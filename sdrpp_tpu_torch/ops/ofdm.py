"""OFDM synchronization (DAB front end).

The counterpart of ``sdrpp_tpu.ops.ofdm`` (reference:
decoder_modules/dab_decoder/src/dab_dsp.h):

- ``CyclicSync`` (dab_dsp.h:8-141): the sliding cyclic-prefix correlation
  corr[i] = sum over the last ``prefix`` samples of conj(x[j]) *
  x[j + symbol], peak-tracked against an AGC'd average to find OFDM
  symbol boundaries. The correlation is one prefix sum over the block
  (torch ops, as in the JAX package); the framing state machine, a
  ``lax.scan`` over every sample in the JAX package, is one kernel launch
  a block here (``ops.sync_walks.cyclic_sync_walk``), which returns each
  emit's sample. An emitted symbol is always the last ``symbol_samps``
  delayed samples up to its emit (a peak restarts the count), so the
  symbols are then gathered in parallel, the carried ``sym_buf``
  supplying the part from before the block.
- ``phase_reference_sync``, ``dab_null_detect``, ``dab_prs_cfo`` and
  ``dab_prs_constellation`` (dab_dsp.h:142-266): frame sync, coarse and
  fine CFO from the phase-reference symbol, with ``torch.fft``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.blocks import Block
from .sync_walks import cyclic_sync_walk

__all__ = ["cyclic_prefix_correlation", "CyclicSync", "phase_reference_sync",
           "load_dab_prs_conj", "dab_null_detect", "dab_prs_cfo",
           "dab_prs_constellation"]


def cyclic_prefix_correlation(tail, x, symbol_samps: int, prefix_samps: int):
    """Sliding CP correlation magnitudes for one block.

    ``tail``: carried last symbol_samps+prefix_samps-1 input samples.
    Returns (new_tail, rcorr[n], delayed_samples[n]) where rcorr[i] is the
    correlation magnitude aligned with the reference's per-sample loop and
    delayed_samples are the symbol-delayed samples it frames
    (dab_dsp.h:57-76: val = delayBuf[i], prod = conj(val)*delayBuf[i+symbol]).
    """
    n = x.shape[-1]
    buf = torch.cat([tail, x], dim=-1)  # [..., n + symbol + prefix - 1]
    val = buf[..., prefix_samps - 1: prefix_samps - 1 + n]
    b0 = buf[..., : n + prefix_samps - 1]
    b1 = buf[..., symbol_samps: symbol_samps + n + prefix_samps - 1]
    prod = torch.conj(b0) * b1  # [..., n + prefix - 1]
    csum = torch.cumsum(prod, dim=-1)
    hi = csum[..., prefix_samps - 1: prefix_samps - 1 + n]
    lo = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., : n - 1]],
                   dim=-1)
    rcorr = torch.abs(hi - lo)
    return buf[..., n:], rcorr, val


class CyclicSync(Block):
    """CP-correlation symbol synchronizer (framing state machine included).

    Output: (symbols[max_syms, symbol_samps], valid[max_syms]) — complete
    OFDM symbols cut at correlation peaks, prefix-valid like the other
    data-dependent-rate blocks. State: the JAX block's tree (``tail``,
    ``avg_corr``, ``peak_corr``, ``last_corr``, ``since_peak``,
    ``sym_buf``).
    """

    def __init__(self, symbol_length: float, cyclic_prefix_length: float,
                 samplerate: float, agc_rate: float = 1e-3, *,
                 device="cuda"):
        self.symbol_samps = int(round(samplerate * symbol_length))
        self.prefix_samps = int(round(samplerate * cyclic_prefix_length))
        self.agc_rate = np.float32(agc_rate)
        self.device = torch.device(device)

    def max_symbols(self, n: int) -> int:
        return n // self.symbol_samps + 2

    def init_state(self):
        d, c64, f32 = self.device, torch.complex64, torch.float32
        return {
            "tail": torch.zeros(self.symbol_samps + self.prefix_samps - 1,
                                dtype=c64, device=d),
            "avg_corr": torch.zeros((), dtype=f32, device=d),
            "peak_corr": torch.zeros((), dtype=f32, device=d),
            "last_corr": torch.zeros((), dtype=f32, device=d),
            "since_peak": torch.zeros((), dtype=torch.int32, device=d),
            "sym_buf": torch.zeros(self.symbol_samps, dtype=c64, device=d),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        sym = self.symbol_samps
        max_syms = self.max_symbols(n)
        tail, rcorr, vals = cyclic_prefix_correlation(
            state["tail"], x.to(torch.complex64), sym, self.prefix_samps)
        carry = torch.stack([state["avg_corr"], state["peak_corr"],
                             state["last_corr"]])
        since0 = state["since_peak"]
        emits, count, carry, since, sym_buf = cyclic_sync_walk(
            rcorr, vals, carry, since0.reshape(1), state["sym_buf"],
            max_syms, self.agc_rate)
        # the stream before the block, as the symbols see it: the carried
        # buffer's first `since0` entries are the last since0 samples
        k = torch.arange(sym, device=x.device)
        prev = state["sym_buf"][(k + since0) % sym]
        ext = torch.cat([prev, vals])
        valid = torch.arange(max_syms, device=x.device) < count
        rows = emits.to(torch.int64).clamp(min=0)[:, None] + 1 + k[None, :]
        syms = torch.where(valid[:, None], ext[rows],
                           torch.zeros((), dtype=ext.dtype, device=x.device))
        new_state = {
            "tail": tail,
            "avg_corr": carry[0],
            "peak_corr": carry[1],
            "last_corr": carry[2],
            "since_peak": since.reshape(()),
            "sym_buf": sym_buf,
        }
        return new_state, (syms, valid)


def phase_reference_sync(received_sym: torch.Tensor, prs: np.ndarray):
    """Frame sync + coarse CFO from the DAB phase-reference symbol
    (dab_dsp.h:142-266 pattern): correlate the received symbol against the
    known PRS in the frequency domain; the cross-correlation peak gives the
    timing offset, its phase slope the fractional CFO.

    Returns (timing_offset, peak_magnitude, cfo_bins).
    """
    n = received_sym.shape[-1]
    dev = received_sym.device
    rx_f = torch.fft.fft(received_sym, dim=-1)
    prs_f = torch.from_numpy(
        np.fft.fft(np.asarray(prs), n).conj().astype(np.complex64)).to(dev)
    xcorr = torch.fft.ifft(rx_f * prs_f, dim=-1)
    mags = torch.abs(xcorr)
    k = torch.argmax(mags, dim=-1)
    # integer CFO from the circular shift of the spectrum correlation
    spec_corr = torch.abs(torch.fft.ifft(
        torch.fft.fft(torch.abs(rx_f).to(torch.complex64))
        * torch.conj(torch.fft.fft(torch.abs(prs_f).to(torch.complex64)))))
    cfo = torch.argmax(spec_corr, dim=-1)
    cfo = torch.where(cfo > n // 2, cfo - n, cfo)
    peak = mags[..., k] if mags.ndim == 1 else torch.amax(mags, -1)
    return k, peak, cfo


# ---------------------------------------------------------------------------
# DAB frame/frequency synchronization (dab_dsp.h:142-266)
# ---------------------------------------------------------------------------

def load_dab_prs_conj() -> np.ndarray:
    """The conjugated DAB phase-reference symbol (2048 points; a copy of
    the JAX package's table, extracted from
    decoder_modules/dab_decoder/src/dab_phase_sym.h)."""
    return np.load(Path(__file__).parent / "dab_phase_sym.npz")["prs_conj"]


def dab_null_detect(level, avg_level, agc_rate: float = 0.01):
    """Null-symbol detection (dab_dsp.h:197-209): a symbol block whose
    total amplitude drops below half the running average marks the frame
    start. Returns (is_null, new_avg)."""
    is_null = level < avg_level * 0.5
    new_avg = agc_rate * level + (1.0 - agc_rate) * avg_level
    return is_null, new_avg


def dab_prs_cfo(symbol: torch.Tensor, prs_conj=None):
    """Coarse+fine CFO from the phase-reference symbol
    (dab_dsp.h:230-256): FFT of symbol * conj(PRS); the peak bin gives the
    integer offset, the neighbor-bin amplitude ratio the fractional part.
    Returns offset estimate in rad/sample (the reference's control loop
    applies offset -= 0.1*estimate).
    """
    if prs_conj is None:
        prs_conj = load_dab_prs_conj()
    n = symbol.shape[-1]
    prod = symbol * torch.as_tensor(np.asarray(prs_conj, np.complex64),
                                    device=symbol.device)
    amps = torch.abs(torch.fft.fft(prod, dim=-1))
    peak = torch.argmax(amps, dim=-1, keepdim=True)
    peak_l = torch.gather(amps, -1, (peak + n - 1) % n)[..., 0]
    peak_r = torch.gather(amps, -1, (peak + 1) % n)[..., 0]
    peak = peak[..., 0].to(torch.float32)
    off_int = torch.where(peak < n // 2, peak, peak - n)
    frac = (peak_r - peak_l) / (peak_r + peak_l)
    return np.float32(np.pi) * (off_int + frac) / (n / 2)


_PI4 = np.complex64(np.exp(1j * np.pi / 4))
_IDX = np.concatenate([np.arange(-767, 0), np.arange(1, 768)])
_CID1 = np.where(_IDX >= 0, _IDX, 2048 + _IDX)
_CID0 = np.where(_IDX - 1 >= 0, _IDX - 1, 2048 + (_IDX - 1))


def dab_prs_constellation(symbol: torch.Tensor) -> torch.Tensor:
    """Adjacent-bin differential demod of the PRS for the constellation
    display (dab_dsp.h:218-228): pi/4-rotated X[i]*conj(X[i-1]) normalized
    by |X[i-1]|^2, over centered bins excluding DC."""
    dev = symbol.device
    spec = torch.fft.fft(symbol, dim=-1)
    cid1 = torch.from_numpy(_CID1).to(dev)
    cid0 = torch.from_numpy(_CID0).to(dev)
    x1 = spec[..., cid1]
    x0 = spec[..., cid0]
    a0 = torch.abs(x0)
    return complex(_PI4) * x1 * torch.conj(x0) / (a0 * a0)
