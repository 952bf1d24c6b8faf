"""Complex NCO mixing (frequency translation) with per-block phase carry.

The counterpart of ``sdrpp_tpu.ops.mix`` (reference:
core/src/dsp/channel/frequency_xlator.h:44-48). The whole block is mixed
at once: ``out[i] = in[i] * exp(j*(phi0 + i*omega))``, carry
``phi0 + n*omega mod 2pi``. The per-sample ramp ``(i*omega) mod 2pi`` is
built on the host in float64 and moved to the device once per block
length: a float32 ramp built on the device drifts over 654k-sample blocks.

The JAX package picks a product-of-phasors or an angle form by backend;
the port runs the angle form (``cos``/``sin`` of the wrapped ramp) on
every device, for one NCO and for a bank of them (``mix_bank``).

``mix_bank``, the VFO bank's mix, is a hand-written CUDA kernel on a CUDA
tensor (``csrc/mix.cu``, built on first use through ``utils.cuda_lib``; a
failed build raises), one launch a call counted in ``mix_bank.launches``;
on a CPU tensor it runs ``mix_bank_plain``, the torch expression. The
kernel replaces no TPU kernel (the JAX package's ``mix_bank`` is XLA
elementwise code): it replaces six torch passes over [C, n], each with a
full-size temporary. It is bounded by its [C, n] complex64 write; a CTA
loads its tile of a shared x once and mixes it for a group of channels,
so x leaves device memory once. It keeps the angle form and its float32
order, ``(phi + hi) + lo`` wrapped exactly as ``torch.remainder`` wraps
it, so the phase's bits are the plain path's and the outputs differ from
it only in the last ulps of ``sincosf`` and of the product. Every
argument is checked before a launch (ValueError); nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..parallel.spmd import current_channel_axis, local_rows
from ..utils import cuda_lib
from ..utils.blocks import Block

__all__ = ["mix", "mix_ramp", "mix_dynamic", "mix_bank", "mix_bank_plain",
           "mix_bank_tables", "FrequencyXlator", "DynamicFrequencyXlator",
           "FrequencyXlatorBank", "hz_to_rads"]

TWO_PI = 2.0 * np.pi
_TWO_PI32 = float(np.float32(TWO_PI))


def hz_to_rads(freq: float, samplerate: float) -> float:
    return TWO_PI * (freq / samplerate)


def mix_ramp(n: int, omega: float, device) -> torch.Tensor:
    """The wrapped per-sample ramp ``(i*omega) mod 2pi``, float64 on the
    host, float32 on ``device``."""
    ramp = np.mod(np.arange(n, dtype=np.float64) * float(omega), TWO_PI)
    return torch.from_numpy(ramp.astype(np.float32)).to(device)


def mix(phase: torch.Tensor, x: torch.Tensor, omega: float,
        ramp: torch.Tensor | None = None):
    """Mix block ``x`` with an NCO at ``omega`` rad/sample starting at
    ``phase`` (float32, shaped like x's leading axes). Returns
    (new_phase, y). ``ramp`` is ``mix_ramp(n, omega)``, built here when
    not given."""
    n = x.shape[-1]
    if ramp is None:
        ramp = mix_ramp(n, omega, x.device)
    ph = torch.remainder(phase[..., None] + ramp, _TWO_PI32)
    y = x * torch.complex(torch.cos(ph), torch.sin(ph))
    step = float(np.float32(np.mod(n * float(omega), TWO_PI)))
    new_phase = torch.remainder(phase + step, _TWO_PI32)
    return new_phase, y


def mix_dynamic(phase: torch.Tensor, x: torch.Tensor, omega_hi: torch.Tensor,
                omega_lo: torch.Tensor):
    """Mix block ``x`` with an NCO whose frequency is a tensor: the
    float32 pair ``omega_hi`` + ``omega_lo`` rad/sample (shaped like
    ``phase``, x's leading axes), as the JAX package's ``mix_dynamic``
    (sdrpp_tpu/ops/mix.py:171) takes it. Returns (new_phase, y). The ramp
    is ``mix``'s, ``(i*omega) mod 2pi`` in float64 from the pair's sum,
    built on the device (no host read of the frequency), then float32: at
    a given omega this is ``mix``, bit for bit, where the JAX function
    leaves a ~5e-3 rad residual a block."""
    n = x.shape[-1]
    w = omega_hi.double() + omega_lo.double()
    i = torch.arange(n, dtype=torch.float64, device=x.device)
    ramp = torch.remainder(i * w[..., None], TWO_PI).float()
    ph = torch.remainder(phase[..., None] + ramp, _TWO_PI32)
    y = x * torch.complex(torch.cos(ph), torch.sin(ph))
    step = torch.remainder(n * w, TWO_PI).float()
    return torch.remainder(phase + step, _TWO_PI32), y


class FrequencyXlator(Block):
    """Frequency translation block (reference frequency_xlator.h:6-66).

    ``offset_hz`` rotates the spectrum by +offset (the RxVFO passes the
    negated VFO offset to center the channel, reference rx_vfo.h:30).
    The ramp for each block length is built once and kept.
    """

    def __init__(self, offset_hz: float, samplerate: float, lead_shape=(),
                 *, device):
        self.omega = float(hz_to_rads(offset_hz, samplerate))
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)
        self._ramps: dict[int, torch.Tensor] = {}

    def init_state(self):
        return torch.zeros(self.lead_shape, dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        ramp = self._ramps.get(n)
        if ramp is None:
            ramp = self._ramps[n] = mix_ramp(n, self.omega, self.device)
        return mix(state, x, self.omega, ramp)


class DynamicFrequencyXlator(Block):
    """Frequency translation with the offset in STATE: retuning is a write
    of two scalar leaves between blocks, as the reference retunes by
    changing the rotator's phase step (frequency_xlator.h:51-58).

    State: ``phase`` and the offset in rad/sample as the JAX block's
    float32 pair ``omega_hi`` + ``omega_lo`` (``offset_state``), mixed by
    ``mix_dynamic``; so at a given offset this mixer is
    ``FrequencyXlator``."""

    def __init__(self, offset_hz: float, samplerate: float, lead_shape=(),
                 *, device):
        self.samplerate = float(samplerate)
        self.init_offset = float(offset_hz)
        self.lead_shape = tuple(lead_shape)
        self.device = torch.device(device)

    def offset_state(self, offset_hz: float) -> tuple[np.float32, np.float32]:
        """The (hi, lo) float32 pair of ``offset_hz`` in rad/sample."""
        w = float(hz_to_rads(float(offset_hz), self.samplerate))
        hi = np.float32(w)
        return hi, np.float32(w - float(hi))

    def omega_leaves(self, offset_hz: float) -> dict:
        """``omega_hi`` and ``omega_lo`` leaves of ``offset_hz``."""
        return {k: torch.full(self.lead_shape, float(v), dtype=torch.float32,
                              device=self.device)
                for k, v in zip(("omega_hi", "omega_lo"),
                                self.offset_state(offset_hz))}

    def init_state(self):
        return {"phase": torch.zeros(self.lead_shape, dtype=torch.float32,
                                     device=self.device),
                **self.omega_leaves(self.init_offset)}

    def __call__(self, state, x):
        phase, y = mix_dynamic(state["phase"], x, state["omega_hi"],
                               state["omega_lo"])
        return dict(state, phase=phase), y


def mix_bank_tables(n: int, omegas: np.ndarray, device):
    """The per-channel wrapped phase ramp of a block of ``n`` samples,
    factored as i = a*K + b into two tables built on the host in float64:
    ``hi`` [C, n/K] and ``lo`` [C, K], and the per-block phase step [C],
    each float32 on ``device``."""
    omegas = np.asarray(omegas, dtype=np.float64)
    k = 1 << min(12, max(1, (int(n).bit_length() // 2)))
    while n % k:
        k >>= 1
    a = n // k
    hi = np.mod(np.arange(a, dtype=np.float64)[None, :] * (k * omegas[:, None]),
                TWO_PI)
    lo = np.mod(np.arange(k, dtype=np.float64)[None, :] * omegas[:, None],
                TWO_PI)
    step = np.mod(n * omegas, TWO_PI)
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in (hi, lo, step))


def mix_bank_plain(phase, x, hi, lo, step):
    """Plain PyTorch version of ``mix_bank`` on its tables (this shard's
    rows): (new_phase [C], y [C, n])."""
    c, n = phase.shape[0], x.shape[-1]
    new_phase = torch.remainder(phase + step, _TWO_PI32)
    ph = phase[:, None, None] + hi[:, :, None] + lo[:, None, :]
    ph = torch.remainder(ph, _TWO_PI32).reshape(c, n)
    return new_phase, x * torch.complex(torch.cos(ph), torch.sin(ph))


def _check_bank(phase, x, hi, lo, step):
    """ValueError unless the arguments are what the kernel takes: complex64
    x [n] or [C, n], float32 phase and step [C], hi [C, A], lo [C, K]
    with A K = n and K a power of 2, all on one device."""
    if x.dtype != torch.complex64:
        raise ValueError(f"mix_bank takes a complex64 x, not {x.dtype}")
    for name, t in (("phase", phase), ("hi", hi), ("lo", lo),
                    ("step", step)):
        if t.dtype != torch.float32:
            raise ValueError(f"mix_bank takes a float32 {name}, not "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError("mix_bank takes tensors on one device")
    if phase.ndim != 1 or x.ndim not in (1, 2):
        raise ValueError(f"mix_bank takes phase [C] and x [n] or [C, n], "
                         f"not {list(phase.shape)} and {list(x.shape)}")
    c, n = phase.shape[0], x.shape[-1]
    a, k = hi.shape[-1], lo.shape[-1]
    if (x.ndim == 2 and x.shape[0] != c) or step.shape != (c,) or \
            hi.shape != (c, a) or lo.shape != (c, k) or a * k != n or \
            k & (k - 1) or c < 1 or n < 1:
        raise ValueError(
            f"mix_bank shapes: phase {list(phase.shape)}, x "
            f"{list(x.shape)}, hi {list(hi.shape)}, lo {list(lo.shape)}, "
            f"step {list(step.shape)} (want [C], [n] or [C, n], [C, A], "
            f"[C, K], [C] with A K = n, K a power of 2)")


# the C entry's argument types, the stream last (cuda_lib.launch appends it)
_BANK_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def mix_bank(phase: torch.Tensor, x: torch.Tensor, omegas: np.ndarray,
             tables=None):
    """Mix a wideband block against a bank of NCOs, one per channel (the
    reference's per-VFO rotator, frequency_xlator.h:44-48, batched).

    ``phase`` [C] float32 carried phases; ``x`` complex64 [n] (shared) or
    [C, n], unit stride along n; ``omegas`` static rad/sample per channel;
    ``tables`` is ``mix_bank_tables(n, omegas)``, built here when not
    given. Returns (new_phase [C], y [C, n]). The phase of sample i = a*K
    + b is ``(phi + hi[a]) + lo[b]`` wrapped to [0, 2pi), in the JAX
    package's order. Inside ``parallel.spmd.channel_shard`` a ``phase`` of
    fewer rows than the tables is this rank's channel shard, and the
    tables' rows for it are taken. On a CUDA tensor one launch of
    ``csrc/mix.cu``; on a CPU tensor ``mix_bank_plain``."""
    n = x.shape[-1]
    if tables is None:
        tables = mix_bank_tables(n, omegas, x.device)
    hi, lo, step = tables
    c = phase.shape[0] if phase.ndim else 0
    if c != hi.shape[0] and current_channel_axis() is not None:
        # a rank's channel shard (parallel/spmd.py): its rows of the tables
        hi, lo, step = (local_rows(t, c) for t in (hi, lo, step))
    _check_bank(phase, x, hi, lo, step)
    dev = x.device
    if dev.type == "cpu":
        return mix_bank_plain(phase, x, hi, lo, step)
    if dev.type != "cuda":
        raise RuntimeError(f"mix_bank runs on CUDA or CPU tensors, not {dev}")
    if x.stride(-1) != 1:
        raise ValueError("mix_bank takes an x contiguous along n")
    phase, hi, lo, step = (t.contiguous() for t in (phase, hi, lo, step))
    new_phase = torch.empty_like(phase)
    y = torch.empty((c, n), dtype=torch.complex64, device=dev)
    fn = cuda_lib.bind("mix", "mix_bank", _BANK_ARGS)
    rc = cuda_lib.launch(fn, dev, x.data_ptr(),
                         x.stride(0) if x.ndim == 2 else 0,
                         phase.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                         step.data_ptr(), new_phase.data_ptr(), y.data_ptr(),
                         c, hi.shape[1], lo.shape[1])
    if rc:
        raise RuntimeError(f"mix_bank: CUDA error {rc} (C={c}, n={n}, "
                           f"K={lo.shape[1]})")
    mix_bank.launches += 1
    return new_phase, y


mix_bank.launches = 0


class FrequencyXlatorBank(Block):
    """Per-channel frequency translation over a channel axis.

    ``offsets_hz``: per-channel offsets (the bank mixes by +offset; pass
    negated VFO offsets as RxVFO does, rx_vfo.h:30). State: the carried
    [C] phase. The tables for each block length are built once and kept.
    """

    def __init__(self, offsets_hz, samplerate: float, *, device):
        self.omegas = np.asarray(
            [hz_to_rads(o, samplerate) for o in np.asarray(offsets_hz)],
            np.float64)
        self.channels = self.omegas.shape[0]
        self.device = torch.device(device)
        self._tables: dict[int, tuple] = {}

    def init_state(self):
        return torch.zeros((self.channels,), dtype=torch.float32,
                           device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        tables = self._tables.get(n)
        if tables is None:
            tables = self._tables[n] = mix_bank_tables(n, self.omegas,
                                                       self.device)
        return mix_bank(state, x, self.omegas, tables)
