"""VFO bank: N digital down-converters + demodulators over a channel axis.

The counterpart of ``sdrpp_tpu.parallel.vfo_bank``. The reference runs one
thread chain per VFO (core/src/signal_path/iq_frontend.cpp:122-142; one
VFO = RxVFO, channel/rx_vfo.h:6-135); here the bank is one batched
computation: the shared wideband block is mixed against a bank of NCOs
into [channels, n], then resampled, filtered, squelched and demodulated
with a leading channel axis. State trees keep the JAX package's keys, so
``utils.blocks.state_from_numpy`` carries a JAX bank state into the port.

Channel sharding (``shard``, ``sharded_step``) keeps the JAX package's
placement: a state leaf whose leading dim is the channel count splits
over a mesh axis, the wideband input is replicated, and each rank's audio
is its [C/d, n] rows. The JAX package runs the bank under ``shard_map``;
here each rank is a process on its own device that runs the bank on its
channel rows inside ``parallel.spmd.channel_shard``, where the NCO bank
and the FFT channelizer take their tables' rows for that shard. The bank
needs no collective: the only communication is the caller's, a gather of
the audio (``parallel.multihost.gather_global``) where it wants it whole.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.analog import AMDemod, CWDemod, NFMDemod, SSBDemod, WFMDemod
from ..models.radio import DEEMP_TAUS
from ..ops import taps as taps_mod
from ..ops.channelizer import FFTChannelizerBank
from ..ops.fir import FIR
from ..ops.mix import FrequencyXlatorBank
from ..ops.resample import RationalResampler
from ..ops.scans import Deemphasis, Squelch
from ..utils.blocks import Block
from ..utils.tracing import annotate
from .mesh import replicated, shard_placements
from .spmd import axis_size, channel_shard, local_rows

__all__ = ["VFOBank", "ScannerBank"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class VFOBank(Block):
    """Bank of RxVFOs: per-channel mix -> shared-plan resample -> channel LPF.

    All channels share out_samplerate/bandwidth (the scanner pattern);
    offsets differ per channel. Input: wideband [n] complex64 (or [C, n]).
    Output: [C, n_out].
    """

    def __init__(self, offsets_hz, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, *, device):
        offsets_hz = np.asarray(offsets_hz, np.float64)
        self.channels = len(offsets_hz)
        ls = (self.channels,)
        self.xlator = FrequencyXlatorBank(-offsets_hz, in_samplerate,
                                          device=device)
        self.resamp = RationalResampler(in_samplerate, out_samplerate,
                                        lead_shape=ls, device=device)
        self.block_multiple = self.resamp.block_multiple
        self.filter = None
        if bandwidth != out_samplerate:
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=torch.complex64, lead_shape=ls,
                              device=device)

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return {
            "xlator": self.xlator.init_state(),
            "resamp": self.resamp.init_state(),
            "filter": self.filter.init_state() if self.filter else (),
        }

    def __call__(self, state, x):
        with annotate("vfo.mix", device=True):
            xs, y = self.xlator(state["xlator"], x)
        with annotate("vfo.resample", device=True):
            rs, y = self.resamp(state["resamp"], y)
        fs = ()
        if self.filter is not None:
            with annotate("vfo.filter", device=True):
                fs, y = self.filter(state["filter"], y)
        return {"xlator": xs, "resamp": rs, "filter": fs}, y


_DEMODS = {
    "am": lambda rate, bw, ls, dev: AMDemod(bandwidth=bw, samplerate=rate,
                                            lead_shape=ls, device=dev),
    "nfm": lambda rate, bw, ls, dev: NFMDemod(bandwidth=bw, samplerate=rate,
                                              lead_shape=ls, device=dev),
    "usb": lambda rate, bw, ls, dev: SSBDemod("usb", bandwidth=bw,
                                              samplerate=rate, lead_shape=ls,
                                              device=dev),
    "lsb": lambda rate, bw, ls, dev: SSBDemod("lsb", bandwidth=bw,
                                              samplerate=rate, lead_shape=ls,
                                              device=dev),
    "cw": lambda rate, bw, ls, dev: CWDemod(samplerate=rate, lead_shape=ls,
                                            device=dev),
    # broadcast FM stereo: demod at the IF rate; the bank resamples the
    # stereo pair to the audio rate afterwards (wfm.h:246)
    "wfm": lambda rate, bw, ls, dev: WFMDemod(deviation=bw / 2.0,
                                              samplerate=rate, lead_shape=ls,
                                              device=dev),
}


class ScannerBank(Block):
    """Multi-channel scanner: VFO bank + per-channel squelch + demod bank.

    ``channelizer``: "time" (``VFOBank``: NCO bank, power-of-2 cascade and
    polyphase resampler) or "fft" (``FFTChannelizerBank``; needs an
    integer in/IF rate ratio). Output: [C, n_audio] float32 audio per
    channel ([C, n_audio, 2] for WFM). The device defaults to ``cuda``;
    without a card construction raises rather than falling back.

    WFM's AF stage is the radio's (radio_module.h:81-88): the stereo
    pair resampled from the IF rate to ``audio_rate``, then, with
    ``deemphasis`` (a key of ``models.radio.DEEMP_TAUS``: "22us", "50us",
    "75us"), the de-emphasis filter, whose last outputs the state carries
    under ``deemph``. ``deemphasis`` is a broadcast-FM stage: other modes
    refuse it, and without it the state has no ``deemph`` key.

    Spans (``utils.tracing.annotate``): ``bank`` around a call, carrying
    its number (``calls``) as the block id of every span beneath it, and
    ``bank.vfo``, ``bank.squelch``, ``bank.demod``, ``bank.af`` (the
    resampler and the de-emphasis) around its stages; ``VFOBank`` adds
    ``vfo.mix``, ``vfo.resample`` and ``vfo.filter``, ``WFMDemod``
    ``wfm.pilot`` and ``wfm.stereo``, and the de-emphasis ``af.deemph``.
    All are timed on the card's stream too.
    """

    def __init__(self, offsets_hz, in_samplerate: float, mode: str = "usb",
                 if_rate: float = 48000.0, bandwidth: float = 2700.0,
                 squelch_level: float | None = None,
                 audio_rate: float = 48000.0, channelizer: str = "time",
                 deemphasis: str | None = None, *, device="cuda"):
        if deemphasis is not None and mode != "wfm":
            raise ValueError(f"de-emphasis is WFM's AF stage; the {mode} "
                             f"bank has none")
        tau = DEEMP_TAUS[deemphasis]
        self.channels = len(np.asarray(offsets_hz))
        self.mode = mode
        self.calls = 0  # blocks run: the block id of the bank's spans
        ls = (self.channels,)
        if channelizer == "fft":
            self.vfo = FFTChannelizerBank(offsets_hz, in_samplerate, if_rate,
                                          bandwidth=min(bandwidth, if_rate),
                                          device=device)
        elif channelizer == "time":
            self.vfo = VFOBank(offsets_hz, in_samplerate, if_rate,
                               min(bandwidth, if_rate), device=device)
        else:
            raise ValueError(f"unknown channelizer {channelizer!r}")
        self.squelch = (Squelch(squelch_level, lead_shape=ls, device=device)
                        if squelch_level is not None else None)
        self.demod = _DEMODS[mode](if_rate, bandwidth, ls, device)
        # WFM demodulates stereo at the IF rate; resample the stereo
        # planes down to the audio rate
        self.af = None
        if mode == "wfm" and audio_rate != if_rate:
            self.af = RationalResampler(if_rate, audio_rate,
                                        dtype=torch.float32,
                                        lead_shape=(self.channels, 2),
                                        device=device)
        self.deemph = (Deemphasis(tau, audio_rate, stereo=True, lead_shape=ls,
                                  device=device)
                       if tau is not None else None)
        self.block_multiple = self.vfo.block_multiple
        if self.af is not None:
            # the input block must give an IF count divisible by the AF
            # stage's multiple: one vfo multiple of input yields q IF
            # samples, so the input needs af_bm/gcd(q, af_bm) of them
            q = self.vfo.out_count(self.vfo.block_multiple)
            af_bm = self.af.block_multiple
            self.block_multiple = (self.vfo.block_multiple
                                   * (af_bm // int(np.gcd(q, af_bm))))

    def init_state(self):
        st = {
            "vfo": self.vfo.init_state(),
            "squelch": self.squelch.init_state() if self.squelch else (),
            "demod": self.demod.init_state(),
            "af": self.af.init_state() if self.af else (),
        }
        if self.deemph is not None:
            st["deemph"] = self.deemph.init_state()
        return st

    def __call__(self, state, x):
        block, self.calls = self.calls, self.calls + 1
        with annotate("bank", block, device=True):
            with annotate("bank.vfo", device=True):
                vs, y = self.vfo(state["vfo"], x)
            ss = ()
            if self.squelch is not None:
                with annotate("bank.squelch", device=True):
                    ss, y = self.squelch(state["squelch"], y)
            with annotate("bank.demod", device=True):
                ds, audio = self.demod(state["demod"], y)
            st = {"vfo": vs, "squelch": ss, "demod": ds, "af": ()}
            if self.af is not None or self.deemph is not None:
                with annotate("bank.af", device=True):
                    if self.af is not None:
                        # [C, n, 2] stereo -> [C, 2, n] planes -> resample
                        # -> back
                        st["af"], planes = self.af(state["af"],
                                                   audio.transpose(-1, -2))
                        audio = planes.transpose(-1, -2)
                    if self.deemph is not None:
                        with annotate("af.deemph", device=True):
                            st["deemph"], audio = self.deemph(
                                state["deemph"], audio)
        return st, audio

    def _leaf_spec(self, leaf, axis="channels"):
        """``axis`` for a leaf whose leading dim is the channel count (it
        splits over ``axis``), None for a replicated one."""
        if leaf.ndim >= 1 and leaf.shape[0] == self.channels:
            return axis
        return None

    def shard(self, mesh, state, axis="channels"):
        """This rank's rows of the full carried ``state``, with the channel
        dim split over ``axis`` of ``mesh``; returns (local_state,
        in_placements, out_placements): the wideband input replicated, the
        audio split on its leading (channel) dim."""
        d = axis_size(mesh, axis)
        if self.channels % d:
            raise ValueError(f"{self.channels} channels do not split evenly "
                             f"over {d} ranks")

        def shard_leaf(leaf):
            if self._leaf_spec(leaf, axis) is None:
                return leaf
            return local_rows(leaf, self.channels // d, axis, mesh)

        return (_tree_map(shard_leaf, state), replicated(mesh),
                shard_placements(mesh, axis, 0))

    def sharded_step(self, mesh, axis="channels"):
        """The channel-sharded step over ``axis`` of ``mesh`` (one mesh dim
        name or a tuple, e.g. ("host", "chip") on a 2-D mesh): ``step(
        local_state, x)`` runs the bank on this rank's channel rows of the
        state (``shard``) and the whole wideband block ``x``, and returns
        (local_state, audio [C/d, n]).

        Returns (step, state_specs): per leaf of ``init_state()``, ``axis``
        where it splits, None where it is replicated."""
        specs = _tree_map(lambda l: self._leaf_spec(l, axis),
                          self.init_state())

        def step(state, x):
            with channel_shard(axis, mesh):
                return self(state, x)

        return step, specs
