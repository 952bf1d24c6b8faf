"""Command-line entry points of the port: ``run``, ``bank`` and ``decode``.

``run`` reads IQ from a test source or a WAV file, demodulates one channel
and writes the audio to a WAV file — the counterpart of ``sdrpp_tpu``'s
``run`` (sdrpp_tpu/cli.py:110-254) without its checkpoint, trace, watchdog
and container options. ``bank`` demodulates many channels at once through
the batched ``ScannerBank`` and writes one WAV per channel
(sdrpp_tpu/cli.py:257-331). ``decode meteor`` runs the Meteor M2 LRPT
decoder (sdrpp_tpu/cli.py:677-823) and writes the s8 x84 soft-symbol file
and ``<out>_vcdu.bin``; the other decode modes are not ported yet.

Every command runs on the CUDA card unless ``--device`` names another
torch device (``--device cpu``); without a card it fails.

Usage: python -m sdrpp_tpu_torch run --source test:2400000
       python -m sdrpp_tpu_torch bank --source test:6144000 \
           --offsets=-100e3,0,100e3 --mode nfm
       python -m sdrpp_tpu_torch decode meteor --source capture.wav
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

log = logging.getLogger("sdrpp_tpu_torch")


def _make_source(spec: str):
    """'test:<samplerate>' -> the synthetic test source (a -20 dBFS tone at
    +100 kHz over -90 dBFS noise, as the JAX cli's default); anything else
    is an IQ WAV path, read block by block to its end."""
    from .io.sources import FileSource, TestSource

    if spec.startswith("test:"):
        fs = float(spec.split(":", 1)[1])
        return TestSource(fs, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    return FileSource(spec, loop=False)


def _auto_block(fs: float, if_rate: float, block_multiple: int,
                if_target: int = 65536, floor: int = 262144,
                ceil: int = 1 << 22) -> int:
    """Input block size so the post-VFO IF block reaches ``if_target``
    samples (where the chunk-parallel loops engage with full lanes),
    clamped to [floor, ceil] and rounded to the chain's block multiple
    (sdrpp_tpu/cli.py:663)."""
    want = int(if_target * fs / max(if_rate, 1.0))
    want = min(max(floor, want), ceil)
    return max(block_multiple, (want // block_multiple) * block_multiple)


def _blocks(src, block: int, max_blocks: int, device):
    """Yield ``block``-sample complex64 tensors on ``device`` from
    ``src``: ``max_blocks`` of them (0 = until a capture's end, or 100
    blocks of an endless source)."""
    cap = getattr(src, "num_frames", None)
    total = nblocks = 0
    while max_blocks == 0 or nblocks < max_blocks:
        if cap is not None and total + block > cap:
            return
        yield torch.from_numpy(np.ascontiguousarray(
            src.read(block), np.complex64)).to(device)
        total += block
        nblocks += 1
        if max_blocks == 0 and cap is None and nblocks >= 100:
            return


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")


def cmd_run(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch run")
    p.add_argument("--source", required=True,
                   help="'test:<samplerate>' or an IQ WAV path")
    _add_device_arg(p)
    p.add_argument("--mode", default="wfm",
                   choices=["wfm", "nfm", "am", "usb", "lsb", "dsb"])
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--out", default="audio.wav")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per device step (default: auto, so "
                        "the IF block engages the chunk-parallel loops)")
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--deemphasis", default=None,
                   choices=[None, "22us", "50us", "75us"])
    args = p.parse_args(argv)

    from .io.sinks import RecorderSink
    from .models.radio import RadioChannel

    device = torch.device(args.device)
    src = _make_source(args.source)
    fs = src.samplerate
    chan = RadioChannel(args.mode, fs, offset=args.offset,
                        bandwidth=args.bandwidth, squelch_level=args.squelch,
                        deemphasis=args.deemphasis, device=device)
    bm = chan.block_multiple
    block = _auto_block(fs, chan.if_rate, bm) if args.block_size is None \
        else max(bm, (args.block_size // bm) * bm)
    cap = getattr(src, "num_frames", None)
    if args.block_size is None and cap is not None and cap >= bm:
        block = min(block, (cap // bm) * bm)  # short captures: one block
    log.info("mode=%s fs=%g block=%d device=%s -> audio %g", args.mode, fs,
             block, device, chan.audio_rate)

    state = chan.init_state()
    sink = RecorderSink(args.out, int(chan.audio_rate),
                        channels=2 if chan.stereo_out else 1)
    total = 0
    t0 = time.perf_counter()
    for x in _blocks(src, block, args.blocks, device):
        state, audio = chan(state, x)
        sink.write(audio.cpu().numpy())
        total += block
    sink.close()
    dt = time.perf_counter() - t0
    log.info("processed %d samples in %.3f s (%.3f Msamp/s) -> %s", total, dt,
             total / max(dt, 1e-9) / 1e6, args.out)
    return 0


def cmd_decode(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch decode")
    p.add_argument("mode", choices=["meteor"])
    p.add_argument("--source", required=True,
                   help="'test:<samplerate>' or an IQ WAV path")
    _add_device_arg(p)
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--out", default="meteor.s",
                   help="soft-symbol file; VCDUs go to <out>_vcdu.bin")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per step (default: auto, so the "
                        "decoder-rate block engages the chunked loops)")
    args = p.parse_args(argv)

    from pathlib import Path

    from .decoders.meteor_lrpt import MeteorLRPTDecoder
    from .models.channel import RxVFO

    device = torch.device(args.device)
    target = 150000.0
    src = _make_source(args.source)
    fs = src.samplerate
    vfo = None
    if fs != target or args.offset:
        vfo = RxVFO(fs, target, bandwidth=target, offset=args.offset,
                    device=device)
        vstate = vfo.init_state()
    dec = MeteorLRPTDecoder(target, device=device)

    bm = vfo.block_multiple if vfo else 1
    block = _auto_block(fs, target, bm) if args.block_size is None \
        else max(bm, (args.block_size // bm) * bm)
    cap = getattr(src, "num_frames", None)
    if cap is not None and cap >= bm:
        block = min(block, (cap // bm) * bm)  # short captures: one block
    log.info("decode meteor fs=%g block=%d device=%s", fs, block, device)

    t0 = time.perf_counter()
    for x in _blocks(src, block, args.blocks, device):
        if vfo is not None:
            vstate, x = vfo(vstate, x)
        dec.process(x)
    soft, vcdus, info = dec.finalize()
    soft.tofile(args.out)
    vpath = str(Path(args.out).with_suffix("")) + "_vcdu.bin"
    with open(vpath, "wb") as f:
        f.write(vcdus.tobytes())
    log.info("%d soft bytes -> %s; %d/%d CADUs (rotation %d) -> %s in "
             "%.3f s", len(soft), args.out, info["vcdus_ok"],
             info["cadus_seen"], info["rotation"], vpath,
             time.perf_counter() - t0)
    return 0


def cmd_bank(argv):
    """Demodulate many channels at once: one batched ScannerBank
    computation, one WAV recording per channel."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch bank")
    p.add_argument("--source", required=True,
                   help="'test:<samplerate>' or an IQ WAV path")
    p.add_argument("--offsets", required=True,
                   help="comma-separated VFO offsets in Hz; use the "
                        "--offsets=-200e3,0,150e3 form when the first "
                        "offset is negative")
    p.add_argument("--mode", default="nfm",
                   choices=["nfm", "am", "usb", "lsb", "cw", "wfm"])
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--if-rate", type=float, default=48000.0)
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--channelizer", default="time", choices=["time", "fft"],
                   help="'fft' = shared-FFT channelizer (one wideband FFT "
                        "for all channels; needs integer fs/if ratio)")
    p.add_argument("--out-dir", default="bank_audio")
    p.add_argument("--container", default="wav", choices=["wav"],
                   help="recording container (flac and mp3 are not "
                        "ported yet)")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=262144)
    _add_device_arg(p)
    args = p.parse_args(argv)

    from pathlib import Path

    from .io.sinks import RecorderSink
    from .parallel.vfo_bank import ScannerBank

    device = torch.device(args.device)
    src = _make_source(args.source)
    fs = src.samplerate
    offsets = np.array([float(o) for o in args.offsets.split(",")])
    bank = ScannerBank(offsets, fs, mode=args.mode, if_rate=args.if_rate,
                       bandwidth=args.bandwidth, squelch_level=args.squelch,
                       channelizer=args.channelizer, device=device)
    bm = bank.block_multiple
    block = max(bm, (args.block_size // bm) * bm)
    log.info("%d-channel %s bank, fs=%g, block=%d, device=%s", len(offsets),
             args.mode, fs, block, device)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # WFM leaves the bank stereo, resampled to 48 kHz; the other modes
    # leave it mono at the IF rate
    rate = 48000 if bank.af is not None else int(args.if_rate)
    sinks = [RecorderSink(out_dir / f"ch{i}_{int(o):+d}Hz.{args.container}",
                          rate, container=args.container,
                          channels=2 if args.mode == "wfm" else 1)
             for i, o in enumerate(offsets)]
    state = bank.init_state()
    total = 0
    t0 = time.perf_counter()
    for x in _blocks(src, block, args.blocks, device):
        state, audio = bank(state, x)
        audio = audio.cpu().numpy()
        for i, sink in enumerate(sinks):
            sink.write(audio[i])
        total += block
    for sink in sinks:
        sink.close()
    dt = time.perf_counter() - t0
    log.info("processed %d samples in %.3f s (%.3f Msamp/s x %d channels); "
             "%d channel recordings -> %s/", total, dt,
             total / max(dt, 1e-9) / 1e6, len(offsets), len(sinks), out_dir)
    return 0


COMMANDS = {"run": cmd_run, "bank": cmd_bank, "decode": cmd_decode}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
