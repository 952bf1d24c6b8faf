"""Command-line entry points of the port: ``run``, ``bank``, ``spectrum``,
``scan``, ``decode``, ``serve``, ``ui`` and ``preheat``.

The counterparts of ``sdrpp_tpu``'s commands (sdrpp_tpu/cli.py):

- ``run``: IQ from a test source or a WAV file -> one ``RadioChannel`` in
  any of its eight modes -> a WAV, FLAC or MP3 recording (``--container``)
  at ``--audio-rate`` in ``--sample-format`` (cli.py:110-254): the step
  runs under ``utils.watchdog.StepWatchdog`` (retries, the poisoned-device
  probe, ``--checkpoint-every N`` blocks), the final state is saved to
  ``--checkpoint`` with the stream offset and ``--resume`` continues from
  it (seeking a WAV source), ``--trace LOGDIR`` writes a
  ``torch.profiler`` Chrome trace of the loop, and a ``StreamMonitor``'s
  throughput line is logged; ``--mode raw`` records the baseband IQ as
  stereo WAV on the host, as the JAX command does;
- ``bank``: many channels at once through the batched ``ScannerBank``, one
  WAV, FLAC or MP3 recording per channel (cli.py:257-331);
- ``spectrum``: the ``IQFrontEnd``'s waterfall dB lines to .npy, and the
  palette-mapped framebuffer with ``--framebuffer`` (cli.py:334-387);
- ``scan``: the scanner's sweep over the front end's FFT lines, reporting
  the carriers it parked on (cli.py:612-660);
- ``decode``: the digital decoders (cli.py:677-846) at their own rates,
  behind an ``RxVFO`` when the source's rate or ``--offset`` differs:
  ``m17`` (48 kHz; voice to an 8 kHz stereo WAV, LSF callsigns logged;
  needs the system libcodec2), ``hrpt`` (3 Msps; the AVHRR lines of every
  minor frame to .npy), ``falcon9`` (6 Msps; video TS packets to a file,
  GPS lines logged), ``kgsstv`` (12 kHz; the raw 7-byte frames) and
  ``meteor`` (150 kHz; the s8 x84 soft-symbol file and
  ``<out>_vcdu.bin``);
- ``serve``: the baseband server (``io.wire``, the reference's ``sdrpp
  --server``): the source's blocks quantized to i16 on the device and
  streamed to one TCP client, with the source's remote controls
  (cli.py:390-440);
- ``ui``: the web panadapter (``misc.webui``: ``ReceiverEngine`` and the
  page), with ``--supervise`` to restart a session whose device context
  is poisoned, and ``--config`` to persist it (cli.py:479-542);
- ``preheat``: a warm step of each UI mode's chain, which builds the
  kernels those chains launch into ``sdrpp_tpu_torch/_build/`` ahead of
  the first session (cli.py:545-609).

Every command takes the JAX CLI's ``--source`` forms (cli.py:47-107): a
WAV path, ``test:<samplerate>`` (a tone at ``--tone`` Hz), and the network
sources ``rtltcp:``, ``spyserver:``, ``kiwisdr:``, ``hpsdr:``,
``hermes:``, ``rfspace:`` and ``spectran:``.

The device loops run as the JAX loops do, through ``utils.pipeline``: a
reader thread and pinned, side-stream uploads ahead of the device
(``Prefetcher``), and each block's output read back one block late
(``DeferredWriter``). Every command runs on the CUDA card unless
``--device`` names another torch device (``--device cpu``); without a
card it fails.

Usage: python -m sdrpp_tpu_torch run --source test:2400000 --mode cw
       python -m sdrpp_tpu_torch bank --source test:6144000 \
           --offsets=-100e3,0,100e3 --mode nfm
       python -m sdrpp_tpu_torch spectrum --source test:2400000
       python -m sdrpp_tpu_torch scan --source capture.wav --start=-1e6 \
           --stop=1e6
       python -m sdrpp_tpu_torch decode meteor --source capture.wav
       python -m sdrpp_tpu_torch decode hrpt --source capture.wav \
           --offset 250e3
       python -m sdrpp_tpu_torch serve --source rtltcp:127.0.0.1:1234
       python -m sdrpp_tpu_torch ui --source test:2400000 --port 8073
       python -m sdrpp_tpu_torch preheat --samplerate 2400000
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import sys
import time

import numpy as np
import torch

from .utils.log import get_logger

log = get_logger()

# child exit code meaning "restart me" — the engine side lives in
# misc/webui.py; re-exported here for the supervisor and tests
from .misc.webui import BACKEND_FATAL_EXIT  # noqa: E402


def _add_source_args(p):
    p.add_argument("--source", required=True,
                   help="IQ WAV path, 'test:<samplerate>', "
                        "'rtltcp:<host>:<port>[:<samplerate>]', "
                        "'spyserver:<host>:<port>', "
                        "'kiwisdr:<host>:<port>[:<freq_hz>]', "
                        "'hpsdr:<host>[:<port>[:<samplerate>]]', "
                        "'hermes:<host>[:<port>[:<samplerate>]]', "
                        "'rfspace:<host>:<port>[:<samplerate>]', or "
                        "'spectran:<host>[:<port>]'")
    p.add_argument("--tone", type=float, default=100000.0,
                   help="test source tone offset Hz")


def _make_source(spec: str, tone: float = 100000.0):
    """The source a ``--source`` spec names (sdrpp_tpu/cli.py:61-107):
    'test:<samplerate>', the synthetic test source (a -20 dBFS tone at
    ``tone`` Hz over -90 dBFS noise); a network source (rtltcp:,
    spyserver:, kiwisdr:, hpsdr:, hermes:, rfspace:, spectran:),
    connected and started; anything else an IQ WAV path, read block by
    block to its end."""
    from .io.sources import FileSource, TestSource

    src = spec
    if src.startswith("test:"):
        fs = float(src.split(":", 1)[1])
        return TestSource(fs, tones=[(tone, -20.0)], noise_dbfs=-90.0)
    if src.startswith("rtltcp:"):
        from .io.rtl_tcp import RtlTcpSource
        parts = src.split(":")
        sr = float(parts[3]) if len(parts) > 3 else 2400000.0
        return RtlTcpSource(parts[1], int(parts[2]), samplerate=sr)
    if src.startswith("spyserver:"):
        from .io.spyserver import SpyServerSource
        parts = src.split(":")
        s = SpyServerSource(parts[1], int(parts[2]))
        s.start()
        return s
    if src.startswith("kiwisdr:"):
        from .io.kiwisdr import KiwiSDRSource
        parts = src.split(":")
        freq = float(parts[3]) if len(parts) > 3 else 10000000.0
        return KiwiSDRSource(parts[1], int(parts[2]), freq_hz=freq)
    if src.startswith(("hpsdr:", "hermes:")):
        from .io.hpsdr import HermesLite2Source, HpsdrSource
        parts = src.split(":")
        port = int(parts[2]) if len(parts) > 2 else 1024
        cls = HermesLite2Source if src.startswith("hermes:") else HpsdrSource
        sr = float(parts[3]) if len(parts) > 3 else \
            (384000.0 if cls is HermesLite2Source else 192000.0)
        s = cls(parts[1], port, samplerate=sr)
        s.start()
        return s
    if src.startswith("rfspace:"):
        from .io.rfspace import RFspaceSource
        parts = src.split(":")
        s = RFspaceSource(parts[1], int(parts[2]))
        if len(parts) > 3:
            s.set_samplerate(float(parts[3]))
        s.start()
        return s
    if src.startswith("spectran:"):
        from .io.spectran import SpectranHTTPSource
        parts = src.split(":")
        port = int(parts[2]) if len(parts) > 2 else 54664
        return SpectranHTTPSource(parts[1], port)
    return FileSource(src, loop=False)


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


def _blocks(src, block: int, max_blocks: int, device, start: int = 0):
    """Yield ``block``-sample complex64 tensors on ``device`` from
    ``src`` through a ``Prefetcher``: ``max_blocks`` of them (0 = until a
    capture's end, or 100 blocks of an endless source). ``start`` is the
    source's position (a resumed run's offset), for the capture's end."""
    from .utils.pipeline import Prefetcher

    cap = getattr(src, "num_frames", None)
    pre = Prefetcher(src, block, device=device)
    try:
        total, nblocks = start, 0
        while max_blocks == 0 or nblocks < max_blocks:
            if cap is not None and total + block > cap:
                return
            yield pre.read(block)
            total += block
            nblocks += 1
            if max_blocks == 0 and cap is None and nblocks >= 100:
                return
    finally:
        pre.close()


def _stream(step, state, src, block: int, max_blocks: int, device, write,
            monitor=None, label: str | None = None, offset: int = 0):
    """The device loop of ``run`` and ``bank``: each block of ``src``
    (``_blocks``, from stream position ``offset``) through ``step`` (state,
    x) -> (state, y), inside ``monitor.block`` (a ``StreamMonitor``) and an
    ``annotate(label)`` trace region when given, each y handed to
    ``write`` on the host one block late (``DeferredWriter``). Returns
    (final state, stream position)."""
    from .utils.pipeline import DeferredWriter
    from .utils.tracing import annotate

    writer = DeferredWriter(write)
    for x in _blocks(src, block, max_blocks, device, start=offset):
        with (monitor.block(block) if monitor else contextlib.nullcontext()), \
                (annotate(label) if label else contextlib.nullcontext()):
            state, y = step(state, x)
            writer.push(y)
        offset += block
    writer.flush()
    return state, offset


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")


def cmd_run(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch run")
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--mode", default="wfm",
                   choices=["wfm", "nfm", "am", "usb", "lsb", "dsb", "cw",
                            "raw"])
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--out", default="audio.wav")
    p.add_argument("--container", default="wav",
                   choices=["wav", "flac", "mp3"],
                   help="recording container (the recorder's WAV/FLAC/MP3)")
    p.add_argument("--sample-format", default="i16",
                   choices=["u8", "i16", "i24", "i32", "f32"],
                   help="sample depth (recorder main.cpp:48-60; f32 WAV "
                        "only)")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per device step (default: auto, so "
                        "the IF block engages the chunk-parallel loops)")
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--deemphasis", default=None,
                   choices=[None, "22us", "50us", "75us"])
    p.add_argument("--checkpoint", default=None,
                   help="save the chain's state and the stream offset here "
                        "at the end (.npz, the JAX package's format)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N blocks during the run")
    p.add_argument("--resume", action="store_true",
                   help="start from --checkpoint's state and offset")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "to LOGDIR")
    args = p.parse_args(argv)

    from .io.sinks import RecorderSink
    from .models.radio import RadioChannel
    from .utils.checkpoint import load_state, save_state
    from .utils.tracing import StreamMonitor, trace
    from .utils.watchdog import StepWatchdog

    device = torch.device(args.device)
    src = _make_source(args.source, args.tone)
    fs = src.samplerate
    if args.mode == "raw":
        return _record_baseband(src, args)
    chan = RadioChannel(args.mode, fs, offset=args.offset,
                        bandwidth=args.bandwidth, audio_rate=args.audio_rate,
                        squelch_level=args.squelch,
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
    offset = 0
    if args.resume and args.checkpoint:
        try:
            state, offset = load_state(args.checkpoint, state)
        except ValueError as e:
            log.error("cannot resume: checkpoint was written by a different "
                      "chain configuration (%s)", e)
            return 2
        if hasattr(src, "seek"):
            src.seek(offset)
        log.info("resumed from %s at sample %d", args.checkpoint, offset)

    step = StepWatchdog(lambda: chan, max_retries=2, backoff_s=2.0,
                        checkpoint_path=args.checkpoint,
                        checkpoint_every=args.checkpoint_every)
    sink = RecorderSink(args.out, int(chan.audio_rate),
                        container=args.container,
                        channels=2 if chan.stereo_out else 1,
                        sample_format=args.sample_format)
    mon = StreamMonitor(samplerate=fs)
    start = offset
    after = itertools.count(offset + block, block)  # offset after a block
    with (trace(args.trace) if args.trace else contextlib.nullcontext()):
        state, offset = _stream(
            lambda s, x: step(s, x, offset=next(after)), state, src, block,
            args.blocks, device, sink.write, monitor=mon,
            label=f"run:{args.mode}", offset=offset)
    sink.close()
    log.info(str(mon))
    if args.trace:
        log.info("profiler trace -> %s", args.trace)
    if args.checkpoint:
        save_state(args.checkpoint, state, stream_offset=offset)
        log.info("checkpoint -> %s", args.checkpoint)
    log.info("processed %d samples -> %s", offset - start, args.out)
    return 0


def _record_baseband(src, args):
    """``run --mode raw``: the recorder's baseband mode
    (misc_modules/recorder): the source's IQ as stereo WAV (L = I, R = Q)
    at its own rate, on the host (sdrpp_tpu/cli.py:152-175)."""
    from .io import wav

    block = args.block_size or 262144
    chunks = [x.numpy() for x in _blocks(src, block, args.blocks, "cpu")]
    iq = np.concatenate(chunks) if chunks else np.zeros(0, np.complex64)
    wav.write_wav(args.out, int(src.samplerate),
                  np.stack([iq.real, iq.imag], -1), args.sample_format)
    log.info("recorded %d IQ samples -> %s", len(iq), args.out)
    return 0


DECODE_RATES = {"m17": 48000.0, "hrpt": 3000000.0, "falcon9": 6000000.0,
                "kgsstv": 12000.0, "meteor": 150000.0}
DECODE_OUTS = {"m17": "m17.wav", "hrpt": "avhrr.npy",
               "falcon9": "falcon9_video.ts", "kgsstv": "kgsstv_out.bin",
               "meteor": "meteor.s"}


def _decoder(mode: str, rate: float, device):
    if mode == "m17":
        from .models.m17_chain import M17Decoder
        return M17Decoder(rate, device=device, on_lsf=lambda l: log.info(
            "M17 LSF: dst=%s src=%s", l.dst, l.src))
    if mode == "hrpt":
        from .decoders.hrpt import HRPTDecoder
        return HRPTDecoder(rate, device=device)
    if mode == "falcon9":
        from .decoders.falcon9 import Falcon9Decoder
        return Falcon9Decoder(rate, device=device)
    if mode == "kgsstv":
        from .decoders.kg_sstv import KGSSTVDecoder
        return KGSSTVDecoder(rate, device=device)
    from .decoders.meteor_lrpt import MeteorLRPTDecoder
    return MeteorLRPTDecoder(rate, device=device)


def cmd_decode(argv):
    """Digital decoder pipelines (the reference's decoder modules): m17
    voice, NOAA HRPT imagery, Falcon 9 telemetry, KG-STV frames, Meteor M2
    LRPT (soft symbols + Viterbi/RS VCDU payloads)."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch decode")
    p.add_argument("mode", choices=list(DECODE_RATES))
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--out", default=None,
                   help="output path (default per mode: m17 -> m17.wav, "
                        "hrpt -> avhrr.npy, falcon9 -> falcon9_video.ts, "
                        "kgsstv -> kgsstv_out.bin, meteor -> meteor.s with "
                        "the VCDUs in <out>_vcdu.bin)")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per step (default: auto, so the "
                        "decoder-rate block engages the chunked loops)")
    args = p.parse_args(argv)

    from pathlib import Path

    from .models.channel import RxVFO

    device = torch.device(args.device)
    target = DECODE_RATES[args.mode]
    src = _make_source(args.source, args.tone)
    fs = src.samplerate
    vfo = None
    if fs != target or args.offset:
        vfo = RxVFO(fs, target, bandwidth=target, offset=args.offset,
                    device=device)
        vstate = vfo.init_state()
    dec = _decoder(args.mode, target, device)
    out_path = args.out or DECODE_OUTS[args.mode]

    bm = vfo.block_multiple if vfo else 1
    block = _auto_block(fs, target, bm) if args.block_size is None \
        else max(bm, (args.block_size // bm) * bm)
    cap = getattr(src, "num_frames", None)
    if cap is not None and cap >= bm:
        block = min(block, (cap // bm) * bm)  # short captures: one block
    log.info("decode %s fs=%g block=%d device=%s", args.mode, fs, block,
             device)

    t0 = time.perf_counter()
    audio_chunks, avhrr_lines, frames_bin = [], [], b""
    video = open(out_path, "wb") if args.mode == "falcon9" else None
    try:
        for x in _blocks(src, block, args.blocks, device):
            if vfo is not None:
                vstate, x = vfo(vstate, x)
            if args.mode == "m17":
                audio, _ = dec.process(x)
                audio_chunks.append(audio)
            elif args.mode == "hrpt":
                for f in dec.process(x):
                    log.info("HRPT frame: sc=%d fn=%d syncErr=%d",
                             f.spacecraft_id, f.frame_number, f.sync_errors)
                    avhrr_lines.append(f.avhrr)
            elif args.mode == "falcon9":
                for kind, body in dec.process(x):
                    if kind == "gps":
                        log.info("GPS: %s",
                                 body.decode(errors="replace").strip())
                    elif kind == "video":
                        video.write(body)
            elif args.mode == "kgsstv":
                for fr in dec.process(x):
                    frames_bin += fr
            else:
                dec.process(x)
    finally:
        if video is not None:
            video.close()

    dt = time.perf_counter() - t0
    if args.mode == "m17":
        from .io import wav

        audio = (np.concatenate(audio_chunks, axis=0) if audio_chunks
                 else np.zeros((0, 2), np.float32))
        wav.write_wav(out_path, 8000, audio, "i16")
        log.info("%d voice samples -> %s in %.3f s", audio.shape[0],
                 out_path, dt)
    elif args.mode == "hrpt":
        lines = (np.stack(avhrr_lines) if avhrr_lines
                 else np.zeros((0, 5, 2048), np.int32))
        np.save(out_path, lines)
        log.info("%d AVHRR lines -> %s in %.3f s", lines.shape[0], out_path,
                 dt)
    elif args.mode == "falcon9":
        log.info("video TS -> %s in %.3f s", out_path, dt)
    elif args.mode == "kgsstv":
        with open(out_path, "wb") as f:
            f.write(frames_bin)
        log.info("%d frame bytes -> %s in %.3f s", len(frames_bin), out_path,
                 dt)
    else:
        # the reference module's surface: the s8 x84 soft-symbol file
        # (meteor main.cpp:268-276), and the LRPT tail the framework adds
        soft, vcdus, info = dec.finalize()
        soft.tofile(out_path)
        vpath = str(Path(out_path).with_suffix("")) + "_vcdu.bin"
        with open(vpath, "wb") as f:
            f.write(vcdus.tobytes())
        log.info("%d soft bytes -> %s; %d/%d CADUs (rotation %d) -> %s in "
                 "%.3f s", len(soft), out_path, info["vcdus_ok"],
                 info["cadus_seen"], info["rotation"], vpath,
                 time.perf_counter() - t0)
    return 0


def cmd_bank(argv):
    """Demodulate many channels at once: one batched ScannerBank
    computation, one WAV recording per channel."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch bank")
    _add_source_args(p)
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
    p.add_argument("--container", default="wav",
                   choices=["wav", "flac", "mp3"],
                   help="recording container (the recorder's WAV/FLAC/MP3)")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=262144)
    _add_device_arg(p)
    args = p.parse_args(argv)

    from pathlib import Path

    from .io.sinks import RecorderSink
    from .parallel.vfo_bank import ScannerBank
    from .utils.tracing import StreamMonitor

    device = torch.device(args.device)
    src = _make_source(args.source, args.tone)
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
    mon = StreamMonitor(samplerate=fs)
    _stream(bank, state, src, block, args.blocks, device,
            lambda a: [sink.write(a[i]) for i, sink in enumerate(sinks)],
            monitor=mon)
    for sink in sinks:
        sink.close()
    log.info("%s (x%d channels = %.1f Maggsamp/s)", mon, len(offsets),
             mon.samples_per_sec * len(offsets) / 1e6)
    log.info("%d channel recordings -> %s/", len(sinks), out_dir)
    return 0


def cmd_spectrum(argv):
    """IQ -> the front end's waterfall dB lines -> .npy, and with
    ``--framebuffer`` the palette-mapped ABGR framebuffer -> .npy."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch spectrum")
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--fft-size", type=int, default=65536)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--window", default="nuttall",
                   choices=["rectangular", "hamming", "hann", "blackman",
                            "nuttall", "blackman_harris4", "blackman_harris7"])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--out", default="waterfall.npy")
    p.add_argument("--framebuffer", default=None,
                   help="also render the palette-mapped waterfall "
                        "framebuffer (uint32 ABGR) to this .npy")
    p.add_argument("--fb-width", type=int, default=1024)
    args = p.parse_args(argv)

    from .ops.windows import Window
    from .signal_path import IQFrontEnd
    from .utils.pipeline import DeferredWriter

    device = torch.device(args.device)
    src = _make_source(args.source, args.tone)
    fe = IQFrontEnd(src.samplerate, fft_size=args.fft_size,
                    fft_rate=args.fft_rate, fft_window=Window(args.window),
                    block_size=args.block_size, device=device)
    st = fe.init_state()
    lines = []
    writer = DeferredWriter(lines.append)
    for x in _blocks(src, args.block_size, args.blocks, device):
        st, (_iq, fft) = fe(st, x)
        writer.push(fft)
    writer.flush()
    wf = np.concatenate(lines, axis=0)
    np.save(args.out, wf)
    log.info("waterfall %s dB -> %s", wf.shape, args.out)

    if args.framebuffer:
        from .misc.waterfall import WaterfallDisplay

        disp = WaterfallDisplay(raw_fft_size=wf.shape[-1],
                                data_width=args.fb_width,
                                waterfall_height=max(len(wf), 2),
                                whole_bandwidth=src.samplerate)
        for line in wf:
            disp.push_fft(line)
        disp.auto_range()
        # render again at the auto range, so the image spans the palette
        for line in wf:
            disp.push_fft(line)
        np.save(args.framebuffer, disp.framebuffer)
        log.info("framebuffer %s ABGR -> %s", disp.framebuffer.shape,
                 args.framebuffer)
    return 0


def cmd_scan(argv):
    """Sweep --start..--stop over the front end's FFT lines (the scanner
    module's loop, one step a block) and print each frequency it parked on
    with its strongest level."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch scan")
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--start", type=float, required=True, help="start offset Hz")
    p.add_argument("--stop", type=float, required=True, help="stop offset Hz")
    p.add_argument("--interval", type=float, default=25000.0)
    p.add_argument("--level", type=float, default=-50.0)
    p.add_argument("--mode", default="nfm",
                   choices=["nfm", "am", "usb", "lsb", "cw"])
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--block-size", type=int, default=131072)
    p.add_argument("--fft-size", type=int, default=4096)
    args = p.parse_args(argv)

    from .misc.meters import vfo_signal_info
    from .misc.scanner import Scanner
    from .signal_path import IQFrontEnd

    device = torch.device(args.device)
    src = _make_source(args.source, args.tone)
    fs = src.samplerate
    fe = IQFrontEnd(fs, fft_size=args.fft_size,
                    fft_rate=fs / args.block_size * 2,
                    block_size=args.block_size, device=device)
    st = fe.init_state()
    sc = Scanner(args.start, args.stop, args.interval, level_db=args.level)
    now = 0.0
    hits = {}
    for x in _blocks(src, args.block_size, args.blocks, device):
        st, (_iq, fft) = fe(st, x)
        line = fft[-1].cpu().numpy()
        freq = sc.step(line, args.bandwidth, 0.0, fs, now)
        now += args.block_size / fs
        if sc.receiving:
            strength, snr = vfo_signal_info(line, freq, args.bandwidth, fs)
            hits[freq] = max(hits.get(freq, -999.0), strength)
            log.info("RECEIVING %+.1f kHz  %.1f dB (SNR %.1f dB)", freq / 1e3,
                     strength, snr)
        else:
            log.info("scanning... at %+.1f kHz", freq / 1e3)
    for f, s in sorted(hits.items()):
        print(f"{f:+12.0f} Hz  {s:6.1f} dB")
    return 0


def cmd_serve(argv):
    """Stream the source's baseband over TCP (the reference's ``sdrpp
    --server``): each block goes to ``--device``, is quantized to i16
    there and sent to the one client while it has started the stream."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch serve")
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5259)
    p.add_argument("--block-size", type=int, default=65536)
    p.add_argument("--blocks", type=int, default=0, help="0 = run forever")
    args = p.parse_args(argv)

    from .io.wire import BasebandServer
    from .ops.compression import PCM_TYPE_I16

    device = torch.device(args.device)
    torch.zeros(1, device=device)  # no card: fail before serving anything
    src = _make_source(args.source, args.tone)
    srv = BasebandServer(args.addr, args.port, samplerate=src.samplerate,
                         pcm_type=PCM_TYPE_I16)
    srv.on_tune = lambda f: src.tune(f)
    # remote-UI controls (the headless SmGui): expose what the selected
    # source supports, like the reference server mirrors the source menu
    srv.register_control("samplerate", "float", src.samplerate,
                         label="Sample rate (Hz)", min=0.0)
    if hasattr(src, "set_gain"):
        srv.register_control("gain", "float", 0.0, label="Gain (dB)",
                             min=0.0, max=50.0)
    if hasattr(src, "tones"):
        srv.register_control("tone_offset", "float", args.tone,
                             label="Test tone offset (Hz)")

    def _on_control(name, value):
        if name == "gain" and hasattr(src, "set_gain"):
            src.set_gain(value)
        elif name == "tone_offset" and hasattr(src, "tones"):
            src.tones = [(value, -20.0)]

    srv.on_control = _on_control
    log.info("baseband server on %s:%d fs=%g device=%s", args.addr, srv.port,
             src.samplerate, device)
    sent = 0
    t0 = None
    try:
        while args.blocks == 0 or sent < args.blocks:
            if srv.running:
                if t0 is None:
                    t0 = time.perf_counter()
                x = torch.from_numpy(src.read(args.block_size)).to(device)
                srv.send_baseband(x)
                sent += 1
            else:
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    if t0 is not None:
        dt = time.perf_counter() - t0
        log.info("served %d blocks of %d samples in %.3f s (%.1f blocks/s)",
                 sent, args.block_size, dt, sent / max(dt, 1e-9))
    return 0


def _supervise(cmd, max_restarts: int = 20, _spawn=None):
    """Process-level recovery loop (the recovery ladder's rung 4): run
    ``cmd`` as a child with SDRPP_TPU_SUPERVISED set; when it exits with
    BACKEND_FATAL_EXIT (the engine found its device context poisoned: on
    CUDA a device-side fault lasts until the process exits), restart it.
    Any other exit code propagates. The reference's equivalent resilience
    is per-thread trap-and-continue (core/src/utils/threading.h:55-61); a
    CUDA context's fault domain is the PROCESS, so that is where the trap
    goes."""
    import os
    import subprocess

    env = dict(os.environ, SDRPP_TPU_SUPERVISED="1")
    spawn = _spawn or (lambda: subprocess.run(cmd, env=env).returncode)
    restarts = 0
    while True:
        rc = spawn()
        if rc != BACKEND_FATAL_EXIT:
            return rc
        restarts += 1
        if restarts > max_restarts:
            log.error(f"supervisor: giving up after {restarts - 1} "
                      "backend-fatal restarts")
            return 1
        log.warning(f"supervisor: backend unrecoverable (exit {rc}); "
                    f"restarting session (attempt {restarts})")
        time.sleep(min(5.0 * restarts, 60.0))


def cmd_ui(argv):
    """Web panadapter: spectrum/waterfall + tuning + audio in a browser
    (the reference GUI's role on a headless GPU host, misc/webui.py)."""
    from .misc.webui import ALL_MODES

    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch ui")
    _add_source_args(p)
    _add_device_arg(p)
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8073)
    p.add_argument("--mode", default="wfm", choices=ALL_MODES,
                   help="demod mode; digital modes (e.g. meteor) start a "
                        "constellation VFO instead of audio")
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--fft-size", type=int, default=16384)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--no-realtime", action="store_true",
                   help="process as fast as possible (file benchmarking)")
    p.add_argument("--no-bg-preheat", action="store_true",
                   help="don't warm the other modes' chains in the "
                        "background once streaming starts")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="persist the UI session (VFOs/volume/range) to this "
                        "file and restore it on start (ConfigManager role)")
    p.add_argument("--supervise", action="store_true",
                   help="run the session in a supervised child process "
                        "and restart it if its device context is poisoned "
                        "(a device-side fault on CUDA lasts until the "
                        "process exits, so the recovery ladder's last rung "
                        "is a process restart; pair with --config so the "
                        "session's VFOs survive the respawn)")
    args = p.parse_args(argv)

    if args.supervise:
        import os
        if os.environ.get("SDRPP_TPU_SUPERVISED"):
            # already a supervised child (e.g. --supervise leaked into
            # the child argv via an argparse abbreviation): never nest
            p.error("--supervise inside a supervised child")
        # strip the flag INCLUDING argparse prefix abbreviations
        # (--sup, --super, ...) or the child re-supervises forever
        child_argv = ["ui"] + [
            a for a in argv
            if not (a.startswith("--s") and "--supervise".startswith(a))]
        return _supervise([sys.executable, "-m", "sdrpp_tpu_torch"]
                          + child_argv)

    from .misc.webui import ReceiverEngine, serve_ui

    src = _make_source(args.source, args.tone)
    if hasattr(src, "loop"):
        src.loop = True  # a UI session should not stop at file EOF
    engine = ReceiverEngine(src, mode=args.mode, offset=args.offset,
                            bandwidth=args.bandwidth, squelch=args.squelch,
                            audio_rate=args.audio_rate, fft_size=args.fft_size,
                            fft_rate=args.fft_rate, base_block=args.block_size,
                            realtime=not args.no_realtime,
                            background_preheat=not args.no_bg_preheat,
                            device=args.device)
    serve_ui(engine, args.addr, args.port, config_path=args.config)
    return 0


def cmd_preheat(argv):
    """Warm the interactive mode corpus: one block of each UI mode's chain
    (and the structural variants mode cycling visits) on throwaway state,
    which builds every kernel those chains launch (csrc/*.cu with nvcc,
    the host module with the host compiler, into sdrpp_tpu_torch/_build/)
    ahead of the first `ui` session on this machine."""
    from .misc.webui import ALL_MODES, ReceiverEngine

    p = argparse.ArgumentParser(prog="sdrpp_tpu_torch preheat")
    _add_device_arg(p)
    p.add_argument("--samplerate", type=float, default=1000000.0,
                   help="source sample rate the UI will run at")
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--fft-size", type=int, default=16384)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--modes", default=None,
                   help="comma list (default: every UI mode)")
    p.add_argument("--no-variants", action="store_true",
                   help="skip the squelch/RDS/multi-VFO variants")
    args = p.parse_args(argv)

    from .io.sources import TestSource

    modes = (args.modes.split(",") if args.modes else ALL_MODES)
    for m in modes:
        if m not in ALL_MODES:
            p.error(f"unknown mode {m!r} (choose from {ALL_MODES})")

    def _vfo(mode, **kw):
        d = dict(mode=mode, offset=100000.0, bandwidth=None, squelch=None,
                 deemphasis=None, rds=False)
        d.update(kw)
        return d

    corpus = [(f"mode:{m}", {"vfo0": _vfo(m)}) for m in modes]
    if not args.no_variants:
        # the structural variants mode cycling actually visits: squelch
        # presence is a chain change (webui._graph_cfg), RDS adds the
        # pilot/decoder tap, and analog+digital multi-VFO is the mixed
        # topology
        if "nfm" in modes:
            corpus.append(("nfm+squelch",
                           {"vfo0": _vfo("nfm", squelch=-50.0)}))
        if "wfm" in modes:
            corpus.append(("wfm+rds", {"vfo0": _vfo("wfm", rds=True)}))
        if "nfm" in modes and "meteor" in modes:
            corpus.append(("nfm+meteor",
                           {"vfo0": _vfo("nfm"),
                            "vfo1": _vfo("meteor", bandwidth=140000.0)}))

    src = TestSource(args.samplerate, tones=[(100000.0, -20.0)],
                     noise_dbfs=-90.0)
    engine = ReceiverEngine(src, mode=modes[0], audio_rate=args.audio_rate,
                            fft_size=args.fft_size, fft_rate=args.fft_rate,
                            base_block=args.block_size, realtime=False,
                            device=args.device)
    total = 0.0
    for name, cfgs in corpus:
        block, secs = engine.warm_plan(cfgs)
        total += secs
        print(f"preheat {name:<16} block={block:<8} {secs:6.2f} s",
              flush=True)
    print(f"preheat done: {len(corpus)} configs in {total:.1f} s")
    return 0


COMMANDS = {"run": cmd_run, "bank": cmd_bank, "spectrum": cmd_spectrum,
            "scan": cmd_scan, "decode": cmd_decode, "serve": cmd_serve,
            "ui": cmd_ui, "preheat": cmd_preheat}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
