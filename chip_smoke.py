#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sdrpp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card (the analog receive path, the
Meteor LRPT decode path, the /256 wideband front end with its 64-channel
bank, the scanner bank, the HRPT, Falcon 9, M17 and KG-STV decode paths,
the FEC library's K = 9 and K = 6 decodes, RS erasures, the rest of the
DSP library, the live receiver behind ``cli ui``, the baseband server
behind ``cli serve``, the supervised recovery of a poisoned device, ``cli
run``'s FLAC / MP3 containers, checkpoint / resume, trace and watchdog,
and the ATV and DAB OFDM decoders with their walks) and fails (non-zero
exit, no result line) if any phase fails:

1. device: a CUDA card is required; prints nvidia-smi's name and power limit;
2. build: compiles csrc/loop_scan.cu, mm_clock.cu, viterbi.cu,
   decim_fir.cu and sync_walk.cu for sm_90a from this checkout, one nvcc
   each, and the
   kernels' compiled host paths, csrc/kernels_host.cpp, with the host
   compiler, all at once;
3. kernels: every entry against its plain PyTorch version on the card,
   same seeded inputs, with times from CUDA events: ``lane_scan`` and
   ``single_scan`` in the layouts the paths call them with (the chunk
   drivers' overlapping lane views of [hist | block] with the payload
   written in place past the warm-up: PLL [640, 128], AGC [4230, 6],
   FastAGC and Costas order 4 with its seam steps / "meteor" [2048, 64];
   HRPT's FastAGC [2048 + 1024, 128] and order-2 Costas [2048 + 512, 128];
   the AM AGC's one [6544] stream from gain 1e7; the SSB bank's exact AGC
   over 64 transposed [64, 2048] channel rows; the AGCs' inputs clip; off
   the paths PLL [65440], FastAGC and Costas order 4 [8192], and inputs
   that leave the kernel's short forms for its reference forms: AGC steps
   at the clip threshold, an AGC with max_out below 2^-60, PLL and Costas
   seed phases up to 3e5), each bit-exact, with its time a call back
   to back, its device time alone, its host time a call and the walker's
   clock64 cycles per step; the strided layouts must equal the kernel on
   contiguous copies, and wrong arguments must raise ValueError and
   launch nothing; ``mm_symbols`` (the meteor block's
   [1, 65543] row; its symbols held, as a prefix, against the plain
   version on the first 16391 samples, where the kernel's final state is
   held as well; the walker's clock64() cycles per symbol; off the
   path, C = 3 streams with their
   own states, the float variant and two consecutive blocks with the
   state carried, [*, 8199] rows that cross four ring stages; a [64, 8]
   bank must raise; the decode paths' rows [1, 7 + 262144]: the float
   variant at Falcon 9's 1.68, M17's and KG-STV's 10 samples a symbol, the
   complex one at HRPT's 2.2542, each held on its whole row, with clock64
   cycles a symbol),
   ``viterbi_acs_batched`` and ``viterbi_traceback_batched`` (the 30-s
   pass's [528, 4288, 2] as the path launches them, a uint8 soft-bit
   stream plus window starts, and the exact decode's [1, 4288, 2]; off
   the paths a 1024-window launch, the float32 stream, one window across
   two renormalisations and all-128 ties; the 16-state (K = 5) code at
   M17's frames, the LSF's [1, 244, 2] and the payload's [1, 148, 2] uint8
   with erasures, and all-128 ties; the 64-state KG-STV frame [1, 62, 2]
   float32; each held bit-exact on its first 8 windows, with both
   walkers' clock64 cycles a step; wrong arguments and malformed state
   counts must raise ValueError and launch nothing, and a 32-state code
   decodes through ConvCode); every order 2 to 15, S = 2 ... 16384, at R
   = 2 on uint8 and float32 soft bits over FEC_T steps, R = 3 and 6 at S =
   256 and R = 5 at S = 16, uint8 windows of FEC_RENORM_T steps (two
   renormalisations of the fast form) at S = 128 ... 16384 and at R = 6,
   a [64, 4288] windowed launch at S = 32, and
   the fec paths' launches: k9's [1, 2097162, 2], held on its first and
   last FEC_HELD steps, and k6's [513, 4288, 2] windows (the general
   kernels, S > 64 or R > 4, as the rows ``viterbi_acs_general`` /
   ``viterbi_traceback_general``), each bit-exact with both walkers'
   cycles a step, and
   ``decimating_fir`` (each case's time a call back to back, its device
   time alone behind a sleep kernel, and its host time a call) at the
   first r >= 8 stage of each path (wideband
   [1, 2^24] /32 143 taps, bank [64, 262144] /16 72 taps, meteor
   [1, 1048576] /8 54 taps, receive USB and AM [1, 654400] /8 44 and 36
   taps; off the paths the /128 stage's r = 128 with 726 taps, a
   256-sample block shorter than its tail, and 300 outputs a row), beside
   the strided ``conv1d`` it replaced (``library_ms``; the two timed in
   turns, FIR_ROUNDS rounds, medians), and float32 rows [3, 262144] /16;
   then wrong arguments on the card must raise ValueError and launch
   nothing, and a strided view must give what its copy gives; the three
   walks of csrc/sync_walk.cu (``phase_kernels_walks``): ``line_sync_walk``
   on the first ATV block's discriminator output [450007] and
   ``cyclic_sync_walk`` on the first DAB block [204800], each bit-exact,
   and ``chroma_burst_walk`` on [625, 28] bursts of a locked tone at
   ATV_LOCKING_BW, phases within WALK_TOL and outputs within WALK_OUT_TOL
   (at the decoder's bandwidth the PLL does not lock, ROADMAP C), with
   four wrong arguments that must raise and launch nothing. A
   case's ``ms`` is the kernel at ``shape``, its ``plain_ms`` the plain
   version on ``plain_shape`` (the same, or the prefix held); ``path``
   names the path that launches ``shape``; ``bound_ms`` is the least time
   the card could take for the case's bytes (each input read once, each
   output written once, at 3.35 TB/s) or operations (float32 at
   67 TFLOP/s), whichever is larger. A row's ms, plain_ms, bound_ms and
   library_ms are the sums over the cases at a path's shapes, one launch
   each;
4. the receive slice: a 2.4 Msps composite (WFM stereo at +300 kHz, AM
   at -500 kHz, USB at -700 kHz) through ``Receiver(2.4e6,
   block_size=654400, device="cuda")`` for 8 blocks; both loop entries'
   and decimating_fir's launch counts must rise, outputs must be finite,
   each tone must land with SNR > 30 dB and the WFM L/R separation must
   exceed 20 dB;
5. card against CPU: the first two blocks again on device="cpu" (plain
   loop versions); audio RMS difference below -40 dB;
6. the normal entry point: ``cli.main(["run", ...])`` on the card writes
   48 kHz stereo WAV audio;
7. the meteor slice: a synthetic 30-s Meteor M2 LRPT pass (260 CADUs of
   seeded payloads, QPSK at 72 ksym/s, carrier 50 Hz and symbol clock
   20 ppm off, Es/N0 12 dB, at +250 kHz in a 2.4 Msps stream) through
   ``RxVFO`` and ``MeteorLRPTDecoder(device="cuda")`` at
   ``cli._auto_block``'s block, then ``finalize``: every VCDU must come
   back equal to its payload, and lane_scan, mm_symbols, both Viterbi
   entries and decimating_fir must be launched;
8. card against CPU: the first two demod blocks again on device="cpu";
   equal symbol counts, symbols within METEOR_CPU_TOL (max) and
   METEOR_CPU_RMS_TOL (RMS) after the lock;
9. the entry point: ``cli.main(["decode", "meteor", ...])`` on the card
   recovers the three payloads of the committed golden capture;
10. the wideband path: bench.py's chain (``parallel.wideband``: the /256
    cascade at 1.572864 Gsps, then the shared-FFT channelizer into 64
    channels, Squelch, NFM discriminator and audio FIR) on WIDE_BLOCKS
    blocks of 2^24 samples of one seamlessly repeating block (seeded
    noise plus NFM carriers on 8 channels), uploaded once; per-block
    CUDA-event ms, input Gsamp/s, decimating_fir launches, peak memory;
    every carrier channel's tone SNR > 30 dB, all audio finite;
11. card against CPU: the first four wideband blocks on device="cpu",
    audio RMS difference below -40 dB from audio sample 1000 on;
12. bench.py's SSB bank (lane_scan launches must rise) and muted NFM bank
    (odd channels' audio exactly 0, even channels' not) at 6.144 Msps;
13. the entry point: ``cli.main(["bank", ...])`` with no --device (the
    card): 64 NFM channels from test:6144000, --channelizer time and fft,
    4 blocks each, 64 WAVs each; on the time channelizer decimating_fir
    launches on 64 rows;
14. tests/test_golden.py's NFM bank through ``ScannerBank`` on the card
    against the committed golden, below -40 dB after the settle;
15. the radio-options path: a 2.4 Msps composite (WFM stereo with a
    57 kHz RDS subcarrier carrying a PI code and PS name, a CW carrier,
    AM, NFM with impulse bursts, a second NFM station) through
    ``Receiver(2.4e6, block_size=652800, device="cuda")`` with seven VFOs
    (WFM with RDS, CW, raw, AM, NFM with noise blanker and FM IF noise
    reduction, the same NFM without them, NFM with dynamic offset and
    bandwidth) for RADIO_NBLOCKS blocks, the WFM VFO's RDS baseband
    decoded by ``RDSReceiver(device="cuda")``; the dynamic VFO is retuned
    through ``retune_state`` before block RADIO_RETUNE_BLOCK and narrowed
    through ``set_bandwidth_state`` before block RADIO_BW_BLOCK. PI and
    PS must come back exact with >= 10 groups, the CW, raw and AM tones
    and the retuned station's tone SNR > 30 dB, the old station gone, the
    blanker must lower the impulse energy; lane_scan, single_scan,
    mm_symbols and decimating_fir launches must rise; per-block CUDA-event
    ms and host s; then the first two blocks on device="cpu", every VFO's
    audio and the RDS baseband below -40 dB after the settle;
16. the entry points of that slice: ``cli.main(["run", "--mode", "cw",
    ...])``, ``run --mode raw --sample-format i24``, ``run --audio-rate
    44100``, ``spectrum --framebuffer`` and ``scan`` over a WAV of the
    composite (it must park on the CW, AM and both NFM carriers);
17. the pipeline: ``cli run`` and ``cli bank`` (through ``Prefetcher`` and
    ``DeferredWriter``) write WAV files byte-identical to the same loops
    run unpipelined on the card, and the two loops timed over PIPE_BLOCKS
    blocks, PIPE_PAIRS pipelined/plain pairs;
18. the decode paths at ``cli decode``'s rates and 262,144-sample blocks
    (each ends in its checks; per-block CUDA-event ms, host s, the M&M's
    share where a tap times it, real-time factor, launches):
    hrpt-3M, HRPT_FRAMES seeded minor frames as Manchester BPSK at 3 Msps
    (a carrier phase, HRPT_CARRIER_HZ off) through
    ``HRPTDecoder(device="cuda")``, its loops chunked: every frame with 0
    sync errors, its spacecraft id, frame number and words exact;
    lane_scan and mm_symbols launched; then the loops' chunked and exact
    routes on that signal and on the same frames in noise (HRPT_NOISE a
    component), each route's frames, sync errors and wrong words printed,
    the exact route held exact on both (the chunked route's losses in
    noise are the JAX package's warm-ups, ROADMAP C); falcon9-6M, F9_FRAMES frames
    of video and GPS packets as FM at 6 Msps through ``Falcon9Decoder``:
    every packet exact; m17-48k, an LSF and M17_FRAMES stream frames
    shaped by the port's ``RRCInterpolator`` with light noise, through
    ``GFSKDemod``, ``slice_4fsk``, ``FrameDemux`` and the frame decodes
    on the card: the LSF's callsigns and every payload exact, and with
    libcodec2 ``M17Decoder``'s voice sample count (else "m17 voice:
    libcodec2 absent"); kgsstv-12k, KG_FRAMES frames through
    ``KGSSTVDecoder``: every frame exact but its last two bits, which the
    reference decodes out of erasures; then each path's first two blocks
    again on device="cpu" (equal symbol counts, symbols within
    METEOR_CPU_TOL and METEOR_CPU_RMS_TOL from symbol METEOR_CPU_SKIP,
    equal outputs), and ``cli.main(["decode", mode, ...])`` on the card
    over WAVs of the signals (m17, with libcodec2, from a 2.4 Msps WAV at
    M17_CLI_OFFSET through RxVFO and decimating_fir), each output equal to
    the phase's content;
19. the fec paths: fec_k9, ``ConvCode(2, 9, CONV_R12_9, device="cuda")``
    (256 states) on FEC_MSG_BYTES of seeded message, 2,097,162 trellis
    steps of uint8 soft bits (Es/N0 6.5 dB), through ``decode_soft_np``
    and ``decode_soft_stream`` (the exact decode above 64 states); fec_k6,
    ``ConvCode(2, 6, CONV_R12_6)`` (32 states) through
    ``decode_soft_stream``'s windows; each decode must return the message
    exactly (fec_k9 through both entries' general kernels); RS
    erasures: RS_BLOCKS CCSDS blocks with every (f, e) at 2e + f = 32 and
    one beyond it, card equal to CPU; the rest of the DSP library at 2.4
    Msps in two DSP_BLOCK-sample blocks, card against CPU:
    ``DecimatingFIR`` /8 (real taps: the decimating-FIR kernel; complex
    taps), the complex-tap ``PolyphaseResampler``, ``CarrierTrackingPLL``
    on a pilot DSP_PILOT_HZ off (single_scan), and
    ``FFTPowerDecimator(256, fft_len=2^20)`` against ``PowerDecimator`` on
    the wideband stream, both timed;
20. ui-2p4, the live receiver: ``ReceiverEngine`` (``cli ui``'s defaults:
    2.4 Msps, 262,144-sample base blocks, a 16384-point FFT at 20 Hz,
    48 kHz audio) with four VFOs over the radio-options composite plus a
    QPSK carrier (WFM with RDS, NFM with squelch, USB 150 Hz under the CW
    carrier, meteor at 140 kHz) and its ``WebUIServer``: UI_BLOCKS blocks
    unpaced (the step's CUDA-event ms, host ms a block, the real-time
    factor, which must exceed 1, B1-B4 launches a block); each analog
    VFO's int16 ring within 1 LSB of the same ``RadioChannel`` run
    directly on the card, RDS PI and PS exact, the USB tone's SNR > 30 dB,
    the constellation on four points, the page served; UI_CPU_BLOCKS
    blocks on the card and on a CPU engine (rings below -40 dB after the
    settle, equal symbol counts, symbols within METEOR_CPU_TOL and
    METEOR_CPU_RMS_TOL); then UI_REALTIME_S seconds paced in real time
    (blocks within 2 of the seconds' worth), every GET route timed
    (p50, p99 of UI_ROUTE_REPS), set_offset (a state write: the step
    kept, blocks rising), set_mode and add_vfo (control to the first block
    on the new chain) timed;
21. serve-2p4: ``python -m sdrpp_tpu_torch serve --source test:2400000
    --blocks SERVE_BLOCKS`` as a subprocess on the card; the port's
    ``BasebandClient`` receives SERVE_BLOCKS i16 frames bit-equal to the
    source's blocks quantized on the CPU; blocks a second;
22. ui-fault: a child engine on the card under SDRPP_TPU_SUPERVISED with
    a session file applies controls, then its step launches a device-side
    assert (``UI_FAULT_SCRIPT``, not package code): the child must exit
    86 with the session saved, controls included; a second child restores
    that session, streams clean blocks and takes a streak of plain
    exceptions through the whole ladder without exiting;
23. run-resume (``phase_run_resume``): a WAV of the slice composite
    (RUN_BLOCKS blocks of RUN_BLOCK) through ``cli run --container flac``
    on the card at each RUN_MODES station: straight through, and half with
    ``--checkpoint --checkpoint-every 1 --trace`` then half with
    ``--resume``; the halves' FLAC samples must equal the straight run's
    exactly, the checkpoint's offset the stream's, and the trace must name
    RUN_KERNELS (wfm: lane_scan's ``loop_scan_kernel``; am: single_scan's
    and the /8 ``decim_fir_kernel``); the cost of a checkpoint a block
    (``save_state`` of the WFM chain's state); and ``StepWatchdog`` on the
    card: a step that queues WATCHDOG_SLEEP cycles of device sleep must
    raise StepTimeout under a 0.1-s deadline though its call returns at
    once; mp3: one ``run --container mp3`` decoded back, or a line saying
    libmp3lame is absent;
24. atv-11p25 (``phase_atv``): ATV_BLOCKS PAL frames of ``atv_composite``
    (11.25 Msps, 450,000 samples a block) through ``ATVDecoder(device=
    "cuda")``: frames at the rollovers, per-block CUDA-event and host ms
    and the real-time factor, line_sync_walk and chroma_burst_walk once a
    block; a CPU decoder on the same blocks must take the same vertical
    scan; dab-2p048 (``phase_dab``): one second of DAB mode I
    (``dab_signal``: 2048-point symbols, 504-sample prefixes, null symbols,
    the phase reference, a 0.25-bin carrier offset) in DAB_BLOCKS blocks
    through ``CyclicSync(device="cuda")``: every phase-reference symbol
    found (``phase_reference_sync``), its ``dab_prs_cfo`` within
    DAB_CFO_TOL of the offset and its ``dab_prs_constellation`` on four
    points; cyclic_sync_walk once a block, and every block's walk equal to
    the plain walk's on the same inputs;
25. when the parent commit is unpacked at _scratch/parent (``git archive
    <parent> | tar -x -C _scratch/parent``): an A/B of the meteor block
    time, decimating_fir at every FIR_CASES shape, the loop scans at
    the kernel phase's path cases (the same bodies and inputs, contiguous
    and time-major), both Viterbi entries on the pass case's stream and
    finalize's Viterbi on the 30-s pass's soft bits, each tree in its own
    process, parent, change, change, parent, printed as one "ab" line;
    without it the phase says so and is skipped.

The last lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

builds the kernels and, instead of the phases above, profiles (with
torch.profiler) PROFILE_RX_BLOCKS steady blocks of the receive slice
(``Receiver.process_block``, three VFOs) and of the radio-options path
(seven VFOs and the RDS chain), PROFILE_BLOCKS of the wideband
chain, PROFILE_METEOR_BLOCKS steady blocks of the 30-s meteor pass and its
``finalize``, PROFILE_BLOCKS steady blocks of the HRPT and Falcon 9
paths, PROFILE_RX_BLOCKS steady blocks of the ui-2p4 engine (its own
thread, everything a block takes) with the waterfall's ``push_fft`` timed
alone, and PROFILE_CALLS calls of decimating_fir at each FIR_CASES
shape:
device time by kernel, the device's busy and idle share of the host-clock
window, the loop-scan kernels' share, and each decimating_fir launch's own
device time beside the wrapper's host time per call. It prints one JSON
line and no result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FS = 2.4e6
BLOCK = 654400
NBLOCKS = 8
VFOS = {"wfm": dict(mode="wfm", offset=300e3, deemphasis="50us"),
        "am": dict(mode="am", offset=-500e3),
        "usb": dict(mode="usb", offset=-700e3)}
# the USB channel's passband is [-1350, +1350] Hz around its VFO and is
# shifted up by 1350 Hz, so a 1.5 kHz audio tone sits 150 Hz above it
TONES = {"am": 1000.0, "usb": 1500.0}
SETTLE = 1000  # audio samples of the zero-state start-up transient
# the radio-options path: every RadioChannel option of the JAX receive
# path at 2.4 Msps, in blocks of 34 x 19,200 samples (19,200: the lcm of
# these VFOs' block multiples; 654,400 is not a multiple of the RDS or CW
# VFO's)
RADIO_BLOCK = 652800
RADIO_NBLOCKS = 10         # 2.7 s: the RDS chain decodes ~30 groups
RADIO_RETUNE_BLOCK = 4     # nfm_dyn retuned to RADIO_NFM2 before this block
RADIO_BW_BLOCK = 6         # and narrowed to RADIO_BW before this one
RADIO_BW = 10000.0
RADIO_WFM = 300e3          # stereo (L 1 kHz, R 3 kHz) + 57 kHz RDS
RADIO_CW = -199900.0       # a CW carrier, 100 Hz above the CW VFO
RADIO_AM = -500e3          # AM, 1 kHz at 50 %
RADIO_NFM = 600e3          # NFM, 1 kHz, with impulse bursts
RADIO_NFM2 = 800e3         # NFM, 1.5 kHz: the retune's target
RADIO_PI = 0x54A8
RADIO_PS = "H100 RDS"
RADIO_VFOS = {
    "wfm_rds": dict(mode="wfm", offset=RADIO_WFM, deemphasis="50us",
                    rds=True),
    "cw": dict(mode="cw", offset=-200e3),
    "raw": dict(mode="raw", offset=-201e3),  # the CW carrier at +1.1 kHz
    "am": dict(mode="am", offset=RADIO_AM),
    "nfm_nb": dict(mode="nfm", offset=RADIO_NFM, noise_blanker=True,
                   fm_if_nr=True),
    "nfm_plain": dict(mode="nfm", offset=RADIO_NFM),
    "nfm_dyn": dict(mode="nfm", offset=RADIO_NFM, dynamic_offset=True,
                    dynamic_bandwidth=True),
}
RADIO_TONES = {"cw": 900.0, "raw": 1100.0, "am": 1000.0}
# the live receiver (cli ui's defaults: 2.4 Msps, 262,144-sample base
# blocks, a 16384-point FFT at 20 Hz, 48 kHz audio) with four VFOs over
# the radio-options composite plus a QPSK carrier
UI_BASE_BLOCK = 262144
UI_FFT = 16384
UI_BLOCKS = 24             # 2.5 s: RDS decodes PI and PS
UI_CPU_BLOCKS = 2          # blocks of the CPU engine held against the card
UI_REALTIME_S = 4.0        # seconds streamed with realtime pacing
UI_ROUTE_REPS = 20         # GETs of each route timed while streaming
UI_METEOR = -950e3         # 72 ksym/s QPSK for the meteor VFO
UI_VFOS = {"fm": dict(mode="wfm", offset=RADIO_WFM, bandwidth=None,
                      squelch=None, deemphasis="50us", rds=True),
           "nfm": dict(mode="nfm", offset=RADIO_NFM2, bandwidth=None,
                       squelch=-60.0, deemphasis=None, rds=False),
           # the CW carrier 150 Hz above the VFO: a 1.5 kHz tone (TONES)
           "usb": dict(mode="usb", offset=RADIO_CW - 150.0, bandwidth=None,
                       squelch=None, deemphasis=None, rds=False),
           "sat": dict(mode="meteor", offset=UI_METEOR, bandwidth=140000.0,
                       squelch=None, deemphasis=None, rds=False)}
UI_ROUTES = ("/", "/api/state", "/api/bookmarks", "/api/fft",
             "/api/waterfall?since=0", "/api/constellation?vfo=sat",
             "/audio.wav?vfo=fm")
SERVE_BLOCKS = 32          # cli serve's blocks at 2.4 Msps
SERVE_BLOCK = 262144
SOURCES = {"lane_scan": "sdrpp_tpu_torch/csrc/loop_scan.cu",
           "single_scan": "sdrpp_tpu_torch/csrc/loop_scan.cu",
           "mm_symbols": "sdrpp_tpu_torch/csrc/mm_clock.cu",
           "viterbi_acs_batched": "sdrpp_tpu_torch/csrc/viterbi.cu",
           "viterbi_traceback_batched": "sdrpp_tpu_torch/csrc/viterbi.cu",
           "viterbi_acs_general": "sdrpp_tpu_torch/csrc/viterbi.cu",
           "viterbi_traceback_general": "sdrpp_tpu_torch/csrc/viterbi.cu",
           "decimating_fir": "sdrpp_tpu_torch/csrc/decim_fir.cu",
           "line_sync_walk": "sdrpp_tpu_torch/csrc/sync_walk.cu",
           "chroma_burst_walk": "sdrpp_tpu_torch/csrc/sync_walk.cu",
           "cyclic_sync_walk": "sdrpp_tpu_torch/csrc/sync_walk.cu"}
REPLACES = {"lane_scan": "sdrpp_tpu/ops/scans_pallas.py:147",
            "single_scan": "sdrpp_tpu/ops/scans_pallas.py:68",
            "mm_symbols": "sdrpp_tpu/ops/clock_recovery_pallas.py:35",
            "viterbi_acs_batched": "sdrpp_tpu/ops/fec_pallas.py:51",
            "viterbi_traceback_batched": "sdrpp_tpu/ops/fec_pallas.py:132",
            "viterbi_acs_general": "sdrpp_tpu/ops/fec_pallas.py:221",
            "viterbi_traceback_general": "sdrpp_tpu/ops/fec_pallas.py:132",
            "decimating_fir": "sdrpp_tpu/ops/fir_pallas.py:74",
            # XLA-lowered lax.scans, not Pallas kernels
            "line_sync_walk": "sdrpp_tpu/decoders/atv.py:97",
            "chroma_burst_walk": "sdrpp_tpu/decoders/atv.py:178",
            "cyclic_sync_walk": "sdrpp_tpu/ops/ofdm.py:109"}
# rows counted by a wrapper's second count: the general kernels' launches
# (S > 64, or R > 4 for the ACS), as the host path reports them
GENERAL = {"viterbi_acs_general": "viterbi_acs_batched",
           "viterbi_traceback_general": "viterbi_traceback_batched"}
# the paths each kernel must be launched on
REQUIRED = {"receive": ("lane_scan", "single_scan", "decimating_fir"),
            "radio": ("lane_scan", "single_scan", "mm_symbols",
                      "decimating_fir"),
            "meteor": ("lane_scan", "mm_symbols", "viterbi_acs_batched",
                       "viterbi_traceback_batched", "decimating_fir"),
            "wideband": ("decimating_fir",),
            "ssb_bank": ("lane_scan",),
            "muted_bank": (),
            "bank": ("decimating_fir",),
            "bank_fft": (),
            "hrpt": ("lane_scan", "mm_symbols"),
            "falcon9": ("mm_symbols",),
            "m17": ("mm_symbols", "viterbi_acs_batched",
                    "viterbi_traceback_batched"),
            "kgsstv": ("mm_symbols", "viterbi_acs_batched",
                       "viterbi_traceback_batched"),
            "fec_k9": ("viterbi_acs_batched", "viterbi_traceback_batched",
                       "viterbi_acs_general", "viterbi_traceback_general"),
            "fec_k6": ("viterbi_acs_batched", "viterbi_traceback_batched"),
            "dsp_lib": ("lane_scan", "single_scan", "decimating_fir"),
            "ui": ("lane_scan", "single_scan", "mm_symbols",
                   "decimating_fir"),
            "run_wfm": ("lane_scan",),
            "run_am": ("single_scan", "decimating_fir"),
            "atv": ("line_sync_walk", "chroma_burst_walk"),
            "dab": ("cyclic_sync_walk",)}
# H100 SXM peaks (NVIDIA's data sheet): device memory bytes/s and float32
# operations/s outside the tensor cores; a case's bound is the larger of
# its bytes and its operations over these
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per lane step of each loop body, counted from the
# bodies in ops/scans_kernels.py (a comparison, a select or a
# transcendental counts as one)
LOOP_OPS = {"pll": 18, "agc": 16, "fast_agc": 5, "costas2": 20,
            "costas4": 26, "costas_meteor": 44}
MM_OPS_PER_SYMBOL = 57     # 8 taps x 2 planes x (mul + add) + the loop
ACS_OPS_PER_STATE = 6      # two path sums, a compare, a select, 2 metrics
TB_OPS_PER_STEP = 4        # a word's half, a shift, a test, the next state
# the Viterbi stream decode's windows (ConvCode.decode_soft_stream's
# defaults: L-step chunks with W steps of warm-up and warm-down)
VIT_L, VIT_W = 4096, 96
VIT_T = VIT_L + 2 * VIT_W
VIT_PASS_WINDOWS = 528     # the 30-s pass's windows
VIT_FULL_WINDOWS = 1024    # one full launch (ConvCode._STREAM_BATCH)
VIT_HELD = 8               # windows of each case held against the plain one
VIT_RENORM = 4096          # csrc/viterbi.cu: steps between renormalisations
# decimating_fir cases: (path, rows, n, plan ratio); the kernel runs the
# plan's first stage (r >= 8)
FIR_CASES = [("wideband", 1, 1 << 24, 256, "c64"),
             ("bank", 64, 262144, 128, "c64"),
             ("meteor", 1, 1048576, 16, "c64"),
             ("receive", 1, 654400, 32, "c64"),
             ("receive", 1, 654400, 64, "c64"),
             # the radio-options block: NFM and raw (/32), AM (/64), CW
             # (/256) VFOs, and the RDS tap's 240 kHz -> 5 kHz (/32)
             ("radio", 1, 652800, 32, "c64"), ("radio", 1, 652800, 64, "c64"),
             ("radio", 1, 652800, 256, "c64"), ("radio", 1, 65280, 32, "c64"),
             # off the paths: the /128 stage (r = 128, 726 taps); a block
             # shorter than the tail (n < m - 1); 300 outputs a row, not a
             # multiple of the kernel's 128-output tile; float32 rows
             (None, 1, 1 << 20, 8192, "c64"), (None, 1, 256, 8192, "c64"),
             (None, 2, 9600, 256, "c64"), (None, 3, 262144, 128, "f32")]
# the wideband path (bench.py's chain at its widths)
WIDE_BLOCKS = 16         # 512 audio samples a block: 6.7 Hz bins
WIDE_CARRIERS = (3, 11, 19, 27, 36, 44, 52, 60)   # 8 of the 64 channels
WIDE_TONE = 700.0          # Hz, rounded to a multiple of fs / 2^24
# Hz; the 12.5 kHz channel filter cuts this signal's Bessel sidebands
# beyond 6.25 kHz (the 10th of a 656 Hz tone), which lands as harmonic
# distortion near -30 dB: the tone's SNR is held against the band outside
# the tone and its harmonics, and the SINAD (distortion counted) reported
WIDE_DEVIATION = 5000.0
WIDE_AMP = 0.1
WIDE_NOISE = 1e-3
WIDE_SETTLE = 1000         # audio samples left out of the tone SNR
WIDE_CPU_BLOCKS = 4        # blocks compared card vs CPU
WIDE_CPU_SETTLE = 1000     # audio samples of the chain's start left out
BANK_BLOCK = 1 << 18       # bench.py's bank block at 6.144 Msps
PIPE_CMDS = {"run": ("test:2400000", BLOCK),      # cli source, block
             "bank": ("test:6144000", BANK_BLOCK)}
PIPE_BLOCKS = 50           # blocks of each timed cli loop
PIPE_PAIRS = 10            # pipelined / plain pairs a command
PIPE_READS = 20            # blocks of the source's read timed alone
PROFILE_BLOCKS = 5
PROFILE_RX_BLOCKS = 4      # steady receive blocks profiled (after 3 warm)
PROFILE_METEOR_BLOCKS = 4  # steady meteor blocks profiled (after 3 warm)
FIR_ROUNDS = 5             # alternating kernel / conv1d timing rounds
PROFILE_CALLS = 20
# kernel vs plain version: the same float32 operations in the same order,
# no FMA contraction (--fmad=false), IEEE division -> expected 0. The loop
# scans (every rewrite of an operation proven equal, the Costas rotation
# equal to torch.cos / torch.sin on the card) and the Viterbi entries are
# held bit-exact; the M&M and the FIR within 1e-6 of their largest output.
KERNEL_TOL = 1e-6
# mm_symbols on the meteor path: [1, tail + 65536 IF samples]
MM_TAIL = 7
MM_BLOCK = 65536
MM_PLAIN = 16384             # samples of the row the plain version runs
MM_EXTRA_BLOCK = 8192        # the off-path M&M cases' block (4 ring stages)
# the A/B against the parent tree (when it is unpacked there): meteor
# blocks timed per run, in the order parent, change, change, parent
AB_PARENT = "_scratch/parent"
AB_BLOCKS = 6
# meteor slice
METEOR_FS = 2.4e6
METEOR_IF = 150000.0
METEOR_OFFSET = 250e3
METEOR_SECONDS = 30.0
METEOR_CADUS = 260
METEOR_LEAD_SYMS = 7200      # 0.1 s of random QPSK before the first CADU
METEOR_ESN0_DB = 12.0
METEOR_CARRIER_HZ = 50.0     # carrier offset from the VFO centre
METEOR_CLOCK_PPM = 20.0      # symbol clock error
# card vs CPU on the first two demod blocks: the RRC FIR runs through
# cuFFT on the card and pocketfft on the CPU (ulp-level differences), and
# the M&M flips a sign decision wherever a noisy interpolated sample lies
# within rounding of 0; both loops then re-converge within tens of
# symbols. Held: equal symbol counts, max |diff| <= METEOR_CPU_TOL (5 % of
# a symbol's amplitude) and RMS |diff| <= METEOR_CPU_RMS_TOL (measured
# 1.34e-3 on the H100) after the acquisition; a systematic kernel error
# fails the RMS even where no single symbol exceeds the max
METEOR_CPU_SKIP = 4000       # symbols of acquisition left out
METEOR_CPU_TOL = 0.05
METEOR_CPU_RMS_TOL = 5e-3
GOLDEN_WAV = "tests/data/meteor_lrpt_150000Hz.wav"
GOLDEN_PAYLOAD = "tests/data/meteor_lrpt_payload.bin"
GOLDEN_CHAINS = "tests/data/golden_chains.npz"
GOLDEN_SETTLE = 400        # IF samples of the NFM bank's zero-state start
# the digital decode paths at cli decode's rates, in cli._auto_block's
# 262,144-sample blocks
DECODE_BLOCK = 262144
HRPT_FS = 3e6
HRPT_FRAMES = 6            # minor frames: 1 s of a pass, 12 blocks
HRPT_SC = 13               # spacecraft id in word 6
HRPT_LEAD_SYMS = 6000      # random symbols before the first frame
HRPT_CARRIER_HZ = 100.0    # carrier offset (the phase starts at 0.3 rad)
HRPT_NOISE = 0.05          # a component, on the routes' noisy signal
F9_FS = 6e6
F9_FRAMES = 100            # 0.29 s of telemetry, 7 blocks
M17_FS = 48000.0
M17_FRAMES = 250           # stream frames: 10 s of a call, 2 blocks
M17_DST, M17_SRC = "SP5WWP", "N0CALL"
M17_CLI_FS = 2.4e6         # cli decode m17's source: an RxVFO to 48 kHz
M17_CLI_OFFSET = 250e3
M17_CLI_FRAMES = 24        # one 3,276,800-sample cli block
KG_FS = 12000.0
KG_FRAMES = 200            # 28.5 s of frames, 2 blocks
# the fec paths: 262,144 message bytes are 2,097,162 trellis steps of a
# rate-1/2 code, 4.2 M soft bits, 29 s of a 72 ksym/s QPSK downlink's
# coded bits; soft bits at 0 / 255 plus N(0, 60) noise: Es/N0 =
# 20 log10(127.5 / 60) = 6.5 dB, where K = 9 and K = 6 correct every error
FEC_MSG_BYTES = 262144
FEC_SIGMA = 60.0
FEC_T = 2048               # steps of each off-path general-kernel case
# steps of the off-path fast-form cases and of the k9 path case held (its
# first / last): past two of the general ACS's renormalisations (csrc/
# viterbi.cu, every VIT_RENORM steps)
FEC_RENORM_T = 2 * VIT_RENORM + 256
FEC_HELD = FEC_RENORM_T
FEC_WINDOWS = 64           # the off-path 32-state windowed launch
RS_BLOCKS = 1024
DSP_BLOCK = 654400         # the receive path's block at 2.4 Msps
DSP_PILOT_HZ = 5.0         # CarrierTrackingPLL's pilot offset
DSP_PLL_BW = 0.01
DSP_PLL_HELD = 32600       # samples of each block the CPU PLL runs
DSP_PLL_LANES = 4          # CarrierTrackingPLL's lead shape (lane_scan)
DSP_TOL = 5e-5             # card vs CPU, of the output's peak (or 1)
FFT_DECIM_TOL = 5e-5       # FFTPowerDecimator vs the cascade, likewise

RUN_BLOCK = 654400         # run-resume: the slice's block (x 200 and x 1600)
RUN_BLOCKS = 4             # straight through, or half then half resumed
RUN_MODES = {"wfm": 300e3, "am": -500e3}   # the slice composite's stations
# kernel names the --trace of each mode's run must hold: wfm's pilot PLL
# (lane_scan), am's AGC (single_scan) and /8 decimating FIR
RUN_KERNELS = {"wfm": ("loop_scan_kernel",),
               "am": ("loop_scan_kernel", "decim_fir_kernel")}
CKPT_REPS = 10             # save_state calls timed
WATCHDOG_SLEEP = 1_000_000_000   # device clock cycles of the slow step
ATV_FS = 625.0 * 720.0 * 25.0    # 11.25 Msps
ATV_BLOCK = 450000         # one PAL frame: 625 lines of 720 samples, 40 ms
ATV_BLOCKS = 3
ATV_LOCKING_BW = 0.003     # chroma_burst_walk's case: a PLL bandwidth that
                           # locks at 720-sample lines
WALK_TOL = 3.6e-6          # chroma_burst_walk card vs plain: phases (rad)
WALK_OUT_TOL = 1e-5        # and the burst's unit-amplitude outputs
CHROMA_OPS_PER_STEP = 40   # float operations a burst step: the complex mix
                           # (6), the loop (8), cosf, sinf and atan2f (~8 each)
CYCLIC_OPS_PER_SAMPLE = 7  # 2 compares, 2 products, a sum, the count, a test
DAB_FS = 2.048e6
DAB_FFT = 2048             # transmission mode I
DAB_CP = 504
DAB_NULL = 2656
DAB_SYMS = 76              # the phase reference and 75 data symbols a frame
DAB_BLOCK = 204800         # 0.1 s
DAB_BLOCKS = 10            # one second
DAB_CFO_BINS = 0.25        # the residual carrier offset, in bins
DAB_CFO_TOL = 1.5e-4       # rad/sample, 0.05 of a bin
DAB_PRS_RATIO = 5.0        # a PRS correlates this far above a block's median


def log(*args):
    print(*args, flush=True)


def composite(n: int, seed: int = 0) -> np.ndarray:
    """The 2.4 Msps test signal: WFM stereo (L 1 kHz, R 3 kHz, 19 kHz pilot,
    75 kHz deviation) at +300 kHz, AM (1 kHz, 50 %) at -500 kHz, USB
    (1.5 kHz tone) at -700 kHz, and seeded noise."""
    t = np.arange(n) / FS
    l = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.5 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.45 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * (l - r) * np.sin(2 * np.pi * 38000.0 * t))
    x = 0.5 * np.exp(1j * (2 * np.pi * 300e3 * t
                           + np.cumsum(2 * np.pi * 75000.0 * mpx / FS)))
    x += 0.2 * (1 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) \
        * np.exp(-2j * np.pi * 500e3 * t)
    x += 0.05 * np.exp(2j * np.pi * (-700e3 + 150.0) * t)
    rng = np.random.default_rng(seed)
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def band_power(audio: np.ndarray, fs: float, f0: float, halfwidth: float = 20.0):
    """(power within +-halfwidth of f0, power in 100 Hz..15 kHz elsewhere)."""
    w = np.hanning(len(audio))
    p = np.abs(np.fft.rfft(audio * w)) ** 2
    f = np.fft.rfftfreq(len(audio), 1.0 / fs)
    near = np.abs(f - f0) <= halfwidth
    band = (f >= 100.0) & (f <= 15000.0)
    return p[near].sum(), p[band & ~near].sum()


def snr_db(audio, fs, f0, halfwidth: float = 20.0):
    s, n = band_power(audio, fs, f0, halfwidth)
    return 10 * np.log10(s / max(n, 1e-30))


def tone_snr_sinad(audio, fs, f0, halfwidth: float = 40.0):
    """(SNR, SINAD) in dB of a tone at f0: its power within +-halfwidth
    over the 100 Hz..15 kHz band's power outside the tone and its
    harmonics (SNR), or outside the tone only (SINAD)."""
    w = np.hanning(len(audio))
    p = np.abs(np.fft.rfft(audio * w)) ** 2
    f = np.fft.rfftfreq(len(audio), 1.0 / fs)
    near = np.abs(f - f0) <= halfwidth
    harm = np.abs(f - f0 * np.maximum(np.round(f / f0), 1.0)) <= halfwidth
    band = (f >= 100.0) & (f <= 15000.0)
    s = p[near].sum()
    return (10 * np.log10(s / max(p[band & ~harm].sum(), 1e-30)),
            10 * np.log10(s / max(p[band & ~near].sum(), 1e-30)))


def rms_db(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)) + 1e-30
    return float(20 * np.log10(np.sqrt(np.mean(d ** 2)) / ref + 1e-30))


def cuda_ms(fn, reps: int):
    """Mean milliseconds of fn() over reps calls, from CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm(fn, secs: float = 0.1, calls: int | None = None):
    """fn() back to back for ``secs`` of host time (at most ``calls``
    calls: the host enqueues a long kernel far faster than the card runs
    it), then a synchronize: the card's clock leaves its idle level before
    a timing (the plain versions before a case leave it idle for
    seconds)."""
    import torch

    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < secs and (calls is None or n < calls):
        fn()
        n += 1
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 5):
    """Median milliseconds of one fn() on the device alone: a sleep kernel
    holds the stream while the host enqueues the events and the call, so
    the host's time is not in the interval."""
    import torch

    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_fns():
    """Every kernel wrapper of the port by name; each carries ``launches``."""
    from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK
    from sdrpp_tpu_torch.ops import fec_kernels as FK
    from sdrpp_tpu_torch.ops import fir_kernels as DK
    from sdrpp_tpu_torch.ops import scans_kernels as K
    from sdrpp_tpu_torch.ops import sync_walks as W

    return {"lane_scan": K.lane_scan, "single_scan": K.single_scan,
            "mm_symbols": MK.mm_symbols,
            "viterbi_acs_batched": FK.viterbi_acs_batched,
            "viterbi_traceback_batched": FK.viterbi_traceback_batched,
            "decimating_fir": DK.decimating_fir,
            "line_sync_walk": W.line_sync_walk,
            "chroma_burst_walk": W.chroma_burst_walk,
            "cyclic_sync_walk": W.cyclic_sync_walk}


def reset_counts():
    for fn in kernel_fns().values():
        fn.launches = 0
        if hasattr(fn, "launches_general"):
            fn.launches_general = 0


def kernel_counts() -> dict:
    """Every row's launch count: each wrapper's, and the general Viterbi
    kernels' share of their wrapper's."""
    fns = kernel_fns()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts.update({row: fns[entry].launches_general
                   for row, entry in GENERAL.items()})
    return counts


def read_counts(path: str) -> dict:
    """The launch counts since ``reset_counts``; fails unless every kernel
    ``path`` requires was launched."""
    counts = kernel_counts()
    log(f"{path} launches: {counts}")
    for name in REQUIRED[path]:
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on the {path} path")
    return counts


def loop_body_args():
    """The loop bodies at the paths' settings (and two off them), by name:
    (constructor in ops/scans_kernels, its arguments as JSON values), so
    the A/B builds the same bodies in each tree."""
    from sdrpp_tpu_torch.ops.mix import hz_to_rads
    from sdrpp_tpu_torch.ops.scans import _critically_damped

    alpha, beta = (float(v) for v in _critically_damped(25000.0 / 240000.0))
    ca, cb = (float(v) for v in _critically_damped(0.005))
    ra, rb = (float(v) for v in _critically_damped(0.01))
    ha, hb = (float(v) for v in _critically_damped(0.06 ** 2 / 2.0))
    baud = float(hz_to_rads(1187.5, 5000.0))
    return {
        "pll": ("pll_body", [alpha, beta, float(hz_to_rads(18750.0, 240000.0)),
                             float(hz_to_rads(19250.0, 240000.0))]),
        "agc48": ("agc_body", [1.0, 50.0 / 48000.0, 5.0 / 48000.0, 10e6,
                               10.0]),
        "agc24": ("agc_body", [1.0, 50.0 / 24000.0, 5.0 / 24000.0, 10e6,
                               10.0]),
        # max_out below 2^-60: outside the kernel's short clip decision, so
        # every step runs the reference form, and every step clips
        "agc_tiny_out": ("agc_body", [1.0, 50.0 / 48000.0, 5.0 / 48000.0,
                                      10e6, 1e-19]),
        "fast_agc": ("fast_agc_body", [1.0, 10e6, 0.001]),
        # the radio-options path: the CW AGC, the RDS chain's FastAGC and
        # its two Costas loops (the second held around baud/2)
        "agc_cw": ("agc_body", [1.0, 100.0 / 3000.0, 5.0 / 3000.0, 10e6,
                                1.0]),
        "fast_agc_rds": ("fast_agc_body", [1.0, 1e6, 0.1]),
        "costas2": ("costas_body", [2, ca, cb, -np.pi, np.pi]),
        "costas2_baud": ("costas_body", [2, ra, rb, baud * 0.9, baud * 1.1]),
        "costas4": ("costas_body", [4, ca, cb, -np.pi, np.pi]),
        "costas_meteor": ("costas_body", ["meteor", ca, cb, -np.pi, np.pi]),
        # HRPTDecoder's FastAGC (rate 2e-5) and order-2 Costas (bandwidth
        # 0.06^2 / 2)
        "fast_agc_hrpt": ("fast_agc_body", [1.0, 10e6, 0.02e-3]),
        "costas2_hrpt": ("costas_body", [2, ha, hb, -np.pi, np.pi])}


def loop_bodies():
    """The loop bodies of ``loop_body_args``, built."""
    from sdrpp_tpu_torch.ops import scans_kernels as K

    return {key: getattr(K, ctor)(*args)
            for key, (ctor, args) in loop_body_args().items()}


def loop_streams(rng, body, m: int, c: int, kind: str = "path"):
    """Seeded [m, c] float32 streams for `body` (numpy, time-major): pilot
    phases; AGC amplitudes with their suffix max, with three 64-sample
    bursts a lane 40x above the level, which clip (kind "am": the AM
    AGC's 0.2 level, no bursts); FastAGC amplitudes; or a locked
    QPSK-like signal with a slow carrier as Costas streams."""
    from sdrpp_tpu_torch.ops.scans_kernels import METEOR_PHASES

    if body.name == "pll":
        w = 2 * np.pi * 19000.0 / 240000.0
        ph = (w * np.arange(m)[:, None] + rng.uniform(-np.pi, np.pi, c)
              + 0.2 * rng.standard_normal((m, c)))
        return [np.angle(np.exp(1j * ph)).astype(np.float32)]
    if body.name == "agc":
        level = 0.2 if kind == "am" else 0.05
        a = level * np.abs(rng.standard_normal((m, c)))
        if kind != "am":
            for j in range(c):
                for p in rng.integers(0, max(m - 64, 1), 3):
                    a[p:p + 64, j] *= 40.0
        a = a.astype(np.float32)
        return [a, np.flip(np.maximum.accumulate(np.flip(a, 0), 0), 0).copy()]
    pts = (np.asarray([float(p) for p in METEOR_PHASES])
           if body.name == "costas_meteor"
           else np.pi / 4 + np.pi / 2 * np.arange(4))
    ph = (pts[rng.integers(0, 4, (m, c))] + 1e-4 * np.arange(m)[:, None]
          + rng.uniform(-0.05, 0.05, c))
    v = (np.exp(1j * ph) + 0.05 * (rng.standard_normal((m, c))
                                   + 1j * rng.standard_normal((m, c))))
    if body.name == "fast_agc":
        return [(0.3 * np.abs(v)).astype(np.float32)]
    if body.name == "costas_meteor":
        return [np.angle(v).astype(np.float32), np.abs(v).astype(np.float32)]
    return [v.real.astype(np.float32), v.imag.astype(np.float32)]


def loop_seed(body, c: int, kind: str = "path") -> np.ndarray:
    """A [k, c] seed carry for `body`. Kind "am": the AM AGC's start (amp
    0, gain 1e7); "wild": PLL / Costas phases far outside [-pi, pi] (up to
    3e5, past the short sincos's 105615), whose first update leaves the
    kernel's short remainder and rotation."""
    if body.name == "pll" or body.name.startswith("costas"):
        freq = 2 * np.pi * 19000.0 / 240000.0 if body.name == "pll" else 1e-4
        phase = np.zeros(c)
        if kind == "wild":
            phase = np.resize([100.0, -50.0, 2e5, -3e5, 7.0, 13.0, -9.5,
                               0.5], c)
        return np.stack([phase, np.full(c, freq)]).astype(np.float32)
    if body.name == "agc":
        if kind == "am":
            return np.array([[0.0], [1e7]], np.float32).repeat(c, 1)
        return np.stack([np.full(c, 0.05), np.full(c, 20.0)]).astype(np.float32)
    return np.ones((1, c), np.float32)


def agc_edge_streams(rng, body, n: int, c: int):
    """[n, c] AGC streams and a seed whose steps put a * gain within 2^-18
    of max_out every fourth step (each lane's carry followed step by step
    in float32, as the body rounds it), so the kernel's short clip
    decision cannot decide them; zeros, one amplitude of 1e20 (past the
    short form's range) and a second stream that is not a suffix max (any
    values are the body's inputs). Returns (streams, seed)."""
    f32 = np.float32
    sp, att, iatt, dec, idec, mg, mo = (f32(v) for v in body.params)
    a = (0.05 * np.abs(rng.standard_normal((n, c)))).astype(f32)
    a[rng.random((n, c)) < 0.02] = 0.0
    s = rng.uniform(0.05, 0.5, (n, c)).astype(f32)
    seed = np.stack([np.full(c, 0.05), np.full(c, 20.0)]).astype(f32)
    amp = seed[0].copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        for t in range(n):
            if t % 4 == 1:  # a * sp = max_out * (amp * iatt + a * att)
                want = (float(mo) * amp.astype(np.float64) * float(iatt)
                        / (float(sp) - float(mo) * float(att)))
                a[t] = want * (1.0 + rng.uniform(-2.0 ** -18, 2.0 ** -18, c))
            if t == n // 2:
                a[t, 0] = 1e20
            x = a[t]
            upd = np.where(x > amp, amp * iatt + x * att, amp * idec + x * dec)
            amp1 = np.where(x != 0, upd, amp)
            gain1 = np.where(x != 0, np.minimum(sp / amp1, mg), f32(1.0))
            amp = np.where(x * gain1 > mo, s[t], amp1).astype(f32)
    return [a, s], seed


class LoopCase:
    """One lane_scan / single_scan call as a path makes it. Layouts:
    "chunk" (a chunk driver's K overlapping lanes: time-major [W + L, 1, K]
    views of one extended stream [hist | block], the payload written in
    sample order into an [1, K*L] output with the W warm-up steps skipped,
    and Costas's 32 seam steps before them into a side output), "bank"
    (an exact bank loop: [C, n] streams read transposed, written into a
    [C, n] output) and "single" (one [n] stream). `kind` picks the data
    (``loop_streams``, ``loop_seed``; "edge": ``agc_edge_streams``).
    `run(fn, cycles)` calls fn (the kernel or its plain version) on the
    same tensors and returns every output; `time_major()` gives the
    streams and seed as contiguous time-major numpy arrays (the A/B's
    inputs)."""

    def __init__(self, dev, rng, body, layout, n, c=1, K_=1, W=0, side=0,
                 kind="path"):
        import torch

        self.body, self.layout, self.side = body, layout, side
        self.K, self.W = K_, W
        if layout == "chunk":
            L = -(-n // K_)
            self.L, m = L, W + K_ * L
            self.steps, self.lanes = W + L, K_
            self.ext = [torch.from_numpy(s[:, 0].copy()).to(dev)[None]
                        for s in loop_streams(rng, body, m, 1)]
            if body.name == "agc":  # the suffix max over [hist | block]
                self.ext[1] = torch.flip(torch.cummax(torch.flip(
                    self.ext[0], [-1]), -1).values, [-1])
            self.streams = [e.as_strided((W + L, 1, K_), (1, m, L))
                            for e in self.ext]
            self.state = torch.from_numpy(np.repeat(
                loop_seed(body, 1), K_, 1)[:, None]).to(dev)
            self.shape = [W + L, K_]
        elif layout == "bank":
            self.steps, self.lanes = n, c
            if kind == "edge":
                streams, seed = agc_edge_streams(rng, body, n, c)
            else:
                streams = loop_streams(rng, body, n, c, kind)
                seed = loop_seed(body, c, kind)
            self.rows = [torch.from_numpy(s.T.copy()).to(dev)
                         for s in streams]
            self.streams = [r.T for r in self.rows]
            self.state = torch.from_numpy(seed).to(dev)
            self.shape = [n, c]
        else:
            self.steps, self.lanes = n, 1
            self.streams = [torch.from_numpy(s[:, 0].copy()).to(dev)
                            for s in loop_streams(rng, body, n, 1, kind)]
            self.state = torch.from_numpy(loop_seed(body, 1, kind)[:, 0]
                                          .copy()).to(dev)
            self.shape = [n]

    def run(self, fn, cycles=None):
        import torch

        kw = {} if cycles is None else {"cycles": cycles}
        if self.layout == "chunk":
            L, K_ = self.L, self.K
            res = self.state.new_empty((1, K_ * L))
            kw.update(out=res.as_strided((L, 1, K_), (1, K_ * L, L)),
                      skip=self.W)
            outs = [res]
            if self.side:
                side = self.state.new_empty((1, K_, self.side))
                kw["side"] = side.permute(2, 0, 1)
                outs.append(side)
            _, fin = fn(self.body, self.state, self.streams, **kw)
            return outs + [fin]
        if self.layout == "bank":
            res = self.state.new_empty((self.lanes, self.steps))
            _, fin = fn(self.body, self.state, self.streams, out=res.T, **kw)
            return [res, fin]
        return list(fn(self.body, self.state, self.streams, **kw))

    def run_copies(self, fn):
        """The same call on contiguous time-major copies, its outputs laid
        out as run()'s."""
        k = self.body.k
        if self.layout == "chunk":
            C = self.K
            streams = [s.reshape(self.steps, C).contiguous()
                       for s in self.streams]
            out, fin = fn(self.body, self.state.reshape(k, C).contiguous(),
                          streams)
            res = out[self.W:].T.reshape(1, -1)
            outs = [res]
            if self.side:
                outs.append(out[self.W - self.side:self.W].T[None])
            return outs + [fin.reshape(k, 1, C)]
        out, fin = fn(self.body, self.state,
                      [s.contiguous() for s in self.streams])
        return [out.T.contiguous(), fin]

    def time_major(self):
        """(streams, seed): contiguous time-major numpy copies of the
        call's inputs, [n] / [k] for one stream, else [steps, lanes] /
        [k, lanes]."""
        n = self.steps
        flat = [] if self.layout == "single" else [self.lanes]
        return ([s.reshape(n, *flat).contiguous().cpu().numpy()
                 for s in self.streams],
                self.state.reshape(self.body.k, *flat).contiguous().cpu()
                .numpy())

    def nbytes(self) -> int:
        """Bytes the call must move: each input element read once (the
        overlapping lanes' extended stream once), each output written
        once, the carry read and written."""
        ins = (sum(e.numel() for e in self.ext) if self.layout == "chunk"
               else sum(s.numel() for s in self.streams))
        outs = self.lanes * (self.steps - self.W) + self.lanes * self.side
        return 4 * (ins + outs + 2 * self.state.numel())


def phase_kernels(dev):
    """lane_scan and single_scan at the paths' shapes and layouts (and off
    them) against their plain versions: bit-exact required. Each case
    reports the time a call back to back, the device time alone, the host
    time a call and the walker's clock64 cycles per step; the strided
    layouts must equal the kernel on contiguous copies; wrong arguments on
    the card must raise ValueError and launch nothing. Returns (results,
    the path cases' inputs for the A/B: label -> (body, streams, seed))."""
    import torch
    from sdrpp_tpu_torch.ops import scans_kernels as K

    rng = np.random.default_rng(1)
    B = loop_bodies()
    # (entry, body, path launching that call or None, LoopCase args,
    # kind): the receive block's WFM pilot PLL (65,440 samples, K = 128,
    # W = 128), USB AGC (13,088 samples, K = 6, W = 2048; bursts that clip)
    # and AM audio AGC (exact, 6,544 samples, from its start at gain 1e7,
    # which clips); the meteor block's FastAGC and Costas (65,536 IF
    # samples, K = 64, W = 1024, Costas with its 32 seam steps); the SSB
    # bank's exact AGC over 64 channels of 2,048 samples (bursts). Off the
    # paths: the broken-modulation Costas; the exact single-stream branch;
    # and inputs outside the short forms' proven ranges, where the kernel
    # reruns steps in the reference form: AGC steps within 2^-18 of the
    # clip threshold, an amplitude of 1e20 and zeros; an AGC whose max_out
    # is below 2^-60 (every step); PLL and Costas seed phases up to 3e5.
    cases = [
        ("lane_scan", "pll", "receive", ("chunk", 65440, 1, 128, 128), "path"),
        ("lane_scan", "agc48", "receive", ("chunk", 13088, 1, 6, 2048),
         "path"),
        ("single_scan", "agc24", "receive", ("single", 6544), "am"),
        ("lane_scan", "fast_agc", "meteor", ("chunk", 65536, 1, 64, 1024),
         "path"),
        ("lane_scan", "costas4", "meteor", ("chunk", 65536, 1, 64, 1024, 32),
         "path"),
        ("lane_scan", "agc48", "ssb_bank", ("bank", 2048, 64), "path"),
        # the radio-options block (652,800 samples): the WFM pilot PLL
        # (65,280, K = 128), the AM AGC (exact, 6,528 from gain 1e7), the
        # CW AGC (exact, 816), the RDS FastAGC and two Costas (1,360 at
        # 5 kHz)
        ("lane_scan", "pll", "radio", ("chunk", 65280, 1, 128, 128), "path"),
        ("single_scan", "agc24", "radio", ("single", 6528), "am"),
        ("single_scan", "agc_cw", "radio", ("single", 816), "path"),
        ("single_scan", "fast_agc_rds", "radio", ("single", 1360), "path"),
        ("single_scan", "costas2", "radio", ("single", 1360), "path"),
        ("single_scan", "costas2_baud", "radio", ("single", 1360), "path"),
        # the HRPT block (262,144 samples at 3 Msps): FastAGC (K = 128,
        # W = 1024) and the order-2 Costas with its seam steps (K = 128,
        # W = 512)
        ("lane_scan", "fast_agc_hrpt", "hrpt",
         ("chunk", DECODE_BLOCK, 1, 128, 1024), "path"),
        ("lane_scan", "costas2_hrpt", "hrpt",
         ("chunk", DECODE_BLOCK, 1, 128, 512, 32), "path"),
        ("lane_scan", "costas_meteor", None, ("chunk", 65536, 1, 64, 1024),
         "path"),
        ("single_scan", "pll", None, ("single", 65440), "path"),
        ("single_scan", "fast_agc", None, ("single", 8192), "path"),
        ("single_scan", "costas4", None, ("single", 8192), "path"),
        ("lane_scan", "agc48", None, ("bank", 2048, 64), "edge"),
        ("single_scan", "agc_tiny_out", None, ("single", 4096), "path"),
        ("lane_scan", "pll", None, ("bank", 640, 128), "wild"),
        ("lane_scan", "costas4", None, ("bank", 2048, 64), "wild"),
    ]
    results, ab_inputs = [], {}
    for entry, name, path, args, kind in cases:
        body = B[name]
        case = LoopCase(dev, rng, body, *args, kind=kind)
        fn = getattr(K, entry)
        plain = getattr(K, entry + "_plain")
        got = case.run(fn)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: case.run(fn), reps=20)
        dev_ms = device_ms(lambda: case.run(fn))
        t0 = time.perf_counter()
        for _ in range(20):
            case.run(fn)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        cycles = torch.zeros(-(-case.lanes // K.KERNEL_LANES),
                             dtype=torch.int64, device=dev)
        case.run(fn, cycles)
        torch.cuda.synchronize()
        cps = float(cycles.double().mean()) / case.steps
        ref = {}
        plain_ms = cuda_ms(lambda: ref.setdefault("r", case.run(plain)),
                           reps=1)
        exact = all(torch.equal(a, b) for a, b in zip(got, ref["r"]))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref["r"]))
        nbytes = case.nbytes()
        bms, bby = bound(nbytes, LOOP_OPS[body.name] * case.steps * case.lanes)
        label = f"{entry}[{name}] {case.layout} {case.shape}" + (
            "" if kind == "path" else f" {kind}")
        log(f"kernel {label}: {'bit-exact' if exact else 'DIFFERS'} (max abs "
            f"err {err:.3g}), kernel {ms:.4f} ms a call ({dev_ms:.4f} ms on "
            f"the device, {host_us:.1f} us of host time), {cps:.1f} cycles "
            f"per step (clock64), plain {plain_ms:.1f} ms, bound {bms:.5f} ms "
            f"({bby})")
        if not exact:
            raise AssertionError(f"{label} is not bit-exact against its "
                                 f"plain version: {err}")
        if case.layout in ("chunk", "bank"):
            copies = case.run_copies(fn)
            if not all(torch.equal(a, b) for a, b in zip(got, copies)):
                raise AssertionError(f"{label}: the strided views differ "
                                     f"from contiguous copies")
        if path:
            ab_inputs[f"{name} {case.shape}"] = (name, *case.time_major())
        results.append(dict(entry=entry, body=name, shape=case.shape,
                            plain_shape=case.shape, layout=case.layout,
                            kind=kind, path=path, max_abs_err=err, tol=0.0,
                            ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                            host_us=host_us, cycles_per_step=cps,
                            bound_ms=bms, bound_by=bby, library_ms=None))
    log("loop scans on CUDA: the overlapping chunk lanes and a transposed "
        "bank equal their contiguous copies")
    loop_scan_refusals(dev, B)
    return results, ab_inputs


def loop_scan_refusals(dev, B):
    """Wrong arguments to lane_scan / single_scan on the card raise
    ValueError with the plain path's message and launch nothing."""
    import torch
    from sdrpp_tpu_torch.ops import scans_kernels as K

    agc = B["agc48"]
    x = torch.rand((300, 4), device=dev)
    streams = [x, x + 1.0]
    state = torch.ones((2, 4), device=dev)
    before = (K.lane_scan.launches, K.single_scan.launches)
    bad = [("overlapping elements", K.lane_scan, (agc, state, streams),
            dict(out=torch.zeros((1, 4), device=dev).expand(300, 4))),
           ("overlapping elements", K.lane_scan, (agc, state, streams),
            dict(skip=290, side=torch.zeros((1, 4), device=dev).expand(5, 4))),
           ("out shape", K.lane_scan, (agc, state, streams),
            dict(out=torch.zeros((300, 4), device=dev), skip=3)),
           ("side shape", K.lane_scan, (agc, state, streams),
            dict(skip=2, side=torch.zeros((3, 4), device=dev))),
           ("skip 301 outside", K.lane_scan, (agc, state, streams),
            dict(skip=301)),
           ("valid 400 outside", K.lane_scan, (agc, state, streams),
            dict(valid=400)),
           ("float32", K.lane_scan, (agc, state.double(), streams), {}),
           ("2- or 3-D", K.lane_scan,
            (agc, state[..., None, None], [s[..., None, None]
                                           for s in streams]), {}),
           ("state shape", K.lane_scan, (agc, state[:, :3], streams), {}),
           ("takes 2 streams", K.lane_scan, (agc, state, streams[:1]), {}),
           ("one device", K.lane_scan, (agc, state, [x, x.cpu()]), {}),
           ("1-D", K.single_scan, (agc, state, streams), {}),
           ("cycles", K.lane_scan, (agc, state, streams),
            dict(cycles=torch.zeros(2, dtype=torch.int64, device=dev)))]
    for what, fn, args, kw in bad:
        try:
            fn(*args, **kw)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"{fn.__name__} on CUDA raised {e!r}, "
                                     f"expected {what!r}") from e
        else:
            raise AssertionError(f"{fn.__name__} on CUDA took bad arguments "
                                 f"({what})")
    if (K.lane_scan.launches, K.single_scan.launches) != before:
        raise AssertionError("a loop scan counted a launch it refused")
    log(f"loop scans on CUDA: {len(bad)} wrong arguments raise ValueError "
        f"and launch nothing")


def mm_signal(rng, n: int, cplx: bool) -> np.ndarray:
    """The meteor IF at the M&M: 72 ksym/s QPSK held at 150 kHz plus noise
    (its real part for the float variant)."""
    sps = METEOR_IF / 72000.0
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    x = sym[(np.arange(n) / sps).astype(np.int64)]
    x = (x + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    return x if cplx else x.real.copy()


def mm_bound(buf, bank, syms):
    """bound() of one mm_symbols call: the row and bank read, symbols and
    count written, and the state; MM_OPS_PER_SYMBOL per symbol."""
    nsym = int((syms != 0).sum())
    return bound(buf.numel() * buf.element_size() + bank.numel() * 4
                 + syms.numel() * syms.element_size() + syms.shape[0] * 92,
                 MM_OPS_PER_SYMBOL * nsym)


def mm_extra_cases(dev, mm, rng):
    """mm_symbols against its plain version off the meteor row: C = 3
    streams with their own states, the float variant, and two consecutive
    blocks through ``MMClockRecovery`` with the state carried (the card's
    block against the CPU's, whose wrapper runs the plain version). Each
    row crosses several of the kernel's 2048-sample ring stages. Bit-exact
    expected: masks, offsets and counts equal, symbols and states within
    KERNEL_TOL of the largest symbol."""
    import torch
    from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK
    from sdrpp_tpu_torch.ops.clock_recovery import MMClockRecovery

    n = MM_EXTRA_BLOCK
    prm = (mm.mu_gain, mm.omega_gain, mm.min_freq, mm.max_freq)
    omega = float(np.float32(mm.omega))
    results = []

    def hold(body, shape, got, want, ms, plain_ms, bnd):
        exact = all(torch.equal(a.cpu(), b.cpu()) for a, b in
                    ((got[1], want[1]), (got[2], want[2])))
        err = max(float((a.cpu() - b.cpu()).abs().max())
                  for a, b in ((got[0], want[0]), (got[3], want[3])))
        tol = KERNEL_TOL * float(want[0].abs().max())
        log(f"kernel mm_symbols[{body}] {shape}: {int(want[1].sum())} "
            f"symbols, masks and offsets {'equal' if exact else 'DIFFER'}, "
            f"max abs err {err:.3g} (tol {tol:.3g}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms")
        if not (exact and err <= tol):
            raise AssertionError(f"mm_symbols[{body}] disagrees with its "
                                 f"plain version")
        results.append(dict(entry="mm_symbols", body=body, shape=shape,
                            plain_shape=shape, path=None, max_abs_err=err,
                            tol=tol, ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=None))

    def run(body, a):
        got = MK.mm_symbols(*a)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: MK.mm_symbols(*a), reps=5)
        ref = {}
        plain_ms = cuda_ms(lambda: ref.setdefault(
            "r", MK.mm_symbols_plain(*a)), reps=1)
        hold(body, list(a[0].shape), got, ref["r"], ms, plain_ms,
             mm_bound(a[0], a[3], got[0]))

    # three streams, each with its own offset and phase
    buf = torch.from_numpy(np.stack([mm_signal(rng, n + 7, True)
                                     for _ in range(3)])).to(dev)
    fst = torch.zeros((3, 10), dtype=torch.float32, device=dev)
    fst[:, 0] = torch.tensor([0.0, 0.25, 0.75], device=dev)
    fst[:, 1] = omega
    off = torch.tensor([0, 1, 3], dtype=torch.int32, device=dev)
    run("complex_c3", (buf, off, fst, mm._bank, mm.max_symbols(n), *prm))
    # the float variant
    buf = torch.from_numpy(mm_signal(rng, n + 7, False)[None]).to(dev)
    fst = torch.tensor([[0.5, omega, 0.0]], dtype=torch.float32, device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    run("float", (buf, off, fst, mm._bank, mm.max_symbols(n), *prm))
    # two consecutive blocks, the state carried by the block on each
    # device; the card's kernel calls are recorded, and each block's kernel
    # and plain times are taken on its own recorded arguments
    x = mm_signal(rng, 2 * n, True)
    blocks = {}
    calls = []
    kernel = MK.mm_symbols

    def record(*a, **kw):
        calls.append(a)
        return kernel(*a, **kw)

    # the wrapper counts through its module's name, record while patched
    record.launches = 0

    for d in (dev, "cpu"):
        rec = MMClockRecovery(METEOR_IF / 72000.0, 0.001, 0.01, 0.01,
                              complex_input=True, device=d)
        state = rec.init_state()
        outs = []
        MK.mm_symbols = record if d != "cpu" else kernel
        try:
            for k in range(2):
                state, (syms, valid) = rec(state, torch.from_numpy(
                    x[k * n:(k + 1) * n]).to(d))
                # symbols, mask, next offset, next (phase, freq, p1 .. c2)
                outs.append((syms, valid, state["offset"], torch.stack(
                    [state["phase"], state["freq"]]
                    + [v for f in ("p1", "p2", "c1", "c2")
                       for v in (state[f].real, state[f].imag)])))
        finally:
            MK.mm_symbols = kernel
        blocks[str(d)] = outs
    got, want = blocks[str(dev)], blocks["cpu"]
    if len(calls) != 2:
        raise AssertionError(f"MMClockRecovery made {len(calls)} mm_symbols "
                             f"calls over two blocks, not 2")
    for k, a in enumerate(calls):
        ms = cuda_ms(lambda: kernel(*a), reps=5)
        plain_ms = cuda_ms(lambda: MK.mm_symbols_plain(*a), reps=1)
        hold(f"complex_block{k + 1}_of_2", list(a[0].shape), got[k], want[k],
             ms, plain_ms, mm_bound(a[0], a[3], got[k][0][None]))
    return results


def mm_radio_case(dev, rng):
    """mm_symbols as the radio-options path's RDS chain launches it: the
    float variant on one [1, 7 + 1360] row a block (5 kHz, 1187.5 baud
    biphase symbols in noise), against its plain version on the whole row:
    masks and offsets equal, symbols and state within KERNEL_TOL."""
    import torch
    from sdrpp_tpu_torch.models.rds_chain import RDSChain
    from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK

    mm = RDSChain(device=dev).recov
    n = RADIO_BLOCK * 5000 // int(FS)  # 1360 samples at 5 kHz
    sps = 5000.0 / 1187.5
    sym = rng.choice([-1.0, 1.0], int(n / sps) + 2)
    x = (sym[(np.arange(n) / sps).astype(np.int64)]
         + 0.2 * rng.standard_normal(n)).astype(np.float32)
    st = mm.init_state()
    buf = torch.cat([st["tail"], torch.from_numpy(x).to(dev)])[None]
    fst = torch.tensor([[0.0, float(np.float32(mm.omega)), 0.0]],
                       dtype=torch.float32, device=dev)
    a = (buf, st["offset"].reshape(1), fst, mm._bank, mm.max_symbols(n),
         mm.mu_gain, mm.omega_gain, mm.min_freq, mm.max_freq)
    got = MK.mm_symbols(*a)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: MK.mm_symbols(*a), reps=20)
    ref = {}
    plain_ms = cuda_ms(lambda: ref.setdefault("r", MK.mm_symbols_plain(*a)),
                       reps=1)
    want = ref["r"]
    exact = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[3] - want[3]).abs().max()))
    tol = KERNEL_TOL * float(want[0].abs().max())
    shape = list(buf.shape)
    bms, bby = mm_bound(buf, mm._bank, got[0])
    log(f"kernel mm_symbols[float] {shape} (radio, RDS): "
        f"{int(want[1].sum())} symbols, masks and offsets "
        f"{'equal' if exact else 'DIFFER'}, max abs err {err:.3g} (tol "
        f"{tol:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bms:.5f} ms ({bby})")
    if not (exact and err <= tol):
        raise AssertionError("mm_symbols[float] at the RDS row disagrees with "
                             "its plain version")
    return dict(entry="mm_symbols", body="float", shape=shape,
                plain_shape=shape, path="radio", max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=None)


def phase_kernels_digital(dev):
    """mm_symbols at the meteor path's shape against its plain version. The
    plain side runs on a prefix (it is a Python loop of a few torch
    operations per symbol): the recurrence is causal, so the kernel's
    output at the path's shape must start with the plain version's."""
    import torch
    from sdrpp_tpu_torch.models.digital import MeteorDemod
    from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK

    rng = np.random.default_rng(2)
    results = []

    # M&M as the meteor demod runs it: 72 ksym/s QPSK (rectangular hold)
    # at 150 kHz, one [1, tail + 65536] row per block
    mm = MeteorDemod(device=dev).recov
    n = MM_BLOCK
    st = mm.init_state()
    x = mm_signal(rng, n, True)

    def args(m):
        buf = torch.cat([st["tail"], torch.from_numpy(x[:m]).to(dev)])
        fstate = torch.zeros((1, 10), dtype=torch.float32, device=dev)
        fstate[0, 1] = st["freq"]
        return (buf[None], st["offset"].reshape(1), fstate, mm._bank,
                mm.max_symbols(m), mm.mu_gain, mm.omega_gain, mm.min_freq,
                mm.max_freq)

    full, part = args(n), args(MM_PLAIN)
    if full[0].shape[1] != MM_TAIL + MM_BLOCK:
        raise AssertionError(f"mm_symbols row {list(full[0].shape)}")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    got_full = MK.mm_symbols(*full, cycles=cycles)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: MK.mm_symbols(*full), reps=10)
    ms_part = cuda_ms(lambda: MK.mm_symbols(*part), reps=10)
    got = MK.mm_symbols(*part)
    ref = {}
    plain_ms = cuda_ms(lambda: ref.setdefault("r", MK.mm_symbols_plain(*part)),
                       reps=1)
    want = ref["r"]
    # on the plain version's row: symbols, mask, offset and state
    if not torch.equal(got[1], want[1]) or not torch.equal(got[2], want[2]):
        raise AssertionError("mm_symbols: valid mask or offset differs from "
                             "the plain version")
    # on the path's row: its first symbols are the plain version's
    nsym = int(want[1].sum())
    if not bool(got_full[1][0, :nsym].all()):
        raise AssertionError("mm_symbols: the path row's valid prefix is "
                             "shorter than the plain version's")
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[3] - want[3]).abs().max()),
              float((got_full[0][0, :nsym] - want[0][0, :nsym]).abs().max()))
    tol = KERNEL_TOL * float(want[0].abs().max())
    shape, plain_shape = list(full[0].shape), list(part[0].shape)
    nsym_full = int(got_full[1].sum())
    cps = int(cycles[0]) / nsym_full
    bms, bby = bound(full[0].numel() * 8 + mm._bank.numel() * 4
                     + got_full[1].numel() * 9 + 2 * 11 * 4,
                     MM_OPS_PER_SYMBOL * nsym_full)
    log(f"kernel mm_symbols {shape} ({nsym_full} symbols; the first {nsym} "
        f"held against the plain version on {plain_shape}): max abs err "
        f"{err:.3g} (tol {tol:.3g}), kernel {ms:.4f} ms at {shape}, "
        f"{ms_part:.4f} ms at {plain_shape}, plain {plain_ms:.1f} ms at "
        f"{plain_shape}, bound {bms:.5f} ms ({bby}); walker {cps:.1f} "
        f"cycles per symbol (clock64)")
    if not err <= tol:
        raise AssertionError(f"mm_symbols disagrees with its plain version: "
                             f"{err} > {tol}")
    results.append(dict(entry="mm_symbols", body="complex", shape=shape,
                        plain_shape=plain_shape, path="meteor",
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        ms_at_plain_shape=ms_part, bound_ms=bms,
                        bound_by=bby, library_ms=None,
                        cycles_per_symbol=cps))
    results += mm_extra_cases(dev, mm, rng)
    results.append(mm_radio_case(dev, rng))
    # the kernel takes the 128 x 8 bank only: another raises on the card,
    # with no launch and no fallback to the plain version
    before = MK.mm_symbols.launches
    try:
        MK.mm_symbols(full[0], full[1], full[2], mm._bank[:64], *full[4:])
    except ValueError as e:
        if "[128, 8] bank" not in str(e):
            raise AssertionError(f"mm_symbols raised {e!r} on a [64, 8] "
                                 f"bank") from e
    else:
        raise AssertionError("mm_symbols took a [64, 8] bank on the card")
    if MK.mm_symbols.launches != before:
        raise AssertionError("mm_symbols counted a launch it refused")
    log("mm_symbols on CUDA: a [64, 8] bank raises ValueError")
    return results


def viterbi_stream(rng, code, total: int, kind: str = "coded") -> np.ndarray:
    """[total, R] uint8 soft bits: the code bits of random message bits (0
    -> 0, 1 -> 255) plus N(0, 60) noise, rounded and clipped to 0..255 as
    the meteor path's soft bits are; or all 128 ("ties": every comparison
    of the trellis a tie)."""
    if kind == "ties":
        return np.full((total, code.rate), 128, np.uint8)
    k = code.order
    bits = rng.integers(0, 2, total + k - 1).astype(np.int64)
    # the shift register at each step, the newest bit in bit 0 (encode)
    reg = sum(bits[k - 1 - j:k - 1 - j + total] << j for j in range(k))
    soft = 255.0 * code.reg_outputs[reg] + rng.normal(0, 60, (total, code.rate))
    return np.clip(np.round(soft), 0, 255).astype(np.uint8)


def viterbi_starts(total: int) -> np.ndarray:
    """decode_soft_stream's window starts over ``total`` steps: chunk c
    starts W steps before c * L, clamped to [0, total - T]."""
    n = -(-total // VIT_L)
    return np.clip(np.arange(n) * VIT_L - VIT_W, 0, total - VIT_T
                   ).astype(np.int32)


def viterbi_case(dev, label, path, soft_np, starts_np, T, expected,
                 held_steps=None, reps=10):
    """Both Viterbi entries on one case: [B] windows of T steps of the
    soft-bit stream ``soft_np`` from ``starts_np``, ``expected`` [2S, R].
    Held bit-exact against their plain versions on the first VIT_HELD
    windows, or, with ``held_steps``, the ACS on each window's first
    ``held_steps`` steps (a step's decisions depend on the steps before it
    only) and the walk on its last ``held_steps`` (it starts at state 0 at
    the end, so their bits depend on their words only). Each entry's time
    a call (CUDA events), the walkers' clock64 cycles a trellis step and
    its bound. The entries are the general kernels' rows where the launch
    took them (each wrapper's ``launches_general``). Returns the two
    results."""
    import torch
    from sdrpp_tpu_torch.ops import fec_kernels as FK

    S = expected.shape[0] // 2
    soft = torch.from_numpy(soft_np).to(dev)
    starts = torch.from_numpy(starts_np).to(dev)
    B, total, R = starts.shape[0], soft.shape[0], soft.shape[1]
    held = min(B, VIT_HELD)
    hs = T if held_steps is None else min(int(held_steps), T)
    acs_cyc = torch.zeros(B, dtype=torch.int64, device=dev)
    tb_cyc = torch.zeros(B, dtype=torch.int64, device=dev)
    acs_g = FK.viterbi_acs_batched.launches_general
    tb_g = FK.viterbi_traceback_batched.launches_general
    words = FK.viterbi_acs_batched(soft, starts, T, expected, acs_cyc)
    bits = FK.viterbi_traceback_batched(words, tb_cyc, num_states=S)
    acs_general = FK.viterbi_acs_batched.launches_general > acs_g
    tb_general = FK.viterbi_traceback_batched.launches_general > tb_g
    torch.cuda.synchronize()
    # clock64 cycles a trellis step: the windows' mean and maximum
    acs_cps = float(acs_cyc.double().mean()) / T
    tb_cps = float(tb_cyc.double().mean()) / T
    acs_max, tb_max = int(acs_cyc.max()) / T, int(tb_cyc.max()) / T
    def acs():
        return FK.viterbi_acs_batched(soft, starts, T, expected)

    def tb():
        return FK.viterbi_traceback_batched(words, num_states=S)

    # about 0.1 s of calls to warm each, from one call's time
    warm(acs, calls=max(2, int(100 / max(cuda_ms(acs, reps=1), 0.01))))
    acs_ms = cuda_ms(acs, reps=reps)
    warm(tb, calls=max(2, int(100 / max(cuda_ms(tb, reps=1), 0.01))))
    tb_ms = cuda_ms(tb, reps=reps)
    ref = {}
    acs_plain_ms = cuda_ms(lambda: ref.setdefault(
        "w", FK.viterbi_acs_batched_plain(soft, starts[:held], hs,
                                          expected)), reps=1)
    tb_plain_ms = cuda_ms(lambda: ref.setdefault(
        "b", FK.viterbi_traceback_batched_plain(
            words[:held, T - hs:].contiguous(), S)), reps=1)
    acs_diff = int(FK.unpack_decisions(words[:held, :hs] ^ ref["w"],
                                       S).sum())
    tb_diff = int((bits[:held, T - hs:] != ref["b"]).sum())
    # the bytes each function must move: the soft bits its windows cover,
    # read once, the starts and the expected outputs; its words written
    # once / the words read once and the bits written once
    cover = np.zeros(total + 1, np.int64)
    st = np.clip(starts_np.astype(np.int64), 0, total - T)
    np.add.at(cover, st, 1)
    np.add.at(cover, st + T, -1)
    covered = int((np.cumsum(cover)[:total] > 0).sum())
    acs_bound = bound(covered * R * soft.element_size()
                      + starts.numel() * 4 + expected.numel() * 4
                      + words.numel() * 8,
                      ACS_OPS_PER_STATE * S * B * T)
    tb_bound = bound(words.numel() * 8 + bits.numel(),
                     TB_OPS_PER_STEP * B * T)
    dtype = "u8" if soft.dtype == torch.uint8 else "f32"
    shape = [B, T, R]
    acs_entry = ("viterbi_acs_general" if acs_general
                 else "viterbi_acs_batched")
    tb_entry = ("viterbi_traceback_general" if tb_general
                else "viterbi_traceback_batched")
    log(f"kernel {acs_entry} S={S} {shape} {dtype} ({label}): {acs_diff} "
        f"decisions of the first {held} windows' {hs} steps differ, kernel "
        f"{acs_ms:.4f} ms, {acs_cps:.1f} cycles a step (clock64; "
        f"{acs_max:.1f} in the slowest window), plain {acs_plain_ms:.1f} ms "
        f"on [{held}, {hs}], bound {acs_bound[0]:.5f} ms ({acs_bound[1]})")
    log(f"kernel {tb_entry} S={S} [{B}, {T}] ({label}): {tb_diff} bits of "
        f"the first {held} windows' last {hs} steps differ, kernel "
        f"{tb_ms:.4f} ms, {tb_cps:.1f} cycles a step (clock64; "
        f"{tb_max:.1f} in the slowest window), plain {tb_plain_ms:.1f} ms "
        f"on [{held}, {hs}], bound {tb_bound[0]:.5f} ms ({tb_bound[1]})")
    if acs_diff or tb_diff:
        raise AssertionError(f"a Viterbi kernel is not bit-exact against "
                             f"its plain version ({label}, S = {S})")
    common = dict(body=f"s{S}", path=path, kind=label, tol=0.0,
                  library_ms=None, states=S)
    return [dict(entry=acs_entry, shape=shape, plain_shape=[held, hs, R],
                 dtype=dtype, max_abs_err=float(acs_diff), ms=acs_ms,
                 plain_ms=acs_plain_ms, cycles_per_step=acs_cps,
                 cycles_per_step_max=acs_max, bound_ms=acs_bound[0],
                 bound_by=acs_bound[1], **common),
            dict(entry=tb_entry, shape=[B, T], plain_shape=[held, hs],
                 max_abs_err=float(tb_diff), ms=tb_ms, plain_ms=tb_plain_ms,
                 cycles_per_step=tb_cps, cycles_per_step_max=tb_max,
                 bound_ms=tb_bound[0], bound_by=tb_bound[1], **common)]


def phase_kernels_viterbi(dev):
    """The two Viterbi entries against their plain versions, bit-exact on
    each case's first VIT_HELD windows. Path cases: the 30-s pass's
    [528, 4288, 2] in the path's layout (a uint8 soft-bit stream plus
    decode_soft_stream's window starts) and the exact decode's [1, 4288,
    2] (B5); off the paths: one full-pass launch of 1024 windows, the
    float32 stream (the kernel's reference form), one window over a stream
    that crosses two renormalisations, and all-128 soft bits (ties). Each
    case: its time a call (CUDA events), both walkers' clock64 cycles a
    trellis step, its bound. Wrong arguments must raise ValueError and
    launch nothing. Returns (results, the pass case's stream and starts
    for the A/B)."""
    import torch
    from sdrpp_tpu_torch.models.lrpt import CCSDS_CONV_POLYS
    from sdrpp_tpu_torch.ops import fec_kernels as FK
    from sdrpp_tpu_torch.ops.fec import ConvCode

    rng = np.random.default_rng(6)
    code = ConvCode(2, 7, CCSDS_CONV_POLYS, device=dev)
    pass_total = VIT_PASS_WINDOWS * VIT_L - 1000
    pass_soft = viterbi_stream(rng, code, pass_total)
    full_total = VIT_FULL_WINDOWS * VIT_L - 1000
    long_total = 2 * VIT_RENORM + 1000
    # (label, path, soft [total, 2], starts, T[, expected])
    cases = [
        ("pass", "meteor", pass_soft, viterbi_starts(pass_total), VIT_T),
        ("B5 exact", None, viterbi_stream(rng, code, VIT_T),
         np.zeros(1, np.int32), VIT_T),
        ("full batch", None, viterbi_stream(rng, code, full_total),
         viterbi_starts(full_total), VIT_T),
        ("float32", None, pass_soft.astype(np.float32),
         viterbi_starts(pass_total), VIT_T),
        ("two renormalisations", None,
         viterbi_stream(rng, code, long_total), np.zeros(1, np.int32),
         long_total),
        ("ties", None, viterbi_stream(rng, code, pass_total, "ties"),
         viterbi_starts(pass_total), VIT_T),
        # expected outputs off the integers: the kernel's reference form
        ("expected + 0.25", None, pass_soft[:VIT_HELD * VIT_L],
         viterbi_starts(VIT_HELD * VIT_L), VIT_T, code._expected + 0.25),
    ] + decode_viterbi_cases(dev, rng)
    results = []
    for label, path, soft_np, starts_np, T, *exp in cases:
        results += viterbi_case(dev, label, path, soft_np, starts_np, T,
                                exp[0] if exp else code._expected)
    viterbi_refusals(dev, code._expected)
    viterbi_state_refusals(dev)
    return results, {"soft": pass_soft, "starts": viterbi_starts(pass_total),
                     "T": VIT_T}


def viterbi_refusals(dev, expected):
    """Wrong arguments to the Viterbi entries on the card raise ValueError
    with the plain path's message and launch nothing."""
    import torch
    from sdrpp_tpu_torch.ops import fec_kernels as FK

    soft = torch.zeros((100, 2), dtype=torch.uint8, device=dev)
    starts = torch.zeros(3, dtype=torch.int32, device=dev)
    words = torch.zeros((3, 100), dtype=torch.int64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    acs, tb = FK.viterbi_acs_batched, FK.viterbi_traceback_batched
    before = (acs.launches, tb.launches)
    bad = [("uint8 or float32", acs, (soft.double(), starts, 10, expected)),
           ("2 to 32 soft bits", acs,
            (torch.zeros((100, 33), dtype=torch.uint8, device=dev), starts,
             10, torch.zeros((128, 33), device=dev))),
           ("expected must be", acs, (soft, starts, 10, expected[:96])),
           ("int32 vector", acs, (soft, starts.long(), 10, expected)),
           ("one device", acs, (soft, starts.cpu(), 10, expected)),
           ("window length 101", acs, (soft, starts, 101, expected)),
           ("cycles", acs, (soft, starts, 10, expected,
                            torch.zeros(2, **i64))),
           ("decision words", tb,
            (torch.zeros((3, 100, 64), dtype=torch.int8, device=dev),)),
           ("cycles", tb, (words, torch.zeros(4, **i64)))]
    for what, fn, args in bad:
        try:
            fn(*args)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"{fn.__name__} on CUDA raised {e!r}, "
                                     f"expected {what!r}") from e
        else:
            raise AssertionError(f"{fn.__name__} on CUDA took bad arguments "
                                 f"({what})")
    if (acs.launches, tb.launches) != before:
        raise AssertionError("a Viterbi entry counted a launch it refused")
    log(f"viterbi on CUDA: {len(bad)} wrong arguments raise ValueError and "
        f"launch nothing")


def phase_kernels_fir(dev):
    """decimating_fir at the first r >= 8 stage of each path against its
    plain version, beside the strided conv1d (TF32 off) the port ran
    before it (library_ms), which computes the same sum from the
    [tail | x] planes."""
    import torch
    import torch.nn.functional as F
    from sdrpp_tpu_torch.ops import fir_kernels as DK
    from sdrpp_tpu_torch.ops.resample import decim_plan

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is on: the library time would not "
                             "be a float32 convolution")
    gen = torch.Generator(device=dev).manual_seed(3)
    results = []
    for path, rows, n, ratio, dt in FIR_CASES:
        r, taps = decim_plan(ratio)[0]
        m = taps.shape[0]
        dtype, nc = ((torch.complex64, 2) if dt == "c64"
                     else (torch.float32, 1))
        w = torch.from_numpy(taps.astype(np.float32)).to(dev)
        x = torch.randn((rows, n), generator=gen, dtype=dtype, device=dev)
        tail = torch.randn((rows, m - 1), generator=gen, dtype=dtype,
                           device=dev)
        new_tail, y = DK.decimating_fir(tail, x, w, r)
        L = n + m - 1
        buf = torch.cat([tail, x], -1)
        planes = (torch.view_as_real(buf).movedim(-1, -2) if nc == 2
                  else buf[:, None]).reshape(rows * nc, 1, L).contiguous()
        weight = w.reshape(1, 1, m)
        lib = F.conv1d(planes, weight, stride=r)[..., :n // r]
        torch.cuda.synchronize()
        # the kernel and the conv1d in turns, FIR_ROUNDS rounds of 20 calls
        # each, medians: at the host-bound shapes both see the same host
        ms, library_ms = (float(np.median(t)) for t in zip(*[
            (cuda_ms(lambda: DK.decimating_fir(tail, x, w, r), reps=20),
             cuda_ms(lambda: F.conv1d(planes, weight, stride=r), reps=20))
            for _ in range(FIR_ROUNDS)]))
        # the wrapper's host time per call (enqueue only), beside ms
        t0 = time.perf_counter()
        for _ in range(20):
            DK.decimating_fir(tail, x, w, r)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        dev_ms = device_ms(lambda: DK.decimating_fir(tail, x, w, r))
        ref = {}
        DK.decimating_fir_plain(tail, x, w, r)  # warm
        plain_ms = cuda_ms(lambda: ref.setdefault(
            "r", DK.decimating_fir_plain(tail, x, w, r)), reps=1)
        want_tail, want = ref["r"]
        err = max(float((y - want).abs().max()),
                  float((new_tail - want_tail).abs().max()))
        tol = KERNEL_TOL * float(want.abs().max())
        lib = lib.reshape(rows, nc, -1)
        lib = (torch.view_as_complex(lib.movedim(-2, -1).contiguous())
               if nc == 2 else lib[:, 0])
        lib_err = float((lib - want).abs().max())
        nbytes = (rows * (m - 1 + n) * 4 * nc + m * 4
                  + rows * (n // r + m - 1) * 4 * nc)
        bms, bby = bound(nbytes, rows * (n // r) * m * 2 * nc)
        log(f"kernel decimating_fir [{rows}, {n}] {dt} /{r} {m} taps ({path}): "
            f"max abs err {err:.3g} (tol {tol:.3g}), kernel {ms:.4f} ms "
            f"a call ({dev_ms:.4f} ms on the device, {host_us:.1f} us of "
            f"host time), plain {plain_ms:.2f} "
            f"ms, conv1d {library_ms:.4f} ms "
            f"(differs from the plain sum by {lib_err:.3g}), bound "
            f"{bms:.4f} ms ({bby}, {nbytes / 1e6:.1f} MB)")
        if not err <= tol:
            raise AssertionError(f"decimating_fir disagrees with its plain "
                                 f"version at [{rows}, {n}] /{r}: {err} > "
                                 f"{tol}")
        results.append(dict(entry="decimating_fir", body=f"{dt}_r{r}_m{m}",
                            shape=[rows, n], plain_shape=[rows, n],
                            path=path, max_abs_err=err, tol=tol, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            device_ms=dev_ms, host_us=host_us,
                            library_err=lib_err,
                            bound_ms=bms, bound_by=bby,
                            bytes=nbytes))
        del x, tail, buf, planes, lib, ref
    # the compiled host path makes the plain path's checks and launches
    # nothing on wrong arguments
    r, taps = decim_plan(128)[0]
    w = torch.from_numpy(taps.astype(np.float32)).to(dev)
    x = torch.zeros((2, 8 * r), dtype=torch.complex64, device=dev)
    tail = torch.zeros((2, w.shape[0] - 1), dtype=torch.complex64,
                       device=dev)
    before = DK.decimating_fir.launches
    c128 = torch.complex128
    for what, args in (("complex64 or float32", (tail.to(c128), x.to(c128),
                                                  w, r)),
                       ("taps", (tail, x, w.double(), r)),
                       ("tail", (tail[:1], x, w, r)),
                       ("tail", (tail.real.contiguous(), x, w, r)),
                       ("one device", (tail, x, w.cpu(), r)),
                       ("multiple of decimation", (tail, x, w, r + 1))):
        try:
            DK.decimating_fir(*args)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"decimating_fir on CUDA raised "
                                     f"{e!r}, expected {what!r}") from e
        else:
            raise AssertionError(f"decimating_fir on CUDA took bad "
                                 f"arguments ({what})")
    if DK.decimating_fir.launches != before:
        raise AssertionError("decimating_fir counted a launch it refused")
    # a non-contiguous view gives what its contiguous copy gives
    xs = torch.randn((2, 16 * r), generator=gen, device=dev)[:, ::2]
    a = DK.decimating_fir(tail.real.contiguous(), xs, w, r)
    b = DK.decimating_fir(tail.real.contiguous(), xs.contiguous(), w, r)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError("decimating_fir on a strided view differs")
    log("decimating_fir on CUDA: six wrong arguments raise ValueError, a "
        "strided view equals its copy")
    return results


def make_receiver(device):
    from sdrpp_tpu_torch.receiver import Receiver

    rx = Receiver(FS, block_size=BLOCK, device=device)
    for name, cfg in VFOS.items():
        rx.create_vfo(name, **cfg)
    return rx


def phase_slice(iq):
    """The main path on the card; returns per-block audio and timings."""
    import torch

    rx = make_receiver("cuda")
    audio = {name: [] for name in VFOS}
    block_ms, wall_s = [], []
    reset_counts()
    for k in range(NBLOCKS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out, _ = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        block_ms.append(start.elapsed_time(end))
        for name, a in out.items():
            audio[name].append(a.cpu().numpy())
    launches = read_counts("receive")
    for name, blocks in audio.items():
        for a in blocks:
            if not np.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite audio")
    return audio, block_ms, wall_s, launches


def check_audio(audio):
    """Tone SNRs and the WFM stereo separation, over blocks 2..8."""
    fs = 48000.0
    checks = {}
    for name, f0 in TONES.items():
        a = np.concatenate(audio[name][1:])
        checks[f"{name}_snr_db"] = snr_db(a, fs, f0)
    st = np.concatenate(audio["wfm"][1:])
    left, right = st[:, 0], st[:, 1]
    # separation at each tone's own frequency, so de-emphasis cancels
    sep_1k = 10 * np.log10(band_power(left, fs, 1000.0)[0]
                           / band_power(right, fs, 1000.0)[0])
    sep_3k = 10 * np.log10(band_power(right, fs, 3000.0)[0]
                           / band_power(left, fs, 3000.0)[0])
    mono = left + right
    s1, _ = band_power(mono, fs, 1000.0)
    s3, rest = band_power(mono, fs, 3000.0)
    checks["wfm_snr_db"] = 10 * np.log10((s1 + s3) / max(rest - s1, 1e-30))
    checks["wfm_separation_db"] = min(sep_1k, sep_3k)
    for key, value in checks.items():
        log(f"{key}: {value:.2f}")
    for name in ("am", "usb", "wfm"):
        if not checks[f"{name}_snr_db"] > 30.0:
            raise AssertionError(f"{name}: SNR {checks[f'{name}_snr_db']:.2f} dB")
    if not checks["wfm_separation_db"] > 20.0:
        raise AssertionError(f"WFM separation {checks['wfm_separation_db']:.2f} dB")
    return checks


def phase_cpu(iq, audio):
    """The first two blocks on the CPU (plain loops) against the card."""
    rx = make_receiver("cpu")
    cpu = {name: [] for name in VFOS}
    for k in range(2):
        out, _ = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        for name, a in out.items():
            cpu[name].append(a.numpy())
    diffs = {}
    for name in VFOS:
        got = np.concatenate(audio[name][:2])
        want = np.concatenate(cpu[name])
        diffs[name] = {"settled_db": rms_db(got[SETTLE:], want[SETTLE:]),
                       "whole_db": rms_db(got, want)}
        log(f"card vs cpu {name}: {diffs[name]['settled_db']:.1f} dB from "
            f"audio sample {SETTLE}, {diffs[name]['whole_db']:.1f} dB whole")
        if not diffs[name]["settled_db"] < -40.0:
            raise AssertionError(f"{name}: card and CPU disagree")
    return diffs


def phase_cli():
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.io.wav import read_wav

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "wfm.wav"
        rc = cli.main(["run", "--source", "test:2400000", "--mode", "wfm",
                       "--blocks", "4", "--device", "cuda", "--out", str(out)])
        if rc:
            raise AssertionError(f"cli run returned {rc}")
        info, data = read_wav(out)
    log(f"cli run: {data.shape[0]} frames, {info.channels} channels at "
        f"{info.samplerate} Hz")
    if info.samplerate != 48000 or info.channels != 2 or data.shape[0] == 0:
        raise AssertionError("cli run did not write 48 kHz stereo audio")
    return {"frames": int(data.shape[0])}


def meteor_pass(seed: int = 5):
    """The synthetic pass: (payloads [N, 892], a block generator of
    complex64 2.4 Msps IQ). QPSK symbols from the port's encode_cadus,
    after METEOR_LEAD_SYMS random symbols and followed by random symbols
    to METEOR_SECONDS; rectangular hold at the offset symbol clock, the
    carrier at METEOR_OFFSET + METEOR_CARRIER_HZ, AWGN at METEOR_ESN0_DB
    over the 2.4 MHz band."""
    from sdrpp_tpu_torch.decoders.meteor_lrpt import encode_cadus

    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (METEOR_CADUS, 892), dtype=np.uint8)
    rs = 72000.0 * (1.0 + METEOR_CLOCK_PPM * 1e-6)
    nsym = int(METEOR_SECONDS * rs) + 2
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    data = encode_cadus(payloads)
    syms = qpsk.astype(np.complex64)
    syms[METEOR_LEAD_SYMS:METEOR_LEAD_SYMS + len(data)] = data
    # unit symbol energy; noise power over the band = fs / (rs Es/N0)
    sigma = np.sqrt(METEOR_FS / rs / 10 ** (METEOR_ESN0_DB / 10) / 2)
    f_c = METEOR_OFFSET + METEOR_CARRIER_HZ

    def block(start: int, n: int) -> np.ndarray:
        t = (start + np.arange(n)) / METEOR_FS
        x = syms[np.minimum((t * rs).astype(np.int64), nsym - 1)] \
            * np.exp(2j * np.pi * f_c * t)
        x += sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        return x.astype(np.complex64)

    return payloads, block


def phase_meteor():
    """The meteor main path on the card: RxVFO -> MeteorLRPTDecoder ->
    finalize. Returns (results, the first two blocks' IF input, the pass's
    uint8 soft bits at the rotation that decoded: what finalize's Viterbi
    decodes)."""
    import torch
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.decoders.meteor_lrpt import MeteorLRPTDecoder
    from sdrpp_tpu_torch.models.channel import RxVFO
    from sdrpp_tpu_torch.models.lrpt import soft_s8_to_u8, symbols_to_soft_bits

    t_gen = time.perf_counter()
    payloads, gen = meteor_pass()
    gen_s = time.perf_counter() - t_gen
    vfo = RxVFO(METEOR_FS, METEOR_IF, bandwidth=METEOR_IF,
                offset=METEOR_OFFSET, device="cuda")
    dec = MeteorLRPTDecoder(METEOR_IF, device="cuda")
    block = cli._auto_block(METEOR_FS, METEOR_IF, vfo.block_multiple)
    nblocks = int(METEOR_SECONDS * METEOR_FS) // block
    vstate = vfo.init_state()
    first_if, block_ms, gen_block_s = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for k in range(nblocks):
        t0 = time.perf_counter()
        iq = gen(k * block, block)
        gen_block_s.append(time.perf_counter() - t0)
        x = torch.from_numpy(iq).to("cuda")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        vstate, y = vfo(vstate, x)
        dec.process(y)
        end.record()
        torch.cuda.synchronize()
        block_ms.append(start.elapsed_time(end))
        if k < 2:
            first_if.append(y.cpu())
    t0 = time.perf_counter()
    _, vcdus, info = dec.finalize()
    torch.cuda.synchronize()
    fin_s = time.perf_counter() - t0
    launches = read_counts("meteor")
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    nsyms = len(dec.symbols)
    if_block = vfo.out_count(block)
    med_ms = float(np.median(block_ms[1:]))
    sym_rate = nsyms / nblocks / (med_ms / 1e3)  # symbols/s processed
    log(f"meteor: {nblocks} blocks of {block} samples ({if_block} at "
        f"{METEOR_IF:g} Hz), {nsyms} symbols; median {med_ms / 1e3:.4f} "
        f"s/block over blocks 2..{nblocks} (CUDA events, RxVFO + demod); "
        f"{sym_rate:.0f} symbols/s = {sym_rate / 72000.0:.2f}x the 72 ksym/s "
        f"real-time rate; signal made in {gen_s + sum(gen_block_s):.1f} s")
    log(f"meteor finalize: {fin_s:.3f} s (viterbi "
        f"{dec.timings['viterbi_s']:.3f}, sync {dec.timings['sync_s']:.3f}, "
        f"RS {dec.timings['rs_s']:.3f}); {info}; peak device memory "
        f"{peak_mib:.1f} MiB")
    if len(vcdus) != len(payloads) or not np.array_equal(vcdus, payloads):
        got = sum(any(np.array_equal(v, p) for v in vcdus) for p in payloads)
        raise AssertionError(f"meteor: {len(vcdus)} VCDUs, {got} of "
                             f"{len(payloads)} payloads recovered")
    syms = dec.symbols * np.exp(-0.5j * np.pi * info["rotation"])
    pass_u8 = soft_s8_to_u8(symbols_to_soft_bits(syms * np.sqrt(2)))
    return {"blocks": nblocks, "block": block, "if_block": if_block,
            "symbols": nsyms, "block_ms": block_ms,
            "median_s_per_block": med_ms / 1e3, "symbols_per_s": sym_rate,
            "realtime_x": sym_rate / 72000.0, "finalize_s": fin_s,
            "peak_mib": peak_mib,
            **dec.timings, "vcdus": int(len(vcdus)), **info,
            "launches": launches}, first_if, pass_u8[:len(pass_u8) // 2 * 2]


def phase_meteor_cpu(first_if):
    """The first two demod blocks on the CPU (plain loops) against the
    card, from the same IF input."""
    import torch
    from sdrpp_tpu_torch.models.digital import MeteorDemod

    out = {}
    for dev in ("cuda", "cpu"):
        d = MeteorDemod(device=dev)
        st = d.init_state()
        syms = []
        for y in first_if:
            st, (s, v) = d(st, y.to(dev))
            syms.append(s[v].cpu())
        out[dev] = torch.cat(syms).numpy()
    card, cpu = out["cuda"], out["cpu"]
    if len(card) != len(cpu):
        raise AssertionError(f"meteor card vs cpu: {len(card)} vs {len(cpu)} "
                             f"symbols")
    d = np.abs(card[METEOR_CPU_SKIP:] - cpu[METEOR_CPU_SKIP:])
    err, rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    err_all = float(np.abs(card - cpu).max())
    log(f"meteor card vs cpu: {len(card)} symbols each; from symbol "
        f"{METEOR_CPU_SKIP} max |diff| {err:.3g} (tol {METEOR_CPU_TOL}), RMS "
        f"{rms:.3g} (tol {METEOR_CPU_RMS_TOL}); {err_all:.3g} overall")
    if not (err <= METEOR_CPU_TOL and rms <= METEOR_CPU_RMS_TOL):
        raise AssertionError("meteor: card and CPU disagree")
    return {"symbols": int(len(card)), "max_diff": err, "rms_diff": rms,
            "max_diff_all": err_all}


def phase_decode_cli():
    from sdrpp_tpu_torch import cli

    golden = np.fromfile(GOLDEN_PAYLOAD, np.uint8).reshape(3, 892)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "meteor.s"
        t0 = time.perf_counter()
        rc = cli.main(["decode", "meteor", "--source", GOLDEN_WAV,
                       "--device", "cuda", "--out", str(out)])
        secs = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"cli decode returned {rc}")
        soft = np.fromfile(out, np.int8)
        vcdus = np.fromfile(Path(tmp) / "meteor_vcdu.bin",
                            np.uint8).reshape(-1, 892)
    found = [any(np.array_equal(v, p) for v in vcdus) for p in golden]
    log(f"cli decode meteor: {len(soft)} soft bytes, {len(vcdus)} VCDUs, "
        f"golden payloads found {found} in {secs:.2f} s")
    if not all(found):
        raise AssertionError("cli decode meteor missed a golden payload")
    return {"soft_bytes": int(len(soft)), "vcdus": int(len(vcdus)),
            "seconds": secs}


def wideband_block(dev):
    """One 2^24-sample block at 1.572864 Gsps that repeats seamlessly:
    seeded numpy noise plus NFM carriers (WIDE_TONE at WIDE_DEVIATION) at
    the WIDE_CARRIERS channels' offsets, every frequency rounded to a
    multiple of fs / 2^24 = 93.75 Hz and every phase computed from an
    integer sample index modulo 2^24. Returns (block on ``dev``, tone Hz,
    H2D seconds of the noise block)."""
    import torch
    from sdrpp_tpu_torch.parallel import wideband as W

    n = W.WIDE_BLOCK
    rng = np.random.default_rng(7)
    noise = (WIDE_NOISE * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))).astype(np.complex64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.from_numpy(noise).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    bin_hz = W.FS_WIDE / n
    i = torch.arange(n, dtype=torch.int64, device=dev)

    def turns(k):  # exp argument of a k-bin tone, exact modulo 2^24
        return (2 * np.pi / n) * torch.remainder(k * i, n).double()

    kt = int(round(WIDE_TONE / bin_hz))
    beta = WIDE_DEVIATION / (kt * bin_hz)
    mod = beta * torch.sin(turns(kt))
    offsets = W.bank_offsets()
    carriers = torch.zeros(n, dtype=torch.complex128, device=dev)
    for ch in WIDE_CARRIERS:
        kc = int(round(offsets[ch] / bin_hz))
        carriers += WIDE_AMP * torch.exp(1j * (turns(kc) + mod))
    x = (x + carriers).to(torch.complex64)
    del carriers, mod, i
    return x, kt * bin_hz, h2d_s


def phase_wideband():
    """bench.py's wideband chain on the card: WIDE_BLOCKS blocks of the
    one uploaded block. Returns (results, block, per-block audio)."""
    import torch
    from sdrpp_tpu_torch.parallel import wideband as W

    x, tone, h2d_s = wideband_block("cuda")
    chain = W.make_chain("wideband", device="cuda")
    state = chain.init_state()
    audio, block_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(WIDE_BLOCKS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, y = chain(state, x)
        end.record()
        torch.cuda.synchronize()
        block_ms.append(start.elapsed_time(end))
        audio.append(y.cpu().numpy())
    launches = read_counts("wideband")
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    med_ms = float(np.median(block_ms[1:]))
    gsps = W.WIDE_BLOCK / (med_ms / 1e3) / 1e9
    for a in audio:
        if not np.isfinite(a).all():
            raise AssertionError("wideband: non-finite audio")
    whole = np.concatenate(audio, -1)
    snrs, sinads = {}, {}
    for ch in WIDE_CARRIERS:
        snrs[ch], sinads[ch] = tone_snr_sinad(whole[ch, WIDE_SETTLE:],
                                              W.IF_RATE, tone)
    h2d_gbs = x.numel() * 8 / h2d_s / 1e9
    log(f"wideband: {WIDE_BLOCKS} blocks of {W.WIDE_BLOCK} samples at "
        f"{W.FS_WIDE / 1e9:.6f} Gsps -> {W.CHANNELS} channels x "
        f"{audio[0].shape[-1]} audio samples; median {med_ms:.3f} ms/block "
        f"over blocks 2..{WIDE_BLOCKS} (CUDA events) = {gsps:.3f} Gsamp/s "
        f"input ({gsps * 1e9 / W.FS_WIDE:.2f}x real time); one H2D of the "
        f"128 MiB block {h2d_s * 1e3:.1f} ms ({h2d_gbs:.2f} GB/s); peak "
        f"device memory {peak_mib:.1f} MiB")
    log(f"wideband tone {tone:g} Hz SNR (SINAD) by carrier channel: "
        + ", ".join(f"{ch}: {snrs[ch]:.1f} ({sinads[ch]:.1f}) dB"
                    for ch in WIDE_CARRIERS))
    if not min(snrs.values()) > 30.0:
        raise AssertionError(f"wideband: tone SNR {min(snrs.values()):.2f} dB")
    return {"block": W.WIDE_BLOCK, "blocks": WIDE_BLOCKS, "block_ms": block_ms,
            "median_ms": med_ms, "gsamples_per_s": gsps,
            "h2d_ms": h2d_s * 1e3, "h2d_gb_per_s": h2d_gbs,
            "peak_mib": peak_mib, "tone_hz": tone,
            "snr_db": {str(k): v for k, v in snrs.items()},
            "sinad_db": {str(k): v for k, v in sinads.items()},
            "launches": launches}, x, audio


def phase_wideband_cpu(x, audio):
    """The first WIDE_CPU_BLOCKS wideband blocks on the CPU (plain kernels,
    pocketfft) against the card, from audio sample WIDE_CPU_SETTLE on: the
    first block starts every stage from zero state, and the channels with
    no carrier (unmuted for that block) discriminate the start's splatter
    near -100 dB, where ulp-level differences of the two FFTs decide the
    phase; the audio FIR carries that into the next block. Also reported:
    the carrier channels alone, from audio sample 0."""
    from sdrpp_tpu_torch.parallel import wideband as W

    chain = W.make_chain("wideband", device="cpu")
    state = chain.init_state()
    xc = x.cpu()
    cpu = []
    for _ in range(WIDE_CPU_BLOCKS):
        state, y = chain(state, xc)
        cpu.append(y.numpy())
    got = np.concatenate(audio[:WIDE_CPU_BLOCKS], -1)
    want = np.concatenate(cpu, -1)
    diff = rms_db(got[:, WIDE_CPU_SETTLE:], want[:, WIDE_CPU_SETTLE:])
    carriers = list(WIDE_CARRIERS)
    diff_carriers = rms_db(got[carriers], want[carriers])
    diff_all = rms_db(got, want)
    log(f"wideband card vs cpu: {diff:.1f} dB over blocks 1-"
        f"{WIDE_CPU_BLOCKS} from audio sample {WIDE_CPU_SETTLE}; carrier "
        f"channels {diff_carriers:.1f} dB from sample 0; all {diff_all:.1f} "
        f"dB from sample 0")
    if not diff < -40.0:
        raise AssertionError("wideband: card and CPU disagree")
    return {"settled_db": diff, "carriers_db": diff_carriers,
            "whole_db": diff_all}


def phase_banks():
    """bench.py's SSB bank (its AGC runs in lane_scan with the channels as
    lanes) and muted NFM bank at 6.144 Msps, BANK_BLOCK samples a block."""
    import torch
    from sdrpp_tpu_torch.parallel import wideband as W

    n = BANK_BLOCK
    offsets = W.bank_offsets()
    t = np.arange(n) / W.FS_MID
    rng = np.random.default_rng(3)
    res = {}

    ssb = W.make_chain("ssb", device="cuda")
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for ch in range(0, W.CHANNELS, 8):  # USB tones 1 kHz above 8 channels
        x = x + 0.05 * np.exp(2j * np.pi * (offsets[ch] + 1000.0) * t)
    xs = torch.from_numpy(x.astype(np.complex64)).to("cuda")
    state = ssb.init_state()
    reset_counts()
    ms = []
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, y = ssb(state, xs)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        if not torch.isfinite(y).all():
            raise AssertionError("ssb bank: non-finite audio")
    res["ssb_bank"] = {"block_ms": ms, "median_ms": float(np.median(ms[1:])),
                       "launches": read_counts("ssb_bank")}

    muted = W.make_chain("muted", device="cuda")
    x = 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for ch in range(0, W.CHANNELS, 2):  # bench.py:349-353
        x = x + 0.25 * np.exp(1j * (2 * np.pi * offsets[ch] * t
                                    + 0.5 * np.sin(2 * np.pi * 1000.0 * t)))
    xs = torch.from_numpy(x.astype(np.complex64)).to("cuda")
    state = muted.init_state()
    reset_counts()
    ms = []
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, y = muted(state, xs)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        per_ch = y.abs().sum(-1).cpu().numpy()
        if not ((per_ch[1::2] == 0.0).all() and (per_ch[0::2] > 0.0).all()):
            raise AssertionError("muted bank: odd channels not exactly 0 or "
                                 "even channels silent")
    res["muted_bank"] = {"block_ms": ms, "median_ms": float(np.median(ms[1:])),
                         "launches": read_counts("muted_bank")}
    for name, r in res.items():
        log(f"{name}: {W.CHANNELS} channels, {n} samples a block at "
            f"{W.FS_MID / 1e6:g} Msps, median {r['median_ms']:.3f} ms/block "
            f"(CUDA events, blocks 2..4)")
    return res


def phase_bank_cli():
    """``cli bank`` with no --device: 64 NFM channels from test:6144000,
    the time and the fft channelizer; 64 WAVs each. Records the rows of
    every decimating_fir launch."""
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.io.wav import read_wav
    from sdrpp_tpu_torch.ops import fir_kernels as DK
    from sdrpp_tpu_torch.parallel import wideband as W

    offsets = ",".join(f"{o:.1f}" for o in W.bank_offsets())
    rows_seen = []
    launch = DK._launch

    def spy(tail, x, taps, r):
        rows_seen.append(int(np.prod(x.shape[:-1])))
        return launch(tail, x, taps, r)

    res = {}
    DK._launch = spy
    try:
        for chz in ("time", "fft"):
            rows_seen.clear()
            with tempfile.TemporaryDirectory() as tmp:
                reset_counts()
                t0 = time.perf_counter()
                rc = cli.main(["bank", "--source", "test:6144000",
                               f"--offsets={offsets}", "--mode", "nfm",
                               "--channelizer", chz, "--blocks", "4",
                               "--out-dir", tmp])
                secs = time.perf_counter() - t0
                if rc:
                    raise AssertionError(f"cli bank returned {rc}")
                counts = read_counts("bank" if chz == "time" else "bank_fft")
                wavs = sorted(Path(tmp).glob("ch*.wav"))
                info, data = read_wav(wavs[0])
            log(f"cli bank --channelizer {chz}: {len(wavs)} WAVs of "
                f"{data.shape[0]} frames at {info.samplerate} Hz in "
                f"{secs:.2f} s; decimating_fir rows {sorted(set(rows_seen))}")
            if len(wavs) != W.CHANNELS or data.shape[0] != 4 * 262144 // 128:
                raise AssertionError(f"cli bank --channelizer {chz} wrote "
                                     f"{len(wavs)} WAVs of {data.shape[0]} "
                                     f"frames")
            if chz == "time" and set(rows_seen) != {W.CHANNELS}:
                raise AssertionError(f"cli bank: decimating_fir rows "
                                     f"{rows_seen}, expected {W.CHANNELS}")
            res[chz] = {"wavs": len(wavs), "seconds": secs,
                        "launches": counts, "rows": sorted(set(rows_seen))}
    finally:
        DK._launch = launch
    return res


def phase_golden_bank():
    """tests/test_golden.py's NFM bank through ScannerBank on the card.
    From zero state the discriminator starts on the channel filters'
    leading edge (the first ~300 IF samples), where rounding decides the
    phase; it is held from GOLDEN_SETTLE on."""
    import torch
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank

    fs = 512000.0
    offs = np.array([-128000.0, 64000.0])
    bank = ScannerBank(offs, fs, mode="nfm", if_rate=32000.0,
                       bandwidth=12500.0)
    n = bank.block_multiple * (65536 // bank.block_multiple)
    t = np.arange(n) / fs
    iq = (0.4 * np.exp(1j * (2 * np.pi * 64000.0 * t
                             + np.cumsum(2 * np.pi * 5000.0
                                         * np.sin(2 * np.pi * 700.0 * t) / fs)))
          ).astype(np.complex64)
    _, audio = bank(bank.init_state(), torch.from_numpy(iq).to("cuda"))
    got = audio.cpu().numpy()
    want = np.load(GOLDEN_CHAINS)["nfm_bank"]
    if got.shape != want.shape:
        raise AssertionError(f"golden bank shape {got.shape} != {want.shape}")
    settled = rms_db(got[:, GOLDEN_SETTLE:], want[:, GOLDEN_SETTLE:])
    whole = rms_db(got, want)
    log(f"NFM-bank golden on the card: {settled:.1f} dB from IF sample "
        f"{GOLDEN_SETTLE}, {whole:.1f} dB whole")
    if not settled < -40.0:
        raise AssertionError("NFM-bank golden: the card disagrees")
    return {"settled_db": settled, "whole_db": whole}


def radio_composite(n: int, seed: int = 4) -> np.ndarray:
    """The radio-options path's 2.4 Msps signal: WFM stereo carrying a
    57 kHz RDS subcarrier (PI RADIO_PI, PS name RADIO_PS in group-0A
    segments; tests/test_rds.py:116-151 at this rate), a CW carrier, an AM
    station, an NFM station with impulse bursts (a Hann-shaped 17 us burst
    up to 30x its level every 10 ms), a second NFM station, and seeded
    noise."""
    from sdrpp_tpu_torch.decoders.rds import encode_group

    t = np.arange(n) / FS
    bits = []
    name = RADIO_PS.encode()
    while len(bits) < n / FS * 1187.5 + 208:
        for seg in range(4):
            bits += encode_group([RADIO_PI, (9 << 5) | seg, 0xE0E0,
                                  (name[2 * seg] << 8) | name[2 * seg + 1]])
    diff = np.cumsum(np.asarray(bits, np.int64)) % 2
    half = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    k = np.floor(t * 2 * 1187.5).astype(np.int64)
    # biphase, smoothed over 0.27 ms (the test's 64 samples at 240 kHz)
    c = np.concatenate([[0.0], np.cumsum(half[k])])
    w = 640
    lo, hi = np.clip(np.arange(n) - w // 2, 0, n), np.clip(
        np.arange(n) + w // 2, 0, n)
    rds_bb = (c[hi] - c[lo]) / w
    l = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.4 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.41 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.41 * (l - r) * np.sin(2 * np.pi * 38000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    x = 0.5 * np.exp(1j * (2 * np.pi * RADIO_WFM * t
                           + np.cumsum(2 * np.pi * 75000.0 * mpx / FS)))
    x += 0.05 * np.exp(2j * np.pi * RADIO_CW * t)
    x += 0.2 * (1 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) \
        * np.exp(2j * np.pi * RADIO_AM * t)
    nfm = 0.1 * np.exp(1j * (2 * np.pi * RADIO_NFM * t
                             + 3.0 * np.sin(2 * np.pi * 1000.0 * t)))
    # Hann-shaped bursts: an impulse at the NFM station's 48 kHz IF that
    # leaves the stations 200 kHz and more away clean
    pos = np.arange(n) % 24000
    x += nfm * (1.0 + 29.0 * np.where(
        pos < 40, np.sin(np.pi * (pos + 0.5) / 40) ** 2, 0.0))
    x += 0.1 * np.exp(1j * (2 * np.pi * RADIO_NFM2 * t
                            + 2.0 * np.sin(2 * np.pi * 1500.0 * t)))
    rng = np.random.default_rng(seed)
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def make_radio_receiver(device):
    from sdrpp_tpu_torch.receiver import Receiver

    rx = Receiver(FS, block_size=RADIO_BLOCK, device=device)
    for name, cfg in RADIO_VFOS.items():
        rx.create_vfo(name, **cfg)
    return rx


def radio_step(rx, iq, k):
    """Block k of the radio-options path: nfm_dyn's writes between blocks
    (retune_state before RADIO_RETUNE_BLOCK, set_bandwidth_state before
    RADIO_BW_BLOCK), then ``Receiver.process_block``."""
    chans = rx._state["channels"]
    dyn = rx._channels["nfm_dyn"]
    if k == RADIO_RETUNE_BLOCK:
        chans["nfm_dyn"] = dyn.retune_state(chans["nfm_dyn"], RADIO_NFM2)
    if k == RADIO_BW_BLOCK:
        chans["nfm_dyn"] = dyn.set_bandwidth_state(chans["nfm_dyn"], RADIO_BW)
    return rx.process_block(iq[k * RADIO_BLOCK:(k + 1) * RADIO_BLOCK])


def phase_radio(iq, device="cuda"):
    """The radio-options path through ``Receiver(..., device)`` for
    RADIO_NBLOCKS blocks, the RDS baseband decoded by
    ``RDSReceiver(device)``. Returns (audio by VFO, the RDS blocks, the
    decoder, CUDA-event ms a block, host s a block, launches)."""
    import torch
    from sdrpp_tpu_torch.models.rds_chain import RDSReceiver

    rx = make_radio_receiver(device)
    rds_rx = RDSReceiver(device=device)
    audio = {name: [] for name in RADIO_VFOS}
    rds, block_ms, wall_s = [], [], []
    cuda = torch.device(device).type == "cuda"
    reset_counts()
    for k in range(RADIO_NBLOCKS):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out, _ = radio_step(rx, iq, k)
        rds_rx.process(out["wfm_rds"][1])
        if cuda:
            end.record()
            torch.cuda.synchronize()
            block_ms.append(start.elapsed_time(end))
        wall_s.append(time.perf_counter() - t0)
        for name, a in out.items():
            a = a[0] if isinstance(a, tuple) else a
            audio[name].append(a.cpu().numpy())
        rds.append(out["wfm_rds"][1].cpu().numpy())
    launches = read_counts("radio") if cuda else None
    for name, blocks in audio.items():
        if not all(np.isfinite(a).all() for a in blocks):
            raise AssertionError(f"radio {name}: non-finite audio")
    return audio, rds, rds_rx.decoder, block_ms, wall_s, launches


def check_radio(audio, decoder):
    """RDS PI and PS exact with >= 10 groups; the CW, raw and AM tones'
    SNR > 30 dB; the blanker lowers the NFM station's impulse energy
    against the same VFO without it; after the retune the new station's
    tone > 30 dB and the old one's gone (> 40 dB down); the narrowed
    bandwidth raises the NFM audio by 6250 / 5000."""
    fs = 48000.0
    checks = {"rds_pi": decoder.pi_code, "rds_ps": decoder.ps_name,
              "rds_groups": decoder.groups_decoded}
    log(f"RDS on the card: PI {decoder.pi_code:#06x}, PS {decoder.ps_name!r},"
        f" {decoder.groups_decoded} groups")
    if decoder.pi_code != RADIO_PI or decoder.ps_name != RADIO_PS \
            or decoder.groups_decoded < 10:
        raise AssertionError("RDS: PI / PS name not recovered")
    for name, f0 in RADIO_TONES.items():
        a = np.concatenate(audio[name][1:])
        if a.ndim == 2:  # raw: the I channel
            a = a[:, 0]
        checks[f"{name}_snr_db"] = snr_db(a, fs, f0)
    # the impulse energy: the NFM station's audio outside its tone
    nb, plain = (np.concatenate(audio[k][1:]) for k in ("nfm_nb",
                                                         "nfm_plain"))
    checks["nb_impulse_db"] = 10 * np.log10(band_power(nb, fs, 1000.0)[1]
                                            / band_power(plain, fs, 1000.0)[1])
    dyn = audio["nfm_dyn"]
    after = np.concatenate(dyn[RADIO_RETUNE_BLOCK + 1:])
    checks["retune_snr_db"] = snr_db(
        np.concatenate(dyn[RADIO_RETUNE_BLOCK + 1:RADIO_BW_BLOCK]), fs, 1500.0)
    # narrowed to 10 kHz, the channel cuts the station's 4th Bessel
    # sidebands (6 kHz): harmonics are left out of this SNR
    checks["narrowed_snr_db"] = tone_snr_sinad(
        np.concatenate(dyn[RADIO_BW_BLOCK + 1:]), fs, 1500.0)[0]
    checks["retune_old_tone_db"] = 10 * np.log10(
        band_power(after, fs, 1000.0)[0] / band_power(after, fs, 1500.0)[0])
    rms = [np.sqrt(np.mean(np.square(audio["nfm_dyn"][k][SETTLE:])))
           for k in (RADIO_BW_BLOCK - 1, RADIO_BW_BLOCK + 1)]
    checks["bandwidth_gain"] = float(rms[1] / rms[0])
    for key, value in checks.items():
        log(f"radio {key}: {value}")
    for key in ("cw_snr_db", "raw_snr_db", "am_snr_db", "retune_snr_db",
                "narrowed_snr_db"):
        if not checks[key] > 30.0:
            raise AssertionError(f"radio {key}: {checks[key]:.2f} dB")
    if not checks["nb_impulse_db"] < -3.0:
        raise AssertionError("the noise blanker did not lower the impulses")
    if not checks["retune_old_tone_db"] < -40.0:
        raise AssertionError("after the retune the old station remains")
    if not abs(checks["bandwidth_gain"] - 1.25) < 0.05:
        raise AssertionError("set_bandwidth_state did not take effect")
    return checks


def phase_radio_cpu(iq, audio, rds):
    """The radio-options path's first two blocks on the CPU against the
    card: audio (and the RDS baseband) below -40 dB after the settle."""
    rx = make_radio_receiver("cpu")
    cpu = {name: [] for name in RADIO_VFOS}
    cpu_rds = []
    for k in range(2):
        out, _ = radio_step(rx, iq, k)
        for name, a in out.items():
            cpu[name].append((a[0] if isinstance(a, tuple) else a).numpy())
        cpu_rds.append(out["wfm_rds"][1].numpy())
    diffs = {}
    for name in RADIO_VFOS:
        got = np.concatenate(audio[name][:2])
        want = np.concatenate(cpu[name])
        diffs[name] = rms_db(got[SETTLE:], want[SETTLE:])
    got, want = np.concatenate(rds[:2]), np.concatenate(cpu_rds)
    diffs["rds_baseband"] = rms_db(got[100:].view(np.float32),
                                   want[100:].view(np.float32))
    for name, d in diffs.items():
        log(f"radio card vs cpu {name}: {d:.1f} dB after the settle")
        if not d < -40.0:
            raise AssertionError(f"radio {name}: card and CPU disagree")
    return diffs


def _cli_out(argv, device):
    """cli.main(argv + ["--device", device]) with its standard output
    captured; fails on a non-zero return."""
    import contextlib
    import io

    from sdrpp_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--device", device])
    if rc:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def phase_radio_cli(iq, device="cuda"):
    """The entry points of the radio-options slice on the card: ``run
    --mode cw`` (the test source's tone through the BFO, SNR > 30 dB),
    ``run --mode raw --sample-format i24``, ``run --audio-rate 44100``,
    ``spectrum --framebuffer``, and ``scan`` over a WAV of the composite,
    which must park on its CW, AM and two NFM carriers."""
    from sdrpp_tpu_torch.io import wav

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _cli_out(["run", "--source", "test:2400000", "--mode", "cw",
                  "--offset", "99900", "--blocks", "4", "--block-size",
                  str(RADIO_BLOCK), "--out", str(tmp / "cw.wav")], device)
        info, data = wav.read_wav(tmp / "cw.wav")
        res["cw_snr_db"] = snr_db(data[len(data) // 4:, 0], 48000.0, 900.0)
        if (info.samplerate, info.channels) != (48000, 1) \
                or not res["cw_snr_db"] > 30.0:
            raise AssertionError(f"cli run --mode cw: {info}, "
                                 f"{res['cw_snr_db']:.1f} dB")
        _cli_out(["run", "--source", "test:2400000", "--mode", "raw",
                  "--sample-format", "i24", "--blocks", "2", "--block-size",
                  "65280", "--out", str(tmp / "raw.wav")], device)
        info, data = wav.read_wav(tmp / "raw.wav")
        if (info.samplerate, info.channels, info.bits) != (2400000, 2, 24) \
                or data.shape != (2 * 65280, 2):
            raise AssertionError(f"cli run --mode raw: {info} {data.shape}")
        _cli_out(["run", "--source", "test:2400000", "--mode", "wfm",
                  "--audio-rate", "44100", "--blocks", "4", "--out",
                  str(tmp / "wfm441.wav")], device)
        info, data = wav.read_wav(tmp / "wfm441.wav")
        if (info.samplerate, info.channels) != (44100, 2) or not len(data):
            raise AssertionError(f"cli run --audio-rate 44100: {info}")
        res["audio_rate_frames"] = int(len(data))
        _cli_out(["spectrum", "--source", "test:2400000", "--blocks", "4",
                  "--out", str(tmp / "wf.npy"), "--framebuffer",
                  str(tmp / "fb.npy")], device)
        wf, fb = np.load(tmp / "wf.npy"), np.load(tmp / "fb.npy")
        peak = float(np.fft.fftshift(np.fft.fftfreq(wf.shape[1], 1 / FS))[
            int(np.argmax(wf.mean(0)))])
        if wf.shape[1] != 65536 or fb.dtype != np.uint32 \
                or abs(peak - 100000.0) > 100.0:
            raise AssertionError(f"cli spectrum: {wf.shape} {fb.dtype} "
                                 f"peak {peak}")
        res["spectrum"] = {"lines": int(wf.shape[0]), "fb": list(fb.shape)}
        n = 2 * RADIO_BLOCK
        wav.write_wav(tmp / "band.wav", int(FS),
                      np.stack([iq[:n].real, iq[:n].imag], -1), "f32")
        hits = {}
        for lo, hi, want in ((-300e3, -100e3, RADIO_CW),
                             (-700e3, -400e3, RADIO_AM),
                             (500e3, 700e3, RADIO_NFM),
                             (700e3, 900e3, RADIO_NFM2)):
            out = _cli_out(["scan", "--source", str(tmp / "band.wav"),
                            f"--start={lo}", f"--stop={hi}", "--blocks", "9"], device)
            found = [float(line.split()[0]) for line in out.splitlines()
                     if line.strip().endswith("dB")]
            hits[f"{want:+.0f}"] = found
            if not found or any(abs(f - want) > 12500.0 for f in found):
                raise AssertionError(f"cli scan {lo}..{hi}: {found}, "
                                     f"expected {want}")
        res["scan_hits"] = hits
    log(f"radio entry points: {res}")
    return res


def ui_composite(n: int) -> np.ndarray:
    """The live receiver's 2.4 Msps signal: the radio-options composite
    (WFM with RDS, CW, AM, two NFM stations) plus 72 ksym/s QPSK at
    UI_METEOR for the meteor VFO."""
    x = radio_composite(n).astype(np.complex128)
    rng = np.random.default_rng(21)
    sps = FS / 72000.0
    nsym = int(n / sps) + 2
    q = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    t = np.arange(n) / FS
    x += 0.1 * q[np.floor(np.arange(n) / sps).astype(np.int64)] \
        * np.exp(2j * np.pi * UI_METEOR * t)
    return x.astype(np.complex64)


class ArraySource:
    """A source over an IQ array: reads it block by block, and at its end
    wraps (``loop``) or returns a short block, which stops the engine."""

    def __init__(self, iq, loop=False):
        self.iq, self.loop, self.pos = iq, loop, 0
        self.samplerate, self.center_freq = FS, 0.0

    def read(self, n):
        if self.loop and self.pos + n > len(self.iq):
            self.pos = 0
        out = self.iq[self.pos:self.pos + n]
        self.pos += len(out)
        return out


class StepTimer:
    """Wraps an engine's step: CUDA events around each call on the card
    (the step's device span, as the default stream sees it) and the host
    clock at each call's start (a block's host time is the gap between
    starts)."""

    def __init__(self, step, cuda=True):
        self.step, self.cuda, self.events, self.starts = step, cuda, [], []

    def __call__(self, state, x):
        import torch

        self.starts.append(time.perf_counter())
        if not self.cuda:
            return self.step(state, x)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.step(state, x)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        """The steps' CUDA-event milliseconds (NaN off the card)."""
        import torch

        if not self.cuda:
            return [float("nan")] * len(self.starts)
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def ui_engine(iq, device, realtime=False, loop=False):
    """``ReceiverEngine`` at cli ui's defaults on ``device`` with the four
    UI_VFOS (selected: nfm), built, not started."""
    from sdrpp_tpu_torch.misc.webui import ReceiverEngine

    eng = ReceiverEngine(ArraySource(iq, loop), mode="nfm",
                         fft_size=UI_FFT, fft_rate=20.0,
                         base_block=UI_BASE_BLOCK, realtime=realtime,
                         device=device)
    with eng.lock:
        eng.vfos = {k: dict(v) for k, v in UI_VFOS.items()}
        eng.selected = "nfm"
        for name in UI_VFOS:
            eng._ensure_audio_ring(name)
    eng._build()
    return eng


def _wait_for(pred, timeout=120.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _ring(eng, name):
    st = eng._audio[name]
    return st["ring"][:st["written"]].copy()


def ui_direct(iq, nblocks, block, device):
    """Each analog UI VFO's chain run directly (``IQFrontEnd`` +
    ``RadioChannel`` as the engine plans them) on the same blocks: the
    int16 stereo PCM the engine's ring should hold at volume 1."""
    from sdrpp_tpu_torch.models.radio import RadioChannel
    from sdrpp_tpu_torch.signal_path import IQFrontEnd
    import torch

    fe = IQFrontEnd(FS, fft_size=UI_FFT, fft_rate=20.0, block_size=block,
                    device=device)
    chans = {n: RadioChannel(c["mode"], FS, offset=c["offset"],
                             bandwidth=c["bandwidth"], audio_rate=48000.0,
                             squelch_level=c["squelch"],
                             deemphasis=c["deemphasis"], rds=c["rds"],
                             dynamic_offset=True, dynamic_bandwidth=True,
                             device=device)
             for n, c in UI_VFOS.items() if c["mode"] != "meteor"}
    fst = fe.init_state()
    states = {n: c.init_state() for n, c in chans.items()}
    pcm = {n: [] for n in chans}
    for k in range(nblocks):
        x = torch.from_numpy(iq[k * block:(k + 1) * block]).to(device)
        fst, (y, _) = fe(fst, x)
        for n, c in chans.items():
            states[n], a = c(states[n], y)
            a = (a[0] if isinstance(a, tuple) else a).float().cpu().numpy()
            if a.ndim == 1:
                a = np.stack([a, a], -1)
            pcm[n].append(np.clip(a * 32767.0, -32768, 32767)
                          .astype(np.int16))
    return {n: np.concatenate(v) for n, v in pcm.items()}


def _get_ms(url, nbytes=None):
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read(nbytes) if nbytes else r.read()
    return (time.perf_counter() - t0) * 1e3, body


def phase_ui(device="cuda"):
    """ui-2p4: the port's ``ReceiverEngine`` and ``WebUIServer`` at cli
    ui's defaults with four VFOs (WFM with RDS, NFM with squelch, USB on
    the CW carrier, meteor at 140 kHz). UI_BLOCKS blocks with realtime off
    (block ms from CUDA events on the step, host s a block, real-time
    factor, B1-B4 launches), checked: each analog ring within 1 LSB of the
    same RadioChannel run directly on the card, RDS PI and PS exact, the
    constellation's symbols on four points; then UI_CPU_BLOCKS blocks on a
    CPU engine against the card's rings (below -40 dB after the settle)
    and symbols (the M&M's bounds); then UI_REALTIME_S seconds paced in
    real time, during which every GET route is timed (p50, p99) and
    set_offset (a state write: the step kept, blocks rising), set_mode and
    add_vfo (control to the first block on the new chain) are timed."""
    import threading

    import torch
    from sdrpp_tpu_torch.misc.webui import WebUIServer

    probe = ui_engine(np.zeros(1, np.complex64), "cpu")
    block = probe._block
    iq = ui_composite(UI_BLOCKS * block)
    cuda = torch.device(device).type == "cuda"
    eng = ui_engine(iq, device)
    timer = StepTimer(eng._step, cuda)
    eng._step = timer
    srv = WebUIServer(eng, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    eng.start()
    eng._thread.join(600)
    launches = read_counts("ui") if cuda else {}
    res = {"block": block, "blocks": eng.blocks, "vfos": list(UI_VFOS)}
    if eng.blocks != UI_BLOCKS or eng.error or eng.failures:
        raise AssertionError(f"ui engine: {eng.blocks} blocks, "
                             f"error {eng.error}, {eng.failures} failures")
    ms = timer.ms()
    host = np.diff(timer.starts).tolist()
    res["block_ms"], res["host_s"] = ms, host
    res["median_ms"] = float(np.median(ms[1:]))
    res["median_host_s"] = float(np.median(host[1:]))
    res["realtime_factor"] = block / FS / res["median_host_s"]
    res["launches"] = launches
    res["launches_per_block"] = {k: v / UI_BLOCKS for k, v in launches.items()}
    log(f"ui-2p4: {UI_BLOCKS} blocks of {block} ({block / FS * 1e3:.1f} ms "
        f"of signal), step median {res['median_ms']:.3f} ms (CUDA events), "
        f"host {res['median_host_s'] * 1e3:.3f} ms a block over blocks "
        f"2..{UI_BLOCKS}, {res['realtime_factor']:.2f}x real time; "
        f"launches a block {res['launches_per_block']}")
    if cuda and not res["realtime_factor"] > 1.0:
        raise AssertionError("ui engine slower than real time")
    _, page = _get_ms(base + "/")
    if b"<canvas" not in page:
        raise AssertionError("ui: the page was not served")
    direct = ui_direct(iq, UI_BLOCKS, block, device)
    rings = {n: _ring(eng, n) for n in direct}
    res["ring_vs_direct_lsb"] = {}
    for n, want in direct.items():
        got = rings[n]
        if got.shape != want.shape:
            raise AssertionError(f"ui {n}: ring {got.shape} vs {want.shape}")
        d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        res["ring_vs_direct_lsb"][n] = d
        if d > 1:
            raise AssertionError(f"ui {n}: ring {d} LSB from the direct chain")
    dec = eng._rds["fm"].decoder
    res["rds"] = {"pi": dec.pi_code, "ps": dec.ps_name,
                  "groups": dec.groups_decoded}
    if dec.pi_code != RADIO_PI or dec.ps_name != RADIO_PS:
        raise AssertionError(f"ui RDS: {res['rds']}")
    syms = eng.read_constellation("sat", 4096)
    z = syms[np.abs(syms) > 0.3]
    res["constellation_coherence"] = float(np.abs(np.mean(
        np.exp(4j * np.mod(np.angle(z), np.pi / 2))))) if len(z) else 0.0
    res["symbols"] = int(eng._const["sat"]["written"])
    if not res["constellation_coherence"] > 0.5:
        raise AssertionError(f"ui constellation: {res}")
    # the USB audio reaches full scale, so int16 clips it: its odd
    # harmonics are left out of this SNR
    snr = tone_snr_sinad(rings["usb"][48000:, 0].astype(np.float64),
                         48000.0, TONES["usb"])[0]
    res["usb_snr_db"] = snr
    if not snr > 30.0:
        raise AssertionError(f"ui usb: {snr:.1f} dB")
    srv.shutdown()
    srv.server_close()

    # the first UI_CPU_BLOCKS blocks on the card and on the CPU, each an
    # engine run to the end of those blocks
    short = {}
    for dev in (device, "cpu"):
        e = ui_engine(iq[:UI_CPU_BLOCKS * block], dev)
        e.start()
        e._thread.join(600)
        if e.blocks != UI_CPU_BLOCKS or e.error:
            raise AssertionError(f"ui {dev} engine: {e.blocks} {e.error}")
        short[dev] = e
    card, cpu = short[device], short["cpu"]
    res["card_vs_cpu_db"] = {
        n: rms_db(_ring(card, n)[SETTLE:], _ring(cpu, n)[SETTLE:])
        for n in direct}
    counts = (card._const["sat"]["written"], cpu._const["sat"]["written"])
    d = np.abs(card.read_constellation("sat", 4096)
               - cpu.read_constellation("sat", 4096))
    res["symbols_card_vs_cpu"] = {"count": counts, "max": float(d.max()),
                                  "rms": float(np.sqrt(np.mean(d ** 2)))}
    log(f"ui card vs cpu: {res['card_vs_cpu_db']} dB, symbols "
        f"{res['symbols_card_vs_cpu']} (the last 4096 of each)")
    for n, d in res["card_vs_cpu_db"].items():
        if not d < -40.0:
            raise AssertionError(f"ui {n}: card and CPU disagree ({d:.1f} dB)")
    sc = res["symbols_card_vs_cpu"]
    if counts[0] != counts[1] or not (sc["max"] <= METEOR_CPU_TOL
                                      and sc["rms"] <= METEOR_CPU_RMS_TOL):
        raise AssertionError(f"ui symbols: card and CPU disagree ({sc})")

    res["realtime"] = phase_ui_realtime(iq, device,
                                        res["realtime_factor"] > 1.0)
    log(f"ui-2p4 result: {json.dumps(res, default=float)}")
    return res


def phase_ui_realtime(iq, device, keeps_up=True):
    """UI_REALTIME_S seconds of the engine paced in real time over the
    composite (looped), with the routes and controls timed meanwhile. The
    pacing is held (blocks within 2 of the seconds' worth) when the engine
    ran faster than real time unpaced (``keeps_up``)."""
    import threading

    from sdrpp_tpu_torch.misc.webui import WebUIServer

    eng = ui_engine(iq, device, realtime=True, loop=True)
    eng.attach_bookmarks()
    srv = WebUIServer(eng, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    res = {}
    eng.start()
    try:
        _wait_for(lambda: eng.blocks >= 2, what="the first blocks")
        b0, t0 = eng.blocks, time.monotonic()
        routes = {}
        for route in UI_ROUTES:
            times = [_get_ms(base + route,
                             44 + 4 * 4800 if route.startswith("/audio")
                             else None)[0] for _ in range(UI_ROUTE_REPS)]
            routes[route] = {"p50_ms": float(np.percentile(times, 50)),
                             "p99_ms": float(np.percentile(times, 99))}
        res["routes"] = routes
        remaining = UI_REALTIME_S - (time.monotonic() - t0)
        if remaining > 0:
            time.sleep(remaining)
        dt, nb = time.monotonic() - t0, eng.blocks - b0
        res["paced"] = {"seconds": dt, "blocks": nb,
                        "expected": dt * FS / eng._block}
        if keeps_up and abs(nb - res["paced"]["expected"]) > 2.0:
            raise AssertionError(f"ui pacing: {res['paced']}")

        step, b0 = eng._step, eng.blocks
        t0 = time.monotonic()
        eng.control("set_offset", RADIO_NFM)
        _wait_for(lambda: eng._built_cfgs["nfm"]["offset"] == RADIO_NFM
                  and eng.blocks > b0, what="set_offset")
        res["set_offset_ms"] = (time.monotonic() - t0) * 1e3
        b1 = eng.blocks
        _wait_for(lambda: eng.blocks >= b1 + 2, what="blocks after retune")
        if eng._step is not step:
            raise AssertionError("ui: set_offset rebuilt the chain")
        for action, value, done in (
                ("set_mode", "am",
                 lambda: eng._built_cfgs["nfm"]["mode"] == "am"),
                ("add_vfo", {"name": "extra", "mode": "nfm",
                             "offset": RADIO_NFM2},
                 lambda: "extra" in eng._built_cfgs)):
            t0 = time.monotonic()
            eng.control(action, value)
            _wait_for(done, what=action)
            b1 = eng.blocks
            _wait_for(lambda: eng.blocks > b1, what=f"a block after {action}")
            res[f"{action}_ms"] = (time.monotonic() - t0) * 1e3
        if eng.error or eng.failures:
            raise AssertionError(f"ui realtime: {eng.error} "
                                 f"({eng.failures} failures)")
    finally:
        eng.stop()
        srv.shutdown()
        srv.server_close()
    log(f"ui-2p4 realtime: {json.dumps(res, default=float)}")
    return res


def phase_serve(device="cuda"):
    """serve-2p4: ``python -m sdrpp_tpu_torch serve --source test:2400000
    --blocks SERVE_BLOCKS`` (on the card, its default) as a subprocess; the
    port's ``BasebandClient`` must receive SERVE_BLOCKS i16 frames equal,
    bit for bit, to the test source's blocks quantized on the CPU. Blocks
    a second from the server's log and from the client's clock."""
    import re
    import socket

    from sdrpp_tpu_torch.io.sources import TestSource
    from sdrpp_tpu_torch.io.wire import BasebandClient
    from sdrpp_tpu_torch.ops.compression import (PCM_TYPE_I16, pack_frame,
                                                 unpack_frame)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrpp_tpu_torch", "serve", "--source",
         "test:2400000", "--blocks", str(SERVE_BLOCKS), "--block-size",
         str(SERVE_BLOCK), "--port", str(port), "--device", device],
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                client = BasebandClient("127.0.0.1", port)
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("cli serve did not listen")
                time.sleep(0.1)
        client.start()
        t0 = time.perf_counter()
        frames = [client.read_packet() for _ in range(SERVE_BLOCKS)]
        client_s = time.perf_counter() - t0
        client.close()
        rc = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    if rc:
        raise AssertionError(f"cli serve exited {rc}: {err[-2000:]}")
    src = TestSource(FS, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    for k, (kind, got) in enumerate(frames):
        want = unpack_frame(pack_frame(src.read(SERVE_BLOCK), PCM_TYPE_I16))
        if kind != "baseband" or not np.array_equal(got, want):
            raise AssertionError(f"cli serve frame {k} differs from the "
                                 "CPU's quantization")
    m = re.search(r"served (\d+) blocks .* \(([\d.]+) blocks/s\)", err)
    res = {"blocks": SERVE_BLOCKS, "block": SERVE_BLOCK,
           "server_blocks_per_s": float(m.group(2)) if m else None,
           "client_blocks_per_s": SERVE_BLOCKS / client_s,
           "bit_equal": True}
    log(f"serve-2p4: {json.dumps(res)}")
    return res


# the ui-fault phase's child (run with SDRPP_TPU_SUPERVISED=1): argv[1] is
# "fault" (stream on the card with a session file, apply controls, then a
# device-side assert in the step: the engine must save the session and
# exit BACKEND_FATAL_EXIT) or "restore" (the saved session restored and
# streamed clean, then a streak of plain exceptions that must not exit);
# argv[2] is the session file, argv[3] the device
UI_FAULT_SCRIPT = r"""
import sys, time
import torch
from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ReceiverEngine, serve_ui

def wait(pred, what, timeout=180):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)

def boom(*a, **kw):
    raise RuntimeError("synthetic step failure")

mode, cfg, device = sys.argv[1:4]
src = TestSource(2400000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
eng = ReceiverEngine(src, mode="nfm", offset=100000.0, realtime=False,
                     base_block=262144, fft_size=16384, device=device)
srv = serve_ui(eng, port=0, forever=False, config_path=cfg)
wait(lambda: eng.blocks >= 2, "blocks")
if mode == "fault":
    eng.control("add_vfo", {"name": "keep", "mode": "am",
                            "offset": -300000.0})
    eng.control("set_volume", 0.3)
    # promoted to last-good (a clean block on the new chain), so the
    # ladder's revert keeps it
    wait(lambda: "keep" in (eng._last_good_vfos or {}), "add_vfo")
    real = eng._step

    def assert_step(state, x):
        eng._step = real
        # an index past the end: the index kernel's device-side assert,
        # which poisons the context until the process exits
        torch.zeros(4, device=x.device)[
            torch.full((1,), 1 << 20, dtype=torch.long, device=x.device)]
        return real(state, x)

    print("ASSERTING", flush=True)
    eng._step = assert_step
    eng._thread.join(300)
    print("ENGINE THREAD RETURNED WITHOUT EXIT", eng.error, flush=True)
    sys.exit(3)
assert "keep" in eng._built_cfgs and eng.volume == 0.3, eng.vfos
assert eng.error is None and eng.failures == 0, eng.error
a = eng.audio_written("keep")
wait(lambda: eng.audio_written("keep") > a, "audio on the restored vfo")
print("RESTORED", eng.blocks, sorted(eng.vfos), flush=True)
eng._step = boom
type(eng)._plan = boom
wait(lambda: eng.failures >= 6, "the ladder")
assert not eng.fatal and eng._thread.is_alive(), eng.error
print("ALIVE", eng.failures, flush=True)
eng.stop()
srv.server_close()  # serve_ui(forever=False) serves no requests
"""


def phase_ui_fault(device="cuda"):
    """ui-fault: a child engine on the card under SDRPP_TPU_SUPERVISED with
    a session file applies controls, then its step launches a device-side
    assert: the child must exit BACKEND_FATAL_EXIT (86) with the session
    saved, controls included. A second child restores that session and
    streams clean blocks, then takes a streak of plain Python exceptions
    through the whole ladder without exiting."""
    import os

    from sdrpp_tpu_torch.cli import BACKEND_FATAL_EXIT

    env = dict(os.environ, SDRPP_TPU_SUPERVISED="1")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = str(Path(tmp) / "ui.json")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", UI_FAULT_SCRIPT, "fault",
                            cfg, device], env=env, capture_output=True, text=True,
                           timeout=600)
        res["fault_rc"], res["fault_s"] = r.returncode, time.perf_counter() - t0
        if r.returncode != BACKEND_FATAL_EXIT or "ASSERTING" not in r.stdout:
            raise AssertionError(f"ui-fault child exited {r.returncode}: "
                                 f"{r.stdout[-1000:]} {r.stderr[-3000:]}")
        saved = json.loads(Path(cfg).read_text())
        res["saved"] = {"vfos": sorted(saved["vfos"]),
                        "volume": saved["volume"]}
        if saved["vfos"].get("keep", {}).get("mode") != "am" \
                or saved["volume"] != 0.3:
            raise AssertionError(f"ui-fault: session not saved: {saved}")
        fatal = [l for l in r.stderr.splitlines() if "FATAL" in l]
        res["fatal_line"] = fatal[-1][-300:] if fatal else None
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", UI_FAULT_SCRIPT, "restore",
                            cfg, device], env=env, capture_output=True, text=True,
                           timeout=600)
        res["restore_rc"] = r.returncode
        res["restore_s"] = time.perf_counter() - t0
        if r.returncode or "RESTORED" not in r.stdout \
                or "ALIVE" not in r.stdout:
            raise AssertionError(f"ui-fault restore child exited "
                                 f"{r.returncode}: {r.stdout[-1000:]} "
                                 f"{r.stderr[-3000:]}")
        res["restore_out"] = r.stdout.strip().splitlines()
    log(f"ui-fault: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# cli run's options (run-resume, mp3), the ATV decoder (atv-11p25) and the
# DAB OFDM front end (dab-2p048), and the three walk kernels
# ---------------------------------------------------------------------------

def _flac(path):
    from sdrpp_tpu_torch.io.flac import read_flac

    return read_flac(path)[1]


def _trace_names(logdir: Path) -> str:
    """The text of the one Chrome trace ``--trace`` wrote into logdir."""
    files = list(logdir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--trace wrote {len(files)} traces in {logdir}")
    return files[0].read_text()


def watchdog_on_card(dev):
    """StepWatchdog on the card times the step's device work, not its
    enqueue: a step that queues WATCHDOG_SLEEP cycles of device sleep
    returns to the host at once, yet under a 0.1-s deadline the watchdog
    raises StepTimeout; a short step passes; a healthy context is not
    poisoned."""
    import torch
    from sdrpp_tpu_torch.utils.watchdog import (StepTimeout, StepWatchdog,
                                                device_poisoned)

    x = torch.zeros(4, device=dev)

    def slow(s, v):
        torch.cuda._sleep(WATCHDOG_SLEEP)
        return s, v + 1

    t0 = time.perf_counter()
    slow(0, x)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wd = StepWatchdog(lambda: slow, timeout_s=0.1, max_retries=0)
    t0 = time.perf_counter()
    try:
        wd(0, x)
        timed_out = False
    except StepTimeout:
        timed_out = True
    raised_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    quick = StepWatchdog(lambda: (lambda s, v: (s, v + 1)), timeout_s=5.0,
                         max_retries=0)
    quick(0, x)
    res = {"enqueue_s": enqueue_s, "timed_out": timed_out,
           "raised_after_s": raised_s,
           "poisoned": device_poisoned(dev)}
    log(f"watchdog on the card: a {WATCHDOG_SLEEP}-cycle sleep step enqueues "
        f"in {enqueue_s * 1e3:.2f} ms, StepTimeout after {raised_s:.3f} s "
        f"under a 0.1-s deadline: {timed_out}; healthy context poisoned: "
        f"{res['poisoned']}")
    if not timed_out or enqueue_s >= 0.1 or res["poisoned"]:
        raise AssertionError(f"the watchdog did not time the device work: "
                             f"{res}")
    return res


def phase_run_resume(dev):
    """run-resume: ``cli run --container flac`` on the card over a WAV of
    the slice composite, for each RUN_MODES station (wfm: the pilot PLL,
    lane_scan; am: the AGC, single_scan, and the /8 decimating FIR):
    RUN_BLOCKS blocks straight through, then RUN_BLOCKS / 2 with
    ``--checkpoint --checkpoint-every 1 --trace`` and RUN_BLOCKS / 2 with
    ``--resume``; the FLAC samples of the two halves must equal the
    straight run's exactly, the trace must name the mode's kernels, the
    checkpoint's offset must be the stream's. Then the cost of a
    checkpoint (``save_state`` of the chain's state, a D2H and the .npz)
    and the watchdog's device deadline."""
    import torch
    from sdrpp_tpu_torch.io import wav
    from sdrpp_tpu_torch.models.radio import RadioChannel
    from sdrpp_tpu_torch.utils.checkpoint import save_state

    res = {"launches": {}}
    n = RUN_BLOCKS * RUN_BLOCK
    half = RUN_BLOCKS // 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        iq = composite(n, seed=7)
        src = tmp / "slice.wav"
        wav.write_wav(src, int(FS), np.stack([iq.real, iq.imag], -1), "f32")
        del iq
        for mode, offset in RUN_MODES.items():
            common = ["run", "--source", str(src), "--mode", mode,
                      "--offset", str(offset), "--container", "flac",
                      "--block-size", str(RUN_BLOCK)]
            reset_counts()
            t0 = time.perf_counter()
            _cli_out([*common, "--blocks", str(RUN_BLOCKS), "--out",
                      str(tmp / "all.flac")], dev.type)
            straight_s = time.perf_counter() - t0
            launches = read_counts(f"run_{mode}")
            ck = tmp / f"{mode}.npz"
            t0 = time.perf_counter()
            _cli_out([*common, "--blocks", str(half), "--checkpoint",
                      str(ck), "--checkpoint-every", "1", "--trace",
                      str(tmp / f"trace_{mode}"), "--out",
                      str(tmp / "a.flac")], dev.type)
            first_s = time.perf_counter() - t0
            if int(np.load(ck)["__stream_offset__"]) != half * RUN_BLOCK:
                raise AssertionError(f"run --checkpoint ({mode}): offset")
            _cli_out([*common, "--blocks", str(RUN_BLOCKS - half),
                      "--checkpoint", str(ck), "--resume", "--out",
                      str(tmp / "b.flac")], dev.type)
            if int(np.load(ck)["__stream_offset__"]) != n:
                raise AssertionError(f"run --resume ({mode}): offset")
            whole, a, b = (_flac(tmp / f) for f in ("all.flac", "a.flac",
                                                    "b.flac"))
            joined = np.concatenate([a, b])
            exact = joined.shape == whole.shape and np.array_equal(joined,
                                                                   whole)
            text = _trace_names(tmp / f"trace_{mode}")
            named = {k: k in text for k in RUN_KERNELS[mode]}
            r = {"frames": int(whole.shape[0]), "channels": int(whole.shape[1]),
                 "resumed_equal": bool(exact), "trace_names": named,
                 "straight_s": straight_s, "first_half_s": first_s,
                 "launches": launches}
            log(f"run-resume {mode}: {whole.shape[0]} frames x "
                f"{whole.shape[1]}, split and resumed equal: {exact}, trace "
                f"names {named}, launches {launches}")
            if not exact or not all(named.values()) or not len(whole):
                raise AssertionError(f"run-resume {mode}: {r}")
            res[mode] = r
            res["launches"][mode] = launches
        # a checkpoint's cost a block: save_state of the chain's state
        chan = RadioChannel("wfm", FS, offset=RUN_MODES["wfm"], device=dev)
        st = chan.init_state()
        st, _ = chan(st, torch.zeros(RUN_BLOCK, dtype=torch.complex64,
                                     device=dev))
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(st))
        save_state(tmp / "c.npz", st, stream_offset=RUN_BLOCK)
        t0 = time.perf_counter()
        for _ in range(CKPT_REPS):
            save_state(tmp / "c.npz", st, stream_offset=RUN_BLOCK)
        res["checkpoint_ms"] = (time.perf_counter() - t0) / CKPT_REPS * 1e3
        res["state_bytes"] = nbytes
        log(f"run --checkpoint-every 1: save_state of the wfm chain's state "
            f"({nbytes} bytes on the card) {res['checkpoint_ms']:.2f} ms a "
            f"block (D2H + .npz, host clock, {CKPT_REPS} calls)")
    res["watchdog"] = watchdog_on_card(dev)
    return res


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def phase_mp3(dev):
    """mp3: one ``cli run --container mp3`` on the card where libmp3lame is
    present (the decoded recording at 48 kHz); a line saying so where it
    is absent."""
    from sdrpp_tpu_torch.io import mp3

    if not mp3.available():
        log("mp3: libmp3lame absent, the MP3 container not run")
        return {"available": False}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "a.mp3"
        _cli_out(["run", "--source", "test:2400000", "--mode", "wfm",
                  "--container", "mp3", "--blocks", "2", "--block-size",
                  str(RUN_BLOCK), "--out", str(out)], dev.type)
        rate, data = mp3.decode_mp3(out)
    log(f"mp3: cli run --container mp3 decoded {data.shape[0]} frames at "
        f"{rate} Hz")
    if rate != 48000 or not data.shape[0]:
        raise AssertionError(f"cli run --container mp3: {rate} {data.shape}")
    return {"available": True, "frames": int(data.shape[0]), "rate": rate}


def atv_composite(n_lines: int, seed: int = 8) -> np.ndarray:
    """PAL-like composite video at 11.25 Msps (720 samples a line), FM
    modulated with a deviation of fs / 2 (the decoder's): each line a sync
    tip (samples [0, 71) and [703, 720) at -0.3), a grey ramp, a colour
    burst at the subcarrier over the samples the chroma PLL's window
    reads, its phase alternating +-135 degrees by line (the PAL phases),
    a chroma carrier over the active region, and seeded noise."""
    from sdrpp_tpu_torch.decoders import atv

    L = atv.LINE_LEN
    k = np.arange(L)
    line = np.where((k < 71) | (k >= L - 17), -0.3,
                    0.1 + 0.3 * (k - 71) / (L - 88))
    t = np.arange(n_lines * L)
    kk, ll = t % L, t // L
    w0 = 2 * np.pi * atv.CHROMA_SUBCARRIER / ATV_FS
    theta = np.where(ll % 2 == 1, atv.A_PHASE, atv.B_PHASE)
    delay = atv.CHROMA_FIR_DELAY
    burst = (kk >= atv.BURST_START - delay) & (kk < atv.BURST_END - delay)
    active = (kk >= atv.BURST_START) & (kk < L - 17)
    video = (line[kk] + 0.15 * np.cos(w0 * t + theta) * burst
             + 0.1 * np.cos(w0 * t) * active)
    video += 0.005 * np.random.default_rng(seed).standard_normal(len(t))
    return np.exp(1j * np.cumsum(np.pi * video)).astype(np.complex64)


def phase_atv(dev):
    """atv-11p25: ATV_BLOCKS blocks of ATV_BLOCK samples (a PAL frame, 40
    ms each) of ``atv_composite`` through ``ATVDecoder(device="cuda")``:
    per-block CUDA-event ms and host ms, the real-time factor, the
    launches (line_sync_walk and chroma_burst_walk once a block), frames
    of [625, 720, 2] uint8 at the rollovers; then a CPU decoder (the plain
    walks) on the same blocks: the same vertical scan block by block
    (ypos, field, frames). The chroma frames themselves are not compared:
    the decoder's ChromaPLL (bandwidth 0.01) does not lock at 720-sample
    lines (ROADMAP C), so card and CPU part from their first ulp."""
    import torch
    from sdrpp_tpu_torch.decoders.atv import ATVDecoder

    iq = atv_composite(ATV_BLOCKS * ATV_BLOCK // 720)
    blocks = [iq[k * ATV_BLOCK:(k + 1) * ATV_BLOCK] for k in range(ATV_BLOCKS)]
    x_dev = [torch.from_numpy(b).to(dev) for b in blocks]
    dec = ATVDecoder(device=dev)
    reset_counts()
    frames, ms, wall, scan = [], [], [], []
    for x in x_dev:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        frames += dec.process(x)
        e1.record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        ms.append(e0.elapsed_time(e1))
        scan.append((dec.assembler.ypos, dec.assembler.even_frame))
    launches = read_counts("atv")
    cpu = ATVDecoder(device="cpu")
    cpu_frames, cpu_scan = [], []
    for b in blocks:
        cpu_frames += cpu.process(b)
        cpu_scan.append((cpu.assembler.ypos, cpu.assembler.even_frame))
    block_s = ATV_BLOCK / ATV_FS
    med_wall = float(np.median(wall[1:]))
    res = {"block_ms": ms, "wall_s": wall, "launches": launches,
           "frames": len(frames), "cpu_frames": len(cpu_frames),
           "scan": scan, "cpu_scan": cpu_scan,
           "realtime_factor": block_s / med_wall,
           "median_ms": float(np.median(ms[1:])), "median_wall_s": med_wall}
    log(f"atv-11p25: {len(frames)} frames in {ATV_BLOCKS} blocks, median "
        f"{res['median_ms']:.3f} ms a block (CUDA events) and "
        f"{med_wall * 1e3:.3f} ms of host time against {block_s * 1e3:.1f} "
        f"ms of signal ({res['realtime_factor']:.2f}x real time); vertical "
        f"scan {scan}, CPU {cpu_scan}; launches {launches}")
    bad = [f.shape for f in frames if f.shape != (625, 720, 2)
           or f.dtype != np.uint8]
    if len(frames) < ATV_BLOCKS - 1 or bad or scan != cpu_scan \
            or len(cpu_frames) != len(frames):
        raise AssertionError(f"atv-11p25: {res} {bad}")
    if launches["line_sync_walk"] != ATV_BLOCKS \
            or launches["chroma_burst_walk"] != ATV_BLOCKS:
        raise AssertionError(f"atv-11p25: not one launch a block: "
                             f"{launches}")
    return res


def dab_signal(n: int, seed: int = 9) -> np.ndarray:
    """DAB transmission mode I at 2.048 Msps: frames of a null symbol
    (2,656 samples), the phase-reference symbol (the port's table) and
    DAB_SYMS - 1 data symbols of random pi/4-DQPSK-like carriers on the
    1,536 used bins, each a 2,048-point symbol behind its 504-sample
    cyclic prefix, unit RMS; a carrier offset of DAB_CFO_BINS and seeded
    noise at -30 dB."""
    from sdrpp_tpu_torch.ops.ofdm import load_dab_prs_conj

    rng = np.random.default_rng(seed)
    N, cp = DAB_FFT, DAB_CP
    prs = np.conj(load_dab_prs_conj()).astype(np.complex128)
    prs /= np.sqrt(np.mean(np.abs(prs) ** 2))
    used = np.r_[1:769, N - 768:N]

    def with_cp(s):
        return np.concatenate([s[-cp:], s])

    frames = []
    while sum(map(len, frames)) < n:
        parts = [np.zeros(DAB_NULL), with_cp(prs)]
        for _ in range(DAB_SYMS - 1):
            spec = np.zeros(N, np.complex128)
            spec[used] = np.exp(1j * (np.pi / 4 + np.pi / 2
                                      * rng.integers(0, 4, len(used))))
            s = np.fft.ifft(spec)
            parts.append(with_cp(s / np.sqrt(np.mean(np.abs(s) ** 2))))
        frames.append(np.concatenate(parts))
    x = np.concatenate(frames)[:n]
    x = x * np.exp(2j * np.pi * DAB_CFO_BINS / N * np.arange(n))
    x += 0.0316 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        / np.sqrt(2)
    return x.astype(np.complex64)


def phase_dab(dev):
    """dab-2p048: DAB_BLOCKS blocks of DAB_BLOCK samples (one second) of
    ``dab_signal`` through ``CyclicSync(2048 / fs, 504 / fs, fs,
    device="cuda")``; every emitted symbol through ``phase_reference_sync``
    to find the phase-reference symbols (one a 96-ms frame), each through
    ``dab_prs_cfo`` (aligned to its timing) and, with the estimate
    removed, ``dab_prs_constellation``: the estimate within DAB_CFO_TOL of
    the injected offset, the constellation on its four points. Per-block
    CUDA-event and host ms, launches (cyclic_sync_walk once a block). Then
    every block's walk again from the card's inputs and carried state,
    against the plain walk: the emits exactly equal."""
    import torch
    from sdrpp_tpu_torch.ops import sync_walks as W
    from sdrpp_tpu_torch.ops.ofdm import (CyclicSync,
                                          cyclic_prefix_correlation,
                                          dab_prs_cfo, dab_prs_constellation,
                                          load_dab_prs_conj,
                                          phase_reference_sync)

    x = dab_signal(DAB_BLOCKS * DAB_BLOCK)
    xs = [torch.from_numpy(x[k * DAB_BLOCK:(k + 1) * DAB_BLOCK]).to(dev)
          for k in range(DAB_BLOCKS)]
    cs = CyclicSync(DAB_FFT / DAB_FS, DAB_CP / DAB_FS, DAB_FS, device=dev)
    st = cs.init_state()
    states = [st]
    reset_counts()
    ms, wall, out = [], [], []
    for xb in xs:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        st, (syms, valid) = cs(st, xb)
        e1.record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        ms.append(e0.elapsed_time(e1))
        states.append(st)
        out.append((syms, valid))
    launches = read_counts("dab")
    prs_conj = load_dab_prs_conj()
    prs = np.conj(prs_conj)
    emitted, found, cfo, clusters = 0, 0, [], []
    want = 2 * np.pi * DAB_CFO_BINS / DAB_FFT
    for syms, valid in out:
        nv = int(valid.sum())
        emitted += nv
        if not nv:
            continue
        k, peak, _ = phase_reference_sync(syms[:nv], prs)
        k, peak = k.cpu().numpy(), peak.cpu().numpy()
        for i in np.nonzero(peak > DAB_PRS_RATIO * np.median(peak))[0]:
            found += 1
            sym = syms[i]
            est = float(dab_prs_cfo(sym, np.roll(prs_conj, int(k[i]))))
            cfo.append(est)
            nn = torch.arange(DAB_FFT, device=dev, dtype=torch.float32)
            clean = torch.roll(sym * torch.exp(-1j * est * nn), -int(k[i]))
            c = dab_prs_constellation(clean).cpu().numpy()
            h, _ = np.histogram(np.mod(np.angle(c), np.pi / 2), bins=9,
                                range=(0, np.pi / 2))
            clusters.append(float(h.max() / h.sum()))
    # the walk again, card against the plain version, from each block's
    # inputs and the card's carried state (outside the counted run)
    emits_equal, plain_s = True, 0.0
    for b, xb in enumerate(xs):
        s0 = states[b]
        _, rcorr, vals = cyclic_prefix_correlation(
            s0["tail"], xb, cs.symbol_samps, cs.prefix_samps)
        args = (torch.stack([s0["avg_corr"], s0["peak_corr"],
                             s0["last_corr"]]), s0["since_peak"].reshape(1),
                s0["sym_buf"], cs.max_symbols(DAB_BLOCK), cs.agc_rate)
        got = W.cyclic_sync_walk(rcorr, vals, *args)
        t0 = time.perf_counter()
        ref = W.cyclic_sync_walk(rcorr.cpu(), vals.cpu(),
                                 *[a.cpu() if isinstance(a, torch.Tensor)
                                   else a for a in args])
        plain_s += time.perf_counter() - t0
        emits_equal &= all(torch.equal(g.cpu(), r)
                           for g, r in zip(got, ref))
    block_s = DAB_BLOCK / DAB_FS
    med_wall = float(np.median(wall[1:]))
    res = {"block_ms": ms, "wall_s": wall, "launches": launches,
           "emitted": emitted, "prs_found": found, "cfo_est": cfo,
           "cfo_true": want, "cluster_share": clusters,
           "emits_equal_plain": bool(emits_equal), "plain_s": plain_s,
           "median_ms": float(np.median(ms[1:])), "median_wall_s": med_wall,
           "realtime_factor": block_s / med_wall}
    log(f"dab-2p048: {emitted} symbols emitted in {DAB_BLOCKS} blocks, "
        f"{found} phase-reference symbols, CFO estimates "
        f"{[round(c, 6) for c in cfo]} against {want:.6f} rad/sample, "
        f"constellation shares {[round(c, 3) for c in clusters]}; median "
        f"{res['median_ms']:.3f} ms a block (CUDA events), "
        f"{med_wall * 1e3:.3f} ms host, {res['realtime_factor']:.2f}x real "
        f"time; walk emits, state and buffer equal the plain walk's on "
        f"every block: {emits_equal} (plain {plain_s:.2f} s); launches "
        f"{launches}")
    frames = DAB_BLOCKS * DAB_BLOCK // (DAB_NULL + DAB_SYMS * (DAB_FFT + DAB_CP))
    if not emits_equal or found < frames or launches["cyclic_sync_walk"] \
            != DAB_BLOCKS or any(abs(c - want) > DAB_CFO_TOL for c in cfo) \
            or any(c < 0.9 for c in clusters):
        raise AssertionError(f"dab-2p048: {res}")
    return res


def _walk_case(entry, path, shape, plain_shape, err, tol, ms, plain_ms,
               nbytes, ops, **extra):
    bms, bby = bound(nbytes, ops)
    log(f"kernel {entry} {shape} ({path}): max abs err {err:.3g} (tol "
        f"{tol:.3g}), kernel {ms:.4f} ms a call, plain {plain_ms:.2f} ms on "
        f"{plain_shape}, bound {bms:.5f} ms ({bby}); {extra}")
    if not err <= tol:
        raise AssertionError(f"{entry} disagrees with its plain version at "
                             f"{shape}: {err} > {tol}")
    return dict(entry=entry, path=path, shape=list(shape),
                plain_shape=list(plain_shape), max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=None, bytes=nbytes, ops=ops, **extra)


def phase_kernels_walks(dev):
    """The three walks against their plain versions at the paths' shapes,
    on the same inputs: line_sync_walk on the first ATV block's
    discriminator output ([450007] with the tail; exact), chroma_burst_walk
    on [625, 28] bursts of a locked tone (ATV_LOCKING_BW: at the decoder's
    0.01 the PLL does not lock, ROADMAP C, and its cos / sin / atan2 ulps
    would grow without bound; phases within WALK_TOL, outputs within
    WALK_OUT_TOL), cyclic_sync_walk on the first DAB block ([204800],
    2048-sample symbols; exact), each timed with CUDA events, with its
    time a line, a burst step or a sample beside it; then wrong arguments
    must raise ValueError and launch nothing."""
    import torch
    from sdrpp_tpu_torch.decoders import atv
    from sdrpp_tpu_torch.ops import sync_walks as W
    from sdrpp_tpu_torch.ops.fm import Quadrature
    from sdrpp_tpu_torch.ops.ofdm import CyclicSync, cyclic_prefix_correlation

    cases = []
    # line_sync_walk
    iq = torch.from_numpy(atv_composite(ATV_BLOCK // 720)).to(dev)
    quad = Quadrature(ATV_FS / 2, ATV_FS, device=dev)
    _, y = quad(quad.init_state(), iq)
    ls = atv.LineSync(1.0, omega_gain=1e-6, mu_gain=1.0,
                      omega_rel_limit=0.05, device=dev)
    st = ls.init_state()
    buf = torch.cat([st["tail"], y])
    carry = torch.stack([st["pos"], st["freq"]])
    args = (buf, ls.bank, carry, st["locked"].reshape(1),
            ls.max_lines(ATV_BLOCK), ls.omega_gain, ls.mu_gain, ls.min_freq,
            ls.max_freq, ls.sync_level, ls.sync_bias)
    got = W.line_sync_walk(*args)
    ms = cuda_ms(lambda: W.line_sync_walk(*args), reps=5)
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    t0 = time.perf_counter()
    ref = W.line_sync_walk(*cpu_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((g.cpu().float() - r.float()).abs().max())
              for g, r in zip(got, ref))
    lines = int(ref[1])
    cases.append(_walk_case(
        "line_sync_walk", "atv", [ATV_BLOCK + 7], [ATV_BLOCK + 7], err, 0.0,
        ms, plain_ms, (ATV_BLOCK + 7) * 4 + 128 * 8 * 4
        + args[4] * 720 * 4 + 32, lines * (720 * 21 + 40), lines=lines,
        us_per_line=ms * 1e3 / max(lines, 1)))
    # chroma_burst_walk
    L, nb = ATV_BLOCK // 720, atv.BURST_END - atv.BURST_START
    w0 = 2 * np.pi * atv.CHROMA_SUBCARRIER / ATV_FS
    t = (np.arange(L)[:, None] * 720 + atv.BURST_START + np.arange(nb))
    burst = torch.from_numpy(np.exp(1j * (w0 * t + 0.3)).astype(
        np.complex64)).to(dev)
    pll = atv.ChromaPLL(ATV_LOCKING_BW, 720, atv.BURST_START, atv.BURST_END,
                        init_freq=w0, min_freq=w0 * 0.9, max_freq=w0 * 1.1,
                        device=dev)
    carry = torch.tensor([0.0, np.float32(w0)], dtype=torch.float32,
                         device=dev)
    refs = torch.zeros(L, dtype=torch.float32, device=dev)
    args = (burst, refs, carry, atv.BURST_START, 720 - atv.BURST_END,
            pll.alpha, pll.beta, pll.min_freq, pll.max_freq)
    got = W.chroma_burst_walk(*args)
    ms = cuda_ms(lambda: W.chroma_burst_walk(*args), reps=5)
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    t0 = time.perf_counter()
    ref = W.chroma_burst_walk(*cpu_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    phase_err = max(float((got[0].cpu() - ref[0]).abs().max()),
                    float((got[2].cpu() - ref[2]).abs().max()))
    out_err = float((got[1].cpu() - ref[1]).abs().max())
    locked = float(np.abs(np.angle(got[1][-20:].cpu().numpy())).mean())
    if not out_err <= WALK_OUT_TOL or not locked < 0.05:
        raise AssertionError(f"chroma_burst_walk: outputs {out_err} > "
                             f"{WALK_OUT_TOL} or not locked ({locked})")
    cases.append(_walk_case(
        "chroma_burst_walk", "atv", [L, nb], [L, nb], phase_err, WALK_TOL,
        ms, plain_ms, L * nb * 16 + L * 4 + L * 16 + 16,
        L * nb * CHROMA_OPS_PER_STEP, out_err=out_err,
        locked_phase_err=locked, us_per_step=ms * 1e3 / (L * nb)))
    # cyclic_sync_walk
    cs = CyclicSync(DAB_FFT / DAB_FS, DAB_CP / DAB_FS, DAB_FS, device=dev)
    st = cs.init_state()
    xb = torch.from_numpy(dab_signal(DAB_BLOCK)).to(dev)
    _, rcorr, vals = cyclic_prefix_correlation(st["tail"], xb,
                                               cs.symbol_samps,
                                               cs.prefix_samps)
    args = (rcorr, vals, torch.stack([st["avg_corr"], st["peak_corr"],
                                      st["last_corr"]]),
            st["since_peak"].reshape(1), st["sym_buf"],
            cs.max_symbols(DAB_BLOCK), cs.agc_rate)
    got = W.cyclic_sync_walk(*args)
    ms = cuda_ms(lambda: W.cyclic_sync_walk(*args), reps=5)
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    t0 = time.perf_counter()
    ref = W.cyclic_sync_walk(*cpu_args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
    cases.append(_walk_case(
        "cyclic_sync_walk", "dab", [DAB_BLOCK], [DAB_BLOCK], err, 0.0, ms,
        plain_ms, DAB_BLOCK * 12 + DAB_FFT * 16 + args[5] * 4 + 32,
        DAB_BLOCK * CYCLIC_OPS_PER_SAMPLE, emits=int(ref[1]),
        ns_per_sample=ms * 1e6 / DAB_BLOCK))
    # wrong arguments raise ValueError and launch nothing
    before = {n: f.launches for n, f in kernel_fns().items()}
    f32 = torch.float32
    for what, call in (
            ("bank", lambda: W.line_sync_walk(buf, ls.bank[:64], carry[:2],
                                              torch.zeros(1, dtype=torch.bool,
                                                          device=dev), 4,
                                              0, 0, 0, 0, 0, 0)),
            ("complex64 [L, nb]", lambda: W.chroma_burst_walk(
                burst.real.contiguous(), refs, carry, 1, 1, 0, 0, 0, 0)),
            ("since", lambda: W.cyclic_sync_walk(
                rcorr, vals, args[2], args[3].to(f32), args[4], 4, 0.001)),
            ("one device", lambda: W.cyclic_sync_walk(
                rcorr, vals.cpu(), *args[2:]))):
        try:
            call()
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"a walk raised {e!r}, expected "
                                     f"{what!r}") from e
        else:
            raise AssertionError(f"a walk took bad arguments ({what})")
    if {n: f.launches for n, f in kernel_fns().items()} != before:
        raise AssertionError("a walk counted a launch it refused")
    log("the walks on CUDA: four wrong arguments raise ValueError, nothing "
        "launched")
    return cases


def phase_pipeline_identity(device="cuda"):
    """``cli run`` (WFM, 4 blocks) and ``cli bank`` (64 NFM channels, 4
    blocks) through the pipeline, against the same loops run unpipelined
    on the card (``_pipe_loop``): the WAV files byte for byte."""
    from sdrpp_tpu_torch.parallel import wideband as W

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _cli_out(["run", "--source", PIPE_CMDS["run"][0], "--mode", "wfm",
                  "--blocks", "4", "--block-size", str(BLOCK), "--out",
                  str(tmp / "run.wav")], device)
        _pipe_loop("run", tmp / "run", False, device, 4)
        res["run_equal"] = ((tmp / "run.wav").read_bytes()
                            == (tmp / "run" / "ch0.wav").read_bytes())
        offs = [float(f"{o:.1f}") for o in W.bank_offsets()]
        _cli_out(["bank", "--source", PIPE_CMDS["bank"][0],
                  "--offsets=" + ",".join(f"{o:.1f}" for o in offs),
                  "--mode", "nfm", "--blocks", "4", "--block-size",
                  str(PIPE_CMDS["bank"][1]), "--out-dir", str(tmp / "bank")],
                 device)
        _pipe_loop("bank", tmp / "plain", False, device, 4)
        res["bank_equal"] = all(
            (tmp / "bank" / f"ch{i}_{int(o):+d}Hz.wav").read_bytes()
            == (tmp / "plain" / f"ch{i}.wav").read_bytes()
            for i, o in enumerate(offs))
    log(f"pipeline identity on the card: {res}")
    if not (res["run_equal"] and res["bank_equal"]):
        raise AssertionError("the pipelined cli loops wrote other bytes than "
                             "the unpipelined loops")
    return res


def _pipe_setup(cmd, path, device):
    """A fresh source, chain, state and sink(s) for one timed loop of
    ``cmd``, as ``cli run`` (WFM) or ``cli bank`` (64 NFM channels)
    builds them: (src, block, step, state, write, close)."""
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.io.sinks import RecorderSink
    from sdrpp_tpu_torch.models.radio import RadioChannel
    from sdrpp_tpu_torch.parallel import wideband as W
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank

    spec, block = PIPE_CMDS[cmd]
    src = cli._make_source(spec)
    if cmd == "run":
        chan = RadioChannel("wfm", FS, device=device)
        sink = RecorderSink(path / "ch0.wav", 48000, channels=2)
        return src, block, chan, chan.init_state(), sink.write, sink.close
    offs = np.array([float(f"{o:.1f}") for o in W.bank_offsets()])
    bank = ScannerBank(offs, src.samplerate, mode="nfm", if_rate=48000.0,
                       bandwidth=12500.0, device=device)
    sinks = [RecorderSink(path / f"ch{i}.wav", 48000)
             for i in range(len(offs))]

    def close():
        for s in sinks:
            s.close()

    return (src, block, bank, bank.init_state(),
            lambda a: [s.write(a[i]) for i, s in enumerate(sinks)], close)


def _pipe_loop(cmd, path, piped, device, nblocks=PIPE_BLOCKS):
    """Host seconds of one ``cmd`` block loop over ``nblocks`` blocks,
    from the first read to the last sink's close, its objects built
    before the clock starts: ``cli._stream`` (the pipeline, which builds
    its pinned ring and reader thread as the cli does), or the loop
    without it (a read, ``.to(device)``, the step, ``.cpu()``, the
    write)."""
    import torch
    from sdrpp_tpu_torch import cli

    path.mkdir()
    src, block, step, state, write, close = _pipe_setup(cmd, path, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if piped:
        cli._stream(step, state, src, block, nblocks, device, write)
    else:
        for _ in range(nblocks):
            state, y = step(state, torch.from_numpy(src.read(block)).to(device))
            write(y.cpu().numpy())
    close()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def pipe_verdict(piped, plain, bound=0.05):
    """faster (slower) when the pipelined side wins (loses) at least nine
    tenths of the pairs, ties counting for neither, and the medians differ
    by more than the plain runs' own spread (their interquartile
    distance); unchanged when the medians differ by at most ``bound`` of
    the plain median and the spread is within it too; else unresolved."""
    n = len(plain)
    wins = sum(a < b for a, b in zip(piped, plain))
    losses = sum(a > b for a, b in zip(piped, plain))
    q1, q3 = np.percentile(plain, [25, 75])
    spread, med = q3 - q1, float(np.median(plain))
    diff = med - float(np.median(piped))
    if wins >= 0.9 * n and diff > spread:
        return "faster"
    if losses >= 0.9 * n and -diff > spread:
        return "slower"
    if abs(diff) <= bound * med and spread <= bound * med:
        return "unchanged"
    return "unresolved"


def phase_pipeline_timing(device="cuda"):
    """``cli run`` and ``cli bank``'s block loops timed pipelined against
    unpipelined over the same span (the loop only, objects built first)
    and the same PIPE_BLOCKS blocks: PIPE_PAIRS pairs a command, the side
    that runs first alternating; ``pipe_verdict`` reads the pairs. Every
    pair's files must be byte-equal. The source's read alone (PIPE_READS
    blocks) is timed too: the plain loop waits for it, the pipeline
    overlaps it."""
    from sdrpp_tpu_torch import cli

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for cmd in ("run", "bank"):
            spec, block = PIPE_CMDS[cmd]
            src = cli._make_source(spec)
            t0 = time.perf_counter()
            for _ in range(PIPE_READS):
                src.read(block)
            r = {"block": block, "blocks": PIPE_BLOCKS,
                 "read_s_per_block": (time.perf_counter() - t0) / PIPE_READS,
                 "piped_s": [], "plain_s": [], "equal": True}
            for k in range(PIPE_PAIRS):
                order = (True, False) if k % 2 == 0 else (False, True)
                for piped in order:
                    side = "piped" if piped else "plain"
                    dt = _pipe_loop(cmd, tmp / f"{cmd}{k}_{side}", piped,
                                    device)
                    r[f"{side}_s"].append(dt)
                r["equal"] &= all(
                    f.read_bytes() == (tmp / f"{cmd}{k}_plain" / f.name)
                    .read_bytes()
                    for f in sorted((tmp / f"{cmd}{k}_piped").glob("*.wav")))
            ratio = [a / b for a, b in zip(r["piped_s"], r["plain_s"])]
            r["ratio"] = ratio
            r["piped_s_per_block"] = float(np.median(r["piped_s"])) / PIPE_BLOCKS
            r["plain_s_per_block"] = float(np.median(r["plain_s"])) / PIPE_BLOCKS
            r["verdict"] = pipe_verdict(r["piped_s"], r["plain_s"])
            res[cmd] = r
            log(f"pipeline timing, cli {cmd} ({PIPE_BLOCKS} blocks of "
                f"{block}, {PIPE_PAIRS} pairs): pipelined {r['piped_s']} s, "
                f"plain {r['plain_s']} s, ratio {ratio}, source read "
                f"{r['read_s_per_block']:.4f} s/block: {r['verdict']}")
    if not all(r["equal"] for r in res.values()):
        raise AssertionError("pipelined and plain timed loops wrote other "
                             "bytes")
    return res


# run from the root of a tree (the parent's or this one) in a subprocess,
# through the package's public entry points only: argv[1] is a JSON object
# of the settings; prints one "AB {...}" line
AB_SCRIPT = r"""
import inspect, json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from sdrpp_tpu_torch.decoders.meteor_lrpt import MeteorLRPTDecoder
from sdrpp_tpu_torch.models.channel import RxVFO
from sdrpp_tpu_torch.models.lrpt import CCSDS_CONV_POLYS
from sdrpp_tpu_torch.ops import fec_kernels as FK
from sdrpp_tpu_torch.ops import fir_kernels as DK
from sdrpp_tpu_torch.ops.fec import ConvCode
from sdrpp_tpu_torch.ops.resample import decim_plan

a = json.loads(sys.argv[1])
fs, block, blocks = a["fs"], a["block"], a["blocks"]


def events_ms(fn, reps):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# seeded 72 ksym/s QPSK at the VFO offset plus noise, made in bulk
rng = np.random.default_rng(a["seed"])
n = blocks * block
k = (np.arange(n) * (72000.0 / fs)).astype(np.int64)
sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, k[-1] + 1)))
iq = (sym[k] * np.exp(2j * np.pi * a["offset"] / fs * np.arange(n))
      + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
iq = iq.astype(np.complex64)
vfo = RxVFO(fs, a["if"], bandwidth=a["if"], offset=a["offset"], device="cuda")
dec = MeteorLRPTDecoder(a["if"], device="cuda")
vs, ms = vfo.init_state(), []
for b in range(blocks):
    x = torch.from_numpy(iq[b * block:(b + 1) * block]).to("cuda")
    torch.cuda.synchronize()

    def step():
        global vs
        vs, y = vfo(vs, x)
        dec.process(y)

    ms.append(events_ms(step, 1))
# the loop scans: the kernel phase's bodies and inputs (contiguous,
# time-major: [n] streams go to single_scan)
from sdrpp_tpu_torch.ops import scans_kernels as K
bodies = {key: getattr(K, ctor)(*args)
          for key, (ctor, args) in a["bodies"].items()}
data = np.load(a["loop_inputs"])
loops = {}
for i, (label, key) in enumerate(a["loops"]):
    body = bodies[key]
    ins = [torch.from_numpy(data[f"s{i}_{j}"]).cuda()
           for j in range(body.nstreams)]
    st = torch.from_numpy(data[f"seed{i}"]).cuda()
    fn = K.single_scan if ins[0].dim() == 1 else K.lane_scan
    fn(body, st, ins)
    torch.cuda.synchronize()
    loops[label] = events_ms(lambda: fn(body, st, ins), 20)
g = torch.Generator(device="cuda").manual_seed(3)
fir = {}
for rows, n, ratio in a["cases"]:
    r, taps = decim_plan(ratio)[0]
    w = torch.from_numpy(taps.astype(np.float32)).cuda()
    x = torch.randn((rows, n), generator=g, dtype=torch.complex64,
                    device="cuda")
    tail = torch.zeros((rows, taps.shape[0] - 1), dtype=torch.complex64,
                       device="cuda")
    DK.decimating_fir(tail, x, w, r)
    torch.cuda.synchronize()
    fir[f"[{rows}, {n}] /{r}"] = events_ms(
        lambda: DK.decimating_fir(tail, x, w, r), 20)
# the Viterbi entries on the pass case's uint8 stream and window starts:
# a tree whose ACS takes the windows gathered ([B, T, R] float32, as its
# decode_soft_stream gathers them) gets them so, outside the timing
vit = np.load(a["viterbi_inputs"])
code = ConvCode(2, 7, CCSDS_CONV_POLYS, device="cuda")
expected = torch.from_numpy(code.reg_outputs.astype(np.float32) * 255).cuda()
soft = torch.from_numpy(vit["soft"]).cuda()
starts = torch.from_numpy(vit["starts"]).cuda()
T = int(vit["T"])
if "starts" in inspect.signature(FK.viterbi_acs_batched).parameters:
    acs = lambda: FK.viterbi_acs_batched(soft, starts, T, expected)
else:
    win = soft[starts.long()[:, None] + torch.arange(T, device="cuda")].float()
    acs = lambda: FK.viterbi_acs_batched(win, expected)
dec = acs()
torch.cuda.synchronize()
viterbi = {"acs_ms": events_ms(acs, 10),
           "traceback_ms": events_ms(
               lambda: FK.viterbi_traceback_batched(dec), 10)}
# finalize's viterbi_s at the decoding rotation: decode_soft_stream on the
# pass's soft bits, host clock (it ends in the copy of the bits to the
# host), median of 5 after a warm call
u8 = vit["pass_u8"]
code.decode_soft_stream(u8)
secs = []
for _ in range(5):
    t0 = time.perf_counter()
    code.decode_soft_stream(u8)
    secs.append(time.perf_counter() - t0)
viterbi["viterbi_s"] = float(np.median(secs))
print("AB " + json.dumps({"meteor_block_ms": float(np.median(ms[1:])),
                          "decimating_fir_ms": fir, "loop_scan_ms": loops,
                          "viterbi": viterbi}))
"""


def phase_ab(block: int, loop_inputs: dict, viterbi_inputs: dict):
    """The A/B against the parent tree, when one is unpacked at AB_PARENT
    (``git archive <parent> | tar -x -C _scratch/parent``): the meteor
    block time (RxVFO + MeteorLRPTDecoder.process on seeded QPSK, median
    of blocks 2..AB_BLOCKS of the meteor path's ``block`` samples, CUDA
    events), decimating_fir at every complex FIR_CASES shape, the loop
    scans on ``loop_inputs`` (phase_kernels' path cases: label -> (body,
    contiguous time-major streams, seed), handed over in an .npz with the
    bodies' constructor arguments; CUDA events, 20 calls), both Viterbi
    entries on the pass case's stream and starts (``viterbi_inputs``;
    CUDA events, 10 calls) and finalize's Viterbi (decode_soft_stream on
    the 30-s pass's soft bits, ``viterbi_inputs["pass_u8"]``; host clock),
    each tree in its own process through the package's public entry
    points, in the order parent, change, change, parent. Returns None
    without a parent tree."""
    root = Path(__file__).resolve().parent
    parent = root / AB_PARENT
    if not (parent / "sdrpp_tpu_torch").is_dir():
        log(f"ab: no parent tree at {AB_PARENT}; skipped")
        return None
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {}
        for i, (streams, seed) in enumerate(v[1:] for v in
                                            loop_inputs.values()):
            arrays.update({f"s{i}_{j}": x for j, x in enumerate(streams)})
            arrays[f"seed{i}"] = seed
        npz = str(Path(tmp) / "loop_inputs.npz")
        np.savez(npz, **arrays)
        vit_npz = str(Path(tmp) / "viterbi_inputs.npz")
        np.savez(vit_npz, **viterbi_inputs)
        settings = json.dumps({
            "cases": [[rows, n, ratio] for _, rows, n, ratio, dt in FIR_CASES
                      if dt == "c64"],
            "fs": METEOR_FS, "if": METEOR_IF, "offset": METEOR_OFFSET,
            "block": block, "blocks": AB_BLOCKS, "seed": 5,
            "bodies": loop_body_args(), "loop_inputs": npz,
            "viterbi_inputs": vit_npz,
            "loops": [[label, v[0]] for label, v in loop_inputs.items()]})
        runs = [ab_run(name, tree, settings)
                for name, tree in (("parent", parent), ("change", root),
                                   ("change", root), ("parent", parent))]
    res = {"order": [r["tree"] for r in runs], "runs": runs}
    for tree in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == tree]
        res[tree] = {"meteor_block_ms": [r["meteor_block_ms"] for r in mine]}
        for part in ("decimating_fir_ms", "loop_scan_ms", "viterbi"):
            res[tree][part] = {k: [r[part][k] for r in mine]
                               for k in mine[0][part]}
    log("ab " + json.dumps({k: res[k] for k in ("order", "parent",
                                                  "change")}))
    return res


def ab_run(name: str, tree: Path, settings: str) -> dict:
    """One A/B run: AB_SCRIPT from the root of ``tree``."""
    proc = subprocess.run([sys.executable, "-c", AB_SCRIPT, settings],
                          cwd=tree, capture_output=True, text=True,
                          timeout=600)
    line = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
    if proc.returncode or not line:
        raise AssertionError(f"ab: the {name} run failed:\n"
                             f"{proc.stderr[-3000:]}")
    return {"tree": name, **json.loads(line[-1][3:])}


def m17_code(dev):
    from sdrpp_tpu_torch.decoders import m17_frame as mf
    from sdrpp_tpu_torch.ops.fec import ConvCode

    return ConvCode(2, 5, mf.CONV_POLYS, device=dev)


def m17_frame_soft(rng, kind: str, flips: int = 0) -> np.ndarray:
    """[T, 2] uint8 soft bits of one M17 frame as the frame layer hands
    them to the K = 5 decode: "lsf" (240 bits, P1-punctured, 244 steps) or
    "payload" (144 bits, P2, 148 steps), ``flips`` hard bit errors before
    the depuncture, 128 at every punctured position."""
    from sdrpp_tpu_torch.decoders import m17_frame as mf

    nbits, pattern, size = ((240, mf.PUNCT_P1, mf.ENCODED_LSF_SIZE)
                            if kind == "lsf" else
                            (144, mf.PUNCT_P2, mf.ENCODED_PAYLOAD_SIZE))
    sent = mf._puncture(mf._conv_encode_terminated(
        rng.integers(0, 2, nbits)), pattern).copy()
    if flips:
        sent[rng.choice(len(sent), flips, replace=False)] ^= 1
    soft = mf._depuncture_soft(sent, pattern, size)
    return soft.astype(np.uint8).reshape(-1, 2)


def kgsstv_frame_soft(rng) -> np.ndarray:
    """[62, 2] float32 soft bits as the KG-STV deframer makes them: 108
    noisy +-1 symbols to clip((v + 1) * 128, 0, 255) (not integers), then
    16 erasures of 128."""
    from sdrpp_tpu_torch.decoders import kg_sstv as kg

    sym = kg.KGSSTVDeframer.encode_frame(
        bytes(rng.integers(0, 256, 7).astype(np.uint8)))[len(kg.SYNC_WORD):]
    v = sym + rng.normal(0, 0.3, sym.size)
    soft = np.clip((v + 1.0) * 128.0, 0.0, 255.0)
    soft = np.concatenate([soft, np.full(16, 128.0)]).astype(np.float32)
    return soft.reshape(-1, 2)


def decode_viterbi_cases(dev, rng):
    """The Viterbi cases of the decode paths (label, path, soft, starts, T,
    expected): M17's K = 5 LSF (244 steps) and stream payload (148) frames
    as uint8 soft bits with erasures, all-128 ties on the LSF's length, and
    KG-STV's K = 7 frame (62 steps) as float32 soft bits."""
    from sdrpp_tpu_torch.decoders import kg_sstv as kg
    from sdrpp_tpu_torch.ops.fec import ConvCode

    m17, kgc = m17_code(dev), ConvCode(2, 7, kg.CONV_POLYS, device=dev)
    one = np.zeros(1, np.int32)
    return [
        ("m17 lsf", "m17", m17_frame_soft(rng, "lsf", 8), one, 244,
         m17._expected),
        ("m17 payload", "m17", m17_frame_soft(rng, "payload", 4), one, 148,
         m17._expected),
        ("m17 ties", None, np.full((244, 2), 128, np.uint8), one, 244,
         m17._expected),
        ("kgsstv", "kgsstv", kgsstv_frame_soft(rng), one, 62, kgc._expected),
    ]


def viterbi_state_refusals(dev):
    """A 32-state code decodes on the card (ConvCode at order 6, one launch
    of each entry), and malformed state counts raise ValueError and launch
    nothing: expected rows that are not 2S for a power of two S, a
    traceback of 48 states, words of the wrong shape for 256 states."""
    import torch
    from sdrpp_tpu_torch.ops import fec as F
    from sdrpp_tpu_torch.ops import fec_kernels as FK

    code = F.ConvCode(2, 6, F.CONV_R12_6, device=dev)
    acs, tb = FK.viterbi_acs_batched, FK.viterbi_traceback_batched
    msg = np.random.default_rng(16).integers(0, 256, 64).astype(np.uint8)
    soft = np.unpackbits(code.encode(msg))[:code.encode_len_bits(64)] * 255
    before = (acs.launches, tb.launches, acs.launches_general,
              tb.launches_general)
    got = np.packbits(code.decode_soft_np(soft.astype(np.float32)))
    after = (acs.launches, tb.launches, acs.launches_general,
             tb.launches_general)
    if not np.array_equal(got, msg) or after != (before[0] + 1,
                                                 before[1] + 1, *before[2:]):
        raise AssertionError("the 32-state code did not decode with one "
                             "launch of each Viterbi entry")
    before = after
    st = torch.zeros((100, 2), dtype=torch.uint8, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    bad = [(acs, (st, one, 10, code._expected[:48])),
           (acs, (st, one, 10, torch.zeros((130, 2), device=dev))),
           (lambda d: tb(d, num_states=48),
            (torch.zeros((1, 10), dtype=torch.int64, device=dev),)),
           (lambda d: tb(d, num_states=256),
            (torch.zeros((1, 10), dtype=torch.int64, device=dev),))]
    for fn, args in bad:
        try:
            fn(*args)
        except ValueError as e:
            if "16384" not in str(e) and "[B, T, 4]" not in str(e):
                raise AssertionError(f"a malformed Viterbi call raised "
                                     f"{e!r}") from e
        else:
            raise AssertionError("a malformed Viterbi call ran on the card")
    if (acs.launches, tb.launches, acs.launches_general,
            tb.launches_general) != before:
        raise AssertionError("a refused Viterbi call counted a launch")
    log(f"viterbi on CUDA: a 32-state code decodes its {len(msg)} bytes; "
        f"{len(bad)} malformed state counts "
        f"raise ValueError and launch nothing")


def fec_path_soft(order: int) -> tuple:
    """The fec paths' seeded message (FEC_MSG_BYTES) and its soft bits for
    ``ConvCode(2, order)`` (CONV_R12_9 / CONV_R12_6): the port's encode,
    0 -> 0 and 1 -> 255, N(0, FEC_SIGMA) noise, rounded and clipped to
    uint8 -> (message, [T, 2] uint8 soft bits, code polynomials)."""
    from sdrpp_tpu_torch.ops import fec as F

    polys = {9: F.CONV_R12_9, 6: F.CONV_R12_6}[order]
    code = F.ConvCode(2, order, polys, device="cpu")
    rng = np.random.default_rng(90 + order)
    msg = rng.integers(0, 256, FEC_MSG_BYTES).astype(np.uint8)
    bits = np.unpackbits(code.encode(msg))[:code.encode_len_bits(len(msg))]
    soft = np.clip(np.round(bits * 255.0 + rng.normal(0, FEC_SIGMA,
                                                      bits.size)), 0, 255)
    return msg, soft.astype(np.uint8).reshape(-1, 2), polys


def phase_kernels_fec(dev, k9_soft, k6_soft):
    """The general Viterbi kernels (every S but the tuned 16 and 64 at R <=
    4) against their plain versions, bit-exact: every order 2 to 15 (S = 2
    ... 16384) at R = 2 on uint8 and on float32 soft bits, FEC_T steps
    from step 0 (B5's single stream); R = 3 and R = 6 at S = 256 and R = 5
    at S = 16 (the warp kernel of R > 4); uint8 over FEC_RENORM_T steps,
    two of the CTA kernel's renormalisations, at S = 128, 256 (a thread a
    state), 2048, 4096, 8192, 16384 (2 to 16 states a thread) and R = 6
    at S = 256 (expected rows read through the cache); a
    [FEC_WINDOWS, 4288] windowed launch at S = 32 (B6); the fec paths'
    launches at their shapes, k9's [1, 2097162, 2] (held on its first and
    last FEC_HELD steps) and k6's [513, 4288, 2] windows."""
    from sdrpp_tpu_torch.ops import fec as F

    rng = np.random.default_rng(15)
    one = np.zeros(1, np.int32)
    cases = []
    for order in range(2, 16):
        code = F.ConvCode(2, order, fec_polys(2, order), device=dev)
        u8 = viterbi_stream(rng, code, FEC_T)
        cases.append((f"k{order} u8", None, u8, one, FEC_T, code._expected))
        f32 = (u8 + rng.uniform(-0.5, 0.5, u8.shape)).astype(np.float32)
        cases.append((f"k{order} f32", None, f32, one, FEC_T,
                      code._expected))
    for rate, order in ((3, 9), (6, 9), (5, 5)):
        code = F.ConvCode(rate, order, fec_polys(rate, order), device=dev)
        cases.append((f"k{order} rate {rate}", None,
                      viterbi_stream(rng, code, FEC_T), one, FEC_T,
                      code._expected))
    for rate, order in ((2, 8), (2, 9), (2, 12), (2, 13), (2, 14), (2, 15),
                        (6, 9)):
        code = F.ConvCode(rate, order, fec_polys(rate, order), device=dev)
        cases.append((f"k{order} rate {rate} renormalised", None,
                      viterbi_stream(rng, code, FEC_RENORM_T), one,
                      FEC_RENORM_T, code._expected))
    k6 = F.ConvCode(2, 6, F.CONV_R12_6, device=dev)
    win_total = FEC_WINDOWS * VIT_L - 1000
    cases.append(("k6 windows", None, viterbi_stream(rng, k6, win_total),
                  viterbi_starts(win_total), VIT_T, k6._expected))
    cases.append(("k6 path windows", "fec_k6", k6_soft,
                  viterbi_starts(k6_soft.shape[0]), VIT_T, k6._expected))
    results = []
    for label, path, soft_np, starts_np, T, expected in cases:
        results += viterbi_case(dev, label, path, soft_np, starts_np, T,
                                expected)
    k9 = F.ConvCode(2, 9, F.CONV_R12_9, device=dev)
    return results + viterbi_case(dev, "k9 path", "fec_k9", k9_soft, one,
                                  k9_soft.shape[0], k9._expected,
                                  held_steps=FEC_HELD, reps=3)


def fec_polys(rate: int, order: int) -> tuple:
    """libcorrect's rate-1/2 polynomials where it names some (orders 6 to
    9), else seeded ones of the order (top and bottom bits set)."""
    from sdrpp_tpu_torch.ops import fec as F

    named = {6: F.CONV_R12_6, 7: F.CONV_R12_7, 8: F.CONV_R12_8,
             9: F.CONV_R12_9}
    if rate == 2 and order in named:
        return named[order]
    rng = np.random.default_rng(100 * rate + order)
    return tuple(int(rng.integers(0, 1 << order)) | (1 << (order - 1)) | 1
                 for _ in range(rate))


def phase_fec(dev, k9, k6):
    """The fec paths through ConvCode on the card, the counts reset before
    and read after each: fec_k9, ``ConvCode(2, 9, CONV_R12_9)`` (256
    states) over FEC_MSG_BYTES of seeded message, 2,097,162 trellis steps
    of uint8 soft bits, through ``decode_soft_np`` (B5 then B7) and
    ``decode_soft_stream`` (the exact decode at S = 256, as the JAX package
    takes it on a TPU); fec_k6, ``ConvCode(2, 6, CONV_R12_6)`` (32 states)
    through ``decode_soft_stream``'s windows (B6 then B7). Every decode
    must return the message exactly. Host seconds of each decode."""
    import torch
    from sdrpp_tpu_torch.ops import fec as F

    out = {}
    for name, order, (msg, soft, polys), decodes in (
            ("fec_k9", 9, k9, ("decode_soft_np", "decode_soft_stream")),
            ("fec_k6", 6, k6, ("decode_soft_stream",))):
        code = F.ConvCode(2, order, polys, device=dev)
        flat = soft.reshape(-1)
        code.decode_soft_stream(flat[:2 * 20000])  # first use: the builds
        torch.cuda.synchronize()
        reset_counts()
        res = {"steps": int(soft.shape[0]), "message_bytes": len(msg)}
        for fn in decodes:
            t0 = time.perf_counter()
            bits = getattr(code, fn)(flat)
            secs = time.perf_counter() - t0
            got = np.packbits(bits)[:len(msg)]
            wrong = int((got != msg).sum())
            res[fn] = {"seconds": secs, "wrong_bytes": wrong}
            log(f"{name} {fn}: {soft.shape[0]} steps of {code.num_states} "
                f"states in {secs:.3f} s (host clock), {wrong} of "
                f"{len(msg)} message bytes wrong")
            if wrong or len(bits) != 8 * len(msg):
                raise AssertionError(f"{name} {fn} did not return the "
                                     f"message")
        res["launches"] = read_counts(name)
        res["decision_bytes"] = int(soft.shape[0] * max(code.num_states, 64)
                                    // 8)
        log(f"{name}: decision words {res['decision_bytes'] / 1e6:.1f} MB "
            f"a decode")
        out[name] = res
    return out


def phase_rs_erasures(dev):
    """ReedSolomon.decode_with_erasures on RS_BLOCKS CCSDS blocks (RS(255,
    223), fcr 112, gap 11) with every (f, e) at the limit 2e + f = 32 in
    turn, plus one block beyond it (f = 31, e = 1), on the card and on
    the CPU: equal bytes and ok flags; every block at the limit decoded to
    its message, the one beyond it not ok."""
    import torch
    from sdrpp_tpu_torch.ops import fec as F

    rng = np.random.default_rng(23)
    rs = F.ReedSolomon(F.RS_CCSDS, 112, 11, 32, device=dev)
    grid = [(32 - 2 * e, e) for e in range(17)]
    cases = [grid[b % len(grid)] for b in range(RS_BLOCKS - 1)] + [(31, 1)]
    msgs = rng.integers(0, 256, (RS_BLOCKS, rs.msg_len)).astype(np.uint8)
    blocks = np.stack([rs.encode(m) for m in msgs])
    pos = np.zeros((RS_BLOCKS, 32), np.int32)
    for b, (f, e) in enumerate(cases):
        hit = rng.choice(255, f + e, replace=False)
        blocks[b, hit] ^= rng.integers(1, 256, f + e).astype(np.uint8)
        pos[b, :f] = hit[:f]
    counts = np.array([f for f, _ in cases], np.int32)
    args = [torch.from_numpy(a) for a in (blocks, pos, counts)]
    card = rs.decode_with_erasures(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: rs.decode_with_erasures(*(a.to(dev) for a in args)),
                 reps=3)
    cpu_rs = F.ReedSolomon(F.RS_CCSDS, 112, 11, 32, device="cpu")
    cpu = cpu_rs.decode_with_erasures(*args)
    equal = (torch.equal(card[0].cpu(), cpu[0])
             and torch.equal(card[1].cpu(), cpu[1]))
    ok = card[1].cpu().numpy()
    right = int((card[0].cpu().numpy()[:-1] == msgs[:-1]).all(1).sum())
    log(f"rs erasures: {RS_BLOCKS} blocks, {len(grid)} (f, e) at 2e + f = "
        f"32, card {ms:.2f} ms a batch; {right} of {RS_BLOCKS - 1} decoded "
        f"to their messages, beyond the limit ok={bool(ok[-1])}, card "
        f"{'equal to' if equal else 'DIFFERS from'} the CPU")
    if not (equal and ok[:-1].all() and right == RS_BLOCKS - 1
            and not ok[-1]):
        raise AssertionError("RS erasure decoding failed on the card")
    return {"blocks": RS_BLOCKS, "ms": ms, "card_vs_cpu_equal": equal}


def phase_dsp_lib(dev, wide_x):
    """The rest of the DSP library at the receive widths, two
    DSP_BLOCK-sample blocks at 2.4 Msps with the state carried, the card
    against the CPU: DecimatingFIR /8 with the plan's real taps (the
    decimating-FIR kernel) and with complex band-pass taps (the strided
    conv1d), the complex-tap PolyphaseResampler 3/25, and
    CarrierTrackingPLL on a pilot DSP_PILOT_HZ off (one stream,
    single_scan) and on DSP_PLL_LANES pilots at once (a lead shape,
    lane_scan), each held on each block's first DSP_PLL_HELD samples, the
    CPU's second block from the card's carried state; then
    FFTPowerDecimator(256, fft_len=2^20) against PowerDecimator (the
    cascade) on two blocks of the wideband stream, both timed.
    decimating_fir, single_scan and lane_scan launches must rise."""
    import torch
    from sdrpp_tpu_torch.ops import fir as FR
    from sdrpp_tpu_torch.ops import resample as RS
    from sdrpp_tpu_torch.ops import scans as SC
    from sdrpp_tpu_torch.ops import taps as TP
    from sdrpp_tpu_torch.utils.blocks import state_from_numpy, state_to_numpy

    rng = np.random.default_rng(31)
    n = DSP_BLOCK
    x = (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n)) \
        .astype(np.complex64)
    cplx = TP.band_pass(50e3, 150e3, 20e3, FS, complex_taps=True) \
        .astype(np.complex64)
    t = np.arange(2 * n)
    pilot = (np.exp(1j * (2 * np.pi * DSP_PILOT_HZ * t / FS + 0.4))
             * (1.0 + 0.1 * rng.standard_normal(2 * n))).astype(np.complex64)
    lane = np.arange(DSP_PLL_LANES)[:, None]
    pilots = (np.exp(1j * (2 * np.pi * DSP_PILOT_HZ * (lane + 1) * t / FS
                           + 0.4 + lane))
              * (1.0 + 0.1 * rng.standard_normal((DSP_PLL_LANES, 2 * n)))
              ).astype(np.complex64)
    blocks = {
        "decimating_fir /8 real": (lambda d: FR.DecimatingFIR(
            RS.decim_plan(8)[0][1], 8, device=d), x, n),
        "decimating_fir /8 complex taps": (lambda d: FR.DecimatingFIR(
            cplx, 8, device=d), x, n),
        "polyphase 3/25 complex taps": (lambda d: RS.PolyphaseResampler(
            3, 25, cplx * np.float32(3), device=d), x, n),
        "carrier_tracking_pll": (lambda d: SC.CarrierTrackingPLL(
            DSP_PLL_BW, device=d), pilot, DSP_PLL_HELD),
        f"carrier_tracking_pll [{DSP_PLL_LANES}, n]": (
            lambda d: SC.CarrierTrackingPLL(
                DSP_PLL_BW, lead_shape=(DSP_PLL_LANES,), device=d), pilots,
            DSP_PLL_HELD),
    }
    out = {}
    torch.cuda.synchronize()
    reset_counts()
    for name, (make, sig, held) in blocks.items():
        blk, cpu = make(dev), make("cpu")
        st = blk.init_state()
        ys, secs = [], []
        for k in range(2):
            xb = torch.from_numpy(np.ascontiguousarray(
                sig[..., k * n:(k + 1) * n])).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st_in = st
            st, y = blk(st, xb)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            # the CPU from the card's state before this block, on its
            # first `held` samples (causal blocks: the prefix's outputs
            # depend on it alone)
            m = held - held % 600  # a multiple of every decimation here
            cs = state_from_numpy(state_to_numpy(st_in), "cpu")
            _, yc = cpu(cs, torch.from_numpy(
                np.ascontiguousarray(sig[..., k * n:k * n + m])))
            ys.append((y.cpu().numpy()[..., :yc.shape[-1]], yc.numpy()))
        err = max(float(np.abs(a - b).max()) for a, b in ys)
        scale = max(float(np.abs(b).max()) for _, b in ys)
        tol = DSP_TOL * max(scale, 1.0)
        log(f"dsp {name}: 2 x {n} samples, {secs[1] * 1e3:.2f} ms a block "
            f"(host clock), card vs CPU max abs err {err:.3g} (tol "
            f"{tol:.3g})")
        if not err <= tol:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
        out[name] = {"max_abs_err": err, "tol": tol, "block_s": secs}
    # FFTPowerDecimator against the cascade on the wideband stream
    fd = RS.FFTPowerDecimator(256, fft_len=1 << 20, device=dev)
    pd = RS.PowerDecimator(256, device=dev)
    P = 16 * fd.block_multiple
    wn = wide_x.shape[-1]
    wb = [wide_x[:P], torch.cat([wide_x[P:], wide_x[:2 * P - wn]])]
    sf, sp = fd.init_state(), pd.init_state()
    yf, yp = [], []
    for b in wb:
        sf, a = fd(sf, b)
        sp, c = pd(sp, b)
        yf.append(a)
        yp.append(c)
    yf, yp = torch.cat(yf), torch.cat(yp)
    err = float((yf - yp).abs().max())
    scale = float(yp.abs().max())
    fft_ms = cuda_ms(lambda: fd(sf, wb[1]), reps=5)
    cas_ms = cuda_ms(lambda: pd(sp, wb[1]), reps=5)
    tol = FFT_DECIM_TOL * max(scale, 1.0)
    log(f"dsp FFTPowerDecimator(256, 2^20) on 2 x {P} wideband samples: "
        f"{fft_ms:.3f} ms a block, PowerDecimator {cas_ms:.3f} ms "
        f"(CUDA events), max abs err {err:.3g} (tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError("FFTPowerDecimator disagrees with the cascade")
    out["fft_power_decimator"] = {"ms": fft_ms, "cascade_ms": cas_ms,
                                  "max_abs_err": err, "tol": tol,
                                  "samples": P}
    out["launches"] = read_counts("dsp_lib")
    return out


def phase_kernels_decode_mm(dev):
    """mm_symbols at the decode paths' rows (one [1, 7 + 262144] row a
    262,144-sample block, cli._auto_block at each rate), against its plain
    version on the whole row: the float variant at Falcon 9's 1.68 samples
    a symbol (the FM discriminator's output of 3.5714 MBaud NRZ at 6 Msps),
    at M17's and KG-STV's 10 (4FSK / binary FSK after the RRC), and the
    complex variant at HRPT's 2.2542 (BPSK NRZ after the RRC, a carrier
    phase). Masks and offsets equal, symbols and state within KERNEL_TOL of
    the largest symbol; the walker's clock64 cycles a symbol."""
    import torch
    from sdrpp_tpu_torch.decoders import falcon9 as f9
    from sdrpp_tpu_torch.decoders import hrpt
    from sdrpp_tpu_torch.decoders import kg_sstv as kg
    from sdrpp_tpu_torch.decoders import m17_frame as mf
    from sdrpp_tpu_torch.ops import clock_recovery_kernels as MK
    from sdrpp_tpu_torch.ops import taps as taps_mod
    from sdrpp_tpu_torch.ops.clock_recovery import MMClockRecovery

    rng = np.random.default_rng(8)
    n = DECODE_BLOCK
    results = []

    def held(symbols, sps, fs, rrc=None):
        y = symbols[(np.arange(n) / sps).astype(np.int64)]
        if rrc is not None:
            taps = taps_mod.root_raised_cosine_rate(31, rrc, fs / sps, fs)
            y = np.convolve(y, taps, mode="same")
        return y

    cases = []
    # Falcon 9: FM discriminator output of NRZ bits (rad / deviation)
    sps = F9_FS / f9.Falcon9Decoder.BAUDRATE
    bits = rng.choice([-1.0, 1.0], int(n / sps) + 2)
    ph = np.cumsum(2 * np.pi * f9.Falcon9Decoder.DEVIATION
                   * held(bits, sps, F9_FS) / F9_FS)
    iq = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    d = np.angle(iq[1:] * np.conj(iq[:-1]))
    x = np.concatenate([[0.0], d]) * F9_FS / (2 * np.pi
                                              * f9.Falcon9Decoder.DEVIATION)
    cases.append(("falcon9", "float", x.astype(np.float32),
                  MMClockRecovery(sps, 0.01 ** 2 / 4.0, 0.01, 100e-6,
                                  complex_input=False, device=dev)))
    # HRPT: BPSK NRZ through the RRC (beta 0.6), a carrier phase
    sps = HRPT_FS / hrpt.SYMBOL_RATE
    y = held(rng.choice([-1.0, 1.0], int(n / sps) + 2), sps, HRPT_FS, 0.6)
    y = y * np.exp(0.3j) + 0.05 * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    cases.append(("hrpt", "complex", y.astype(np.complex64),
                  MMClockRecovery(sps, (0.01 ** 2) / 4.0, 0.01, 0.005,
                                  complex_input=True, device=dev)))
    # M17 (4FSK levels) and KG-STV (binary), 10 samples a symbol after the
    # RRC, in noise
    for path, fs, baud, beta, levels, og in (
            ("m17", M17_FS, mf.M17_BAUDRATE, mf.M17_RRC_ALPHA,
             [-1.0, -1 / 3, 1 / 3, 1.0], 1e-6),
            ("kgsstv", KG_FS, kg.BAUDRATE, kg.RRC_ALPHA, [-1.0, 1.0], 1e-6)):
        sps = fs / baud
        y = held(rng.choice(levels, int(n / sps) + 2), sps, fs, beta)
        y = y / np.abs(y).max() + 0.02 * rng.standard_normal(n)
        cases.append((path, "float", y.astype(np.float32),
                      MMClockRecovery(sps, og, 0.01, 0.01,
                                      complex_input=False, device=dev)))
    for path, body, x, mm in cases:
        st = mm.init_state()
        buf = torch.cat([st["tail"], torch.from_numpy(x).to(dev)])[None]
        kf = 10 if mm.complex_input else 3
        fst = torch.zeros((1, kf), dtype=torch.float32, device=dev)
        fst[0, 1] = st["freq"]
        a = (buf, st["offset"].reshape(1), fst, mm._bank, mm.max_symbols(n),
             mm.mu_gain, mm.omega_gain, mm.min_freq, mm.max_freq)
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)
        got = MK.mm_symbols(*a, cycles=cycles)
        torch.cuda.synchronize()
        warm(lambda: MK.mm_symbols(*a))
        ms = cuda_ms(lambda: MK.mm_symbols(*a), reps=5)
        ref = {}
        plain_ms = cuda_ms(lambda: ref.setdefault(
            "r", MK.mm_symbols_plain(*a)), reps=1)
        want = ref["r"]
        exact = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[3] - want[3]).abs().max()))
        tol = KERNEL_TOL * float(want[0].abs().max())
        nsym = int(got[1].sum())
        cps = int(cycles[0]) / nsym
        shape = list(buf.shape)
        bms, bby = mm_bound(buf, mm._bank, got[0])
        log(f"kernel mm_symbols[{body}] {shape} ({path}, {mm.omega:.4f} "
            f"samples a symbol): {nsym} symbols, masks and offsets "
            f"{'equal' if exact else 'DIFFER'}, max abs err {err:.3g} (tol "
            f"{tol:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bms:.5f} ms ({bby}); walker {cps:.1f} cycles per symbol "
            f"(clock64)")
        if not (exact and err <= tol):
            raise AssertionError(f"mm_symbols[{body}] at the {path} row "
                                 f"disagrees with its plain version")
        results.append(dict(entry="mm_symbols", body=body, shape=shape,
                            plain_shape=shape, path=path, max_abs_err=err,
                            tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=bby, library_ms=None, symbols=nsym,
                            cycles_per_symbol=cps))
    return results


# ---------------------------------------------------------------------------
# the digital decode paths (cli decode m17|hrpt|falcon9|kgsstv)
# ---------------------------------------------------------------------------

def _bpsk_hold(bits, sps, n, start=0):
    """NRZ +-1 of ``bits`` held ``sps`` samples, samples [start, start+n)."""
    idx = ((start + np.arange(n)) / sps).astype(np.int64)
    return 2.0 * bits[np.minimum(idx, len(bits) - 1)] - 1.0


def hrpt_pass(seed: int = 11, noise: float = 0.0):
    """HRPT_FRAMES seeded minor frames (spacecraft HRPT_SC, frame numbers
    counting, random words) as Manchester BPSK at 3 Msps after
    HRPT_LEAD_SYMS random symbols: a carrier phase of 0.3 rad,
    HRPT_CARRIER_HZ off, and complex noise of ``noise`` a component;
    padded to whole DECODE_BLOCKs. Returns (words [F, 11090], iq
    complex64)."""
    from sdrpp_tpu_torch.decoders import hrpt

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1024, (HRPT_FRAMES, hrpt.WORDS_PER_FRAME)
                         ).astype(np.int32)
    words[:, :6] = hrpt.SYNC_WORDS
    words[:, 6] = (HRPT_SC << 2) | (np.arange(HRPT_FRAMES) % 4)
    bits = np.unpackbits(words.astype(">u2").view(np.uint8).reshape(-1, 2),
                         axis=1)[:, 6:].reshape(-1)
    raw = np.concatenate([rng.integers(0, 2, HRPT_LEAD_SYMS),
                          hrpt.manchester_encode(bits),
                          rng.integers(0, 2, 2000)]).astype(np.uint8)
    sps = HRPT_FS / hrpt.SYMBOL_RATE
    n = -(-int(len(raw) * sps) // DECODE_BLOCK) * DECODE_BLOCK
    t = np.arange(n)
    x = _bpsk_hold(raw, sps, n) * np.exp(
        1j * (0.3 + 2 * np.pi * HRPT_CARRIER_HZ / HRPT_FS * t))
    if noise:
        x += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return words, x.astype(np.complex64)


def _f9_packet(pkt_id: int, body: bytes) -> bytes:
    """A Falcon 9 packet as main.cpp:187-199 lays it out: length (total -
    2) in 12 bits, the 8-byte id, 15 bytes, the body, 2 trailer bytes."""
    total = 2 + 8 + 15 + len(body) + 2
    return (bytes([(total - 2) >> 8 & 0b1111, (total - 2) & 0xFF])
            + pkt_id.to_bytes(8, "big") + bytes(15) + body + bytes(2))


def falcon9_flight(seed: int = 12):
    """F9_FRAMES frames carrying a stream of video packets (940 random TS
    bytes each) and GPS text packets, as 3.5714 MBaud FM (2 MHz deviation)
    at 6 Msps after 4000 random bits, light noise; padded to whole
    DECODE_BLOCKs. Returns (the (kind, payload) list of every packet that
    ends inside the frames, iq complex64)."""
    from sdrpp_tpu_torch.decoders import falcon9 as f9

    rng = np.random.default_rng(seed)
    total = F9_FRAMES * f9.DATA_LEN
    stream, starts, want = b"", [], []
    k = 0
    while len(stream) < total:
        if k % 3 == 2:
            body = f"GPS: T+{k:05d} lat=28.{k:04d} lon=-80.{k:04d}\n".encode()
            pkt, item = _f9_packet(f9.PKT_GPS_A, body), ("gps", body)
        else:
            body = bytes(rng.integers(0, 256, 940).astype(np.uint8))
            pkt, item = _f9_packet(f9.PKT_VIDEO, body), ("video", body)
        starts.append(len(stream))
        stream += pkt
        if len(stream) <= total:
            want.append(item)
        k += 1
    rs = f9.FalconRS(device="cpu")
    bits = [rng.integers(0, 2, 4000).astype(np.uint8)]
    starts = np.asarray(starts)
    for fr in range(F9_FRAMES):
        lo = fr * f9.DATA_LEN
        inside = starts[(starts >= lo) & (starts < lo + f9.DATA_LEN)]
        ptr = int(inside[0] - lo) if len(inside) else 2047
        counter = fr + 1
        hdr = bytes([(counter >> 13) & 0b111111, (counter >> 5) & 0xFF,
                     ((counter & 0b11111) << 3) | ((ptr >> 8) & 0b111),
                     ptr & 0xFF])
        frame = np.frombuffer(hdr + stream[lo:lo + f9.DATA_LEN], np.uint8)
        bits += [f9.SYNC_BITS, np.unpackbits(rs.encode(frame))]
    bits.append(rng.integers(0, 2, 500).astype(np.uint8))
    bits = np.concatenate(bits)
    sps = F9_FS / f9.Falcon9Decoder.BAUDRATE
    n = -(-int(len(bits) * sps) // DECODE_BLOCK) * DECODE_BLOCK
    ph = np.cumsum(2 * np.pi * f9.Falcon9Decoder.DEVIATION / F9_FS
                   * _bpsk_hold(bits, sps, n))
    x = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
    return want, x.astype(np.complex64)


def shaped_fm(dev, sym, symbolrate, fs, beta, deviation, rng, noise,
              up: int = 1):
    """Symbols as RRC-shaped frequency pulses through the port's
    ``RRCInterpolator`` on ``dev`` at ``fs`` (as tests/test_m17_chain.py:
    78-120 shapes them), the shaper x receive-RRC cascade calibrated to
    unit symbols; with ``up`` > 1 the pulses interpolated linearly to
    ``up`` x ``fs``; then FM at ``deviation`` and complex noise."""
    import torch
    from sdrpp_tpu_torch.ops.resample import RRCInterpolator
    from sdrpp_tpu_torch.ops.taps import root_raised_cosine_rate

    shaper = RRCInterpolator(symbolrate, fs, beta, 31, dtype=torch.float32,
                             device=dev)
    sym = np.concatenate([sym, np.zeros((-len(sym)) % shaper.block_multiple,
                                        np.float32)]).astype(np.float32)
    _, wave = shaper(shaper.init_state(), torch.from_numpy(sym).to(dev))
    nimp = 64 + (-64) % shaper.block_multiple
    imp = np.zeros(nimp, np.float32)
    imp[32] = 1.0
    _, imp_shaped = shaper(shaper.init_state(), torch.from_numpy(imp).to(dev))
    rx = root_raised_cosine_rate(31, beta, symbolrate, fs)
    gain = np.max(np.abs(np.convolve(imp_shaped.cpu().numpy()
                                     .astype(np.float64), rx)))
    wave = wave.cpu().numpy().astype(np.float64) / gain
    if up > 1:
        wave = np.interp(np.arange(len(wave) * up) / up,
                         np.arange(len(wave)), wave)
    iq = np.exp(1j * np.cumsum(2 * np.pi * deviation / (fs * up) * wave))
    n = len(iq)
    iq += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def m17_call(dev, nframes: int = M17_FRAMES, up: int = 1, seed: int = 13):
    """An M17 voice call: the LSF (M17_DST to M17_SRC), then ``nframes``
    stream frames (frame numbers from 0, 16 seeded payload bytes each),
    after a 1200-symbol random run-in (tests/test_m17_chain.py:_modulate),
    4FSK at 4800 baud shaped by the port's RRCInterpolator (alpha 0.5) at
    48 kHz, 2400 Hz deviation at ``up`` x 48 kHz, light noise; at 48 kHz
    padded to whole DECODE_BLOCKs. Returns (lsf bytes, voice [nframes]
    bytes, iq)."""
    from sdrpp_tpu_torch.decoders import m17
    from sdrpp_tpu_torch.decoders import m17_frame as mf

    rng = np.random.default_rng(seed)
    lsf = m17.encode_lsf(M17_DST, M17_SRC, (1 << 0) | (2 << 1) | (5 << 7),
                         b"H100")
    voice = [bytes(rng.integers(0, 256, 16).astype(np.uint8))
             for _ in range(M17_FRAMES)][:nframes]
    blocks = [mf.encode_lsf_frame(lsf)] + [
        mf.encode_stream_frame(lsf, fn, voice[fn]) for fn in range(nframes)]
    sym = np.concatenate(
        [(np.random.default_rng(99).integers(0, 2, 1200) * 2.0 - 1.0)]
        + [mf.symbols_from_bits(b) for b in blocks] + [np.zeros(100)])
    iq = shaped_fm(dev, sym, mf.M17_BAUDRATE, M17_FS, mf.M17_RRC_ALPHA,
                   mf.M17_DEVIATION, rng, 0.02, up)
    if up == 1:
        iq = np.concatenate([iq, np.zeros((-len(iq)) % DECODE_BLOCK,
                                          np.complex64)])
    return lsf, voice, iq


def kgsstv_signal(dev, seed: int = 14):
    """KG_FRAMES seeded 7-byte frames (kg_sstv encode_frame: sync + 108
    scrambled K = 7 symbols), after 400 random symbols, at 1200 baud shaped
    by the port's RRCInterpolator (alpha 0.7), FM at 300 Hz deviation at
    12 kHz, light noise. Returns (frames, iq)."""
    from sdrpp_tpu_torch.decoders import kg_sstv as kg

    rng = np.random.default_rng(seed)
    frames = [bytes(rng.integers(0, 256, 7).astype(np.uint8))
              for _ in range(KG_FRAMES)]
    sym = np.concatenate([rng.integers(0, 2, 400) * 2.0 - 1.0]
                         + [kg.KGSSTVDeframer.encode_frame(f) for f in frames]
                         + [np.zeros(50)])
    iq = shaped_fm(dev, sym, kg.BAUDRATE, KG_FS, kg.RRC_ALPHA, kg.DEVIATION,
                   rng, 0.01)
    iq = np.concatenate([iq, np.zeros((-len(iq)) % DECODE_BLOCK,
                                      np.complex64)])
    return frames, iq


def kg_mask(frames):
    """The frames with their last two bits cleared: the reference decodes
    16 bits past the 108 symbols a frame carries (kg_sstv_dsp.h:196 vs
    :177), so those two come out of erasures (tests/test_kg_sstv.py)."""
    return [f[:6] + bytes([f[6] & 0b11111100]) for f in frames]


class SymbolTap:
    """Wraps a decoder's block (its demod or M&M): calls it, keeps each
    block's valid symbols on the host, and, with ``events``, brackets the
    call with CUDA events (its device time in the block's stream)."""

    def __init__(self, block, events: bool = False):
        self.block, self.events = block, events
        self.symbols, self.ms = [], []

    def __getattr__(self, name):
        return getattr(self.block, name)

    def __call__(self, state, x):
        import torch

        if self.events:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        state, (syms, valid) = self.block(state, x)
        if self.events:
            ev[1].record()
            self.ms.append(ev)
        self.symbols.append(syms[valid].cpu().numpy())
        return state, (syms, valid)

    def all(self):
        return np.concatenate(self.symbols) if self.symbols else np.zeros(0)


def run_decoder(dec, iq, nblocks=None, attr=None, dev="cuda"):
    """Blocks of DECODE_BLOCK samples of ``iq`` through ``dec.process``:
    (each block's outputs, per-block CUDA-event ms, host s, the tap on
    ``attr``)."""
    import torch

    tap = None
    if attr is not None:
        tap = SymbolTap(getattr(dec, attr), events=dev != "cpu")
        setattr(dec, attr, tap)
    nb = len(iq) // DECODE_BLOCK if nblocks is None else nblocks
    outs, ms, wall = [], [], []
    for k in range(nb):
        x = torch.from_numpy(iq[k * DECODE_BLOCK:(k + 1) * DECODE_BLOCK]
                             ).to(dev)
        t0 = time.perf_counter()
        if dev != "cpu":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        outs.append(dec.process(x))
        if dev != "cpu":
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        wall.append(time.perf_counter() - t0)
    return outs, ms, wall, tap


def block_report(path, fs, ms, wall, tap, rate_name):
    """Median block ms (CUDA events, blocks 2..), the M&M's share of it,
    the host time a block and the real-time factor against ``fs``."""
    mm_ms = [a.elapsed_time(b) for a, b in tap.ms] if tap and tap.ms else []
    ms = ms or [1e3 * w for w in wall]  # a CPU rehearsal has no events
    med = float(np.median(ms[1:] if len(ms) > 1 else ms))
    med_wall = float(np.median(wall[1:] if len(wall) > 1 else wall))
    block_s = DECODE_BLOCK / fs
    share = (sum(mm_ms[1:]) / sum(ms[1:]) if len(ms) > 1 and mm_ms
             else None)
    res = {"block": DECODE_BLOCK, "blocks": len(ms), "block_ms": ms,
           "median_block_ms": med, "median_host_s": med_wall,
           "realtime_x": block_s / (med / 1e3),
           "realtime_x_host": block_s / med_wall}
    if mm_ms:
        res.update(mm_ms=mm_ms, mm_share=share,
                   median_mm_ms=float(np.median(mm_ms[1:] or mm_ms)))
    log(f"{path}: median {med:.3f} ms a {DECODE_BLOCK}-sample block (CUDA "
        f"events, blocks 2..{len(ms)}) = {res['realtime_x']:.2f}x {rate_name}"
        f" real time; host {med_wall:.4f} s a block = "
        f"{res['realtime_x_host']:.2f}x" + (
            f"; the M&M {res['median_mm_ms']:.3f} ms a block, "
            f"{100 * share:.1f} % of the block" if mm_ms else ""))
    return res


def phase_hrpt(dev="cuda"):
    """hrpt-3M: HRPT_FRAMES minor frames through HRPTDecoder on the card,
    its loops chunked as the JAX package runs them (K = 128): every frame
    with sync_errors 0, its spacecraft id, frame number and words exact;
    lane_scan and mm_symbols launched. Then the loops' two routes (the
    exact one by lane counts forced to 0) on that signal and on the same
    frames in noise (HRPT_NOISE a component): each route's frames, sync
    errors and wrong words printed; the exact route must be exact on
    both, the chunked one on the clean signal (the JAX package's
    warm-ups are short of HRPT's loop time constants, ROADMAP C)."""
    from sdrpp_tpu_torch.decoders.hrpt import HRPTDecoder

    words, iq = hrpt_pass()
    reset_counts()
    dec = HRPTDecoder(HRPT_FS, device=dev)
    per_block, ms, wall, tap = run_decoder(dec, iq, attr="demod", dev=dev)
    launches = read_counts("hrpt")
    res = block_report("hrpt-3M", HRPT_FS, ms, wall, None, "3 Msps")
    frames = sum(per_block, [])
    routes = {}
    for sig, x in (("clean", iq), ("noisy", hrpt_pass(noise=HRPT_NOISE)[1])):
        for route in ("chunked", "exact"):
            if (sig, route) == ("clean", "chunked"):
                got = frames
            else:
                d = HRPTDecoder(HRPT_FS, device=dev)
                if route == "exact":
                    d.demod.agc.max_lanes = d.demod.costas.max_lanes = 1
                got = sum(run_decoder(d, x, dev=dev)[0], [])
            wrong = [int((f.words != w).sum()) for f, w in zip(got, words)]
            routes[f"{sig} {route}"] = {
                "frames": len(got), "sync_errors": [f.sync_errors
                                                    for f in got],
                "wrong_words": wrong}
            log(f"hrpt-3M {sig} signal, {route} loops: {len(got)} of "
                f"{len(words)} frames, sync errors "
                f"{[f.sync_errors for f in got]}, wrong words {wrong}")
            if route == "exact" or sig == "clean":
                check_hrpt_frames(got, words, f"hrpt-3M ({sig}, {route})")
    res.update(frames=len(frames), symbols=int(len(tap.all())),
               launches=launches, routes=routes)
    return res, (iq[:2 * DECODE_BLOCK], tap.symbols[:2],
                 sum(per_block[:2], []))


def check_hrpt_frames(frames, words, what):
    if len(frames) != len(words):
        raise AssertionError(f"{what}: {len(frames)} of {len(words)} frames")
    for k, (f, w) in enumerate(zip(frames, words)):
        if not (f.sync_errors == 0 and f.spacecraft_id == HRPT_SC
                and f.frame_number == int(w[6]) & 3
                and np.array_equal(f.words, w)
                and np.array_equal(f.avhrr, w[750:750 + 10240]
                                   .reshape(2048, 5).T)):
            raise AssertionError(f"{what}: frame {k} came back wrong "
                                 f"({int((f.words != w).sum())} words)")


def phase_falcon9(dev="cuda"):
    """falcon9-6M: F9_FRAMES frames through Falcon9Decoder on the card:
    every packet's bytes exact, in order; mm_symbols launched; per-block
    CUDA-event ms, the M&M's share, the real-time factor at 6 Msps."""
    from sdrpp_tpu_torch.decoders.falcon9 import Falcon9Decoder

    want, iq = falcon9_flight()
    reset_counts()
    dec = Falcon9Decoder(F9_FS, device=dev)
    per_block, ms, wall, tap = run_decoder(dec, iq, attr="recov", dev=dev)
    launches = read_counts("falcon9")
    got = sum(per_block, [])
    res = block_report("falcon9-6M", F9_FS, ms, wall, tap, "6 Msps")
    kinds = {k: sum(1 for kk, _ in want if kk == k) for k in ("gps", "video")}
    log(f"falcon9-6M: {len(got)} of {len(want)} packets ({kinds})")
    if got != want:
        raise AssertionError(f"falcon9-6M: {len(got)} packets, "
                             f"{sum(a == b for a, b in zip(got, want))} of "
                             f"{len(want)} exact")
    res.update(packets=len(got), symbols=int(len(tap.all())),
               launches=launches)
    return res, (iq[:2 * DECODE_BLOCK], tap.symbols[:2],
                 sum(per_block[:2], []))


class M17Path:
    """The M17 frame path on ``dev``: GFSKDemod (m17dsp.h:657's settings)
    -> slice_4fsk -> FrameDemux -> decode_lsf_frame / LICHAssembler /
    decode_stream_payload. process(x) returns the block's stream payloads;
    ``lsfs`` and ``liches`` collect the LSFs of LSF frames and of LICH."""

    def __init__(self, dev):
        from sdrpp_tpu_torch.decoders import m17_frame as mf
        from sdrpp_tpu_torch.models.digital import GFSKDemod

        self.mf, self.dev = mf, dev
        self.demod = GFSKDemod(mf.M17_BAUDRATE, M17_FS, mf.M17_DEVIATION,
                               rrc_tap_count=31, rrc_beta=mf.M17_RRC_ALPHA,
                               omega_gain=1e-6, mu_gain=0.01,
                               omega_rel_limit=0.01, device=dev)
        self.state = self.demod.init_state()
        self.demux, self.lich = mf.FrameDemux(), mf.LICHAssembler()
        self.lsfs, self.liches = [], []

    def process(self, x):
        mf = self.mf
        self.state, (syms, valid) = self.demod(self.state, x)
        payloads = []
        for ftype, f in self.demux.process(
                mf.slice_4fsk(syms[valid].cpu().numpy())):
            if ftype == mf.FRAME_LSF:
                self.lsfs.append(mf.decode_lsf_frame(f["lsf"],
                                                     device=self.dev))
            elif ftype == mf.FRAME_STREAM:
                got = self.lich.process(f["lich"])
                if got is not None:
                    self.liches.append(got)
                payloads.append(mf.decode_stream_payload(f["payload"],
                                                         device=self.dev))
        return payloads


def phase_m17(dev="cuda"):
    """m17-48k: an M17 call (LSF, M17_FRAMES stream frames) through the
    port's GFSK demod and frame layer on the card: the LSF callsigns exact,
    every stream frame's 18 payload bytes exact, LICH LSFs valid;
    mm_symbols and both Viterbi kernels launched. With libcodec2, also
    ``M17Decoder``: its voice sample count."""
    from sdrpp_tpu_torch.decoders import codec2

    lsf, voice, iq = m17_call(dev)
    reset_counts()
    m17p = M17Path(dev)
    per_block, ms, wall, tap = run_decoder(m17p, iq, attr="demod", dev=dev)
    launches = read_counts("m17")
    lsfs, liches, payloads = m17p.lsfs, m17p.liches, sum(per_block, [])
    res = block_report("m17-48k", M17_FS, ms, wall, tap, "48 kHz")
    want = [bytes([fn >> 8, fn & 0xFF]) + v for fn, v in enumerate(voice)]
    found = [p for p in payloads if p in want]
    log(f"m17-48k: {len(lsfs)} LSF frames ({[(l.dst, l.src, l.valid) for l in lsfs]}), "
        f"{len(liches)} LSFs from LICH, {len(payloads)} stream frames, "
        f"{len(found)} of {len(want)} payloads exact")
    if not (len(lsfs) == 1 and lsfs[0].valid and lsfs[0].dst == M17_DST
            and lsfs[0].src == M17_SRC):
        raise AssertionError("m17-48k: the LSF did not come back")
    # (the sync search may also lock on a stream syncword in the random
    # run-in: such a frame decodes to no payload that was sent)
    if found != want:
        raise AssertionError(f"m17-48k: {len(found)} of {len(want)} "
                             f"payloads, {len(payloads)} stream frames")
    if not liches or not all(l.dst == M17_DST and l.src == M17_SRC
                             for l in liches):
        raise AssertionError("m17-48k: the LICH LSFs did not come back")
    res.update(payloads=len(payloads), lich_lsfs=len(liches),
               symbols=int(len(tap.all())), launches=launches)
    if codec2.available():
        from sdrpp_tpu_torch.models.m17_chain import M17Decoder

        dec = M17Decoder(M17_FS, device=dev)
        out, _, _, _ = run_decoder(_M17Audio(dec), iq, dev=dev)
        samples = sum(len(a) for a in sum(out, []))
        log(f"m17 voice: M17Decoder on the card gave {samples} samples of "
            f"8 kHz voice ({samples / 320:.1f} frames of 320)")
        if samples < (len(voice) - 1) * 320:
            raise AssertionError(f"m17 voice: {samples} samples for "
                                 f"{len(voice)} frames")
        res["voice_samples"] = samples
    else:
        log("m17 voice: libcodec2 absent")
        res["voice_samples"] = None
    return res, (iq[:2 * DECODE_BLOCK], tap.symbols[:2],
                 sum(per_block[:2], []))


class _M17Audio:
    """M17Decoder.process as a run_decoder target: its audio blocks."""

    def __init__(self, dec):
        self.dec = dec

    def process(self, x):
        return [self.dec.process(x)[0]]


def phase_kgsstv(dev="cuda"):
    """kgsstv-12k: KG_FRAMES frames through KGSSTVDecoder on the card:
    every frame exact (its last two bits masked, see kg_mask); mm_symbols
    and both Viterbi kernels launched."""
    from sdrpp_tpu_torch.decoders.kg_sstv import KGSSTVDecoder

    frames, iq = kgsstv_signal(dev)
    reset_counts()
    dec = KGSSTVDecoder(KG_FS, device=dev)
    per_block, ms, wall, tap = run_decoder(dec, iq, attr="recov", dev=dev)
    launches = read_counts("kgsstv")
    got = sum(per_block, [])
    res = block_report("kgsstv-12k", KG_FS, ms, wall, tap, "12 kHz")
    ok = sum(a == b for a, b in zip(kg_mask(got), kg_mask(frames)))
    log(f"kgsstv-12k: {len(got)} frames, {ok} of {len(frames)} exact (last "
        f"two bits masked)")
    if kg_mask(got) != kg_mask(frames):
        raise AssertionError(f"kgsstv-12k: {ok} of {len(frames)} frames")
    res.update(frames=len(got), symbols=int(len(tap.all())),
               launches=launches)
    return res, (iq[:2 * DECODE_BLOCK], tap.symbols[:2],
                 sum(per_block[:2], [])), got


def phase_decode_cpu(first):
    """The first two blocks of each decode path again on device="cpu":
    equal symbol counts, symbols within METEOR_CPU_TOL (max) and
    METEOR_CPU_RMS_TOL (RMS) from symbol METEOR_CPU_SKIP on, and equal
    frames, packets and payloads."""
    from sdrpp_tpu_torch.decoders.falcon9 import Falcon9Decoder
    from sdrpp_tpu_torch.decoders.hrpt import HRPTDecoder
    from sdrpp_tpu_torch.decoders.kg_sstv import KGSSTVDecoder

    out = {}
    for path, (iq, card_syms, card_out) in first.items():
        t0 = time.perf_counter()
        dec, attr = {"hrpt": (HRPTDecoder(HRPT_FS, device="cpu"), "demod"),
                     "falcon9": (Falcon9Decoder(F9_FS, device="cpu"),
                                 "recov"),
                     "m17": (M17Path("cpu"), "demod"),
                     "kgsstv": (KGSSTVDecoder(KG_FS, device="cpu"),
                                "recov")}[path]
        got, _, _, tap = run_decoder(dec, iq, 2, attr, dev="cpu")
        got, want = sum(got, []), card_out
        cpu_s = time.perf_counter() - t0
        card, cpu = np.concatenate(card_syms), tap.all()
        if len(card) != len(cpu):
            raise AssertionError(f"{path} card vs cpu: {len(card)} vs "
                                 f"{len(cpu)} symbols")
        d = np.abs(card[METEOR_CPU_SKIP:] - cpu[METEOR_CPU_SKIP:])
        err, rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
        if path == "hrpt":
            same = len(got) == len(want) and all(
                np.array_equal(a.words, b.words) for a, b in zip(got, want))
        else:
            same = got == want
        log(f"{path} card vs cpu (2 blocks, CPU {cpu_s:.1f} s): "
            f"{len(card)} symbols each; from symbol {METEOR_CPU_SKIP} max "
            f"|diff| {err:.3g} (tol {METEOR_CPU_TOL}), RMS {rms:.3g} (tol "
            f"{METEOR_CPU_RMS_TOL}); outputs {len(got)} on the CPU, "
            f"{'equal' if same else 'DIFFERENT'}")
        if not (err <= METEOR_CPU_TOL and rms <= METEOR_CPU_RMS_TOL
                and same):
            raise AssertionError(f"{path}: card and CPU disagree")
        out[path] = {"symbols": int(len(card)), "max_diff": err,
                     "rms_diff": rms, "outputs": len(got), "cpu_s": cpu_s}
    return out


def phase_decode_paths_cli(results, dev="cuda"):
    """The entry points: ``cli.main(["decode", mode, ...])`` on the card
    over WAVs of the phases' signals: hrpt (3 Msps), falcon9 (6 Msps) and
    kgsstv (12 kHz) at the decoders' own rates, their outputs equal to the
    phases' decoded content; m17 (with libcodec2) from a 2.4 Msps WAV at
    M17_CLI_OFFSET carrying the call's LSF and first M17_CLI_FRAMES
    frames, so RxVFO and decimating_fir run: the LSF log line and the
    voice samples. Each signal is made again from its seed."""
    import logging

    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.decoders import codec2
    from sdrpp_tpu_torch.io import wav

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def run(mode, iq, fs, suffix, offset=0.0):
            src, dst = tmp / f"{mode}.wav", tmp / f"{mode}{suffix}"
            wav.write_wav(src, int(fs), np.stack([iq.real, iq.imag], -1),
                          "f32")
            argv = ["decode", mode, "--source", str(src), "--out", str(dst),
                    "--device", dev]
            if offset:
                argv += ["--offset", str(offset)]
            logs = []
            handler = logging.Handler()
            handler.emit = lambda r: logs.append(r.getMessage())
            logging.getLogger("sdrpp_tpu_torch").addHandler(handler)
            reset_counts()
            t0 = time.perf_counter()
            try:
                rc = cli.main(argv)
            finally:
                logging.getLogger("sdrpp_tpu_torch").removeHandler(handler)
            secs = time.perf_counter() - t0
            counts = {k: f.launches for k, f in kernel_fns().items()}
            if rc:
                raise AssertionError(f"cli decode {mode} returned {rc}")
            return dst, logs, secs, counts

        words, iq = hrpt_pass()
        dst, _, secs, counts = run("hrpt", iq, HRPT_FS, ".npy")
        lines = np.load(dst)
        want = np.stack([w[750:750 + 10240].reshape(2048, 5).T
                         for w in words])
        ok = lines.shape == want.shape and np.array_equal(lines, want)
        out["hrpt"] = {"lines": int(len(lines)), "equal": ok,
                       "seconds": secs, "launches": counts}
        log(f"cli decode hrpt: {len(lines)} AVHRR lines, "
            f"{'equal to' if ok else 'DIFFERENT from'} the frames' in "
            f"{secs:.2f} s")
        del iq

        packets, iq = falcon9_flight()
        dst, _, secs, counts = run("falcon9", iq, F9_FS, ".ts")
        video = b"".join(p for k, p in packets if k == "video")
        ok = dst.read_bytes() == video
        out["falcon9"] = {"bytes": len(video), "equal": ok, "seconds": secs,
                          "launches": counts}
        log(f"cli decode falcon9: {len(video)} video TS bytes "
            f"{'equal' if ok else 'DIFFERENT'} in {secs:.2f} s")
        del iq

        frames, iq = kgsstv_signal(dev)
        dst, _, secs, counts = run("kgsstv", iq, KG_FS, ".bin")
        data = dst.read_bytes()
        got = [data[i:i + 7] for i in range(0, len(data), 7)]
        ok = data == b"".join(results["kgsstv"]) and \
            kg_mask(got) == kg_mask(frames)
        out["kgsstv"] = {"frames": len(got), "equal": ok, "seconds": secs,
                         "launches": counts}
        log(f"cli decode kgsstv: {len(got)} frames, "
            f"{'equal to' if ok else 'DIFFERENT from'} the phase's in "
            f"{secs:.2f} s")

        if codec2.available():
            from sdrpp_tpu_torch.models.channel import RxVFO

            _, _, iq = m17_call(dev, M17_CLI_FRAMES,
                                int(M17_CLI_FS // M17_FS))
            block = cli._auto_block(M17_CLI_FS, M17_FS, RxVFO(
                M17_CLI_FS, M17_FS, M17_FS, M17_CLI_OFFSET,
                device="cpu").block_multiple)
            iq = np.concatenate([iq, np.zeros((-len(iq)) % block,
                                              np.complex64)])
            iq = iq * np.exp(2j * np.pi * M17_CLI_OFFSET / M17_CLI_FS
                             * np.arange(len(iq)))
            dst, logs, secs, counts = run("m17", iq.astype(np.complex64),
                                          M17_CLI_FS, ".wav",
                                          M17_CLI_OFFSET)
            info, audio = wav.read_wav(dst)
            line = f"M17 LSF: dst={M17_DST} src={M17_SRC}"
            ok = (line in logs and info.samplerate == 8000
                  and len(audio) >= (M17_CLI_FRAMES - 1) * 320
                  and (counts["decimating_fir"] >= 1 or dev == "cpu"))
            out["m17"] = {"samples": int(len(audio)), "lsf_line": line in logs,
                          "equal": ok, "seconds": secs, "launches": counts}
            log(f"cli decode m17 (2.4 Msps at {M17_CLI_OFFSET:+g} Hz): "
                f"{len(audio)} voice samples for {M17_CLI_FRAMES} frames, "
                f"LSF line {'logged' if line in logs else 'MISSING'}, "
                f"decimating_fir launches {counts['decimating_fir']}, in "
                f"{secs:.2f} s")
        else:
            log("cli decode m17: libcodec2 absent, not run")
            out["m17"] = None
    bad = [m for m, r in out.items() if r is not None and not r["equal"]]
    if bad:
        raise AssertionError(f"cli decode: {bad} differ from the phases")
    return out


def device_intervals(prof):
    """(name, start us, end us) of every device activity in a profile."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def busy_us(spans):
    """Length of the union of the [start, end) spans."""
    total, end = 0.0, None
    for _, a, b in sorted(spans, key=lambda t: t[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_paths():
    """The --profile mode: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sdrpp_tpu_torch.ops import fir_kernels as DK
    from sdrpp_tpu_torch.ops.resample import decim_plan
    from sdrpp_tpu_torch.parallel import wideband as W

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}

    def summary(name, spans, wall_us, blocks):
        by_name = {}
        for kname, a, b in spans:
            t, c = by_name.get(kname, (0.0, 0))
            by_name[kname] = (t + b - a, c + 1)
        busy = busy_us(spans)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        loops = sum(t for kname, (t, c) in by_name.items()
                    if "loop_scan_kernel" in kname)
        res = {"blocks": blocks, "wall_ms_per_block": wall_us / blocks / 1e3,
               "device_busy_ms_per_block": busy / blocks / 1e3,
               "idle_share": 1.0 - busy / wall_us,
               "device_ops_per_block": len(spans) / blocks,
               "loop_scan_ms_per_block": loops / blocks / 1e3,
               "loop_scan_share_of_busy": loops / busy if busy else 0.0,
               "by_kernel_ms_per_block": {n: t / blocks / 1e3
                                          for n, (t, c) in top[:12]}}
        log(f"profile {name}: {res['wall_ms_per_block']:.3f} ms per block "
            f"(host clock), device busy {res['device_busy_ms_per_block']:.3f}"
            f" ms, idle {100 * res['idle_share']:.1f} %, "
            f"{res['device_ops_per_block']:.0f} device operations per block; "
            f"loop-scan kernels {res['loop_scan_ms_per_block']:.4f} ms "
            f"({100 * res['loop_scan_share_of_busy']:.1f} % of busy)")
        for n, (t, c) in top[:12]:
            log(f"  {t / blocks / 1e3:8.4f} ms/block  x{c // blocks:<3d} "
                f"{n[:100]}")
        return res

    # the receive slice: three VFOs, steady blocks after three warm ones
    iq = composite((3 + PROFILE_RX_BLOCKS) * BLOCK)
    rx = make_receiver("cuda")
    for k in range(3):
        rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(3, 3 + PROFILE_RX_BLOCKS):
            rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["receive"] = summary("receive", device_intervals(prof), wall_us,
                             PROFILE_RX_BLOCKS)
    del rx, iq

    # the radio-options path: seven VFOs and the RDS chain, blocks 3..6
    # (the retune's and the bandwidth write's blocks among them)
    from sdrpp_tpu_torch.models.rds_chain import RDSReceiver

    iq = radio_composite((3 + PROFILE_RX_BLOCKS) * RADIO_BLOCK)
    rx, rds_rx = make_radio_receiver("cuda"), RDSReceiver(device="cuda")
    for k in range(3):
        rds_rx.process(radio_step(rx, iq, k)[0]["wfm_rds"][1])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(3, 3 + PROFILE_RX_BLOCKS):
            rds_rx.process(radio_step(rx, iq, k)[0]["wfm_rds"][1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["radio"] = summary("radio", device_intervals(prof), wall_us,
                           PROFILE_RX_BLOCKS)
    del rx, rds_rx, iq

    x, _, _ = wideband_block("cuda")
    chain = W.make_chain("wideband", device="cuda")
    state = chain.init_state()
    for _ in range(3):  # warm: plans, cuFFT plans, the kernel's build
        state, y = chain(state, x)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_BLOCKS):
            state, y = chain(state, x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["wideband"] = summary("wideband", device_intervals(prof), wall_us,
                              PROFILE_BLOCKS)
    del chain, state, x, y
    out.update(profile_meteor(summary, acts))
    out.update(profile_decode(summary, acts))
    out["ui"] = profile_ui(summary, acts)

    gen = torch.Generator(device="cuda").manual_seed(3)
    out["decimating_fir"] = []
    for path, rows, n, ratio, dt in FIR_CASES:
        r, taps = decim_plan(ratio)[0]
        m = taps.shape[0]
        dtype = torch.complex64 if dt == "c64" else torch.float32
        w = torch.from_numpy(taps.astype(np.float32)).to("cuda")
        xs = torch.randn((rows, n), generator=gen, dtype=dtype, device="cuda")
        tail = torch.zeros((rows, m - 1), dtype=dtype, device="cuda")
        DK.decimating_fir(tail, xs, w, r)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                DK.decimating_fir(tail, xs, w, r)
            host_us = (time.perf_counter() - t0) * 1e6 / PROFILE_CALLS
            torch.cuda.synchronize()
        kern = [b - a for name, a, b in device_intervals(prof)
                if "decim_fir" in name]
        dev_us = float(np.median(kern))
        out["decimating_fir"].append({"path": path, "shape": [rows, n],
                                      "r": r, "m": m, "device_us": dev_us,
                                      "host_us_per_call": host_us})
        log(f"profile decimating_fir [{rows}, {n}] {dt} /{r} ({path}): kernel "
            f"{dev_us:.1f} us on the device (median of {len(kern)}), "
            f"{host_us:.1f} us of host time per call")
    return out


class GatedSource(ArraySource):
    """An ``ArraySource`` whose read of block ``after`` waits for ``gate``:
    the engine's warm blocks run before a profile window opens."""

    def __init__(self, iq, block, after):
        super().__init__(iq)
        import threading

        self.gate, self.at = threading.Event(), block * after

    def read(self, n):
        if self.pos == self.at:
            self.gate.wait()
        return super().read(n)


def profile_ui(summary, acts, dev="cuda"):
    """The --profile mode's live receiver: the ui-2p4 engine (four VFOs,
    cli ui's defaults) streaming unpaced, PROFILE_RX_BLOCKS steady blocks
    after three warm ones, its own thread doing everything a block takes
    (read, upload, step, readbacks, RDS, waterfall); and the waterfall's
    ``push_fft`` of one 16384-point line timed alone on the host."""
    import torch
    from torch.profiler import profile
    from sdrpp_tpu_torch.misc.waterfall import WaterfallDisplay

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    probe = ui_engine(np.zeros(1, np.complex64), "cpu")
    block = probe._block
    iq = ui_composite((3 + PROFILE_RX_BLOCKS) * block)
    eng = ui_engine(iq, dev)
    src = GatedSource(iq, block, 3)
    eng.source = src
    eng.start()
    _wait_for(lambda: eng.blocks >= 3, 300, "the warm blocks")
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        src.gate.set()
        eng._thread.join(300)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    if eng.blocks != 3 + PROFILE_RX_BLOCKS or eng.error:
        raise AssertionError(f"profile ui: {eng.blocks} {eng.error}")
    res = summary("ui", device_intervals(prof), wall_us, PROFILE_RX_BLOCKS)
    wf = WaterfallDisplay(UI_FFT, data_width=1024, waterfall_height=512,
                          whole_bandwidth=FS)
    line = np.random.default_rng(0).standard_normal(UI_FFT).astype(
        np.float32) - 60.0
    for _ in range(3):
        wf.push_fft(line)
    t0 = time.perf_counter()
    for _ in range(20):
        wf.push_fft(line)
    res["push_fft_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    res["fft_lines_per_block"] = eng._wf_total / eng.blocks
    log(f"profile ui: push_fft {res['push_fft_ms']:.3f} ms a "
        f"{UI_FFT}-point line on the host, "
        f"{res['fft_lines_per_block']:.2f} lines a block")
    return res


def profile_decode(summary, acts, dev="cuda"):
    """The --profile mode's decode part: PROFILE_BLOCKS steady blocks (after
    two) of the HRPT and Falcon 9 paths, each block uploaded inside the
    window and decoded through ``process`` as ``cli decode`` does."""
    import torch
    from torch.profiler import profile
    from sdrpp_tpu_torch.decoders.falcon9 import Falcon9Decoder
    from sdrpp_tpu_torch.decoders.hrpt import HRPTDecoder

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    out = {}
    for path, (make, sig) in {
            "hrpt": (lambda: HRPTDecoder(HRPT_FS, device=dev),
                     lambda: hrpt_pass()[1]),
            "falcon9": (lambda: Falcon9Decoder(F9_FS, device=dev),
                        lambda: falcon9_flight()[1])}.items():
        iq, dec = sig(), make()
        blocks = [iq[k * DECODE_BLOCK:(k + 1) * DECODE_BLOCK]
                  for k in range(2 + PROFILE_BLOCKS)]
        for x in blocks[:2]:
            dec.process(torch.from_numpy(x).to(dev))
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for x in blocks[2:]:
                dec.process(torch.from_numpy(x).to(dev))
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        out[path] = summary(path, device_intervals(prof), wall_us,
                            PROFILE_BLOCKS)
        del iq, dec, blocks
    return out


def profile_meteor(summary, acts):
    """The --profile mode's meteor part: the 30-s pass through RxVFO and
    MeteorLRPTDecoder, PROFILE_METEOR_BLOCKS steady blocks profiled (after
    three; their IQ made before the window, the upload inside it), then
    one ``finalize`` (which must recover every payload)."""
    import torch
    from torch.profiler import profile
    from sdrpp_tpu_torch import cli
    from sdrpp_tpu_torch.decoders.meteor_lrpt import MeteorLRPTDecoder
    from sdrpp_tpu_torch.models.channel import RxVFO

    payloads, gen = meteor_pass()
    vfo = RxVFO(METEOR_FS, METEOR_IF, bandwidth=METEOR_IF,
                offset=METEOR_OFFSET, device="cuda")
    dec = MeteorLRPTDecoder(METEOR_IF, device="cuda")
    block = cli._auto_block(METEOR_FS, METEOR_IF, vfo.block_multiple)
    nblocks = int(METEOR_SECONDS * METEOR_FS) // block
    first = 3
    vstate, out = vfo.init_state(), {}

    def step(iq):
        nonlocal vstate
        vstate, y = vfo(vstate, torch.from_numpy(iq).to("cuda"))
        dec.process(y)

    k = 0
    while k < nblocks:
        if k != first:
            step(gen(k * block, block))
            k += 1
            continue
        iqs = [gen(j * block, block)
               for j in range(k, k + PROFILE_METEOR_BLOCKS)]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for iq in iqs:
                step(iq)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        out["meteor"] = summary("meteor", device_intervals(prof), wall_us,
                                PROFILE_METEOR_BLOCKS)
        k += PROFILE_METEOR_BLOCKS
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, vcdus, info = dec.finalize()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out["meteor_finalize"] = summary("meteor finalize",
                                     device_intervals(prof), wall_us, 1)
    out["meteor_finalize"].update(dec.timings, vcdus=int(len(vcdus)), **info)
    log(f"profile meteor finalize: {dec.timings}, {len(vcdus)} VCDUs")
    if len(vcdus) != len(payloads):
        raise AssertionError(f"meteor (profiled): {len(vcdus)} of "
                             f"{len(payloads)} VCDUs")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sdrpp_tpu_torch.utils import cuda_lib

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("loop_scan", "mm_clock", "viterbi", "decim_fir", "sync_walk")
    hosts = ("kernels_host",)
    with ThreadPoolExecutor(len(names) + len(hosts)) as pool:
        built = [pool.submit(cuda_lib.build_host, h) for h in hosts]
        libs = list(pool.map(cuda_lib.build, names)) + [
            b.result() for b in built]
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(l.name for l in libs)} in {build_s:.2f} s")
    for lib in libs:
        log(lib.with_suffix(".log").read_text().strip())

    if "--profile" in sys.argv[1:]:
        print(gpu)
        print(json.dumps({"profile": profile_paths()}))
        return 0
    dev = torch.device("cuda")
    loops, ab_inputs = phase_kernels(dev)
    viterbi, ab_viterbi = phase_kernels_viterbi(dev)
    k9, k6 = fec_path_soft(9), fec_path_soft(6)
    kernels = (loops + phase_kernels_digital(dev)
               + phase_kernels_decode_mm(dev) + viterbi
               + phase_kernels_fec(dev, k9[1], k6[1])
               + phase_kernels_fir(dev) + phase_kernels_walks(dev))

    iq = composite(NBLOCKS * BLOCK)
    audio, block_ms, wall_s, launches = phase_slice(iq)
    med_ms = float(np.median(block_ms[1:]))
    med_wall = float(np.median(wall_s[1:]))
    msps = BLOCK / (med_ms / 1e3) / 1e6
    log(f"slice: median {med_ms / 1e3:.4f} s/block (CUDA events; host "
        f"{med_wall:.4f} s) over blocks 2..{NBLOCKS}, {msps:.2f} Msamp/s "
        f"input = {msps / (FS / 1e6):.2f}x the 2.4 Msps real-time rate")
    checks = check_audio(audio)
    cpu = phase_cpu(iq, audio)
    cli_res = phase_cli()
    meteor, first_if, pass_u8 = phase_meteor()
    meteor_cpu = phase_meteor_cpu(first_if)
    decode_cli = phase_decode_cli()
    wide, wide_x, wide_audio = phase_wideband()
    wide_cpu = phase_wideband_cpu(wide_x, wide_audio)
    dsp = phase_dsp_lib(dev, wide_x)
    del wide_x
    banks = phase_banks()
    bank_cli = phase_bank_cli()
    golden_bank = phase_golden_bank()
    radio_iq = radio_composite(RADIO_NBLOCKS * RADIO_BLOCK)
    r_audio, r_rds, r_dec, r_ms, r_wall, r_launches = phase_radio(radio_iq)
    radio = {"block_ms": r_ms, "wall_s": r_wall, "launches": r_launches,
             "median_ms": float(np.median(r_ms[1:])),
             "median_wall_s": float(np.median(r_wall[1:]))}
    log(f"radio-options slice: median {radio['median_ms']:.3f} ms/block "
        f"(CUDA events) and {radio['median_wall_s']:.4f} s/block of host "
        f"time over blocks 2..{RADIO_NBLOCKS}, {len(RADIO_VFOS)} VFOs, "
        f"{RADIO_BLOCK} samples a block")
    radio.update(check_radio(r_audio, r_dec))
    radio["card_vs_cpu"] = phase_radio_cpu(radio_iq, r_audio, r_rds)
    radio["cli"] = phase_radio_cli(radio_iq)
    del radio_iq, r_audio, r_rds
    ui = phase_ui()
    serve = phase_serve()
    ui_fault = phase_ui_fault()
    pipeline = phase_pipeline_identity()
    pipeline["timing"] = phase_pipeline_timing()
    decode, first = {}, {}
    decode["hrpt"], first["hrpt"] = phase_hrpt()
    decode["falcon9"], first["falcon9"] = phase_falcon9()
    decode["m17"], first["m17"] = phase_m17()
    decode["kgsstv"], first["kgsstv"], kg_frames = phase_kgsstv()
    decode["card_vs_cpu"] = phase_decode_cpu(first)
    del first
    decode["cli"] = phase_decode_paths_cli({"kgsstv": kg_frames})
    fec = phase_fec(dev, k9, k6)
    del k9, k6
    rs = phase_rs_erasures(dev)
    run_resume = phase_run_resume(dev)
    mp3 = phase_mp3(dev)
    atv = phase_atv(dev)
    dab = phase_dab(dev)
    ab = phase_ab(meteor["block"], ab_inputs,
                  dict(ab_viterbi, pass_u8=pass_u8))

    paths = {"receive": launches, "radio": r_launches,
             "meteor": meteor["launches"],
             "wideband": wide["launches"],
             "ssb_bank": banks["ssb_bank"]["launches"],
             "muted_bank": banks["muted_bank"]["launches"],
             "bank": bank_cli["time"]["launches"],
             "bank_fft": bank_cli["fft"]["launches"],
             **{p: decode[p]["launches"]
                for p in ("hrpt", "falcon9", "m17", "kgsstv")},
             "fec_k9": fec["fec_k9"]["launches"],
             "fec_k6": fec["fec_k6"]["launches"],
             "dsp_lib": dsp["launches"],
             "ui": ui["launches"],
             "run_wfm": run_resume["launches"]["wfm"],
             "run_am": run_resume["launches"]["am"],
             "atv": atv["launches"], "dab": dab["launches"]}
    rows = []
    for entry in SOURCES:
        mine = [k for k in kernels if k["entry"] == entry]
        on_path = [k for k in mine if k["path"]]
        by_path = {p: c.get(entry, 0) for p, c in paths.items()}
        total = sum(by_path.values())
        # the live receiver's entry is its launches a block
        by_path["ui"] = ui["launches_per_block"].get(entry, 0)
        lib = [k["library_ms"] for k in on_path]
        rows.append({
            "name": entry, "route": "cuda", "source": SOURCES[entry],
            "replaces": REPLACES[entry], "launches": total,
            "launches_by_path": by_path,
            "max_abs_err": max(k["max_abs_err"] for k in mine),
            "ms": sum(k["ms"] for k in on_path),
            "plain_ms": sum(k["plain_ms"] for k in on_path),
            "bound_ms": sum(k["bound_ms"] for k in on_path),
            "bound_by": max(on_path, key=lambda k: k["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "cases": mine})
    log(json.dumps({"slice": {"block_ms": block_ms, "wall_s": wall_s,
                              "launches": launches, **checks},
                    "card_vs_cpu": cpu, "cli": cli_res, "meteor": meteor,
                    "meteor_card_vs_cpu": meteor_cpu,
                    "decode_cli": decode_cli, "wideband": wide,
                    "wideband_card_vs_cpu": wide_cpu, "banks": banks,
                    "bank_cli": bank_cli, "golden_bank": golden_bank,
                    "radio": radio, "pipeline": pipeline,
                    "decode": decode, "fec": fec, "rs_erasures": rs,
                    "dsp_lib": dsp, "ui": ui, "serve": serve,
                    "ui_fault": ui_fault, "run_resume": run_resume,
                    "mp3": mp3, "atv": atv, "dab": dab, "ab": ab},
                   default=float))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
