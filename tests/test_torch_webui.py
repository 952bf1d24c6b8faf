"""Web panadapter of the port (sdrpp_tpu_torch/misc/webui.py), headless.

The counterpart of the cases of tests/test_webui.py, on the CPU
(``device="cpu"``): the HTTP API the page consumes (state JSON, binary
FFT/waterfall endpoints, the control plane, the progressive WAV stream),
the engine's state writes and background rebuilds, sessions and
bookmarks; the recovery ladder, the supervisor and the background
preheater are in tests/test_torch_webui_ladder.py. Where the port repairs a fault of the reference,
the repaired behaviour is asserted in place of the JAX one:

1. a supervised fatal exit saves the session first
   (tests/test_torch_webui_ladder.py,
   ``test_supervised_fatal_exit_saves_the_session``);
2. rung 4 declares fatal only when a probe of the device fails: a
   streak of plain exceptions keeps backing off, a CPU engine never exits
   (tests/test_torch_webui_ladder.py,
   ``test_ladder_rung4_only_on_a_poisoned_device``,
   ``test_supervised_engine_survives_plain_failures``);
3. ``set_bandwidth`` on an analog VFO not built yet is clamped and
   recorded, no rebuild of its own
   (``test_set_bandwidth_on_an_unbuilt_vfo_clamps_and_waits``);
4. every wait has a deadline; no test sleeps a fixed time.

``test_engine_matches_jax`` runs the JAX ``ReceiverEngine`` and the
port's on the same seeded IQ (WFM with RDS, NFM with squelch, USB and a
Meteor QPSK carrier in one 1 Msps capture) to the capture's end, with
four VFOs and no controls. The JAX loops run in interpret mode (but the
M&M, whose chunked branch the port does not take) so both sides take the
same chunked-or-exact branch. Tolerances, with their reasons: the analog
rings' int16 PCM from audio sample 1000 within -40 dB RMS of the JAX
ring plus 1 LSB (tests/test_torch_radio.py's bound; the int16 rounding
of a value within an ulp of .5 flips by one); the raw FFT lines within
1e-4 of the peak power (tests/test_torch_slice.py's front-end bound); RDS
PI and PS equal; the Meteor constellation the same symbol count and its
ring within the M&M's card-vs-CPU bound (max 0.05, RMS 5e-3: the M&M takes
the sign of each interpolated sample, so ulps part the loops briefly).
"""

import json
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sdrpp_tpu_torch.io.sources import TestSource
from sdrpp_tpu_torch.misc.webui import ReceiverEngine, WebUIServer

torch.set_num_threads(1)



def _engine(**kw):
    src = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    kw.setdefault("mode", "nfm")
    kw.setdefault("offset", 100000.0)
    kw.setdefault("fft_size", 4096)
    kw.setdefault("base_block", 65536)
    kw.setdefault("realtime", False)
    kw.setdefault("device", "cpu")
    return ReceiverEngine(src, **kw)


def _wait(pred, timeout=180.0):
    """Poll ``pred`` until it holds or the deadline passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _settle(eng, timeout=180.0):
    """Wait until no background rebuild is pending or building and the
    engine has streamed a block on the adopted chain."""
    ok = _wait(lambda: not eng.snapshot()["switching"], timeout)
    b0 = eng.blocks
    return ok and _wait(lambda: eng.blocks > b0, timeout)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def server():
    eng = _engine()
    srv = WebUIServer(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    eng.start()
    assert _wait(lambda: eng.blocks >= 2), eng.error
    yield srv, eng, f"http://127.0.0.1:{srv.server_address[1]}"
    eng.stop()
    srv.shutdown()
    srv.server_close()


def _get(url, binary=False):
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read()
        return (body, dict(r.headers)) if binary else json.loads(body)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_index_and_state(server):
    _, eng, base = server
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        page = r.read().decode()
    assert "<canvas" in page and "/api/state" in page

    st = _get(base + "/api/state")
    assert st["samplerate"] == 1000000.0
    assert st["mode"] == "nfm" and st["offset"] == 100000.0
    assert st["running"] and st["error"] is None
    assert st["blocks"] >= 2


def test_fft_endpoint_sees_the_tone(server):
    _, eng, base = server
    body, hdrs = _get(base + "/api/fft", binary=True)
    line = np.frombuffer(body, "<f4")
    assert len(line) == eng.waterfall.data_width
    peak = np.argmax(line)
    frac = peak / len(line) - 0.5
    assert abs(frac * 1000000.0 - 100000.0) < 5000.0
    assert line[peak] > line.mean() + 20.0


def test_waterfall_rows_advance(server):
    _, eng, base = server
    body, hdrs = _get(base + "/api/waterfall?since=0", binary=True)
    line0 = int(hdrs["X-Line"])
    rows = int(hdrs["X-Rows"])
    width = int(hdrs["X-Width"])
    assert rows >= 1 and width == eng.waterfall.data_width
    assert len(body) == rows * width * 4
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    _, hdrs2 = _get(base + f"/api/waterfall?since={line0}", binary=True)
    assert int(hdrs2["X-Line"]) > line0


def test_control_set_offset_and_mode(server):
    _, eng, base = server
    code, resp = _post(base + "/api/control",
                       {"action": "set_offset", "value": -200000.0})
    assert code == 200 and resp["ok"]
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert st["offset"] == -200000.0

    code, resp = _post(base + "/api/control",
                       {"action": "set_mode", "value": "am"})
    assert code == 200
    assert _settle(eng)
    st = _get(base + "/api/state")
    assert st["mode"] == "am" and st["error"] is None
    assert eng._built_cfgs["vfo0"]["mode"] == "am"
    _post(base + "/api/control", {"action": "set_mode", "value": "nfm"})
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_control_rejects_garbage(server):
    _, _, base = server
    code, resp = _post(base + "/api/control", {"action": "frobnicate"})
    assert code == 400 and "unknown action" in resp["error"]
    code, resp = _post(base + "/api/control",
                       {"action": "set_mode", "value": "chirp"})
    assert code == 400


def test_audio_stream_is_progressive_wav(server):
    _, eng, base = server
    with urllib.request.urlopen(base + "/audio.wav", timeout=30) as r:
        hdr = r.read(44)
        assert hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"
        fmt, channels, rate = struct.unpack_from("<HHI", hdr, 20)
        assert (fmt, channels, rate) == (1, 2, int(eng.audio_rate))
        (bits,) = struct.unpack_from("<H", hdr, 34)
        assert bits == 16
        pcm = r.read(4 * 4800)
        assert len(pcm) == 4 * 4800


def test_volume_and_range_controls(server):
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_volume", "value": 0.5})
    assert eng.volume == 0.5
    _post(base + "/api/control", {"action": "set_range",
                                  "value": [-90.0, -10.0]})
    st = _get(base + "/api/state")
    assert st["waterfall_min"] == -90.0 and st["waterfall_max"] == -10.0
    _post(base + "/api/control", {"action": "auto_range"})
    st = _get(base + "/api/state")
    assert st["waterfall_min"] != -90.0 or st["waterfall_max"] != -10.0


def test_engine_fft_hold_trace(server):
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_fft_hold", "value": True})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    body, hdrs = _get(base + "/api/fft", binary=True)
    assert hdrs.get("X-Hold") == "1"
    both = np.frombuffer(body, "<f4")
    assert len(both) == 2 * eng.waterfall.data_width
    _post(base + "/api/control", {"action": "set_fft_hold", "value": False})


def test_multi_vfo_add_select_delete(server):
    _, eng, base = server
    code, resp = _post(base + "/api/control",
                       {"action": "add_vfo",
                        "value": {"name": "vfoB", "mode": "am",
                                  "offset": -150000.0}})
    assert code == 200, resp
    assert _wait(lambda: "vfoB" in eng._built_cfgs)
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert set(st["vfos"]) == {"vfo0", "vfoB"}
    assert st["selected"] == "vfoB"
    assert st["vfos"]["vfoB"]["mode"] == "am"
    assert st["vfos"]["vfoB"]["offset"] == -150000.0

    for name in ("vfo0", "vfoB"):
        with urllib.request.urlopen(base + f"/audio.wav?vfo={name}",
                                    timeout=30) as r:
            hdr = r.read(44)
            assert hdr[:4] == b"RIFF"
            assert len(r.read(4 * 480)) == 4 * 480

    _post(base + "/api/control", {"action": "set_offset", "value": 50000.0})
    assert _wait(lambda: eng.vfos["vfoB"]["offset"] == 50000.0)
    st = _get(base + "/api/state")
    assert st["vfos"]["vfoB"]["offset"] == 50000.0
    assert st["vfos"]["vfo0"]["offset"] != 50000.0

    code, _ = _post(base + "/api/control",
                    {"action": "select_vfo", "value": "vfo0"})
    assert code == 200
    code, _ = _post(base + "/api/control",
                    {"action": "delete_vfo", "value": "vfoB"})
    assert code == 200
    assert _settle(eng)
    st = _get(base + "/api/state")
    assert set(st["vfos"]) == {"vfo0"} and st["selected"] == "vfo0"
    assert st["error"] is None

    code, resp = _post(base + "/api/control",
                       {"action": "delete_vfo", "value": "vfo0"})
    assert code == 400 and "last" in resp["error"]
    code, resp = _post(base + "/api/control",
                       {"action": "add_vfo", "value": {"name": "vfo0"}})
    assert code == 400
    code, resp = _post(base + "/api/control",
                       {"action": "select_vfo", "value": "nope"})
    assert code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/audio.wav?vfo=nope", timeout=30)
    assert exc.value.code == 404


def test_set_view_zoom(server):
    _, eng, base = server
    code, _ = _post(base + "/api/control",
                    {"action": "set_view", "value": [100000.0, 250000.0]})
    assert code == 200
    st = _get(base + "/api/state")
    assert st["view_offset"] == 100000.0
    assert st["view_bandwidth"] == 250000.0
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    body, _ = _get(base + "/api/fft", binary=True)
    line = np.frombuffer(body, "<f4")
    peak = np.argmax(line)
    f_peak = 100000.0 + (peak / len(line) - 0.5) * 250000.0
    assert abs(f_peak - 100000.0) < 2000.0
    _post(base + "/api/control",
          {"action": "set_view", "value": [0.0, 1000000.0]})


def test_control_type_validation_and_state_preservation(server):
    _, eng, base = server
    code, _ = _post(base + "/api/control",
                    {"action": "set_offset", "value": "oops"})
    assert code == 400
    code, _ = _post(base + "/api/control",
                    {"action": "add_vfo",
                     "value": {"name": "bad", "offset": "oops"}})
    assert code == 400
    st = _get(base + "/api/state")
    assert "bad" not in st["vfos"] and st["error"] is None

    # retuning a NEW vfo must not reset vfo0's carried DSP state
    code, _ = _post(base + "/api/control",
                    {"action": "add_vfo",
                     "value": {"name": "vfoC", "mode": "nfm",
                               "offset": -100000.0}})
    assert code == 200
    assert _wait(lambda: "vfoC" in eng._built_cfgs)
    _post(base + "/api/control", {"action": "set_offset", "value": -90000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    leaf = _leaves(eng._state[1]["vfo0"])
    fresh = _leaves(eng._channels["vfo0"].init_state())
    same_as_fresh = all(
        a.shape != b.shape or torch.allclose(a, b)
        for a, b in zip(leaf, fresh))
    assert not same_as_fresh, "vfo0 state was reset by another vfo's retune"
    _post(base + "/api/control", {"action": "select_vfo", "value": "vfo0"})
    _post(base + "/api/control", {"action": "delete_vfo", "value": "vfoC"})
    assert _settle(eng)


def _rds_capture(tmp_path, fs=240000.0, dev=75000.0, name=b"TRCHRDIO"):
    """WFM MPX with a 57 kHz RDS subcarrier (PI 0x2ABC, PS ``name``) as
    an f32 WAV, tests/test_webui.py's signal."""
    from sdrpp_tpu_torch.decoders import rds as rds_mod
    from sdrpp_tpu_torch.io.wav import write_wav
    from sdrpp_tpu_torch.models.rds_chain import RDS_BAUD

    bits = []
    for rep in range(16):
        for seg in range(4):
            block_b = (0 << 12) | (9 << 5) | seg
            blocks = [0x2ABC, block_b, 0xE0E0,
                      (name[seg * 2] << 8) | name[seg * 2 + 1]]
            bits += rds_mod.encode_group(blocks)
    bits = np.array(bits, np.uint8)
    diff = np.cumsum(bits.astype(np.int64)) % 2
    half = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    sps = fs / (2 * RDS_BAUD)
    n = int(len(half) * sps)
    k = np.floor(np.arange(n) / sps).astype(int)
    rds_bb = half[np.clip(k, 0, len(half) - 1)]
    rds_bb = np.convolve(rds_bb, np.ones(64) / 64.0, mode="same")
    t = np.arange(n) / fs
    l = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    mpx = (0.41 * l + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    iq = np.exp(1j * np.cumsum(2 * np.pi * dev * mpx / fs))
    p = tmp_path / f"rds_{int(fs)}Hz.wav"
    write_wav(p, int(fs), np.stack([iq.real * 0.8, iq.imag * 0.8], -1)
              .astype(np.float32), "f32")
    return p


def test_rds_through_engine(tmp_path):
    """WFM MPX with a 57 kHz RDS subcarrier -> wfm VFO with rds=True ->
    PI/PS fields in the state snapshot, waited for up to a deadline."""
    from sdrpp_tpu_torch.io.sources import FileSource

    src = FileSource(_rds_capture(tmp_path), loop=True)
    eng = ReceiverEngine(src, mode="wfm", offset=0.0, realtime=False,
                         base_block=131072, fft_size=4096, device="cpu")
    eng.control("set_rds", True)
    eng.start()
    try:
        def locked():
            if eng.error:
                raise AssertionError(eng.error)
            rx = eng._rds.get("vfo0")
            return rx is not None and rx.decoder.pi_code == 0x2ABC \
                and rx.decoder.ps_name == "TRCHRDIO"
        assert _wait(locked, timeout=300.0), (
            eng.error, {k: v.decoder.groups_decoded
                        for k, v in eng._rds.items()})
    finally:
        eng.stop()
    snap = eng.snapshot()
    rd = snap["vfos"]["vfo0"]["rds_data"]
    assert rd["pi"] == "2ABC" and rd["ps_name"] == "TRCHRDIO"
    assert rd["groups"] >= 4


def test_session_persistence_roundtrip(tmp_path):
    from sdrpp_tpu_torch.misc.webui import load_session, save_session

    cfg = tmp_path / "ui.json"
    eng = _engine()
    eng.control("add_vfo", {"name": "music", "mode": "wfm",
                            "offset": 250000.0})
    eng.control("set_rds", True)
    eng.control("set_volume", 0.7)
    eng.start()
    assert _wait(lambda: eng.blocks >= 1 and "music" in eng.vfos), eng.error
    eng.stop()
    save_session(eng, cfg)

    eng2 = _engine()
    load_session(eng2, cfg)
    assert set(eng2.vfos) == {"vfo0", "music"}
    assert eng2.selected == "music"
    assert eng2.vfos["music"]["mode"] == "wfm"
    assert eng2.vfos["music"]["rds"] is True
    assert eng2.volume == 0.7
    eng2.start()
    assert _wait(lambda: eng2.blocks >= 1), eng2.error
    eng2.stop()
    assert eng2.error is None


def test_raw_mode_and_deemphasis_controls(server):
    _, eng, base = server
    code, _ = _post(base + "/api/control",
                    {"action": "set_deemphasis", "value": "bogus"})
    assert code == 400
    for value, want in (("50us", "50us"), (None, None)):
        code, _ = _post(base + "/api/control",
                        {"action": "set_deemphasis", "value": value})
        assert code == 200
        assert _settle(eng)
        st = _get(base + "/api/state")
        assert st["deemphasis"] == want and st["error"] is None
        assert eng._built_cfgs["vfo0"]["deemphasis"] == want

    code, _ = _post(base + "/api/control",
                    {"action": "set_mode", "value": "raw"})
    assert code == 200
    assert _settle(eng)
    st = _get(base + "/api/state")
    assert st["mode"] == "raw" and st["error"] is None
    with urllib.request.urlopen(base + "/audio.wav", timeout=30) as r:
        assert r.read(44)[:4] == b"RIFF"
        assert len(r.read(4 * 480)) == 4 * 480
    _post(base + "/api/control", {"action": "set_mode", "value": "nfm"})
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})
    assert _settle(eng)


def test_bookmarks_roundtrip(tmp_path, server):
    _, eng, base = server
    eng.attach_bookmarks(tmp_path / "bm.json")
    st = _get(base + "/api/bookmarks")
    assert st["enabled"] and st["bookmarks"] == {}

    _post(base + "/api/control", {"action": "set_offset", "value": 120000.0})
    assert _wait(lambda: eng.vfos["vfo0"]["offset"] == 120000.0)
    code, _ = _post(base + "/api/control",
                    {"action": "add_bookmark", "value": {"name": "beacon"}})
    assert code == 200
    st = _get(base + "/api/bookmarks")
    assert st["bookmarks"]["beacon"]["frequency"] == 120000.0
    assert st["bookmarks"]["beacon"]["mode"] == "nfm"

    _post(base + "/api/control", {"action": "set_offset", "value": -50000.0})
    assert _wait(lambda: eng.vfos["vfo0"]["offset"] == -50000.0)
    code, _ = _post(base + "/api/control",
                    {"action": "apply_bookmark", "value": "beacon"})
    assert code == 200
    assert _wait(lambda: eng.vfos["vfo0"]["offset"] == 120000.0)
    assert _settle(eng)
    s = _get(base + "/api/state")
    assert s["offset"] == 120000.0 and s["mode"] == "nfm"
    assert s["error"] is None

    saved = json.loads((tmp_path / "bm.json").read_text())
    assert saved["lists"]["General"]["bookmarks"]["beacon"]["frequency"] \
        == 120000.0

    code, _ = _post(base + "/api/control",
                    {"action": "delete_bookmark", "value": "beacon"})
    assert code == 200
    st = _get(base + "/api/bookmarks")
    assert st["bookmarks"] == {}
    code, _ = _post(base + "/api/control",
                    {"action": "apply_bookmark", "value": "nope"})
    assert code == 400
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_set_offset_is_a_state_retune_not_a_rebuild(server):
    """Dynamic-offset VFOs: click-to-tune writes the VFO's state; the
    step (the chain) is reused."""
    _, eng, base = server
    assert _settle(eng)
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    step_before = eng._step
    _post(base + "/api/control", {"action": "set_offset", "value": -250000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    assert eng._step is step_before, "offset change rebuilt the chain"
    st = _get(base + "/api/state")
    assert st["offset"] == -250000.0 and st["error"] is None
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    assert eng._step is step_before
    assert eng.snapshot()["error"] is None


def test_scanner_parks_on_the_tone(server):
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_offset",
                                  "value": -400000.0})
    code, resp = _post(base + "/api/control",
                       {"action": "scan_start",
                        "value": {"start": -450000.0, "stop": 450000.0,
                                  "interval": 25000.0, "level": -45.0}})
    assert code == 200, resp

    def parked():
        if eng.error:
            raise AssertionError(eng.error)
        s = eng.snapshot()
        return (s["scanning"] and s["scan_receiving"]
                and abs(s["offset"] - 100000.0) < 26000.0)
    assert _wait(parked, timeout=120.0), eng.snapshot()
    code, _ = _post(base + "/api/control", {"action": "scan_stop"})
    assert code == 200
    assert _wait(lambda: not eng.snapshot()["scanning"])
    code, _ = _post(base + "/api/control",
                    {"action": "scan_start",
                     "value": {"start": 10.0, "stop": 5.0, "interval": 1.0}})
    assert code == 400
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def _qpsk_capture(tmp_path, fs=600000.0, rs=72000.0, n=1 << 19):
    from sdrpp_tpu_torch.io.wav import write_wav

    sps = fs / rs
    rng = np.random.default_rng(0)
    nsym = int(n / sps) + 2
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    k = np.floor(np.arange(n) / sps).astype(int)
    iq = qpsk[np.clip(k, 0, nsym - 1)]
    p = tmp_path / f"meteor_{int(fs)}Hz.wav"
    write_wav(p, int(fs), np.stack([iq.real * 0.7, iq.imag * 0.7], -1)
              .astype(np.float32), "f32")
    return p


def test_meteor_constellation_endpoint(tmp_path):
    """A meteor (digital) VFO: QPSK IQ -> MeteorChannel ->
    /api/constellation serves s8 x84 symbol pairs forming 4 points."""
    from sdrpp_tpu_torch.io.sources import FileSource

    src = FileSource(_qpsk_capture(tmp_path), loop=True)
    eng = ReceiverEngine(src, mode="meteor", offset=0.0, realtime=False,
                         base_block=131072, fft_size=4096, device="cpu")
    srv = WebUIServer(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    eng.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert _wait(lambda: eng.blocks >= 3), eng.error
        body, hdrs = _get(base + "/api/constellation?vfo=vfo0&n=1024",
                          binary=True)
        assert int(hdrs["X-Count"]) >= 512
        pts = np.frombuffer(body, np.int8).astype(np.float32) / 84.0
        z = pts[0::2] + 1j * pts[1::2]
        z = z[np.abs(z) > 0.3]
        assert len(z) > 400
        coh = np.abs(np.mean(np.exp(4j * np.mod(np.angle(z), np.pi / 2))))
        assert coh > 0.5, coh
        stt = _get(base + "/api/state")
        assert "meteor" in stt["modes"] and stt["mode"] == "meteor"
        assert stt["vfos"]["vfo0"]["mode"] == "meteor"
    finally:
        eng.stop()
        srv.shutdown()
        srv.server_close()


def test_constellation_ring_wraparound():
    eng = _engine()
    try:
        from sdrpp_tpu_torch.misc.webui import CONSTELLATION_RING
        R = CONSTELLATION_RING
        a = (np.arange(R - 100) + 1j * 0).astype(np.complex64)
        eng._write_constellation("vfo0", a)
        out = eng.read_constellation("vfo0", max_points=64)
        np.testing.assert_array_equal(out.real, np.arange(R - 164, R - 100))
        b = (np.arange(300) + 1000000.0).astype(np.complex64)
        eng._write_constellation("vfo0", b)
        out = eng.read_constellation("vfo0", max_points=512)
        want = np.concatenate([np.arange(R - 312, R - 100),
                               np.arange(300) + 1000000.0])
        np.testing.assert_array_equal(out.real, want.astype(np.float32))
    finally:
        eng.stop()


def test_meteor_vfo_retune_is_state_only():
    src = TestSource(600000.0, tones=[(50000.0, -20.0)], noise_dbfs=-60.0)
    eng = ReceiverEngine(src, mode="meteor", offset=0.0, realtime=False,
                         base_block=65536, fft_size=4096, device="cpu")
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        eng.control("set_offset", 50000.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["offset"] == 50000.0
        assert eng._step is step_before
        assert eng.error is None
    finally:
        eng.stop()


def test_queued_add_then_delete_validates_in_request_order():
    eng = _engine()
    try:
        eng.control("add_vfo", {"name": "q1", "offset": 0.0})
        eng.control("select_vfo", "q1")
        eng.control("delete_vfo", "q1")
        with pytest.raises(ValueError):
            eng.control("delete_vfo", "q1")
        with pytest.raises(ValueError):
            eng.control("add_vfo", {"name": "vfo0", "offset": 0.0})
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        assert set(eng.vfos) == {"vfo0"}
    finally:
        eng.stop()


def test_set_squelch_is_a_state_write_not_a_rebuild():
    eng = _engine(squelch=-70.0)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        eng.control("set_squelch", -55.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["squelch"] == -55.0
        assert eng._step is step_before
        lvl = float(eng._state[1]["vfo0"]["squelch"]["level"])
        assert lvl == -55.0
        eng.control("set_squelch", None)
        assert _wait(lambda: eng._step is not step_before), eng.error
    finally:
        eng.stop()


def test_set_bandwidth_is_a_state_write_not_a_rebuild():
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        eng.control("set_bandwidth", 9137.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["bandwidth"] == 9137.0
        assert eng._step is step_before
        chan = eng._channels["vfo0"]
        t = eng._state[1]["vfo0"]["vfo"]["filter"]["taps"]
        expect = chan.vfo.filter.taps_state(
            chan.vfo.design_channel_taps(9137.0))
        assert torch.equal(t, expect)
        eng.control("set_bandwidth", 5.0)
        assert _wait(lambda: eng.vfos["vfo0"]["bandwidth"] == 1000.0), \
            eng.vfos["vfo0"]["bandwidth"]
        assert eng._step is step_before
        eng.control("set_bandwidth", None)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["bandwidth"] is None
        assert eng._step is step_before
        assert eng.failures == 0
    finally:
        eng.stop()


def test_set_bandwidth_on_an_unbuilt_vfo_clamps_and_waits():
    """Fix 3 (webui.py:731 of the reference): set_bandwidth on an analog
    VFO whose channel is not built yet clamps the value to the mode's
    range and records it, with no rebuild of its own; the pending build
    writes it into the new channel's state."""
    eng = _engine()
    try:
        eng.control("add_vfo", {"name": "b", "mode": "usb",
                                "offset": -150000.0})
        requests = []
        real = eng._request_rebuild

        def counting():
            requests.append(1)
            real()

        eng._request_rebuild = counting
        eng._apply_controls()  # the add: one rebuild request
        assert requests == [1] and "b" not in eng._channels
        eng.control("set_bandwidth", 123456.0)  # usb: 500 .. 24000 Hz
        eng._apply_controls()
        assert requests == [1]  # no rebuild of its own
        assert eng.vfos["b"]["bandwidth"] == 24000.0
        eng.control("set_bandwidth", 5.0)
        eng._apply_controls()
        assert eng.vfos["b"]["bandwidth"] == 500.0 and requests == [1]
        eng.start()
        assert _wait(lambda: "b" in eng._built_cfgs), eng.error
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 1), eng.error
        chan = eng._channels["b"]
        taps = eng._state[1]["b"]["vfo"]["filter"]["taps"]
        assert torch.equal(taps, chan.vfo.filter.taps_state(
            chan.vfo.design_channel_taps(500.0)))
        assert eng._built_cfgs["b"]["bandwidth"] == 500.0
        assert eng.failures == 0 and eng.error is None
    finally:
        eng.stop()


def test_raw_bandwidth_change_rebuilds_cleanly():
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        eng.control("set_mode", "raw")
        assert _settle(eng, timeout=240)
        assert eng._built_cfgs["vfo0"]["mode"] == "raw"
        f0 = eng.failures
        eng.control("set_bandwidth", 30000.0)
        assert _wait(lambda: eng._built_cfgs["vfo0"].get("bandwidth")
                     is not None, timeout=240)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.failures == f0 and eng.error is None
        from sdrpp_tpu_torch.misc.webui import _DIGITAL_BW_GRID
        assert eng.vfos["vfo0"]["bandwidth"] in _DIGITAL_BW_GRID
    finally:
        eng.stop()


def test_adopt_carries_untouched_vfo_state():
    eng = _engine()
    try:
        with eng.lock:
            eng.vfos["b"] = dict(mode="am", offset=-150000.0,
                                 bandwidth=None, squelch=None,
                                 deemphasis=None, rds=False)
        eng._build()
        state_a = eng._state[1]["vfo0"]
        with eng.lock:
            cfgs = {k: dict(v) for k, v in eng.vfos.items()}
        cfgs["b"]["mode"] = "usb"
        with eng.lock:
            eng.vfos["b"]["mode"] = "usb"
        eng._adopt(eng._plan(cfgs))
        old_leaves = _leaves(state_a)
        new_leaves = _leaves(eng._state[1]["vfo0"])
        assert len(old_leaves) == len(new_leaves)
        assert all(a is b for a, b in zip(old_leaves, new_leaves))
        assert eng._built_cfgs["b"]["mode"] == "usb"
    finally:
        eng.stop()


def test_rapid_mode_churn_coalesces_to_last():
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        for m in ("am", "usb", "wfm", "lsb", "cw"):
            eng.control("set_mode", m)
        assert _settle(eng, timeout=240)
        assert eng.vfos["vfo0"]["mode"] == "cw"
        assert eng._built_cfgs["vfo0"]["mode"] == "cw"
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0)
        assert eng.error is None and eng._thread.is_alive()
    finally:
        eng.stop()


def test_session_persists_digital_vfo(tmp_path):
    from sdrpp_tpu_torch.misc.webui import load_session, save_session

    cfg = tmp_path / "ui.json"
    eng = _engine()
    with eng.lock:
        eng.vfos["sat"] = dict(mode="meteor", offset=-150000.0,
                               bandwidth=140000.0, squelch=None,
                               deemphasis=None, rds=False)
        eng._ensure_audio_ring("sat")
    save_session(eng, cfg)

    eng2 = _engine()
    load_session(eng2, cfg)
    assert "sat" in eng2.vfos and eng2.vfos["sat"]["mode"] == "meteor"
    assert "sat" in eng2._digital


def test_engine_defaults_to_the_card():
    """With no device named the engine builds on CUDA; without a card it
    raises rather than falling back to the CPU."""
    import inspect

    assert inspect.signature(ReceiverEngine).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = TestSource(1000000.0)
    with pytest.raises((RuntimeError, AssertionError)):
        ReceiverEngine(src, mode="nfm", fft_size=4096, base_block=65536)


# ---- the JAX engine and the port's on the same capture ----

FS = 1e6
PARITY_N = 1 << 20
PARITY_VFOS = {
    "fm": dict(mode="wfm", offset=250e3, bandwidth=None, squelch=None,
               deemphasis="50us", rds=True),
    "nfm": dict(mode="nfm", offset=-100e3, bandwidth=None, squelch=-50.0,
                deemphasis=None, rds=False),
    "usb": dict(mode="usb", offset=-30e3, bandwidth=None, squelch=None,
                deemphasis=None, rds=False),
    "sat": dict(mode="meteor", offset=-300e3, bandwidth=None, squelch=None,
                deemphasis=None, rds=False),
}
PARITY_PI, PARITY_PS = 0x2ABC, "PORT+JAX"


def _parity_capture(n, seed=3):
    """1 Msps: WFM stereo with a 57 kHz RDS subcarrier at +250 kHz, NFM
    (1 kHz) at -100 kHz, a USB tone 1.5 kHz above -30 kHz, 72 ksym/s QPSK
    at -300 kHz, seeded noise."""
    from sdrpp_tpu_torch.decoders.rds import encode_group

    t = np.arange(n) / FS
    bits = []
    name = PARITY_PS.encode()
    while len(bits) < n / FS * 1187.5 + 208:
        for seg in range(4):
            bits += encode_group([PARITY_PI, (9 << 5) | seg, 0xE0E0,
                                  (name[2 * seg] << 8) | name[2 * seg + 1]])
    diff = np.cumsum(np.asarray(bits, np.int64)) % 2
    half = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    k = np.floor(t * 2 * 1187.5).astype(np.int64)
    c = np.concatenate([[0.0], np.cumsum(half[k])])
    w = 266  # the JAX test's 64-sample smoothing at 240 kHz
    lo = np.clip(np.arange(n) - w // 2, 0, n)
    hi = np.clip(np.arange(n) + w // 2, 0, n)
    rds_bb = (c[hi] - c[lo]) / w
    l = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.4 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.41 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.41 * (l - r) * np.sin(2 * np.pi * 38000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    x = 0.5 * np.exp(1j * (2 * np.pi * 250e3 * t
                           + np.cumsum(2 * np.pi * 75000.0 * mpx / FS)))
    x += 0.1 * np.exp(1j * (2 * np.pi * -100e3 * t
                            + 3.0 * np.sin(2 * np.pi * 1000.0 * t)))
    x += 0.05 * np.exp(2j * np.pi * (-30e3 + 1500.0) * t)
    rng = np.random.default_rng(seed)
    sps = FS / 72000.0
    nsym = int(n / sps) + 2
    q = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    x += 0.2 * q[np.floor(np.arange(n) / sps).astype(int)] \
        * np.exp(2j * np.pi * -300e3 * t)
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


class _ToEOF:
    """A FileSource (loop=False) whose last read is short, so the engine
    stops at the capture's end (FileSource pads its last block)."""

    def __init__(self, fsrc):
        self.fsrc = fsrc
        self.samplerate = fsrc.samplerate
        self.center_freq = 0.0

    def read(self, n):
        return self.fsrc.read(min(n, self.fsrc.num_frames - self.fsrc.pos))


def _interpret_loops(block, seen=None):
    """The JAX block tree's Pallas loops in interpret mode, the M&M's
    included (the port takes the chunked M&M by JAX's accelerator rule)."""
    seen = set() if seen is None else seen
    if id(block) in seen:
        return
    seen.add(id(block))
    if hasattr(block, "interpret"):
        block.interpret = True
    for v in getattr(block, "__dict__", {}).values():
        if hasattr(v, "__dict__"):
            _interpret_loops(v, seen)


def _run_to_eof(eng):
    with eng.lock:
        eng.vfos = {k: dict(v) for k, v in PARITY_VFOS.items()}
        eng.selected = "fm"
        for k in PARITY_VFOS:
            eng._ensure_audio_ring(k)
    eng._build()
    eng.start()
    eng._thread.join(timeout=600)
    assert not eng._thread.is_alive(), "engine did not stop at the end"
    assert eng.error is None and eng.failures == 0, eng.error
    return eng


def test_engine_matches_jax(tmp_path, monkeypatch):
    import jax  # noqa: F401  (the JAX engine, on the CPU per conftest)

    from sdrpp_tpu.io.sources import FileSource as JFileSource
    from sdrpp_tpu.misc import webui as jwebui
    from sdrpp_tpu.ops import resample as jresample
    from sdrpp_tpu_torch.io.sources import FileSource
    from sdrpp_tpu_torch.io.wav import write_wav

    monkeypatch.setattr(jresample, "POLYPHASE_MODE", "zero_stuff")
    iq = _parity_capture(PARITY_N)
    path = tmp_path / "parity_1000000Hz.wav"
    write_wav(path, int(FS), np.stack([iq.real, iq.imag], -1), "f32")

    kw = dict(mode="nfm", realtime=False, fft_size=4096, base_block=65536)
    port = _run_to_eof(ReceiverEngine(_ToEOF(FileSource(path, loop=False)),
                                      device="cpu", **kw))
    jeng = jwebui.ReceiverEngine(_ToEOF(JFileSource(path, loop=False)), **kw)
    real_plan = jeng._plan

    def plan(cfgs):
        p = real_plan(cfgs)
        for chan in p["channels"].values():
            _interpret_loops(chan)
        return p

    jeng._plan = plan
    jax_eng = _run_to_eof(jeng)

    assert port._block == jax_eng._block
    assert port.blocks == jax_eng.blocks == PARITY_N // port._block
    for name in ("fm", "nfm", "usb"):
        a, b = port._audio[name], jax_eng._audio[name]
        assert a["written"] == b["written"] > 1000
        got = a["ring"][1000:a["written"]].astype(np.float64)
        want = b["ring"][1000:b["written"]].astype(np.float64)
        rms_d = np.sqrt(np.mean((got - want) ** 2))
        rms_w = np.sqrt(np.mean(want ** 2))
        assert rms_w > 1000.0, name  # each VFO hears its station
        assert rms_d <= 10 ** (-40 / 20) * rms_w + 1.0, (name, rms_d, rms_w)
    lt, lj = port.waterfall.fft_lines, jax_eng.waterfall.fft_lines
    assert lt == lj > 0
    pj = 10 ** (jax_eng.waterfall.raw_ffts[:lj] / 10)
    pt = 10 ** (port.waterfall.raw_ffts[:lt] / 10)
    assert np.abs(pj - pt).max() <= 1e-4 * pj.max()
    td, jd = port._rds["fm"].decoder, jax_eng._rds["fm"].decoder
    assert td.pi_code == jd.pi_code == PARITY_PI
    assert td.ps_name == jd.ps_name == PARITY_PS
    assert port.snapshot()["vfos"]["fm"]["rds_data"] \
        == jax_eng.snapshot()["vfos"]["fm"]["rds_data"]
    assert port._const["sat"]["written"] == jax_eng._const["sat"]["written"]
    ct = port.read_constellation("sat", 4096)
    cj = jax_eng.read_constellation("sat", 4096)
    d = np.abs(ct - cj)
    assert d.max() <= 0.05 and np.sqrt(np.mean(d ** 2)) <= 5e-3
