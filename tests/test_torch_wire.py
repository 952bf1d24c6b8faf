"""Port parity for the baseband wire protocol and the network IQ sources.

- ``ops.compression``: ``quantize_block`` / ``pack_frame`` bytes equal
  the JAX package's for i8, i16 and f32 blocks, negative samples that
  saturate under the reference's signed-max scaler included (the port
  takes JAX's float32 steps in its order: an IEEE division, the product,
  round half to even, the clip); ``unpack_frame`` equal too.
- ``io.wire``: a JAX ``BasebandClient`` against the port's
  ``BasebandServer`` and the port's client against the JAX server: every
  frame equal, with the remote-UI schema and actions.
- ``io.rtl_tcp``, ``spyserver``, ``kiwisdr``, ``hpsdr`` (and Hermes-Lite
  2), ``rfspace``, ``spectran``: each against the mock servers of
  tests/test_wire.py and tests/test_hpsdr_rfspace.py (copied here), once
  with the JAX source and once with the port's: the same samples, bit
  for bit, and the same bytes on the wire.
- ``cli serve``, ``ui`` and ``preheat``: argument parsing, every
  ``--source`` form reaching its source class, ``serve`` streaming to a
  client and ``ui`` serving its routes, on the CPU.

All of it runs on the host; nothing needs the card.
"""

import argparse
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.io import wire as jwire
from sdrpp_tpu.ops import compression as jcomp
from sdrpp_tpu_torch.io import wire as twire
from sdrpp_tpu_torch.ops import compression as tcomp

REPO = Path(__file__).resolve().parent.parent
PCMS = [tcomp.PCM_TYPE_I8, tcomp.PCM_TYPE_I16, tcomp.PCM_TYPE_F32]


def _block(seed, n=4096, scale=0.5):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("pcm", PCMS)
def test_pack_frame_bytes_equal_jax(pcm):
    """Frames equal byte for byte over blocks whose most negative sample
    lies far below the signed max (those saturate), and over a block of
    exact ties at the rounding step (x.5 after scaling)."""
    blocks = [_block(s, scale=10.0 ** (s % 4 - 2)) for s in range(12)]
    skew = _block(99)
    skew.real[::7] -= 3.0  # negatives far past the signed max: saturate
    ties = np.full(64, 0.25 + 0.25j, np.complex64)
    ties[0] = 1.0  # scale 32768: every 0.25 lands on an exact integer
    ties[1:9] = (np.arange(8) + 0.5) / 32768.0
    for x in blocks + [skew, ties]:
        assert tcomp.pack_frame(x, pcm) == jcomp.pack_frame(x, pcm)
        frame = jcomp.pack_frame(x, pcm)
        np.testing.assert_array_equal(
            tcomp.unpack_frame(frame).view(np.float32),
            jcomp.unpack_frame(frame).view(np.float32))
    if pcm != tcomp.PCM_TYPE_F32:
        q, scaler = tcomp.quantize_block(torch.from_numpy(skew), pcm)
        lo = torch.iinfo(q.dtype).min
        assert (q == lo).sum() > 0  # the quirk's saturation happened
        jq, js = jcomp.quantize_block(jnp.asarray(skew), pcm)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scaler) == float(js)


def test_quantize_on_a_tensor_batch():
    """[B, n] blocks quantize row by row with one scaler a row, as the JAX
    function does, and dequantize back to the JAX values."""
    x = np.stack([_block(1), _block(2, scale=3.0)])
    for pcm in (tcomp.PCM_TYPE_I8, tcomp.PCM_TYPE_I16):
        q, s = tcomp.quantize_block(torch.from_numpy(x), pcm)
        jq, js = jcomp.quantize_block(jnp.asarray(x), pcm)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = tcomp.dequantize_block(q, s[:, None], pcm)
        jback = jcomp.dequantize_block(jq, js[:, None], pcm)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def _session(server_mod, client_mod):
    """One baseband session between a server and a client of the given
    modules: tune, GET_UI / UI_ACTION, two i16 blocks, an i8 and an f32
    block (SET_SAMPLE_TYPE), a compressed block, the samplerate push.
    Returns what the client received."""
    srv = server_mod.BasebandServer(samplerate=250000.0,
                                    pcm_type=tcomp.PCM_TYPE_I16)
    srv.register_control("gain", "float", 20.0, label="Gain (dB)",
                         min=0.0, max=49.6)
    applied, tuned = [], []
    srv.on_control = lambda n, v: applied.append((n, v))
    srv.on_tune = tuned.append
    cli = client_mod.BasebandClient("127.0.0.1", srv.port)
    got = []
    try:
        cli.set_frequency(7.1e6)
        got.append(cli.read_packet())
        got.append(cli.get_ui())
        got.append((cli.ui_action("gain", 33.5), cli.ui_action("gain", 99.0)))
        cli.start()
        _until(lambda: srv.running)
        for k, pcm in enumerate((1, 1, 0, 2)):
            if pcm != srv.pcm_type:
                cli.set_sample_type(pcm)
                _until(lambda: srv.pcm_type == pcm)
            srv.send_baseband(_block(10 + k))
            got.append(cli.read_packet())
        cli.set_sample_type(1)
        _until(lambda: srv.pcm_type == 1)
        cli.set_compression(True)
        _until(lambda: srv.compression)
        srv.send_baseband(_block(20))
        got.append(cli.read_packet())
        srv.set_samplerate(96000.0)
        got.append(cli.read_packet())
        cli.stop()
        _until(lambda: not srv.running)
    finally:
        cli.close()
        srv.close()
    return got, applied, tuned


def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _same(a, b):
    assert type(a) is type(b), (a, b)
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a.view(np.float32), b.view(np.float32))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")],
                         ids=["port-server", "port-client"])
def test_baseband_session_across_packages(server, client):
    """Each package's client against the other's server: everything the
    client reads equals a JAX-to-JAX session's, frame for frame."""
    mods = {"torch": twire, "jax": jwire}
    want = _session(jwire, jwire)
    got = _session(mods[server], mods[client])
    _same(got, want)
    kinds = [g[0] for g in got[0][3:8]]
    assert kinds == ["baseband"] * 5


# ---- the network sources against mock servers (copied from the JAX
# package's tests, each run once for each package's source) ----

def _rtl_tcp_session(make):
    received_cmds = []
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    n_samples = 4096
    rng = np.random.default_rng(3)
    iq_u8 = rng.integers(0, 256, 2 * n_samples).astype(np.uint8)

    def server():
        conn, _ = srv.accept()
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T, 29 gains
        conn.settimeout(5.0)
        conn.sendall(iq_u8.tobytes())
        try:
            while True:
                data = conn.recv(5)
                if len(data) < 5:
                    break
                received_cmds.append(struct.unpack(">BI", data))
        except OSError:
            pass
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    src = make("127.0.0.1", port, samplerate=2400000.0)
    try:
        head = (src.magic, src.tuner_type, src.tuner_gain_count)
        src.tune(100e6)
        src.set_gain_mode(True)
        src.set_gain(496)
        iq = src.read(n_samples)
    finally:
        src.close()
        srv.close()
    t.join(timeout=5)
    want = (iq_u8.astype(np.float32) - 128.0) / 128.0
    np.testing.assert_allclose(iq.view(np.float32), want, atol=1e-6)
    return iq, head, received_cmds


def _spyserver_session(mod):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    rng = np.random.default_rng(4)
    iq16 = rng.integers(-32768, 32768, 2 * 2048).astype("<i2")
    received = []
    ss = mod

    def server():
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        hdr = conn.recv(8)
        cmd, size = struct.unpack("<II", hdr)
        body = conn.recv(size)
        received.append((cmd, body[:4]))
        di = struct.pack("<12I", 1, 42, 2500000, 2000000, 8, 1, 21,
                         24000000, 1700000000, 16, 0, 0)
        conn.sendall(struct.pack("<IIIII", ss.PROTOCOL_VERSION,
                                 ss.MSG_DEVICE_INFO, 0, 0, len(di)) + di)
        cs = struct.pack("<9I", 1, 10, 100000000, 100000000, 100000000,
                         24000000, 1700000000, 24000000, 1700000000)
        conn.sendall(struct.pack("<IIIII", ss.PROTOCOL_VERSION,
                                 ss.MSG_CLIENT_SYNC, 0, 1, len(cs)) + cs)
        for _ in range(4):
            h = conn.recv(8)
            if len(h) < 8:
                break
            c, sz = struct.unpack("<II", h)
            received.append((c, conn.recv(sz)))
        payload = iq16.tobytes()
        conn.sendall(struct.pack("<IIIII", ss.PROTOCOL_VERSION,
                                 ss.MSG_INT16_IQ, 1, 2, len(payload))
                     + payload)
        try:
            conn.recv(1)
        except OSError:
            pass
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    src = ss.SpyServerSource("127.0.0.1", port)
    try:
        info = (src.device_info, src.sync)
        src.tune(100e6)
        src.start()
        iq = src.read(2048)
    finally:
        src.close()
        srv.close()
    t.join(timeout=5)
    np.testing.assert_allclose(iq.view(np.float32),
                               iq16.astype(np.float32) / 32768.0, atol=1e-6)
    return iq, info, received


def _kiwisdr_session(mod):
    from websockets.sync.server import serve

    rng = np.random.default_rng(5)
    iq16 = rng.integers(-32768, 32768, 1024).astype(">i2")
    received_texts = []
    ready = threading.Event()
    holder = {}

    def handler(ws):
        while True:
            m = ws.recv()
            received_texts.append(m)
            if isinstance(m, str) and m.startswith("SET keepalive"):
                break
        snd = b"SND" + bytes([0x08]) + b"\x00" * (mod.IQ_HEADER_SIZE - 4) \
            + iq16.tobytes()
        ws.send(b"MSG audio_init=0")  # non-SND frame must be ignored
        ws.send(snd)
        ws.send(snd)
        try:
            ws.recv(timeout=2)
        except Exception:
            pass

    def run_server():
        with serve(handler, "127.0.0.1", 0) as server:
            holder["server"] = server
            holder["port"] = server.socket.getsockname()[1] \
                if hasattr(server, "socket") else \
                list(server.sockets)[0].getsockname()[1]
            ready.set()
            server.serve_forever()

    t = threading.Thread(target=run_server, daemon=True)
    t.start()
    assert ready.wait(5)
    src = mod.KiwiSDRSource("127.0.0.1", holder["port"], freq_hz=7074000.0)
    try:
        iq = src.read(1024)  # two 512-sample frames
    finally:
        src.close()
        holder["server"].shutdown()
    t.join(timeout=5)
    want = np.tile(iq16.astype(np.float32) / 32768.0, 2)
    np.testing.assert_allclose(iq.view(np.float32), want, atol=1e-6)
    return iq, received_texts


def _make_ep6_packet(hp, seq, iq24, num_rx=1):
    step = num_rx * 6 + 2
    per_frame = (hp.USABLE_BUF_LEN[num_rx] - 8) // step
    frames = []
    for half in (iq24[:per_frame], iq24[per_frame:]):
        body = bytearray()
        for re, im in half:
            body += int(im & 0xFFFFFF).to_bytes(3, "big")
            body += int(re & 0xFFFFFF).to_bytes(3, "big")
            body += b"\x00" * (step - 6)
        frames.append((b"\x7f\x7f\x7f" + b"\x00" * 5 + bytes(body))
                      .ljust(512, b"\x00"))
    hdr = struct.pack(">HBBI", hp.METIS_SIGNATURE, hp.PKT_USB, hp.EP6, seq)
    return hdr + frames[0] + frames[1]


def _hpsdr_discovery(hp):
    radio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    radio.bind(("127.0.0.1", 0))
    radio.settimeout(5.0)
    port = radio.getsockname()[1]
    got = []

    def responder():
        pkt, addr = radio.recvfrom(1024)
        got.append(pkt)
        resp = struct.pack(">HB6sBB", 0xEFFE, 2, b"\x02\xaa\xbb\xcc\xdd\xee",
                           31, 1)
        radio.sendto(resp, addr)

    t = threading.Thread(target=responder, daemon=True)
    t.start()
    found = hp.discover("127.0.0.1", port, timeout=1.0)
    t.join(timeout=5)
    radio.close()
    return got, [(i.status, i.board_id, i.board_name, i.ver_major,
                  i.ver_minor, i.mac) for i in found]


def _hpsdr_session(hp):
    radio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    radio.bind(("127.0.0.1", 0))
    radio.settimeout(5.0)
    port = radio.getsockname()[1]
    rng = np.random.default_rng(7)
    n_per_pkt = 2 * (504 // 8)
    iq24 = rng.integers(-(1 << 23), 1 << 23, (2 * n_per_pkt, 2), np.int64) \
        .astype(np.int32)
    ctl_packets = []

    def radio_worker():
        client = None
        for _ in range(40):
            pkt, addr = radio.recvfrom(2048)
            client = addr
            if pkt[2] == hp.PKT_USB:
                ctl_packets.append(pkt)
                if len(ctl_packets) == 6:
                    break
        radio.sendto(_make_ep6_packet(hp, 0, iq24[:n_per_pkt]), client)
        radio.sendto(_make_ep6_packet(hp, 1, iq24[n_per_pkt:]), client)
        try:
            while True:
                radio.recvfrom(2048)
        except OSError:
            pass

    t = threading.Thread(target=radio_worker, daemon=True)
    t.start()
    src = hp.HpsdrSource("127.0.0.1", port, samplerate=192000.0)
    try:
        src.tune(7.1e6)
        src.set_preamp(True)
        src.set_atten(10)
        src.start()
        iq = src.read(2 * n_per_pkt)
    finally:
        src.close()
    t.join(timeout=5)
    radio.close()
    want = (iq24.astype(np.float32) + 0.5) / (8388608.0 - 0.5)
    np.testing.assert_allclose(iq.real, want[:, 0], atol=1e-7)
    assert src.seq_losses == 0 and src.sync_losses == 0
    # the control pages the radio saw, by page number (their order in
    # the packets depends on the pacing)
    pages = {}
    for pkt in ctl_packets:
        for off in (8, 520):
            c = pkt[off + 3:off + 8]
            pages[c[0] >> 1] = bytes(c)
    return iq, pages


def _hermes_session(hp):
    radio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    radio.bind(("127.0.0.1", 0))
    radio.settimeout(5.0)
    port = radio.getsockname()[1]
    regs = {}
    rng = np.random.default_rng(8)
    si = rng.integers(-(1 << 23), 1 << 23, 126, np.int64).astype(np.int32)
    sq = rng.integers(-(1 << 23), 1 << 23, 126, np.int64).astype(np.int32)

    def radio_worker():
        client = None
        for _ in range(10):
            pkt, addr = radio.recvfrom(2048)
            client = addr
            if pkt[2] == hp.PKT_USB and pkt[3] == hp.EP2:
                frame = pkt[8:520]
                if frame[:3] == b"\x7f\x7f\x7f":
                    regs[frame[3] >> 1] = struct.unpack(">I", frame[4:8])[0]
            if len(regs) >= 3:
                break
        frames = []
        for half in (range(0, 63), range(63, 126)):
            body = bytearray()
            for i in half:
                body += int(si[i] & 0xFFFFFF).to_bytes(3, "big")
                body += int(sq[i] & 0xFFFFFF).to_bytes(3, "big")
                body += b"\x00\x00"
            frames.append((b"\x7f\x7f\x7f" + b"\x00" * 5
                           + bytes(body)).ljust(512, b"\x00"))
        hdr = struct.pack(">HBBI", 0xEFFE, 0x01, 0x06, 0)
        radio.sendto(hdr + frames[0] + frames[1], client)

    t = threading.Thread(target=radio_worker, daemon=True)
    t.start()
    src = hp.HermesLite2Source("127.0.0.1", port, samplerate=384000.0)
    try:
        src.start()
        src.tune(14.2e6)
        src.set_gain(20)
        iq = src.read(126)
    finally:
        src.close()
    t.join(timeout=5)
    radio.close()
    np.testing.assert_allclose(iq.real, sq.astype(np.float32) / 0x1000000,
                               atol=1e-7)
    return iq, regs


def _rfspace_session(rfs):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    received = []
    udp_ready = threading.Event()
    client_udp = []
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp.bind(("127.0.0.1", port))
    udp.settimeout(5.0)
    rng = np.random.default_rng(9)
    iq16 = rng.integers(-32768, 32768, 2 * 512).astype("<i2")

    def udp_worker():
        data, addr = udp.recvfrom(64)
        assert data == b"\x5A"
        client_udp.append(addr)
        udp_ready.set()

    def tcp_worker():
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        hdr = conn.recv(2)
        raw = struct.unpack("<H", hdr)[0]
        body = conn.recv((raw & 0x1FFF) - 2)
        received.append((raw >> 13, body))
        payload = struct.pack("<HI", rfs.ITEM_PROD_ID, rfs.DEV_ID_NET_SDR)
        conn.sendall(struct.pack("<H", (2 + len(payload))
                                 | (rfs.MSG_SET_CTRL_ITEM_RESP << 13))
                     + payload)
        try:
            while True:
                hdr = conn.recv(2)
                if len(hdr) < 2:
                    break
                raw = struct.unpack("<H", hdr)[0]
                size = raw & 0x1FFF
                body = conn.recv(size - 2) if size > 2 else b""
                received.append((raw >> 13, body))
                if len(body) >= 3 and struct.unpack("<H", body[:2])[0] == \
                        rfs.ITEM_STATE and body[3:4] == bytes([rfs.STATE_RUN]):
                    udp_ready.wait(5)
                    payload = iq16.tobytes()
                    pkt = struct.pack("<HH", (4 + len(payload)) & 0x1FFF
                                      | (rfs.MSG_DATA_ITEM_0 << 13),
                                      0) + payload
                    udp.sendto(pkt, client_udp[0])
        except OSError:
            pass
        conn.close()

    tu = threading.Thread(target=udp_worker, daemon=True)
    tt = threading.Thread(target=tcp_worker, daemon=True)
    tu.start()
    tt.start()
    src = rfs.RFspaceSource("127.0.0.1", port)
    try:
        ident = (src.device_id, src.device_name)
        src.tune(14.1e6)
        src.set_gain(-10)
        src.start()
        iq = src.read(512)
    finally:
        src.close()
    tt.join(timeout=5)
    srv.close()
    udp.close()
    np.testing.assert_allclose(iq.view(np.float32),
                               iq16.astype(np.float32) / 32768.0, atol=1e-7)
    # heartbeats (REQ of the STATE item, one a second) depend on timing
    sets = [(t, b) for t, b in received if t != rfs.MSG_REQ_CTRL_ITEM
            or struct.unpack("<H", b[:2])[0] != rfs.ITEM_STATE]
    return iq, ident, sets


def _spectran_session(mod):
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    rng = np.random.default_rng(11)
    iq = (rng.standard_normal(2 * 1024) * 0.2).astype("<f4")
    control_reqs = []

    def make_chunk(payload, start, end):
        meta = json.dumps({"startFrequency": start, "endFrequency": end,
                           "sampleFrequency": end - start}).encode()
        body = meta + b"\n" + b"\x1e" + payload
        return f"{len(body):x}\r\n".encode() + body + b"\r\n"

    def server():
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        req = b""
        while b"\r\n\r\n" not in req:
            req += conn.recv(4096)
        conn.sendall(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n")
        conn.sendall(make_chunk(iq[:1024].tobytes(), 99_000_000, 101_000_000))
        conn.sendall(make_chunk(iq[1024:].tobytes(), 99_000_000, 101_000_000))
        ctrl, _ = srv.accept()
        ctrl.settimeout(5.0)
        creq = b""
        while b"\r\n\r\n" not in creq:
            creq += ctrl.recv(4096)
        head, body = creq.split(b"\r\n\r\n", 1)
        clen = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                    if ln.lower().startswith(b"content-length")][0])
        while len(body) < clen:
            body += ctrl.recv(4096)
        control_reqs.append((head.split(b"\r\n")[0], json.loads(body)))
        ctrl.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")
        ctrl.close()
        try:
            conn.recv(1)
        except OSError:
            pass
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    src = mod.SpectranHTTPSource("127.0.0.1", port)
    try:
        changes = []
        src.on_samplerate_changed = changes.append
        got = src.read(1024)
        meta = (src.samplerate, src.center_freq, changes)
        src.tune(144_000_000)
    finally:
        src.close()
        srv.close()
    t.join(timeout=5)
    np.testing.assert_array_equal(got.view("<f4"), iq[:2048])
    return got, meta, control_reqs


def _import(package, name):
    import importlib

    return importlib.import_module(f"{package}.io.{name}")


SESSIONS = {
    "rtl_tcp": lambda pkg: _rtl_tcp_session(
        _import(pkg, "rtl_tcp").RtlTcpSource),
    "spyserver": lambda pkg: _spyserver_session(_import(pkg, "spyserver")),
    "kiwisdr": lambda pkg: _kiwisdr_session(_import(pkg, "kiwisdr")),
    "hpsdr_discovery": lambda pkg: _hpsdr_discovery(_import(pkg, "hpsdr")),
    "hpsdr": lambda pkg: _hpsdr_session(_import(pkg, "hpsdr")),
    "hermes_lite2": lambda pkg: _hermes_session(_import(pkg, "hpsdr")),
    "rfspace": lambda pkg: _rfspace_session(_import(pkg, "rfspace")),
    "spectran": lambda pkg: _spectran_session(_import(pkg, "spectran")),
}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_network_source_matches_jax(name):
    """The same mock session with the JAX source and the port's: the
    samples equal bit for bit, and what the mock saw on the wire (commands,
    control pages, registers, control items, texts) is the same."""
    if name == "kiwisdr":
        pytest.importorskip("websockets")
    want = SESSIONS[name]("sdrpp_tpu")
    got = SESSIONS[name]("sdrpp_tpu_torch")
    _same(got, want)


def test_source_helpers_match_jax():
    from sdrpp_tpu.io import kiwisdr as jk
    from sdrpp_tpu.io import rfspace as jr
    from sdrpp_tpu_torch.io import kiwisdr as tk
    from sdrpp_tpu_torch.io import rfspace as tr

    for dev in (tr.DEV_ID_NET_SDR, tr.DEV_ID_CLOUD_IQ):
        assert tr.valid_sample_rates(dev) == jr.valid_sample_rates(dev)
    iq = np.random.default_rng(1).integers(-32768, 32768, 1024) \
        .astype(">i2").tobytes()
    for msg in (b"SND\x08" + b"\x00" * 16 + iq, b"MSG hello",
                b"SND\x00" + b"\x00" * 100):
        a, b = tk.parse_snd_iq(msg), jk.parse_snd_iq(msg)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ---- the CLI: serve, ui, preheat, --source ----

# the CLI subprocesses run with one intra-op thread, as the in-process
# tests do (torch.set_num_threads(1) elsewhere), beside the other workers
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_serve_streams_to_a_client():
    """``serve --blocks 2 --device cpu``: a client (the JAX package's, so
    the frames are read by the reference's decoder) receives two i16
    frames equal to the test source's blocks quantized on the host."""
    from sdrpp_tpu_torch.io.sources import TestSource

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrpp_tpu_torch", "serve", "--source",
         "test:240000", "--tone", "30000", "--blocks", "2", "--block-size",
         "4096", "--port", str(port), "--device", "cpu"],
        cwd=REPO, env=CHILD_ENV, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                cli = jwire.BasebandClient("127.0.0.1", port)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        ui = cli.get_ui()
        assert [c["name"] for c in ui] == ["samplerate", "tone_offset"]
        assert ui[1]["value"] == 30000.0
        cli.start()
        frames = [cli.read_packet() for _ in range(2)]
        cli.close()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    err = proc.stderr.read()
    assert "served 2 blocks" in err, err[-2000:]
    src = TestSource(240000.0, tones=[(30000.0, -20.0)], noise_dbfs=-90.0)
    for kind, iq in frames:
        assert kind == "baseband"
        want = jcomp.unpack_frame(jcomp.pack_frame(src.read(4096), 1))
        np.testing.assert_array_equal(iq, want)


def test_cli_ui_serves_every_route(tmp_path):
    """``ui --source test:1000000 --no-realtime --device cpu`` serves the
    page and every route the page's script calls, and saves the session
    to --config when it stops."""
    port = _free_port()
    cfg = tmp_path / "ui.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrpp_tpu_torch", "ui", "--source",
         "test:1000000", "--no-realtime", "--device", "cpu", "--port",
         str(port), "--fft-size", "4096", "--block-size", "65536",
         "--mode", "nfm", "--offset", "100000", "--no-bg-preheat",
         "--config", str(cfg)],
        cwd=REPO, env=CHILD_ENV, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/api/state",
                                            timeout=10) as r:
                    st = json.loads(r.read())
                if st["blocks"] >= 2:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert b"<canvas" in r.read()
        for path in ("/api/fft", "/api/waterfall?since=0", "/api/bookmarks",
                     "/api/constellation"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                assert r.status == 200, path
        with urllib.request.urlopen(base + "/audio.wav", timeout=10) as r:
            assert r.read(4) == b"RIFF"
        req = urllib.request.Request(
            base + "/api/control", method="POST",
            data=json.dumps({"action": "set_volume", "value": 0.4}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
    finally:
        proc.send_signal(2)  # SIGINT: serve_ui stops and saves
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
    saved = json.loads(cfg.read_text())
    assert saved["volume"] == 0.4 and saved["vfos"]["vfo0"]["mode"] == "nfm"


def test_cli_preheat_warms_each_mode():
    r = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu_torch", "preheat", "--modes",
         "nfm,meteor", "--samplerate", "250000", "--block-size", "65536",
         "--fft-size", "4096", "--device", "cpu"],
        cwd=REPO, env=CHILD_ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [l for l in r.stdout.splitlines() if l.startswith("preheat ")]
    names = [l.split()[1] for l in lines[:-1]]
    assert names == ["mode:nfm", "mode:meteor", "nfm+squelch", "nfm+meteor"]
    assert "preheat done: 4 configs" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu_torch", "preheat", "--modes",
         "zzz", "--no-variants", "--device", "cpu"],
        cwd=REPO, env=CHILD_ENV, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "unknown mode" in r.stderr


def test_cli_arguments_match_jax():
    """serve, ui and preheat take the JAX commands' options, with
    ``--device`` (default cuda) in place of ``--cpu``."""
    from sdrpp_tpu import cli as jcli
    from sdrpp_tpu_torch import cli as tcli

    def options(mod, cmd):
        seen = {}

        class Stop(Exception):
            pass

        def parse(self, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions})
            raise Stop

        real = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            getattr(mod, f"cmd_{cmd}")([])
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = real
        seen.pop("help")
        return seen

    for cmd in ("serve", "ui", "preheat", "run", "bank", "spectrum",
                "scan"):
        j, t = options(jcli, cmd), options(tcli, cmd)
        assert t.pop("device") == "cuda"
        j.pop("cpu")
        if cmd == "bank":  # the port's bank also writes a trace, as run
            # does, and de-emphasises a WFM bank, as run does
            assert t.pop("trace") is None
            assert t.pop("deemphasis") is None
        assert t == j, cmd
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS) - {"bench"}
    assert tcli.BACKEND_FATAL_EXIT == jcli.BACKEND_FATAL_EXIT == 86


SPECS = [("rtltcp:127.0.0.1:1", "io.rtl_tcp", "RtlTcpSource"),
         ("rtltcp:127.0.0.1:1:1024000", "io.rtl_tcp", "RtlTcpSource"),
         ("spyserver:127.0.0.1:1", "io.spyserver", "SpyServerSource"),
         ("kiwisdr:127.0.0.1:1:7074000", "io.kiwisdr", "KiwiSDRSource"),
         ("hpsdr:127.0.0.1", "io.hpsdr", "HpsdrSource"),
         ("hermes:127.0.0.1:1024:192000", "io.hpsdr", "HermesLite2Source"),
         ("rfspace:127.0.0.1:1:2000000", "io.rfspace", "RFspaceSource"),
         ("spectran:127.0.0.1", "io.spectran", "SpectranHTTPSource")]


@pytest.mark.parametrize("spec,module,cls", SPECS,
                         ids=[s[0].split(":")[0] + str(i)
                              for i, s in enumerate(SPECS)])
def test_source_dispatch(monkeypatch, spec, module, cls):
    """Each ``--source`` form reaches the JAX CLI's class with the JAX
    CLI's arguments (the class is replaced by a recorder, so nothing
    connects), in both packages."""
    import importlib

    from sdrpp_tpu import cli as jcli
    from sdrpp_tpu_torch import cli as tcli

    calls = {}
    for pkg, make in (("sdrpp_tpu", lambda s: jcli._make_source(
            argparse.Namespace(source=s, tone=0.0))),
                      ("sdrpp_tpu_torch", tcli._make_source)):
        mod = importlib.import_module(f"{pkg}.{module}")
        log = []

        class Recorder:
            def __init__(self, *a, **kw):
                log.append(("init", a, kw))

            def __getattr__(self, name):
                return lambda *a, **kw: log.append((name, a, kw))

        monkeypatch.setattr(mod, cls, Recorder)
        make(spec)
        calls[pkg] = log
    assert calls["sdrpp_tpu_torch"] == calls["sdrpp_tpu"]
    assert calls["sdrpp_tpu"][0][0] == "init"


def test_test_source_and_wav_dispatch(tmp_path):
    from sdrpp_tpu_torch import cli as tcli
    from sdrpp_tpu_torch.io import wav
    from sdrpp_tpu_torch.io.sources import FileSource, TestSource

    src = tcli._make_source("test:48000", 5000.0)
    assert isinstance(src, TestSource) and src.tones == [(5000.0, -20.0)]
    p = tmp_path / "x.wav"
    wav.write_wav(p, 48000, np.zeros((100, 2), np.float32), "f32")
    f = tcli._make_source(str(p))
    assert isinstance(f, FileSource) and not f.loop


def test_kiwisdr_without_websockets_raises_clearly(monkeypatch):
    """Importing the port never needs websockets; opening a KiwiSDR
    source without it raises a RuntimeError that names the package."""
    from sdrpp_tpu_torch.io import kiwisdr

    monkeypatch.setitem(sys.modules, "websockets", None)
    monkeypatch.setitem(sys.modules, "websockets.sync", None)
    monkeypatch.setitem(sys.modules, "websockets.sync.client", None)
    with pytest.raises(RuntimeError, match="websockets"):
        kiwisdr.KiwiSDRSource("127.0.0.1", 1)
