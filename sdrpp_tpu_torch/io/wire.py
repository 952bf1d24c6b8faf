"""Baseband network protocol: server + client (headless remote IQ).

The port's own copy of ``sdrpp_tpu.io.wire``, over the port's
``ops.compression``; zstd stays optional.

Reference: core/src/server.cpp:49-387 + server_protocol.h:9-52 — the
``sdrpp --server`` mode streams quantized baseband over TCP with a binary
packet protocol (8-byte {type u32, size u32} header), optional zstd, and
control commands (START/STOP/SET_FREQUENCY/SET_SAMPLE_TYPE/
SET_COMPRESSION). This module reimplements that wire contract so remote IQ
delivery feeds per-host device queues (SURVEY §5 distributed-communication
plan); sdrpp_server_source's client role is BasebandClient.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from ..ops.compression import (PCM_TYPE_I16,
                               pack_frame, unpack_frame)

try:
    import zstandard

    _ZSTD = True
except Exception:  # pragma: no cover
    _ZSTD = False

__all__ = ["BasebandServer", "BasebandClient", "PacketType", "Command",
           "Error"]


class PacketType:
    COMMAND = 0
    COMMAND_ACK = 1
    BASEBAND = 2
    BASEBAND_COMPRESSED = 3
    VFO = 4
    FFT = 5
    ERROR = 6


class Command:
    GET_UI = 0x00
    UI_ACTION = 0x01
    START = 0x02
    STOP = 0x03
    SET_FREQUENCY = 0x04
    GET_SAMPLERATE = 0x05
    SET_SAMPLE_TYPE = 0x06
    SET_COMPRESSION = 0x07
    SET_SAMPLERATE = 0x80
    DISCONNECT = 0x81


class Error:
    NONE = 0x00
    INVALID_PACKET = 0x01
    INVALID_COMMAND = 0x02
    INVALID_ARGUMENT = 0x03


_PKT = struct.Struct("<II")
_CMD = struct.Struct("<I")


def _send_packet(sock, ptype: int, payload: bytes):
    sock.sendall(_PKT.pack(ptype, _PKT.size + len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _recv_packet(sock):
    hdr = _recv_exact(sock, _PKT.size)
    ptype, size = _PKT.unpack(hdr)
    payload = _recv_exact(sock, size - _PKT.size)
    return ptype, payload


class BasebandServer:
    """Single-client baseband server (server.cpp:163-201 kicks a second
    client; we queue-accept one at a time)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 samplerate: float = 1000000.0, pcm_type: int = PCM_TYPE_I16,
                 compression: bool = False):
        self.samplerate = samplerate
        self.pcm_type = pcm_type
        self.compression = compression and _ZSTD
        self.running = False
        self.frequency = 0.0
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._client = None
        self._lock = threading.Lock()
        # One packet at a time on the wire: the data plane (send_baseband,
        # main thread) and the control plane (acks/pushes, client thread)
        # share the socket; unserialized sendall calls can interleave
        # mid-packet and corrupt the framing.
        self._send_lock = threading.Lock()
        self._cctx = zstandard.ZstdCompressor() if _ZSTD else None
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._alive = True
        self._thread.start()
        self.on_start = None
        self.on_stop = None
        self.on_tune = None
        # Remote-UI registry (the headless analog of SmGui draw-list
        # mirroring, core/src/gui/smgui.h:8-60 + server.cpp:322-353: the
        # reference serializes the source module's ImGui widgets to the
        # client; we serialize the same information — control kind, id,
        # value, bounds — as a JSON schema).
        self._controls: dict[str, dict] = {}
        self.on_control = None  # callback(name, value) after a UI_ACTION

    def register_control(self, name: str, ctype: str, value=None, **meta):
        """Expose a server-side parameter to remote clients.

        ctype: 'float' | 'int' | 'bool' | 'enum' | 'str' | 'button'.
        meta: min/max/step for numbers, options=[...] for enums, label.
        """
        assert ctype in ("float", "int", "bool", "enum", "str", "button")
        if ctype == "enum":
            assert meta.get("options"), "enum control needs options"
        self._controls[name] = {"name": name, "type": ctype,
                                "value": value, **meta}

    def set_samplerate(self, samplerate: float):
        """Update and push to the client (COMMAND_SET_SAMPLERATE, the one
        server->client command, server_protocol.h:31)."""
        self.samplerate = float(samplerate)
        with self._lock:
            client = self._client
        if client is not None:
            try:
                self._send_locked(client, PacketType.COMMAND,
                                  _CMD.pack(Command.SET_SAMPLERATE)
                                  + struct.pack("<d", self.samplerate))
            except OSError:
                pass

    def _apply_ui_action(self, body: bytes):
        import json

        try:
            action = json.loads(body.decode("utf-8"))
            name = action["name"]
            value = action.get("value")
        except Exception:
            return None
        ctl = self._controls.get(name)
        if ctl is None:
            return None
        t = ctl["type"]
        try:
            if t == "float":
                value = float(value)
            elif t == "int":
                value = int(value)
            elif t == "bool":
                value = bool(value)
            elif t == "enum":
                if value not in ctl["options"]:
                    return None
            elif t == "str":
                value = str(value)
            elif t == "button":
                value = True
        except (TypeError, ValueError):
            return None
        if t in ("float", "int"):
            if "min" in ctl and value < ctl["min"]:
                return None
            if "max" in ctl and value > ctl["max"]:
                return None
        if t != "button":
            ctl["value"] = value
        if self.on_control:
            self.on_control(name, value)
        return name, value

    def _send_locked(self, client, ptype: int, payload: bytes):
        with self._send_lock:
            _send_packet(client, ptype, payload)

    def _accept_loop(self):
        while self._alive:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._client is not None:
                    client.close()  # single client only
                    continue
                self._client = client
            t = threading.Thread(target=self._client_loop, args=(client,),
                                 daemon=True)
            t.start()

    def _client_loop(self, client):
        try:
            while self._alive:
                ptype, payload = _recv_packet(client)
                if ptype != PacketType.COMMAND:
                    self._send_locked(client, PacketType.ERROR, struct.pack("<I", 1))
                    continue
                (cmd,) = _CMD.unpack_from(payload, 0)
                body = payload[_CMD.size:]
                if cmd == Command.START:
                    self.running = True
                    if self.on_start:
                        self.on_start()
                elif cmd == Command.STOP:
                    self.running = False
                    if self.on_stop:
                        self.on_stop()
                elif cmd == Command.SET_FREQUENCY:
                    (self.frequency,) = struct.unpack("<d", body)
                    if self.on_tune:
                        self.on_tune(self.frequency)
                    self._send_locked(client, PacketType.COMMAND_ACK, _CMD.pack(cmd))
                elif cmd == Command.GET_SAMPLERATE:
                    self._send_locked(client, PacketType.COMMAND_ACK,
                                 _CMD.pack(Command.GET_SAMPLERATE)
                                 + struct.pack("<d", self.samplerate))
                elif cmd == Command.SET_SAMPLE_TYPE:
                    (self.pcm_type,) = struct.unpack("<I", body)
                elif cmd == Command.SET_COMPRESSION:
                    (flag,) = struct.unpack("<I", body)
                    self.compression = bool(flag) and _ZSTD
                elif cmd == Command.GET_UI:
                    import json
                    schema = json.dumps(list(self._controls.values()))
                    self._send_locked(client, PacketType.COMMAND_ACK,
                                 _CMD.pack(Command.GET_UI)
                                 + schema.encode("utf-8"))
                elif cmd == Command.UI_ACTION:
                    if self._apply_ui_action(body) is None:
                        self._send_locked(client, PacketType.ERROR,
                                     struct.pack("<I", Error.INVALID_ARGUMENT))
                    else:
                        self._send_locked(client, PacketType.COMMAND_ACK,
                                     _CMD.pack(Command.UI_ACTION))
                else:
                    self._send_locked(client, PacketType.ERROR,
                                 struct.pack("<I", Error.INVALID_COMMAND))
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                if self._client is client:
                    self._client = None
            client.close()

    def send_baseband(self, iq: np.ndarray):
        """Quantize + (optionally zstd) + send one block to the client."""
        with self._lock:
            client = self._client
        if client is None or not self.running:
            return
        frame = pack_frame(iq, self.pcm_type)
        if self.compression:
            payload = self._cctx.compress(frame)
            ptype = PacketType.BASEBAND_COMPRESSED
        else:
            payload = frame
            ptype = PacketType.BASEBAND
        try:
            self._send_locked(client, ptype, payload)
        except OSError:
            pass

    def close(self):
        self._alive = False
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            if self._client:
                self._client.close()


class BasebandClient:
    """Client of the baseband protocol (sdrpp_server_source equivalent)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._dctx = zstandard.ZstdDecompressor() if _ZSTD else None
        self._pending: list = []  # packets buffered while awaiting an ack

    def start(self):
        _send_packet(self._sock, PacketType.COMMAND, _CMD.pack(Command.START))

    def stop(self):
        _send_packet(self._sock, PacketType.COMMAND, _CMD.pack(Command.STOP))

    def set_frequency(self, freq: float):
        _send_packet(self._sock, PacketType.COMMAND,
                     _CMD.pack(Command.SET_FREQUENCY) + struct.pack("<d", freq))

    def set_sample_type(self, pcm_type: int):
        _send_packet(self._sock, PacketType.COMMAND,
                     _CMD.pack(Command.SET_SAMPLE_TYPE)
                     + struct.pack("<I", pcm_type))

    def set_compression(self, enabled: bool):
        _send_packet(self._sock, PacketType.COMMAND,
                     _CMD.pack(Command.SET_COMPRESSION)
                     + struct.pack("<I", int(enabled)))

    def _await_ack(self, cmd: int, timeout: float = 5.0):
        """Read until the ack (or error) for ``cmd``, buffering everything
        else for read_packet()."""
        self._sock.settimeout(timeout)
        try:
            while True:
                ptype, payload = _recv_packet(self._sock)
                if ptype == PacketType.COMMAND_ACK:
                    (acked,) = _CMD.unpack_from(payload, 0)
                    if acked == cmd:
                        return True, payload[_CMD.size:]
                elif ptype == PacketType.ERROR:
                    (code,) = struct.unpack_from("<I", payload, 0)
                    return False, code
                self._pending.append((ptype, payload))
        finally:
            self._sock.settimeout(None)

    def get_ui(self, timeout: float = 5.0):
        """Fetch the server's control schema (COMMAND_GET_UI) as a list of
        dicts {name, type, value, ...bounds} — the headless SmGui."""
        import json

        _send_packet(self._sock, PacketType.COMMAND, _CMD.pack(Command.GET_UI))
        ok, body = self._await_ack(Command.GET_UI, timeout)
        if not ok:
            raise RuntimeError(f"GET_UI failed with error {body}")
        return json.loads(body.decode("utf-8"))

    def ui_action(self, name: str, value=None, timeout: float = 5.0) -> bool:
        """Apply a control change on the server (COMMAND_UI_ACTION).
        Returns True on ack, False on server-side validation error."""
        import json

        payload = json.dumps({"name": name, "value": value}).encode("utf-8")
        _send_packet(self._sock, PacketType.COMMAND,
                     _CMD.pack(Command.UI_ACTION) + payload)
        ok, _ = self._await_ack(Command.UI_ACTION, timeout)
        return ok

    def read_packet(self):
        """Blocking read -> ('baseband', iq) | ('ack', cmd, body) | other."""
        if self._pending:
            ptype, payload = self._pending.pop(0)
        else:
            ptype, payload = _recv_packet(self._sock)
        if ptype == PacketType.BASEBAND:
            return "baseband", unpack_frame(payload)
        if ptype == PacketType.BASEBAND_COMPRESSED:
            return "baseband", unpack_frame(self._dctx.decompress(payload))
        if ptype == PacketType.COMMAND_ACK:
            (cmd,) = _CMD.unpack_from(payload, 0)
            return "ack", cmd, payload[_CMD.size:]
        if ptype == PacketType.COMMAND:
            (cmd,) = _CMD.unpack_from(payload, 0)
            if cmd == Command.SET_SAMPLERATE:
                (fs,) = struct.unpack_from("<d", payload, _CMD.size)
                return "set_samplerate", fs
            return "command", cmd, payload[_CMD.size:]
        return "other", ptype, payload

    def close(self):
        self._sock.close()
