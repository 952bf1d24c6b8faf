"""Aaronia Spectran HTTP network source.

The port's own copy of ``sdrpp_tpu.io.spectran`` (numpy only).

Reference: source_modules/spectran_http_source/src/spectran_http_client.{h,cpp}
— the Spectran V6 "HTTP server" streaming protocol:

- data plane: ``GET /stream?format=float32`` returning a chunked HTTP
  response; every chunk is one JSON metadata line (``startFrequency``,
  ``endFrequency``, optional ``sampleFrequency``; samplerate is derived
  as end-start, spectran_http_client.cpp:106-118), a 0x1E record
  separator, interleaved float32 IQ, and a trailing CRLF
  (spectran_http_client.cpp:121-151).
- control plane: ``PUT /control`` with JSON
  ``{"frequencyCenter":f, "frequencySpan":sr, "type":"capture"}`` on a
  fresh connection per request (spectran_http_client.cpp:45-65).
- center-frequency / samplerate changes are detected from the per-chunk
  metadata and surfaced via callbacks.
"""

from __future__ import annotations

import json
import socket

import numpy as np

__all__ = ["SpectranHTTPSource"]

RECORD_SEPARATOR = 0x1E


class SpectranHTTPSource:
    """Pull-model client: ``read(n)`` -> complex64 + ``tune(freq)``."""

    def __init__(self, host: str, port: int = 54664, timeout: float = 10.0):
        self.host = host
        self.port = int(port)
        self._timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._iq = np.zeros(0, np.complex64)
        self.center_freq = 0.0
        self.samplerate = 0.0
        self.on_center_frequency_changed = None
        self.on_samplerate_changed = None

        self._sock.sendall(
            f"GET /stream?format=float32 HTTP/1.1\r\nHost: {host}\r\n"
            f"Connection: keep-alive\r\n\r\n".encode())
        status, _ = self._read_response_header(self._sock)
        if status != 200:
            raise ConnectionError(f"HTTP request did not return ok: {status}")

    # ---- HTTP plumbing ----

    def _read_response_header(self, sock) -> tuple[int, dict]:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("Spectran server closed")
            data += chunk
        head, rest = data.split(b"\r\n\r\n", 1)
        if sock is self._sock:
            self._buf = rest
        lines = head.decode(errors="replace").split("\r\n")
        status = int(lines[0].split()[1])
        fields = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                fields[k.strip().lower()] = v.strip()
        return status, fields

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(max(4096, n - len(self._buf)))
            if not chunk:
                raise ConnectionError("Spectran server closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_line(self, limit: int = 65536) -> bytes:
        while b"\r\n" not in self._buf[:limit]:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("Spectran server closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _recv_newline_terminated(self, limit: int = 65536) -> bytes:
        """Read up to ``\\n`` (the JSON metadata terminator inside a chunk);
        returns the line WITHOUT the newline but it counts in framing."""
        while b"\n" not in self._buf[:limit]:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("Spectran server closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line

    # ---- control (PUT /control on a fresh connection) ----

    def tune(self, freq: float):
        body = json.dumps({"frequencyCenter": int(freq),
                           "frequencySpan": int(self.samplerate),
                           "type": "capture"})
        ctrl = socket.create_connection((self.host, self.port),
                                        timeout=self._timeout)
        try:
            ctrl.sendall(
                (f"PUT /control HTTP/1.1\r\nHost: {self.host}\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
            self._read_response_header(ctrl)
        finally:
            ctrl.close()
        self.center_freq = float(freq)

    # ---- data ----

    def _read_chunk(self) -> np.ndarray | None:
        """One HTTP chunk -> IQ samples (spectran_http_client.cpp:67-151)."""
        size_line = self._recv_line()
        clen = int(size_line.split(b";")[0], 16)
        if clen == 0:
            return None
        meta_line = self._recv_newline_terminated()
        meta = json.loads(meta_line)
        start = int(meta["startFrequency"])
        end = int(meta["endFrequency"])
        samplerate = float(end - start)  # reference derives it this way
        center = round((start + end) / 2.0)
        if center != self.center_freq:
            self.center_freq = float(center)
            if self.on_center_frequency_changed:
                self.on_center_frequency_changed(self.center_freq)
        if samplerate != self.samplerate:
            self.samplerate = samplerate
            if self.on_samplerate_changed:
                self.on_samplerate_changed(samplerate)
        rs = self._recv_exact(1)[0]
        if rs != RECORD_SEPARATOR:
            raise ConnectionError("Missing record separator")
        # payload fills the rest of the chunk: length minus the JSON line
        # (newline terminator included) and the separator byte
        data_len = clen - (len(meta_line) + 1) - 1
        flat = np.frombuffer(self._recv_exact(data_len), "<f4")
        if self._recv_exact(2) != b"\r\n":
            raise ConnectionError("Missing trailing CRLF")
        return flat[: 2 * (len(flat) // 2)].view(np.complex64)

    def read(self, n: int) -> np.ndarray:
        while len(self._iq) < n:
            samples = self._read_chunk()
            if samples is None:
                raise ConnectionError("Spectran stream ended")
            self._iq = np.concatenate([self._iq, samples])
        out, self._iq = self._iq[:n], self._iq[n:]
        return out

    def close(self):
        self._sock.close()
