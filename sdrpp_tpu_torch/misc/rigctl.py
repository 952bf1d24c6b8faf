"""rigctl TCP server: hamlib NET rigctl control of the receiver.

The port's own copy of ``sdrpp_tpu.misc.rigctl``.

Reference: misc_modules/rigctl_server/src/main.cpp:370-670 — a line
protocol where external software (logging/satellite trackers) tunes the
SDR: F/\\set_freq, f/\\get_freq, M/\\set_mode, m/\\get_mode, V/v vfo,
s/S split, AOS/LOS recorder hooks, q, \\chk_vfo, \\dump_state,
\\start/\\stop. Errors reply "RPRT <code>"; gets reply the value lines.
"""

from __future__ import annotations

import socket
import threading

__all__ = ["RigctlServer", "RigctlClient"]

_MODE_MAP = {
    "FM": "nfm", "WFM": "wfm", "AM": "am", "USB": "usb", "LSB": "lsb",
    "CW": "cw", "DSB": "dsb",
}
_MODE_INV = {v: k for k, v in _MODE_MAP.items()}


class RigctlServer:
    """Line-protocol server driving a controller object.

    ``controller`` must provide: get_freq() -> float, set_freq(f),
    get_mode() -> (mode_str, passband), set_mode(mode, passband),
    start(), stop(); optionally recorder_start()/recorder_stop().
    """

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0):
        self.controller = controller
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._alive = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._alive:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(client,),
                             daemon=True).start()

    def _client_loop(self, client):
        buf = b""
        try:
            while self._alive:
                data = client.recv(1024)
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    resp = self._handle(line.decode().strip())
                    if resp is None:
                        client.close()
                        return
                    if resp:
                        client.sendall(resp.encode())
        except OSError:
            pass
        finally:
            client.close()

    def _handle(self, cmd: str) -> str | None:
        if not cmd:
            return ""
        parts = cmd.split()
        c = self.controller
        op = parts[0]
        try:
            if op in ("F", "\\set_freq"):
                c.set_freq(float(parts[1]))
                return "RPRT 0\n"
            if op in ("f", "\\get_freq"):
                return f"{int(c.get_freq())}\n"
            if op in ("M", "\\set_mode"):
                if parts[1] == "?":
                    return " ".join(_MODE_MAP) + "\n"
                mode = _MODE_MAP.get(parts[1].upper())
                if mode is None:
                    return "RPRT -9\n"
                pb = float(parts[2]) if len(parts) > 2 else -1.0
                c.set_mode(mode, pb)
                return "RPRT 0\n"
            if op in ("m", "\\get_mode"):
                mode, pb = c.get_mode()
                return f"{_MODE_INV.get(mode, 'FM')}\n{int(pb)}\n"
            if op in ("V", "\\set_vfo"):
                if len(parts) > 1 and parts[1] == "?":
                    return "VFOA\n"
                return "RPRT 0\n"
            if op in ("v", "\\get_vfo"):
                return "VFOA\n"
            if op == "\\chk_vfo":
                return "0\n"
            if op in ("s",):
                return "0\nVFOA\n"
            if op in ("S",):
                return "RPRT 0\n"
            if op in ("AOS", "\\recorder_start"):
                if hasattr(c, "recorder_start"):
                    c.recorder_start()
                return "RPRT 0\n"
            if op in ("LOS", "\\recorder_stop"):
                if hasattr(c, "recorder_stop"):
                    c.recorder_stop()
                return "RPRT 0\n"
            if op == "\\start":
                c.start()
                return "RPRT 0\n"
            if op == "\\stop":
                c.stop()
                return "RPRT 0\n"
            if op == "\\get_powerstat":
                return "1\n"
            if op in ("q", "\\quit"):
                return None
            return "RPRT -11\n"  # unimplemented
        except (IndexError, ValueError):
            return "RPRT -1\n"

    def close(self):
        self._alive = False
        try:
            self._listener.close()
        except OSError:
            pass


class RigctlClient:
    """rigctl TCP client: drive an external rig / make this SDR a panadapter
    (reference: misc_modules/rigctl_client — tracks an external radio's
    frequency so the SDR display follows it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4532,
                 timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def _cmd(self, line: str, reply_lines: int = 1) -> list[str]:
        self._sock.sendall(line.encode() + b"\n")
        out = []
        while len(out) < reply_lines:
            while b"\n" not in self._buf:
                data = self._sock.recv(1024)
                if not data:
                    raise ConnectionError("rigctl server closed")
                self._buf += data
            ln, self._buf = self._buf.split(b"\n", 1)
            out.append(ln.decode())
        return out

    def set_freq(self, freq: float) -> bool:
        return self._cmd(f"F {int(freq)}")[0] == "RPRT 0"

    def get_freq(self) -> float:
        return float(self._cmd("f")[0])

    def set_mode(self, mode: str, passband: float = -1) -> bool:
        return self._cmd(f"M {mode} {int(passband)}")[0] == "RPRT 0"

    def get_mode(self) -> tuple[str, float]:
        mode, pb = self._cmd("m", reply_lines=2)
        return mode, float(pb)

    def close(self):
        self._sock.close()
