"""KiwiSDR network source: websocket client for the Kiwi SND stream.

The port's own copy of ``sdrpp_tpu.io.kiwisdr`` (numpy only).
``websockets`` is imported when a source is opened, never at import.

Reference: source_modules/kiwisdr_source/src/kiwisdr.h — connect to
ws://host:port/{ms}/SND, send the text control sequence ("SET auth t=kiwi
p=#", "SET AR OK in=12000 out=48000", "SERVER DE CLIENT ... SND",
"SET mod=iq low_cut=.. high_cut=.. freq=<kHz>", "SET compression=1",
"SET squelch=0 param=0.00", "SET keepalive"), then parse binary frames:
"MSG ..." status text and "SND" + flags byte + 16-byte header + payload —
IQ mode (flags 0x08, 2048+20 bytes) carries 512 BIG-endian int16 IQ pairs
scaled by 1/32768 (kiwisdr.h:118-210). IQ rate is 12 kHz.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["KiwiSDRSource", "parse_snd_iq"]

IQ_RATE = 12000.0
IQ_HEADER_SIZE = 20


def parse_snd_iq(msg: bytes) -> np.ndarray | None:
    """Decode one SND binary frame -> complex64[512] or None if not IQ
    (kiwisdr.h snd_onReceived, IQ branch)."""
    if len(msg) != 2048 + IQ_HEADER_SIZE or msg[:3] != b"SND" or msg[3] != 0x08:
        return None
    raw = np.frombuffer(msg[IQ_HEADER_SIZE:], dtype=">i2").astype(np.float32)
    raw = raw / 32768.0
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


class KiwiSDRSource:
    """read(n) complex64 @ 12 kHz + tune(freq). Requires ``websockets``."""

    __test__ = False

    def __init__(self, host: str, port: int = 8073, freq_hz: float = 10000000.0,
                 password: str = "#", open_timeout: float = 10.0):
        try:
            from websockets.sync.client import connect
        except ImportError as e:
            raise RuntimeError("the KiwiSDR source needs the websockets "
                               "package, which is not installed") from e

        uri = f"ws://{host}:{port}/{int(time.time() * 1000)}/SND"
        self._ws = connect(uri, open_timeout=open_timeout)
        self.samplerate = IQ_RATE
        self.center_freq = freq_hz
        self._iq_buf = np.zeros(0, np.complex64)
        self._last_ping = time.monotonic()
        # Control sequence (kiwisdr.h:224-243)
        self._send(f"SET auth t=kiwi p={password}")
        self._send(f"SET AR OK in={int(IQ_RATE)} out=48000")
        self._send("SERVER DE CLIENT openwebrx.js SND")
        self.tune(freq_hz)
        self._send("SET compression=1")
        self._send("SET squelch=0 param=0.00")
        self._send("SET keepalive")

    def _send(self, text: str):
        self._ws.send(text)

    def tune(self, freq_hz: float):
        self.center_freq = freq_hz
        self._send(f"SET mod=iq low_cut=-6000 high_cut=6000 "
                   f"freq={freq_hz / 1000.0:.3f}")

    def set_agc(self, enabled: bool = True, hang: bool = False,
                thresh: int = -100, slope: int = 6, decay: int = 1000,
                manual_gain: int = 30):
        self._send(f"SET agc={int(enabled)} hang={int(hang)} thresh={thresh} "
                   f"slope={slope} decay={decay} manGain={manual_gain}")

    def read(self, n: int) -> np.ndarray:
        while len(self._iq_buf) < n:
            msg = self._ws.recv()
            if isinstance(msg, str):
                msg = msg.encode()
            iq = parse_snd_iq(msg)
            if iq is not None:
                self._iq_buf = np.concatenate([self._iq_buf, iq])
            # periodic keepalive (kiwisdr.h:278-284)
            now = time.monotonic()
            if now - self._last_ping > 3.0:
                self._send("SET keepalive")
                self._last_ping = now
        out, self._iq_buf = self._iq_buf[:n], self._iq_buf[n:]
        return out

    def close(self):
        self._ws.close()
