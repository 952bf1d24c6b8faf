"""Headless waterfall/FFT display state: the reference WaterFall widget's
data plane without the GUI. A numpy-only copy of ``sdrpp_tpu.misc.waterfall``.

Reference: core/src/gui/widgets/waterfall.{h,cpp}. What this replicates:

- raw-FFT ring of ``waterfall_height`` lines; ``push_fft`` scrolls the
  RGBA framebuffer one line and palette-maps the newest zoomed line
  (waterfall.cpp:896-916).
- zoom: max-decimation of the visible span into ``data_width`` pixels
  (fft_scaler.h:21-64; ``_zoom`` below).
- FFT smoothing: per-bin one-pole IIR ``buf = a*new + (1-a)*buf``
  (waterfall.cpp:918-925, setFFTSmoothingSpeed at :1207-1211).
- FFT hold: decaying max trace ``hold = max(new, hold - speed)``; the
  reference's loop starts at bin 1, so bin 0 never updates
  (waterfall.cpp:951-956) — quirk kept, documented.
- per-VFO level/SNR with optional SNR smoothing and a 10-deep level-max
  history (waterfall.cpp:927-950).
- palette interpolation to a fixed-resolution LUT and ABGR8888 packing
  (updatePalletteFromArray, waterfall.cpp:977-992; the reference burns
  16 MB on a 1,000,000-entry LUT — resolution is a parameter here,
  default 65536, same interpolation math).
- autoRange: min/max of the latest line ±10 dB (waterfall.cpp:994-1012).
"""

from __future__ import annotations

import numpy as np

from ..misc.meters import vfo_signal_info

__all__ = ["WaterfallDisplay", "make_palette"]

# classic SDR++ default palette (waterfall colormap stops)
DEFAULT_COLORS = np.array([
    [0x00, 0x00, 0x20], [0x00, 0x00, 0x30], [0x00, 0x00, 0x50],
    [0x00, 0x00, 0x91], [0x1E, 0x90, 0xFF], [0xFF, 0xFF, 0xFF],
    [0xFF, 0xFF, 0x00], [0xFE, 0x6D, 0x16], [0xFF, 0x00, 0x00],
    [0xC6, 0x00, 0x00], [0x9F, 0x00, 0x00], [0x75, 0x00, 0x00],
    [0x4A, 0x00, 0x00]], np.float32)


def make_palette(colors: np.ndarray | None = None,
                 resolution: int = 65536) -> np.ndarray:
    """Interpolated ABGR8888 LUT (updatePalletteFromArray formula)."""
    colors = DEFAULT_COLORS if colors is None else np.asarray(colors,
                                                              np.float32)
    count = len(colors)
    pos = np.arange(resolution, dtype=np.float64) / resolution * count
    lower = np.clip(np.floor(pos).astype(int), 0, count - 1)
    upper = np.clip(np.ceil(pos).astype(int), 0, count - 1)
    ratio = (pos - np.floor(pos))[:, None]
    rgb = (colors[lower] * (1.0 - ratio) + colors[upper] * ratio) \
        .astype(np.uint32)
    return ((np.uint32(255) << 24) | (rgb[:, 2] << 16) | (rgb[:, 1] << 8)
            | rgb[:, 0])


class WaterfallDisplay:
    """Raw-FFT ring + framebuffer + traces; feed with ``push_fft(line)``."""

    def __init__(self, raw_fft_size: int, data_width: int = 1024,
                 waterfall_height: int = 512, whole_bandwidth: float = 1.0,
                 waterfall_min: float = -70.0, waterfall_max: float = 0.0,
                 palette_resolution: int = 65536):
        self.raw_fft_size = int(raw_fft_size)
        self.data_width = int(data_width)
        self.waterfall_height = int(waterfall_height)
        self.whole_bandwidth = float(whole_bandwidth)
        self.waterfall_min = float(waterfall_min)
        self.waterfall_max = float(waterfall_max)
        self.view_offset = 0.0
        self.view_bandwidth = float(whole_bandwidth)
        self.raw_ffts = np.full((self.waterfall_height, self.raw_fft_size),
                                -1000.0, np.float32)
        self.fft_lines = 0
        self.framebuffer = np.zeros((self.waterfall_height, self.data_width),
                                    np.uint32)
        self.palette = make_palette(resolution=palette_resolution)
        self.latest_fft = np.full(self.data_width, -1000.0, np.float32)
        # traces
        self.fft_smoothing = False
        self._smoothing_alpha = 0.5
        self._smoothing_buf = np.full(self.data_width, -1000.0, np.float32)
        self.fft_hold = False
        self.fft_hold_speed = 0.3
        self.latest_fft_hold = np.full(self.data_width, -1000.0, np.float32)
        # VFO metering
        self.snr_smoothing = False
        self._snr_alpha = 0.5
        self.selected_vfo = None  # (center_offset, bandwidth)
        self.vfo_level = float("-inf")
        self.vfo_snr = 0.0
        self._level_history: list[float] = []
        self.vfo_level_max = float("-inf")

    # ---- controls (waterfall.cpp:1175-1215) ----

    def set_fft_smoothing(self, enabled: bool):
        self.fft_smoothing = bool(enabled)
        self._smoothing_buf[:] = -1000.0

    def set_fft_smoothing_speed(self, speed: float):
        self._smoothing_alpha = float(speed)

    def set_fft_hold(self, enabled: bool):
        self.fft_hold = bool(enabled)
        self.latest_fft_hold[:] = -1000.0

    def set_fft_hold_speed(self, speed: float):
        self.fft_hold_speed = float(speed)

    def set_snr_smoothing(self, enabled: bool):
        self.snr_smoothing = bool(enabled)

    def set_snr_smoothing_speed(self, speed: float):
        self._snr_alpha = float(speed)

    def set_view(self, offset: float, bandwidth: float):
        self.view_offset = float(offset)
        self.view_bandwidth = float(bandwidth)

    def select_vfo(self, center_offset: float, bandwidth: float):
        self.selected_vfo = (float(center_offset), float(bandwidth))

    def auto_range(self):
        """waterfall.cpp:994-1012: latest-line min/max ±10 dB."""
        self.waterfall_min = float(self.latest_fft.min()) - 10.0
        self.waterfall_max = float(self.latest_fft.max()) + 10.0

    # ---- data plane ----

    def _zoom(self, raw_line: np.ndarray) -> np.ndarray:
        """Max-decimation of the view span (fft_scaler.h doZoom)."""
        half = self.whole_bandwidth / 2.0
        lo = (self.view_offset - self.view_bandwidth / 2.0 + half) \
            / self.whole_bandwidth
        hi = (self.view_offset + self.view_bandwidth / 2.0 + half) \
            / self.whole_bandwidth
        i0 = int(np.clip(lo * self.raw_fft_size, 0, self.raw_fft_size - 1))
        i1 = int(np.clip(hi * self.raw_fft_size, i0 + 1, self.raw_fft_size))
        seg = raw_line[i0:i1]
        pixel = (np.arange(len(seg), dtype=np.int64) * self.data_width
                 // len(seg))
        out = np.full(self.data_width, -1000.0, np.float32)
        np.maximum.at(out, pixel, seg)
        return out

    def push_fft(self, raw_line: np.ndarray):
        """Ingest one raw dB FFT line (waterfall.cpp:896-956)."""
        raw_line = np.asarray(raw_line, np.float32)
        assert raw_line.shape == (self.raw_fft_size,)
        self.raw_ffts = np.roll(self.raw_ffts, 1, axis=0)
        self.raw_ffts[0] = raw_line
        self.fft_lines = min(self.fft_lines + 1, self.waterfall_height)

        self.latest_fft = self._zoom(raw_line)

        # scroll framebuffer + palette-map newest line
        self.framebuffer[1:] = self.framebuffer[:-1]
        rng = self.waterfall_max - self.waterfall_min
        pixel = (np.clip(self.latest_fft, self.waterfall_min,
                         self.waterfall_max) - self.waterfall_min) / rng
        ids = (pixel * (len(self.palette) - 1)).astype(np.int64)
        self.framebuffer[0] = self.palette[ids]

        # smoothing: latest = a*latest + (1-a)*buf (waterfall.cpp:918-925)
        if self.fft_smoothing:
            self._smoothing_buf = (self._smoothing_alpha * self.latest_fft
                                   + (1.0 - self._smoothing_alpha)
                                   * self._smoothing_buf)
            self.latest_fft = self._smoothing_buf.copy()

        # VFO level/SNR (waterfall.cpp:927-950)
        if self.selected_vfo is not None:
            center, bw = self.selected_vfo
            level, snr = vfo_signal_info(raw_line, center, bw,
                                         self.whole_bandwidth)
            self.vfo_level = level
            if self.snr_smoothing:
                self.vfo_snr = ((1.0 - self._snr_alpha) * self.vfo_snr
                                + self._snr_alpha * snr)
            else:
                self.vfo_snr = snr
            self._level_history.append(level)
            if len(self._level_history) > 10:
                self._level_history.pop(0)
            self.vfo_level_max = max(self._level_history)

        # hold trace; the reference loop starts at i=1, leaving bin 0
        # frozen (waterfall.cpp:951-956) — replicated as written.
        if self.fft_hold:
            self.latest_fft_hold[1:] = np.maximum(
                self.latest_fft[1:],
                self.latest_fft_hold[1:] - self.fft_hold_speed)

        return self.latest_fft
