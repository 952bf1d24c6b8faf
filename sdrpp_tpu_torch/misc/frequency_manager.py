"""Frequency manager: named bookmarks with mode/bandwidth, list import/export.

The port's own copy of ``sdrpp_tpu.misc.frequency_manager``.

Reference: misc_modules/frequency_manager (978 LoC of ImGui UI around a
simple config-backed bookmark store: name -> {frequency, bandwidth, mode},
grouped into lists, applied to the selected VFO). The store here is the
same JSON shape via ConfigManager.
"""

from __future__ import annotations

from ..utils.config import ConfigManager

__all__ = ["Bookmark", "FrequencyManager"]


class Bookmark(dict):
    @property
    def frequency(self):
        return self["frequency"]

    @property
    def bandwidth(self):
        return self["bandwidth"]

    @property
    def mode(self):
        return self["mode"]


class FrequencyManager:
    def __init__(self, config: ConfigManager, list_name: str = "General"):
        self.config = config
        self.selected_list = list_name
        if self.config.get("lists") is None:
            self.config.set("lists", {list_name: {"bookmarks": {}}})

    def lists(self):
        return list(self.config.get("lists", default={}))

    def create_list(self, name: str):
        if self.config.get("lists", name) is None:
            self.config.set("lists", name, {"bookmarks": {}})

    def delete_list(self, name: str):
        lists = dict(self.config.get("lists", default={}))
        lists.pop(name, None)
        self.config.set("lists", lists)

    def select_list(self, name: str):
        if self.config.get("lists", name) is None:
            raise KeyError(name)
        self.selected_list = name

    def add(self, name: str, frequency: float, bandwidth: float, mode: str):
        self.config.set("lists", self.selected_list, "bookmarks", name, {
            "frequency": float(frequency),
            "bandwidth": float(bandwidth),
            "mode": mode,
        })

    def remove(self, name: str):
        bms = dict(self.config.get("lists", self.selected_list, "bookmarks",
                                   default={}))
        bms.pop(name, None)
        self.config.set("lists", self.selected_list, "bookmarks", bms)

    def get(self, name: str) -> Bookmark | None:
        bm = self.config.get("lists", self.selected_list, "bookmarks", name)
        return Bookmark(bm) if bm else None

    def bookmarks(self) -> dict[str, Bookmark]:
        bms = self.config.get("lists", self.selected_list, "bookmarks",
                              default={})
        return {k: Bookmark(v) for k, v in bms.items()}

    def apply(self, receiver, vfo_name: str, bookmark_name: str):
        """Tune a receiver VFO to a bookmark (the double-click action)."""
        bm = self.get(bookmark_name)
        if bm is None:
            raise KeyError(bookmark_name)
        receiver.delete_vfo(vfo_name)
        receiver.create_vfo(vfo_name, bm.mode, offset=bm.frequency,
                            bandwidth=bm.bandwidth)
        return bm
