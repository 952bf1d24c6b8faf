"""The port's own copies of the JAX package's host modules, held to them.

- ``utils.config.ConfigManager``: defaults merged in, a corrupt file
  repaired, nested get/set, auto-save, acquire/release: the same calls on
  the same files leave the same bytes on disk and return the same values.
- ``misc.frequency_manager.FrequencyManager``: bookmarks and lists on a
  ConfigManager, the same operations, the same files.
- ``utils.log.get_logger``: the same tree under ``sdrpp_tpu_torch``.
- ``utils.cuda_lib`` under threads: four threads loading the compiled
  host module at once on a fresh build directory compile it once and get
  one module object (the host compiler builds it without CUDA, as
  tests/test_torch_host_checks.py does; about 20 s).
"""

import subprocess
import threading

import pytest

from sdrpp_tpu.misc import frequency_manager as jfm
from sdrpp_tpu.utils import config as jconfig
from sdrpp_tpu.utils import log as jlog
from sdrpp_tpu_torch.misc import frequency_manager as tfm
from sdrpp_tpu_torch.utils import config as tconfig
from sdrpp_tpu_torch.utils import cuda_lib
from sdrpp_tpu_torch.utils import log as tlog

DEFAULTS = {"volume": 1.0, "vfos": {"vfo0": {"mode": "wfm", "offset": 0.0}},
            "lists": {}}


def _config_story(mod, path):
    """A sequence of ConfigManager calls; returns what they returned and
    the file's bytes after each step that writes."""
    out = []
    path.write_text('{"volume": 0.5, "vfos": {"vfo1": {"mode": "nfm"}}}')
    cm = mod.ConfigManager(path, defaults=DEFAULTS)
    out += [cm.conf, path.read_bytes()]
    out.append(cm.get("vfos", "vfo0", "mode"))
    out.append(cm.get("vfos", "nope", "mode", default="x"))
    cm.set("vfos", "vfo2", {"mode": "am", "offset": 5.0})
    out.append(path.read_bytes())
    conf = cm.acquire()
    conf["volume"] = 0.25
    cm.release(modified=True)
    out.append(path.read_bytes())
    path.write_text("{not json")  # corrupt: repaired to the defaults
    cm2 = mod.ConfigManager(path, defaults=DEFAULTS)
    out += [cm2.conf, path.read_bytes()]
    quiet = mod.ConfigManager(path.with_name("quiet.json"), defaults=DEFAULTS,
                              auto_save=False)
    quiet.set("a", "b", 1)
    out.append(path.with_name("quiet.json").exists())
    quiet.save()
    out.append(path.with_name("quiet.json").read_bytes())
    return out


def test_config_manager_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _config_story(tconfig, tmp_path / "t" / "c.json") \
        == _config_story(jconfig, tmp_path / "j" / "c.json")


def _bookmark_story(cfg_mod, fm_mod, path):
    out = []
    fm = fm_mod.FrequencyManager(cfg_mod.ConfigManager(path))
    out.append(fm.lists())
    fm.add("beacon", 120000.0, 12500.0, "nfm")
    fm.add("music", 250000, 200000, "wfm")
    out.append({k: dict(v) for k, v in fm.bookmarks().items()})
    bm = fm.get("beacon")
    out.append((bm.frequency, bm.bandwidth, bm.mode, fm.get("none")))
    fm.create_list("Sats")
    fm.select_list("Sats")
    fm.add("meteor", 137.9e6, 140000.0, "meteor")
    out.append((fm.lists(), {k: dict(v) for k, v in fm.bookmarks().items()}))
    with pytest.raises(KeyError):
        fm.select_list("none")
    fm.select_list("General")
    fm.remove("music")
    fm.delete_list("Sats")
    out.append((fm.lists(), path.read_bytes()))
    # a second manager on the same file sees what the first saved
    fm2 = fm_mod.FrequencyManager(cfg_mod.ConfigManager(path))
    out.append({k: dict(v) for k, v in fm2.bookmarks().items()})

    class Rx:
        def __init__(self):
            self.calls = []

        def delete_vfo(self, name):
            self.calls.append(("delete", name))

        def create_vfo(self, name, mode, offset, bandwidth):
            self.calls.append(("create", name, mode, offset, bandwidth))

    rx = Rx()
    fm2.apply(rx, "vfo0", "beacon")
    out.append(rx.calls)
    return out


def test_frequency_manager_matches_jax(tmp_path):
    assert _bookmark_story(tconfig, tfm, tmp_path / "t.json") \
        == _bookmark_story(jconfig, jfm, tmp_path / "j.json")


def test_logger_names():
    assert tlog.get_logger().name == "sdrpp_tpu_torch"
    for name in ("webui", "cli", "x.y"):
        t, j = tlog.get_logger(name), jlog.get_logger(name)
        assert t.name == "sdrpp_tpu_torch." + name
        assert j.name == "sdrpp_tpu." + name
        assert t.getEffectiveLevel() == j.getEffectiveLevel()
    assert set(tlog.__all__) == set(jlog.__all__)


def test_cuda_lib_loads_once_under_threads(tmp_path, monkeypatch):
    """Four threads reach the host module's first use together on a fresh
    build directory: one compile, one module object, no stray temporary
    files."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    real_run = subprocess.run
    compiles = []

    def counting_run(cmd, *a, **kw):
        compiles.append(cmd)
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", counting_run)
    barrier = threading.Barrier(4)
    mods, errors = [], []

    def worker():
        try:
            barrier.wait()
            mods.append(cuda_lib.load_host("kernels_host", cuda=False))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(mods) == 4 and all(m is mods[0] for m in mods)
    assert len(compiles) == 1
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert len(built) == 2 and not [n for n in built if n.endswith(".tmp")]
    assert hasattr(mods[0], "loop_scan")
