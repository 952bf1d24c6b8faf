"""Port parity for the channel-sharded bank (``ScannerBank.shard`` /
``sharded_step``, the ``channel_shard`` rows of ``mix_bank`` and
``FFTChannelizerBank``) and ``parallel.multihost.MultiHostReceiver``, in
worlds of P = 1, 2 and 4 processes.

The port side: this file run as a script is one rank of a gloo world
(``init_method="file://..."``, one thread, no jax); each world's ranks run
every case below in one start-up and rank 0 writes the gathered outputs to
one .npz. The JAX side: the JAX package's ``sharded_step`` / ``shard_map``
on P of the 8 virtual CPU devices that tests/conftest.py gives, with the
same seeded inputs. The cases are tests/test_parallel.py's: the 16-channel
USB bank at 1.024 Msps on both channelizers (squelch at -120 dB), the
2-D ("host", "chip") mesh at 512 ksps, the linear channelizer stage
(``VFOBank``, ``FFTChannelizerBank``) under ``channel_shard``, and
tests/test_multihost.py's 8-channel USB receiver at 256 ksps; each over two
different blocks, so the carried state crosses a block.

Tolerances, with their reasons:

- port against JAX, the bank and the receiver: audio SNR above 40 dB on
  each block, the bound the JAX package holds its own sharded bank to
  (tests/test_parallel.py:217-278): the AGC's attack / decay branches turn
  ulp-level differences between XLA's and torch's kernels into larger
  ones at isolated samples;
- port against JAX, the linear channelizer stage: within 2e-5, the bound
  tests/test_parallel.py holds JAX's sharded stage to against its
  unsharded one (pocketfft against XLA's FFT, cos / sin and complex
  products rounding apart);
- the port's sharded bank and stage against its own unsharded ones: bit
  for bit. Each rank runs the same per-row operations on its rows that
  the unsharded bank runs on all of them, and the tables' rows it takes
  are the unsharded tables' rows. (A chunked loop picks its lane count
  from the rows it is given, as in the JAX package, so a bank whose loops
  run chunked, such as WFM's pilot PLL, differs from its unsharded run by
  a few ulp; these USB cases run their AGC exact.)

A world's processes start with a deadline (``init_process_group``'s
timeout, WORLD_START_S) and are waited on with one (``communicate``'s,
WORLD_RUN_S); on the deadline the ranks are killed and the test fails.
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# the ranks run one thread, and the bank's start-up from zero state turns
# the rounding differences of another thread count into larger ones
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
WORLD_START_S = 60.0
WORLD_RUN_S = 240.0
SNR_DB = 40.0
STAGE_TOL = 2e-5
BANKS = ("time", "fft")
STAGES = ("VFOBank", "FFTChannelizerBank")


# ---- the cases, shared by the ranks and the JAX side ----------------------

def bank_config(name):
    """(offsets, fs, ScannerBank keyword arguments, block target, seed)."""
    if name in BANKS:  # tests/test_parallel.py:217-254
        return (np.linspace(-400000.0, 400000.0, 16), 1024000.0,
                dict(mode="usb", if_rate=32000.0, bandwidth=2700.0,
                     squelch_level=-120.0, channelizer=name), 32768, 7)
    if name == "2d":  # tests/test_parallel.py:257-278
        return (np.linspace(-200000.0, 200000.0, 16), 512000.0,
                dict(mode="usb", if_rate=32000.0, bandwidth=2700.0),
                16384, 8)
    # "multihost": tests/test_multihost.py's receiver
    return (np.linspace(-100000.0, 100000.0, 8), 256000.0,
            dict(mode="usb", if_rate=32000.0, bandwidth=2700.0), 8192, 1234)


def block_len(multiple, target):
    return multiple * max(1, target // multiple)


def bank_blocks(name, n):
    """Two different seeded blocks [2, n] complex64."""
    _, fs, _, _, seed = bank_config(name)
    rng = np.random.default_rng(seed)
    if name != "multihost":
        return (0.1 * (rng.standard_normal((2, n))
                       + 1j * rng.standard_normal((2, n)))).astype(np.complex64)
    t = np.arange(2 * n) / fs  # tests/_multihost_worker.py's signal
    sig = sum(0.1 * np.exp(2j * np.pi * f * t)
              for f in (-100000.0, -20000.0, 60000.0))
    iq = sig + 0.01 * (rng.standard_normal(2 * n)
                       + 1j * rng.standard_normal(2 * n))
    return iq.astype(np.complex64).reshape(2, n)


def stage_blocks(n):
    rng = np.random.default_rng(9)
    return (0.1 * (rng.standard_normal((2, n))
                   + 1j * rng.standard_normal((2, n)))).astype(np.complex64)


def mesh_2d(world):
    """The ("host", "chip") mesh shape of a world: 2 hosts where it can."""
    return (2, world // 2) if world > 1 else (1, 1)


STAGE_ARGS = (np.linspace(-400000.0, 400000.0, 16), 1024000.0, 32000.0,
              2700.0)


# ---- one rank of a world (no jax) ----------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rank(rank, world, init_file, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from sdrpp_tpu_torch.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu_torch.parallel import multihost as MH
    from sdrpp_tpu_torch.parallel.mesh import shard_placements
    from sdrpp_tpu_torch.parallel.spmd import channel_shard, local_rows
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank, VFOBank

    torch.set_num_threads(1)
    url = f"file://{init_file}"
    MH.distributed_init(url, world, rank, device="cpu",
                        timeout_s=WORLD_START_S)
    res = {}
    try:
        chan = MH.global_channel_mesh("cpu")
        grid = init_device_mesh("cpu", mesh_2d(world),
                                mesh_dim_names=("host", "chip"))
        for name, mesh, axis in (("time", chan, "channels"),
                                 ("fft", chan, "channels"),
                                 ("2d", grid, ("host", "chip"))):
            offs, fs, kw, target, _ = bank_config(name)
            bank = ScannerBank(offs, fs, device="cpu", **kw)
            step, _ = bank.sharded_step(mesh, axis)
            state, _, out = bank.shard(mesh, bank.init_state(), axis)
            xs = bank_blocks(name, block_len(bank.block_multiple, target))
            for k in range(2):
                state, y = step(state, torch.from_numpy(xs[k]))
                res[f"{name}_{k}"] = MH.gather_global(y, mesh, out).numpy()

        out = shard_placements(chan, "channels", 0)
        for stage in (VFOBank(*STAGE_ARGS, device="cpu"),
                      FFTChannelizerBank(*STAGE_ARGS[:3],
                                         bandwidth=STAGE_ARGS[3],
                                         device="cpu")):
            c = stage.channels // world
            state = _tree_map(
                lambda l: local_rows(l, c, "channels", chan)
                if l.ndim and l.shape[0] == stage.channels else l,
                stage.init_state())
            xs = stage_blocks(block_len(stage.block_multiple, 32768))
            for k in range(2):
                with channel_shard("channels", chan):
                    state, y = stage(state, torch.from_numpy(xs[k]))
                res[f"{type(stage).__name__}_{k}"] = \
                    MH.gather_global(y, chan, out).numpy()

        offs, fs, kw, target, _ = bank_config("multihost")
        rx = MH.MultiHostReceiver(offs, fs, coordinator=url,
                                  num_processes=world, process_id=rank,
                                  device="cpu", **kw)
        xs = bank_blocks("multihost",
                         block_len(rx.block_multiple, target))
        for k in range(2):
            res[f"multihost_{k}"] = rx.gather_audio(
                rx.process_block(xs[k])).numpy()
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def start_world(script, world, tmp):
    """Start ``world`` ranks of ``script`` (each ``script rank world
    init_file out``); returns what ``finish_world`` takes."""
    init, out = tmp / "init", tmp / "out.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(init),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs, out


def finish_world(started, deadline):
    """Wait for a world's ranks until ``deadline`` (time.monotonic), kill
    any left, and return rank 0's .npz; fails unless every rank exited 0.
    """
    procs, out = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} failed:\n{log}"
    with np.load(out) as f:
        return dict(f)


def world_results(script, tmp_path_factory):
    """Start the worlds of WORLDS at once and yield a getter of world P's
    outputs, which waits for them on its first call; ranks still running
    at the end are killed."""
    started = {w: start_world(script, w, tmp_path_factory.mktemp(f"world{w}"))
               for w in WORLDS}
    deadline = time.monotonic() + WORLD_RUN_S
    worlds = {}

    def get(world):
        if not worlds:
            for w in WORLDS:
                worlds[w] = finish_world(started[w], deadline)
        return worlds[world]

    try:
        yield get
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


# ---- the JAX side and the checks -----------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """World P's gathered outputs; the worlds start with the first test and
    run while the JAX side computes."""
    yield from world_results(__file__, tmp_path_factory)


_JAX = {}


def _jax_bank(name, world):
    """The JAX package's bank on two blocks, sharded over P = world of the
    virtual devices (``sharded_step``), as [2, C, n] audio."""
    key = ("bank", name, world)
    if key in _JAX:
        return _JAX[key]
    import jax
    from jax.sharding import Mesh, NamedSharding

    from sdrpp_tpu.ops import resample as jresample
    from sdrpp_tpu.parallel.vfo_bank import ScannerBank as JaxBank

    offs, fs, kw, target, _ = bank_config(name)
    bank = JaxBank(offs, fs, **kw)
    devs = np.array(jax.devices()[:world])
    if name == "2d":
        mesh, axis = Mesh(devs.reshape(mesh_2d(world)), ("host", "chip")), \
            ("host", "chip")
    else:
        mesh, axis = Mesh(devs, ("channels",)), "channels"
    step, specs = bank.sharded_step(mesh, axis=axis)
    state = jax.tree_util.tree_map(
        lambda l, s: jax.device_put(l, NamedSharding(mesh, s)),
        bank.init_state(), specs)
    xs = bank_blocks(name, block_len(bank.block_multiple, target))
    ys = []
    # the zero-stuffed polyphase form compiles in a fraction of the CPU
    # default's time (tests/test_torch_bank.py does the same)
    mode = jresample.POLYPHASE_MODE
    jresample.POLYPHASE_MODE = "zero_stuff"
    try:
        for k in range(2):
            state, y = step(state, xs[k])
            ys.append(np.asarray(y))
    finally:
        jresample.POLYPHASE_MODE = mode
    _JAX[key] = np.stack(ys)
    return _JAX[key]


def _jax_stage(name, world):
    key = ("stage", name, world)
    if key in _JAX:
        return _JAX[key]
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank as JaxFFT
    from sdrpp_tpu.parallel.spmd import channel_shard as jax_channel_shard
    from sdrpp_tpu.parallel.vfo_bank import VFOBank as JaxVFO

    stage = (JaxVFO(*STAGE_ARGS) if name == "VFOBank"
             else JaxFFT(*STAGE_ARGS[:3], bandwidth=STAGE_ARGS[3]))
    mesh = Mesh(np.array(jax.devices()[:world]), ("channels",))
    specs = jax.tree_util.tree_map(
        lambda l: P("channels", *([None] * (l.ndim - 1)))
        if l.ndim >= 1 and l.shape[0] == 16 else P(),
        jax.eval_shape(stage.init_state))

    def fn(state, x):
        with jax_channel_shard("channels"):
            return stage(state, x)

    step = jax.jit(shard_map(fn, mesh=mesh, in_specs=(specs, P()),
                             out_specs=(specs, P("channels", None)),
                             check_vma=False))
    state = jax.tree_util.tree_map(
        lambda l, s: jax.device_put(l, NamedSharding(mesh, s)),
        stage.init_state(), specs)
    xs = stage_blocks(block_len(stage.block_multiple, 32768))
    ys = []
    for k in range(2):
        state, y = step(state, xs[k])
        ys.append(np.asarray(y))
    _JAX[key] = np.stack(ys)
    return _JAX[key]


@functools.lru_cache(maxsize=None)
def _port_unsharded(name):
    """The port's bank (or stage) unsharded, on the CPU: [2, C, n]."""
    from sdrpp_tpu_torch.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank, VFOBank

    if name in STAGES:
        blk = (VFOBank(*STAGE_ARGS, device="cpu") if name == "VFOBank"
               else FFTChannelizerBank(*STAGE_ARGS[:3],
                                       bandwidth=STAGE_ARGS[3], device="cpu"))
        xs = stage_blocks(block_len(blk.block_multiple, 32768))
    else:
        offs, fs, kw, target, _ = bank_config(name)
        blk = ScannerBank(offs, fs, device="cpu", **kw)
        xs = bank_blocks(name, block_len(blk.block_multiple, target))
    state, ys = blk.init_state(), []
    for k in range(2):
        state, y = blk(state, torch.from_numpy(xs[k]))
        ys.append(y.numpy())
    return np.stack(ys)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(got, np.float64)
    return 10.0 * np.log10(np.sum(ref * ref) / max(np.sum(err * err), 1e-30))


def _port_blocks(port, world, name):
    got = port(world)
    return np.stack([got[f"{name}_{k}"] for k in range(2)])


@pytest.mark.parametrize("name", BANKS + ("2d", "multihost"))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bank_matches_jax(port, world, name):
    """The port's bank on P ranks against the JAX package's on P devices:
    the channelizers, the 2-D mesh, the multi-process receiver."""
    want = _jax_bank(name, world)
    got = _port_blocks(port, world, name)
    assert got.shape == want.shape and np.isfinite(got).all()
    for k in range(2):
        assert _snr_db(want[k], got[k]) > SNR_DB, (k, _snr_db(want[k], got[k]))


@pytest.mark.parametrize("name", BANKS + ("2d", "multihost"))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bank_matches_unsharded_port(port, world, name):
    np.testing.assert_array_equal(_port_blocks(port, world, name),
                                  _port_unsharded(name))


@pytest.mark.parametrize("name", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_channelizer_stage_matches_jax(port, world, name):
    """The linear stage under ``channel_shard`` on P ranks, against JAX's
    under ``shard_map`` on P devices and the port's unsharded stage."""
    want = _jax_stage(name, world)
    got = _port_blocks(port, world, name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STAGE_TOL, rtol=0)
    np.testing.assert_array_equal(got, _port_unsharded(name))


def test_multihost_matches_unsharded_jax(port):
    """tests/test_multihost.py's check: the 4-process receiver against the
    JAX package's unsharded bank."""
    import jax

    from sdrpp_tpu.parallel.vfo_bank import ScannerBank as JaxBank

    offs, fs, kw, target, _ = bank_config("multihost")
    bank = JaxBank(offs, fs, **kw)
    xs = bank_blocks("multihost", block_len(bank.block_multiple, target))
    got = _port_blocks(port, 4, "multihost")
    state, step = bank.init_state(), jax.jit(bank)
    for k in range(2):
        state, want = step(state, xs[k])
        assert _snr_db(want, got[k]) > SNR_DB, k


def test_one_rank_world(tmp_path):
    """A world of 1 on an in-process store (``distributed_init`` without a
    coordinator): the placements cut nothing, a second ``distributed_init``
    with another world size raises, the shard index of a tuple axis
    flattens row-major, ``put_global`` / ``gather_global`` round-trip, and
    ``MultiHostReceiver.run_file`` gives what ``process_block`` gives on
    the file's blocks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from sdrpp_tpu_torch.parallel import mesh as M
    from sdrpp_tpu_torch.parallel import multihost as MH
    from sdrpp_tpu_torch.parallel import spmd

    assert MH.host_shard_paths(["a", "b", "c", "d", "e"], 1, 2) == ["b", "d"]
    assert spmd.current_channel_axis() is None
    assert MH.distributed_init(device="cpu") == (1, 0)
    try:
        with pytest.raises(RuntimeError, match="world"):
            MH.distributed_init(num_processes=2, device="cpu")
        mesh = M.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("channels", "time")
        assert M.channel_sharding(mesh) == [Shard(0), Replicate()]
        assert M.time_sharding(mesh, 2) == [Replicate(), Shard(1)]
        assert M.replicated(mesh) == [Replicate(), Replicate()]
        grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("host", "chip"))
        with pytest.raises(ValueError, match="order"):
            M.shard_placements(grid, ("chip", "host"), 0)
        t = torch.arange(12.0).reshape(4, 3)
        with spmd.channel_shard(("host", "chip"), grid):
            assert spmd.current_channel_axis() == ("host", "chip")
            assert spmd.shard_index(("host", "chip")) == 0
            assert torch.equal(spmd.local_rows(t, 4), t)
            with pytest.raises(ValueError, match="out of"):
                spmd.local_rows(t, 5)
        assert spmd.current_channel_axis() is None
        a = np.arange(48.0).reshape(16, 3)
        blk = MH.put_global(a, mesh, M.channel_sharding(mesh), "cpu")
        assert torch.equal(MH.gather_global(blk, mesh,
                                            M.channel_sharding(mesh)),
                           torch.from_numpy(a))

        from sdrpp_tpu_torch.io.wav import write_wav

        offs, fs, kw, target, _ = bank_config("multihost")
        rx = MH.MultiHostReceiver(offs, fs, device="cpu", **kw)
        n = block_len(rx.block_multiple, target)
        iq = bank_blocks("multihost", n).reshape(-1)
        path = tmp_path / "iq.wav"
        write_wav(path, int(fs), np.stack([iq.real, iq.imag], -1), "f32")
        got = rx.run_file(path, 2, n)
        ref = MH.MultiHostReceiver(offs, fs, device="cpu", **kw)
        for k in range(2):
            want = ref.process_block(iq[k * n:(k + 1) * n])
            assert torch.equal(ref.gather_audio(want), got[k])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
