"""Port parity for ``parallel.time_shard`` (the halo FIR, the affine scan,
the NCO mix, the quadrature discriminator over time shards and the
time-sharded NFM step) and ``parallel.dist_fft`` (the four-step FFT in
natural and matrix form, its power spectrum, ``shard_input``), in worlds
of P = 1, 2 and 4 processes.

The port side: this file run as a script is one rank of a gloo world
(tests/test_torch_parallel.py's launcher: ``file://`` init, one thread,
no jax, deadlines on start-up and on the wait); the ranks run every case
in one start-up, and rank 0 writes the gathered outputs to one .npz. The
JAX side: the JAX package's functions under ``shard_map`` on P of the 8
virtual CPU devices, on the same seeded inputs. The cases are
tests/test_time_shard.py's and tests/test_dist_fft.py's, each time-shard
case over two blocks so the carries cross a block.

Tolerances, with their reasons (each the JAX test's own bound where it
has one):

- ``sharded_fir``: within 2e-4 of JAX at P and of the port's unsharded
  ``FIR`` (overlap-save FFTs of another length round apart);
- ``sharded_affine_scan``: within 1e-4 of JAX at P (rtol, atol 1e-5 as
  tests/test_time_shard.py against its float32 loop), and at least as
  close to a float64 reference as JAX is, also at a = 1 - 2.1e-5 (the DC
  blocker at 2.4 Msps), where JAX's float32 ``associative_scan`` drifts
  and the port's blocked scan does not;
- ``sharded_mix``: within 2e-3 of the exact phasor, the JAX test's bound,
  and within 1e-5 of JAX at P (the same float32 phase; cos / sin round
  apart by an ulp or two);
- ``sharded_quadrature``: within 1e-4 of JAX at P and of the port's
  ``Quadrature``;
- ``make_time_step_nfm``: the JAX test's tone (1 kHz, off by < 5 Hz, SNR
  > 25 dB), and within 1e-4 of JAX at P and of the port's unsharded chain
  (``FrequencyXlator`` -> ``FIR`` -> ``Quadrature`` -> ``FIR``), block 1
  from sample NFM_SETTLE on: from zero state the channel filter fills
  over its first ~330 outputs, where the discriminator takes the angle of
  near-zero samples and rounding differences become O(1) (both packages
  alike; block 2 agrees within 4e-7);
- ``dist_fft``, ``shard_input``: within 2e-6 of the spectrum's peak of
  numpy's FFT and of JAX's ``dist_fft`` at P;
- ``dist_power_spectrum``: within 2e-3 dB of the port's ``SpectrumFFT``
  line and of JAX's at P, the JAX test's bound.
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import WORLDS, world_results

torch.set_num_threads(1)

FIR_N = 8 * 2048
SCAN_N = 8 * 1024
MIX_N = 8 * 1000
QUAD_N = 8 * 1024
NFM_N = 8 * 8192
NFM_SETTLE = 400   # samples of the chain's zero-state start-up
FFT_SIZES = (1 << 12, 1 << 14, 1 << 16)
MATRIX_N = 1 << 10
SPECTRUM_N = 1 << 16
SCAN_RATES = (0.002, 50.0 / 2.4e6)


# ---- the cases, shared by the ranks and the JAX side ----------------------

def fir_case():
    from sdrpp_tpu_torch.ops import taps

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(FIR_N)
         + 1j * rng.standard_normal(FIR_N)).astype(np.complex64)
    return taps.low_pass(3000.0, 1000.0, 48000.0), np.stack([x, x])


def scan_case(rate):
    """(a, b [2, n]): tests/test_time_shard.py's DC-blocker offsets."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(2 * SCAN_N) + 0.4).astype(np.float32)
    return np.float32(1.0 - rate), (np.float32(rate) * x).reshape(2, SCAN_N)


def mix_case():
    omega = 2.0 * np.pi * (1234.5 / 48000.0)
    return omega, np.ones((2, MIX_N), np.complex64)


def quad_case():
    fs, dev = 48000.0, 5000.0
    t = np.arange(2 * QUAD_N) / fs
    audio = np.sin(2 * np.pi * 700.0 * t)
    x = np.exp(1j * np.cumsum(2 * np.pi * dev * audio / fs))
    return 1.0 / (2.0 * np.pi * dev / fs), \
        x.astype(np.complex64).reshape(2, QUAD_N)


NFM = dict(offset_hz=20000.0, samplerate=96000.0, bandwidth=12500.0)


def nfm_case():
    fs, f_ch, dev, f_aud = 96000.0, 20000.0, 5000.0, 1000.0
    t = np.arange(2 * NFM_N) / fs
    audio = np.sin(2 * np.pi * f_aud * t)
    iq = np.exp(1j * (2 * np.pi * f_ch * t
                      + np.cumsum(2 * np.pi * dev * audio / fs)))
    return iq.astype(np.complex64).reshape(2, NFM_N)


def fft_signal(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def spectrum_case():
    from sdrpp_tpu_torch.ops.spectrum import SpectrumFFT

    spec = SpectrumFFT(SPECTRUM_N, float(SPECTRUM_N), 1.0, device="cpu")
    return spec, 0.1 * fft_signal(SPECTRUM_N, 2)


# ---- one rank of a world (no jax) ----------------------------------------

def _rank(rank, world, init_file, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from sdrpp_tpu_torch.parallel import dist_fft as DF
    from sdrpp_tpu_torch.parallel import time_shard as TS
    from sdrpp_tpu_torch.parallel.multihost import (distributed_init,
                                                    gather_global)

    torch.set_num_threads(1)
    distributed_init(f"file://{init_file}", world, rank, device="cpu",
                     timeout_s=60.0)
    res = {}
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("time",))
        fmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("fft",))

        def mine(x):  # this rank's contiguous shard of a block
            w = x.shape[-1] // world
            return torch.from_numpy(np.ascontiguousarray(
                x[..., rank * w:(rank + 1) * w]))

        def whole(y, m=mesh):
            return gather_global(y, m, [Shard(0)]).numpy()

        def blocks(name, fn, state, xs):
            for k in range(2):
                state, y = fn(state, mine(xs[k]))
                res[f"{name}_{k}"] = whole(y)
            res[f"{name}_state"] = state.numpy()

        taps, xs = fir_case()
        blocks("fir", lambda s, x: TS.sharded_fir(s, x, taps, mesh),
               torch.zeros(len(taps) - 1, dtype=torch.complex64), xs)
        for i, rate in enumerate(SCAN_RATES):
            a, bs = scan_case(rate)
            blocks(f"scan{i}",
                   lambda s, b: TS.sharded_affine_scan(a, b, s, mesh),
                   torch.zeros((), dtype=torch.float32), bs)
        omega, xs = mix_case()
        blocks("mix",
               lambda s, x: TS.sharded_mix(s, x, omega, MIX_N // world, mesh),
               torch.zeros((), dtype=torch.float32), xs)
        inv_dev, xs = quad_case()
        blocks("quad",
               lambda s, x: TS.sharded_quadrature(s, x, inv_dev, mesh),
               torch.zeros(1, dtype=torch.complex64), xs)
        step, init_state = TS.make_time_step_nfm(mesh, block_size=NFM_N,
                                                 **NFM)
        state, xs = init_state(), nfm_case()
        for k in range(2):
            state, y = step(state, mine(xs[k]))
            res[f"nfm_{k}"] = whole(y)

        for n in FFT_SIZES:
            res[f"fft_{n}"] = whole(DF.dist_fft(
                DF.shard_input(fft_signal(n, 0), fmesh), fmesh), fmesh)
        res["matrix"] = whole(DF.dist_fft(
            DF.shard_input(fft_signal(MATRIX_N, 1), fmesh), fmesh,
            natural=False), fmesh)
        spec, x = spectrum_case()
        res["spectrum"] = whole(DF.dist_power_spectrum(
            DF.shard_input(x, fmesh), spec.window, fmesh), fmesh)
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


# ---- the JAX side and the checks -----------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """World P's gathered outputs; the worlds start with the first test and
    run while the JAX side computes."""
    yield from world_results(__file__, tmp_path_factory)


def _jax_mesh(world, name):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:world]), axis_names=(name,))


def _jax_blocks(world, fn, state, xs):
    """fn(state, x_local) under shard_map over P devices' "time" axis, on
    two blocks: ([2, n] outputs, final state)."""
    import jax
    from jax.sharding import PartitionSpec as P

    step = jax.jit(jax.shard_map(
        fn, mesh=_jax_mesh(world, "time"), in_specs=(P(), P("time")),
        out_specs=(P(), P("time"))))
    ys = []
    for k in range(2):
        state, y = step(state, xs[k])
        ys.append(np.asarray(y))
    return np.stack(ys), np.asarray(state)


def _port(port, world, name):
    got = port(world)
    return np.stack([got[f"{name}_{k}"] for k in range(2)])


def _close(want, got, tol):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and np.isfinite(got).all()
    err = float(np.abs(want - got).max())
    assert err <= tol, err


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fir(port, world):
    import jax.numpy as jnp

    from sdrpp_tpu.parallel.time_shard import sharded_fir
    from sdrpp_tpu_torch.ops.fir import FIR

    taps, xs = fir_case()
    want, _ = _jax_blocks(world, lambda s, x: sharded_fir(s, x, taps),
                          jnp.zeros(len(taps) - 1, jnp.complex64), xs)
    got = _port(port, world, "fir")
    _close(want, got, 2e-4)
    ref, st = FIR(taps, device="cpu"), None
    st = ref.init_state()
    for k in range(2):
        st, y = ref(st, torch.from_numpy(xs[k]))
        _close(y.numpy(), got[k], 2e-4)
    np.testing.assert_array_equal(port(world)["fir_state"],
                                  xs[1][-(len(taps) - 1):])


@pytest.mark.parametrize("rate", SCAN_RATES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_affine_scan(port, world, rate):
    import jax.numpy as jnp

    from sdrpp_tpu.parallel.time_shard import sharded_affine_scan

    a, bs = scan_case(rate)
    want, want_final = _jax_blocks(
        world, lambda s, b: sharded_affine_scan(a, b, s),
        jnp.float32(0.0), bs)
    i = SCAN_RATES.index(rate)
    got = _port(port, world, f"scan{i}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # float64 reference over both blocks
    ref = np.empty(2 * SCAN_N)
    y, a64 = 0.0, float(a)
    for j, b in enumerate(bs.reshape(-1).astype(np.float64)):
        y = a64 * y + b
        ref[j] = y
    ref = ref.reshape(2, SCAN_N)
    err_port = np.abs(got - ref).max()
    err_jax = np.abs(want - ref).max()
    assert err_port <= err_jax, (err_port, err_jax)
    assert abs(float(port(world)[f"scan{i}_state"]) - ref[-1, -1]) \
        <= max(1e-5, err_port)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mix(port, world):
    import jax.numpy as jnp

    from sdrpp_tpu.parallel.time_shard import sharded_mix

    omega, xs = mix_case()
    want, _ = _jax_blocks(
        world, lambda s, x: sharded_mix(s, x, omega, MIX_N // world),
        jnp.zeros((), jnp.float32), xs)
    got = _port(port, world, "mix")
    _close(np.exp(1j * omega * np.arange(2 * MIX_N)).reshape(2, MIX_N),
           got, 2e-3)
    _close(want, got, 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_quadrature(port, world):
    import jax.numpy as jnp

    from sdrpp_tpu.parallel.time_shard import sharded_quadrature
    from sdrpp_tpu_torch.ops.fm import Quadrature

    inv_dev, xs = quad_case()
    want, _ = _jax_blocks(
        world, lambda s, x: sharded_quadrature(s, x, inv_dev),
        jnp.zeros(1, jnp.complex64), xs)
    got = _port(port, world, "quad")
    _close(want, got, 1e-4)
    ref = Quadrature(5000.0, 48000.0, device="cpu")
    st = ref.init_state()
    for k in range(2):
        st, y = ref(st, torch.from_numpy(xs[k]))
        _close(y.numpy(), got[k], 1e-4)


def _port_nfm_unsharded(xs):
    """The chain make_time_step_nfm shards, unsharded in the port."""
    from sdrpp_tpu_torch.ops import taps
    from sdrpp_tpu_torch.ops.fir import FIR
    from sdrpp_tpu_torch.ops.fm import Quadrature
    from sdrpp_tpu_torch.ops.mix import FrequencyXlator

    fs, bw = NFM["samplerate"], NFM["bandwidth"]
    blocks = [FrequencyXlator(-NFM["offset_hz"], fs, device="cpu"),
              FIR(taps.low_pass(bw / 2.0, bw * 0.05, fs), device="cpu"),
              Quadrature(bw / 2.0, fs, device="cpu"),
              FIR(taps.low_pass(bw / 2.0, bw * 0.1, fs), dtype=torch.float32,
                  device="cpu")]
    states, out = [b.init_state() for b in blocks], []
    for k in range(2):
        y = torch.from_numpy(xs[k])
        for i, b in enumerate(blocks):
            states[i], y = b(states[i], y)
        out.append(y.numpy())
    return np.stack(out)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_nfm_chain(port, world):
    from sdrpp_tpu.parallel.time_shard import make_time_step_nfm

    xs = nfm_case()
    step, init_state = make_time_step_nfm(_jax_mesh(world, "time"),
                                          block_size=NFM_N, **NFM)
    st, want = init_state(), []
    for k in range(2):
        st, y = step(st, xs[k])
        want.append(np.asarray(y))
    got = _port(port, world, "nfm")
    for ref in (np.stack(want), _port_nfm_unsharded(xs)):
        _close(ref[0, NFM_SETTLE:], got[0, NFM_SETTLE:], 1e-4)
        _close(ref[1], got[1], 1e-4)
    # tests/test_time_shard.py's tone check
    y = got.reshape(-1)
    seg = y[len(y) // 2:] - np.mean(y[len(y) // 2:])
    S = np.abs(np.fft.rfft(seg * np.hanning(len(seg)))) ** 2
    freqs = np.fft.rfftfreq(len(seg), 1 / NFM["samplerate"])
    k = np.argmax(S[3:]) + 3
    assert abs(freqs[k] - 1000.0) < 5.0
    sig = S[k - 3: k + 4].sum()
    assert 10 * np.log10(sig / (S[3:].sum() - sig)) > 25


def _fft_close(want, got):
    scale = np.abs(want).max()
    _close(want / scale, np.asarray(got) / scale, 2e-6)


@pytest.mark.parametrize("n", FFT_SIZES)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_fft(port, world, n):
    import jax

    from sdrpp_tpu.parallel.dist_fft import dist_fft

    x = fft_signal(n, 0)
    mesh = _jax_mesh(world, "fft")
    want = np.asarray(jax.jit(lambda v: dist_fft(v, mesh))(x))
    got = port(world)[f"fft_{n}"]
    _fft_close(np.fft.fft(x), got)
    _fft_close(want, got)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_fft_matrix_form(port, world):
    import jax

    from sdrpp_tpu.parallel.dist_fft import dist_fft

    x = fft_signal(MATRIX_N, 1)
    mesh = _jax_mesh(world, "fft")
    want = np.asarray(jax.jit(
        lambda v: dist_fft(v, mesh, natural=False))(x))
    got = port(world)["matrix"]
    assert got.shape == want.shape
    _fft_close(want, got)
    # C[k1, k2] == X[k1 + r*k2]
    _fft_close(np.fft.fft(x), got.T.reshape(-1))


@pytest.mark.parametrize("world", WORLDS)
def test_dist_power_spectrum(port, world):
    import jax

    from sdrpp_tpu.parallel.dist_fft import dist_power_spectrum

    spec, x = spectrum_case()
    mesh = _jax_mesh(world, "fft")
    want = np.asarray(jax.jit(
        lambda v: dist_power_spectrum(v, spec.window, mesh))(x))
    got = port(world)["spectrum"]
    _close(want, got, 2e-3)
    _close(spec(torch.from_numpy(x))[0].numpy(), got, 2e-3)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
