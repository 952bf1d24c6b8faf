"""Port parity for the FEC: ConvCode (encode, the exact Viterbi decode and
the chunk-parallel stream decode), the batched ACS / traceback kernels'
plain versions, and ReedSolomon.

The JAX side runs as the JAX package's own tests run it on the CPU: the
batched Pallas kernels in interpret mode (tests/test_fec_pallas.py), the
stream decode forced onto its chunked path by standing in for
``fec_pallas._pallas_available`` (chunk_bits <= 1024 keeps the interpret
side fast). Tolerance everywhere: bit-exact. Soft bits are integers in
0..255, so every branch metric is an exact float32 sum, every path metric
one rounding of the same operands in the same order on both sides, and the
decisions, bits and bytes agree exactly; the RS decoder is integer
arithmetic over GF(256).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import fec as jfec
from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fec_kernels as FK

torch.set_num_threads(1)

VEC = np.load(Path(__file__).parent / "data" / "libcorrect_vectors.npz")
LRPT = (0o171, 0o133)


def _noisy_soft(code, nbytes, seed, sigma=60.0):
    """Encode random bytes, map to 0/255 soft bits, add seeded noise,
    quantize to integers in 0..255."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, nbytes).astype(np.uint8)
    nbits = code.encode_len_bits(nbytes)
    bits = np.unpackbits(code.encode(msg))[:nbits]
    soft = np.clip(np.round(bits * 255.0 + rng.normal(0, sigma, nbits)),
                   0, 255).astype(np.uint8)
    return msg, soft


@pytest.mark.parametrize("order,polys,key", [(7, jfec.CONV_R12_7, "conv_enc"),
                                             (9, jfec.CONV_R12_9, "conv9_enc"),
                                             (7, LRPT, None)])
def test_conv_encode_matches_jax_and_libcorrect(order, polys, key):
    j = jfec.ConvCode(2, order, polys)
    t = tfec.ConvCode(2, order, polys, device="cpu")
    np.testing.assert_array_equal(t.reg_outputs, j.reg_outputs)
    msg = VEC["conv_msg"]
    np.testing.assert_array_equal(t.encode(msg), j.encode(msg))
    assert t.encode_len_bits(len(msg)) == j.encode_len_bits(len(msg))
    if key is not None:
        np.testing.assert_array_equal(t.encode(msg), VEC[key])


def test_decode_soft_matches_libcorrect():
    t = tfec.ConvCode(2, 7, jfec.CONV_R12_7, device="cpu")
    bits = t.decode_soft(VEC["conv_soft"]).numpy()
    dec = tfec._bytes_from_bits(bits[:(len(bits) // 8) * 8])
    np.testing.assert_array_equal(dec[:int(VEC["conv_declen"])],
                                  VEC["conv_dec"])


@pytest.mark.parametrize("flush", [None, 6])
def test_decode_soft_matches_jax(flush):
    """The exact decode (one window through the batched kernels' plain
    versions) against the JAX lax.scan decode, at an SNR with errors."""
    j = jfec.ConvCode(2, 7, LRPT)
    t = tfec.ConvCode(2, 7, LRPT, device="cpu")
    _, soft = _noisy_soft(t, 150, 0, sigma=90.0)
    want = np.asarray(jax.jit(lambda s: j.decode_soft(s, flush))(
        jnp.asarray(soft.astype(np.float32))))
    got = t.decode_soft(torch.from_numpy(soft), flush_bits=flush)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_acs_and_traceback_plain_match_pallas_batched():
    """B windows of noisy soft bits laid end to end in one stream: the
    packed decisions, unpacked, and the bits bit-exact against the
    interpret-mode batched Pallas kernels (B6, B7) on the gathered windows
    and, window by window, the single-stream ACS (B5)."""
    code = jfec.ConvCode(2, 7, LRPT)
    rng = np.random.default_rng(1)
    soft = np.clip(np.round(255.0 * rng.integers(0, 2, (3, 200, 2))
                            + rng.normal(0, 80, (3, 200, 2))), 0, 255
                   ).astype(np.float32)
    expected = code.reg_outputs.astype(np.float32) * 255.0
    want = np.asarray(fec_pallas.viterbi_acs_pallas_batched(
        jnp.asarray(soft), jnp.asarray(expected), 64, interpret=True))
    starts = torch.tensor([0, 200, 400], dtype=torch.int32)
    got = FK.viterbi_acs_batched(torch.from_numpy(soft.reshape(600, 2)),
                                 starts, 200, torch.from_numpy(expected))
    np.testing.assert_array_equal(FK.unpack_decisions(got).numpy(), want)
    one = np.asarray(fec_pallas.viterbi_acs_pallas(
        jnp.asarray(soft[1]), jnp.asarray(expected), 64, interpret=True))
    np.testing.assert_array_equal(FK.unpack_decisions(got[1]).numpy(), one)
    bits = np.asarray(fec_pallas.viterbi_traceback_pallas_batched(
        jnp.asarray(want), 64, interpret=True))
    np.testing.assert_array_equal(FK.viterbi_traceback_batched(got).numpy(),
                                  bits)


@pytest.fixture(scope="module")
def jax_stream():
    """Noisy soft bits of 4014 trellis steps (4 windows of 1024 + 2 x 96
    steps) and the JAX stream decode of them on its chunked path."""
    t = tfec.ConvCode(2, 7, LRPT, device="cpu")
    _, soft = _noisy_soft(t, 500, 2, sigma=70.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fec_pallas, "_pallas_available", lambda: True)
        want = jfec.ConvCode(2, 7, LRPT).decode_soft_stream(
            soft, chunk_bits=1024, overlap_bits=96)
    return soft, want


def test_decode_soft_stream_matches_jax_stream(jax_stream):
    """The chunk-parallel stream decode (windows of 1024 + 2 x 96 steps)
    against the JAX stream decode on its chunked path, and both against
    the exact decode at a moderate SNR."""
    soft, want = jax_stream
    t = tfec.ConvCode(2, 7, LRPT, device="cpu")
    got = t.decode_soft_stream(soft, chunk_bits=1024, overlap_bits=96)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t.decode_soft(soft).numpy())


@pytest.mark.parametrize("batch,groups", [(2, [2, 2]), (3, [3, 1])])
def test_decode_soft_stream_in_groups_matches_jax_stream(monkeypatch,
                                                         jax_stream, batch,
                                                         groups):
    """Streams of more windows than one batched launch takes (a real pass:
    about 23k windows, 1024 per launch) run in groups; with the group size
    cut to 2 and 3 the 4 windows take two launches, the last one partial
    at 3, and the bits stay bit-exact against the JAX stream decode and
    the exact decode."""
    soft, want = jax_stream
    monkeypatch.setattr(tfec.ConvCode, "_STREAM_BATCH", batch)
    seen = []

    def acs(soft_steps, starts, T, expected):
        seen.append(starts.shape[0])
        return FK.viterbi_acs_batched(soft_steps, starts, T, expected)

    monkeypatch.setattr(tfec, "viterbi_acs_batched", acs)
    t = tfec.ConvCode(2, 7, LRPT, device="cpu")
    got = t.decode_soft_stream(soft, chunk_bits=1024, overlap_bits=96)
    assert seen == groups
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t.decode_soft(soft).numpy())


def test_decode_soft_stream_short_takes_exact_decode():
    t = tfec.ConvCode(2, 7, LRPT, device="cpu")
    msg, soft = _noisy_soft(t, 100, 3)
    bits = t.decode_soft_stream(soft)
    assert isinstance(bits, np.ndarray)
    np.testing.assert_array_equal(np.packbits(bits), msg)


def test_viterbi_wrappers_reject_other_devices():
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        FK.viterbi_acs_batched(torch.zeros((4, 2), device="meta"),
                               torch.zeros(1, dtype=torch.int32,
                                           device="meta"), 4,
                               torch.zeros((128, 2), device="meta"))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        FK.viterbi_traceback_batched(
            torch.zeros((1, 4), dtype=torch.int64, device="meta"))


def test_bits_bytes_helpers():
    data = np.arange(7, dtype=np.uint8) * 37
    np.testing.assert_array_equal(tfec._bits_from_bytes(data),
                                  jfec._bits_from_bytes(data))
    bits = tfec._bits_from_bytes(data)
    np.testing.assert_array_equal(tfec._bytes_from_bits(bits),
                                  jfec._bytes_from_bits(bits))


# ---------------------------------------------------------------------------
# Reed-Solomon
# ---------------------------------------------------------------------------

def _rs_pair():
    return (jfec.ReedSolomon(jfec.RS_CCSDS, 112, 11, 32),
            tfec.ReedSolomon(tfec.RS_CCSDS, 112, 11, 32, device="cpu"))


def test_rs_encode_matches_jax_and_libcorrect():
    j, t = _rs_pair()
    np.testing.assert_array_equal(t.generator, j.generator)
    np.testing.assert_array_equal(t.encode(VEC["rs_msg"]), VEC["rs_enc_ccsds"])
    d = tfec.ReedSolomon(device="cpu")
    np.testing.assert_array_equal(d.encode(VEC["rs_msg"]),
                                  VEC["rs_enc_default"])


def test_rs_decode_matches_libcorrect_vector():
    _, t = _rs_pair()
    out, ok = t.decode(torch.from_numpy(VEC["rs_corrupted"][None]))
    assert bool(ok[0])
    np.testing.assert_array_equal(out[0].numpy()[:int(VEC["rs_declen"])],
                                  VEC["rs_dec"])


def test_rs_decode_batch_matches_jax_up_to_16_errors():
    """Codewords with 0..18 byte errors in one batch: corrected bytes and
    ok flags bit-exact against the JAX vmap decode (beyond 16 errors both
    report failure alike)."""
    j, t = _rs_pair()
    rng = np.random.default_rng(4)
    blocks = []
    for nerr in list(range(17)) + [17, 18]:
        cw = t.encode(rng.integers(0, 256, 223).astype(np.uint8))
        pos = rng.choice(255, nerr, replace=False)
        cw[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
        blocks.append(cw)
    blocks = np.stack(blocks)
    want_out, want_ok = jax.jit(jax.vmap(j.decode))(jnp.asarray(blocks))
    got_out, got_ok = t.decode(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    assert got_ok.numpy()[:17].all()
