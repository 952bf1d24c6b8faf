"""The Viterbi traceback's segment-parallel walk at S > 64 (csrc/viterbi.cu
``tb_map_kernel``, ``tb_chain_kernel`` and ``tb_select_kernel``) as a numpy
model of its schedule, held bit for bit to the plain walk
``fec_kernels.viterbi_traceback_batched_plain`` and, at S = 128, to the JAX
package's Pallas walk ``viterbi_traceback_pallas_batched`` in interpret
mode (B7; it pads the states to one 128-lane tile, so S = 128 is the
widest it takes).

``segment_model`` repeats the kernels step for step: the segment length
``fec_kernels.wide_segment_steps(T)`` (L = 32 for every T below 4096, 64
from 4096 to 16383), the ragged top segment, each segment walked from
every end state with each walk's bits packed 32 steps a word (step t + i
of a block at bit 31 - i, stored after step t = 0 mod 32), the maps of
end states, the chain from state 0 at the top and the bits taken from the
entry state's words four steps at a time. The kernel has no merge
shortcut: every segment is walked in full from every end state.

Cases: S = 128, 256, 1024 and 16384; B = 1 and 3; T = 1, L - 1, L, L +
1 and 3L + 5 at L = 32, and 64L + 5 at L = 64 (S = 128 and 256); the
words of the plain ACS over a noisy stream of a code of order log2(S) +
1 (K = 9 at S = 256), random words, all zero, all ones and the rotation
words (state s takes s & 1: every step a rotation of the states, so no
two walks ever merge). Exact integers on both sides: tolerance 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrpp_tpu.ops import fec_pallas
from sdrpp_tpu_torch.ops import fec as tfec
from sdrpp_tpu_torch.ops import fec_kernels as FK

torch.set_num_threads(1)

VITERBI_CU = (Path(__file__).resolve().parent.parent / "sdrpp_tpu_torch"
              / "csrc" / "viterbi.cu")
STATES = (128, 256, 1024, 16384)
KINDS = ("acs", "random", "zero", "ones", "rotation")
ROTATION = -0x5555555555555556   # 0xAAAA...: bit n of every word is n & 1


def segment_model(words: np.ndarray, S: int) -> dict:
    """The kernels' three phases on int64 words [B, T, S / 64]: the maps
    [B, nseg, S] (the state each end state's walk leaves its segment in),
    the packed bits [B, ceil(T / 32), S] uint32, the chain's entries [B,
    nseg] and the bits [B, T] uint8."""
    B, T = words.shape[:2]
    L = FK.wide_segment_steps(T)
    nseg, t32 = -(-T // L), -(-T // 32)
    w32 = np.ascontiguousarray(words).view(np.uint32).reshape(B, T, S // 32)
    half = np.uint32(S // 2)
    maps = np.zeros((B, nseg, S), np.uint16)
    packed = np.zeros((B, t32, S), np.uint32)
    rows = np.arange(B)[:, None]
    # phase 1: a CTA a (window, segment), every end state walked
    for j in range(nseg):
        lo, n = j * L, min(L, T - j * L)
        s = np.broadcast_to(np.arange(S, dtype=np.uint32), (B, S)).copy()
        acc = np.zeros((B, S), np.uint32)
        for r in range(n - 1, -1, -1):
            t = lo + r
            w = w32[rows, t, s >> 5]
            acc = (acc >> np.uint32(1)) | ((s & np.uint32(1)) << np.uint32(31))
            took = (w >> (s & np.uint32(31))) & np.uint32(1)
            s = (s >> np.uint32(1)) + took * half
            if t % 32 == 0:
                packed[:, t // 32] = acc
        maps[:, j] = s
    # phase 2: a warp a window, from state 0 at the top
    entries = np.zeros((B, nseg), np.int64)
    for b in range(B):
        s = 0
        for j in range(nseg - 1, -1, -1):
            entries[b, j] = s
            s = int(maps[b, j, s])
    # phase 3: a thread a 4-step group of a 32-step block
    bits = np.zeros((B, T), np.uint8)
    for b in range(B):
        for q in range(t32):
            lo = 32 * q
            word = int(packed[b, q, entries[b, lo // L]])
            for t in range(lo, min(lo + 32, T), 4):
                v = word >> (28 - (t - lo))   # steps t ... t + 3: bits 3 ... 0
                n = min(4, T - t)
                bits[b, t:t + n] = (v >> (3 - np.arange(n))) & 1
    return {"L": L, "maps": maps, "packed": packed, "entries": entries,
            "bits": bits}


def _words(kind: str, S: int, B: int, T: int, seed: int) -> np.ndarray:
    """int64 [B, T, S / 64] decision words of ``kind``."""
    rng = np.random.default_rng(seed)
    W = S // 64
    if kind == "random":
        return rng.integers(-2**63, 2**63 - 1, (B, T, W), dtype=np.int64)
    if kind in ("zero", "ones", "rotation"):
        fill = {"zero": 0, "ones": -1, "rotation": ROTATION}[kind]
        return np.full((B, T, W), fill, np.int64)
    # the plain ACS over B windows of a noisy stream of an order
    # log2(S) + 1 code (libcorrect's K = 8 / 9 polynomials where named)
    order = S.bit_length()
    polys = {8: tfec.CONV_R12_8, 9: tfec.CONV_R12_9}.get(order) or tuple(
        int(p) | (1 << (order - 1)) | 1
        for p in rng.integers(0, 1 << order, 2))
    code = tfec.ConvCode(2, order, polys, device="cpu")
    total = B * T + 7
    msg = rng.integers(0, 2, total + order - 1)
    reg = sum(msg[order - 1 - j:order - 1 - j + total] << j
              for j in range(order))
    soft = 255.0 * code.reg_outputs[reg] + rng.normal(0, 60, (total, 2))
    soft = np.clip(np.round(soft), 0, 255).astype(np.uint8)
    starts = torch.arange(B, dtype=torch.int32) * T
    return FK.viterbi_acs_batched(torch.from_numpy(soft), starts, T,
                                  code._expected).numpy()


def _plain(words: np.ndarray, S: int) -> np.ndarray:
    return FK.viterbi_traceback_batched_plain(torch.from_numpy(words),
                                              S).numpy()


def test_segment_length_mirrors_the_kernel():
    """wide_segment_steps is csrc/viterbi.cu's tb_segment_steps:
    2^(floor(log2 T) / 2) within [2^kTbMinLog, 2^kTbMaxLog]."""
    src = VITERBI_CU.read_text()
    lo = int(re.search(r"kTbMinLog = (\d+);", src).group(1))
    hi = int(re.search(r"kTbMaxLog = (\d+);", src).group(1))
    assert "1 << (e < kTbMinLog ? kTbMinLog : e > kTbMaxLog ? kTbMaxLog : e)" \
        in src
    for T in (1, 2, 31, 4095, 4096, 4288, 16383, 16384, 2097162, 2**31 - 1):
        e = (T.bit_length() - 1) // 2
        assert FK.wide_segment_steps(T) == 1 << min(max(e, lo), hi)
    assert FK.wide_segment_steps(4288) == 64
    assert FK.wide_segment_steps(2097162) == 1024
    assert FK.wide_segment_steps(100) % 32 == 0   # blocks stay in a segment


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", STATES)
def test_segment_model_matches_plain_walk(S, B, kind):
    L = FK.wide_segment_steps(101)
    assert L == 32
    for T in (1, L - 1, L, L + 1, 3 * L + 5):
        assert FK.wide_segment_steps(T) == L
        words = _words(kind, S, B, T, seed=S + 10 * B + T)
        got = segment_model(words, S)
        np.testing.assert_array_equal(got["bits"], _plain(words, S),
                                      err_msg=f"S={S} B={B} T={T} {kind}")


@pytest.mark.parametrize("kind", ["acs", "rotation", "random"])
@pytest.mark.parametrize("S", [128, 256])
def test_segment_model_ragged_at_l64(S, kind):
    """64L + 5 steps at L = 64: 65 segments, the top one 5 steps."""
    T = 4101
    assert FK.wide_segment_steps(T) == 64
    words = _words(kind, S, 2, T, seed=7)
    got = segment_model(words, S)
    assert got["maps"].shape == (2, 65, S)
    np.testing.assert_array_equal(got["bits"], _plain(words, S))


def test_rotation_words_never_merge():
    """Under the rotation words every segment's map is a permutation (no
    two end states' walks meet), so the walk must run from every state."""
    S, T = 256, 101
    words = _words("rotation", S, 1, T, seed=0)
    got = segment_model(words, S)
    for m in got["maps"][0]:
        assert len(np.unique(m)) == S
    n = np.arange(S)
    steps = T - 3 * 32   # the top segment's 5 steps: rotated right by 5
    assert np.array_equal(got["maps"][0, -1],
                          ((n >> steps) | (n << (8 - steps))) & (S - 1))
    np.testing.assert_array_equal(got["bits"], _plain(words, S))


def test_chain_entries_are_the_plain_walks_states():
    """entry[j], the chain's state at segment j's top step, is the state
    the plain walk holds there (its bit is the top step's bit)."""
    S, B, T = 256, 3, 101
    words = _words("acs", S, B, T, seed=3)
    got = segment_model(words, S)
    L = got["L"]
    d = torch.from_numpy(words)
    s = torch.zeros(B, dtype=torch.int64)
    states = np.zeros((B, T), np.int64)
    for t in range(T - 1, -1, -1):
        states[:, t] = s.numpy()
        word = d[torch.arange(B), t, s >> 6]
        s = (s >> 1) + ((word >> (s & 63)) & 1) * (S // 2)
    for j in range(got["entries"].shape[1]):
        top = min((j + 1) * L, T) - 1
        np.testing.assert_array_equal(got["entries"][:, j], states[:, top])


@pytest.mark.parametrize("kind,B,T", [("random", 3, 101), ("acs", 1, 33),
                                      ("rotation", 3, 4101)])
def test_segment_model_matches_pallas_walk_at_128_states(kind, B, T):
    S = 128
    words = _words(kind, S, B, T, seed=11)
    dec = FK.unpack_decisions(torch.from_numpy(words), S).numpy()
    want = np.asarray(fec_pallas.viterbi_traceback_pallas_batched(
        jnp.asarray(dec), S, interpret=True))
    got = segment_model(words, S)["bits"]
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(_plain(words, S), want.astype(np.uint8))
