"""The batched Viterbi kernels: add-compare-select and traceback.

The counterpart of ``sdrpp_tpu.ops.fec_pallas``, for every state count S
= 2, 4, ..., 16384 (orders 2 to 15) and every rate R = 2 ... 32: S is
``expected``'s rows / 2 for the ACS and ``num_states`` for the traceback.
Decisions are packed: bit n & 63 of int64 word n >> 6 of a trellis step
is the decision of state n (1 = it took the predecessor (n >> 1) + S /
2). S <= 64 is one word a step, [B, T], with the bits >= S zero; S > 64
is [B, T, S / 64]. ``unpack_decisions`` gives the JAX kernels' [..., S]
int8 form and ``pack_decisions`` the reverse. Two entry points:

- ``viterbi_acs_batched``       a [total, R] soft-bit stream (uint8 or
                                float32), int32 window starts [B], a
                                window length T and the [2S, R] expected
                                outputs -> [B, T] or [B, T, S / 64] int64
                                words (replaces
                                ``viterbi_acs_pallas_batched``,
                                fec_pallas.py:51, which takes the gathered
                                [B, T, R] windows, and with B = 1, start 0
                                and T = total ``viterbi_acs_pallas``,
                                fec_pallas.py:221);
- ``viterbi_traceback_batched`` the words of S states -> [B, T] uint8
                                bits, walking back from state 0 (replaces
                                ``viterbi_traceback_pallas_batched``,
                                fec_pallas.py:132).

On a CUDA tensor each launches ``csrc/viterbi.cu`` through a compiled
host path, ``viterbi_acs`` / ``viterbi_traceback`` of
``csrc/kernels_host.cpp``, which checks the arguments, allocates the
output and launches in one C++ call (both built on first use; a failed
build raises), and adds one to its ``launches`` count, and to
``launches_general`` as well when the host path reports that the launch
took a general kernel (viterbi.cu's dispatch decides); on a CPU tensor each
runs its plain PyTorch version, a Python loop over trellis steps on [B,
S] tensors that takes the same arguments and returns the same words and
bits. Any other device raises. On CUDA, ``cycles`` (an int64 [B] tensor,
or None) receives each window's clock64 cycles (for the traceback at S >
64, those of its segment chain).

S <= 64 at R <= 4 (Meteor LRPT's and KG-STV's 64 states, M17's 16) runs
the warp-per-window kernels: two states a lane for S = 64, one state a
lane for S <= 32 (the lanes above S a copy). S > 64, and any S at R > 4,
runs the general kernels: a CTA of min(S, 1024) threads a window (a warp
a window for S <= 32 at R > 4; on uint8 soft bits at S <= 1024 and R <=
16 two trellis steps a barrier, csrc/viterbi.cu ``acs_r4_kernel``), and
the traceback walks segments of ``wide_segment_steps(T)`` steps in
parallel from every end state, then chains the segments' maps from state
0 (three launches, the host path allocating their scratch). On uint8
soft bits with integral expected outputs (at R <= 4, or R <= 16 in the
CTA kernel) the ACS runs the reference form (the
minimum subtracted every step) for a window's first K - 1 steps, while
states at the initial 1e9 remain; from then on every metric is an
integer within (K - 1) * R * 255 of the minimum and the kernel subtracts
the minimum only every 4096 steps, which keeps every metric below (4096
+ K - 1) * R * 255 < 2^24, where float32 adds of integers are exact: the
decisions equal the reference's bit for bit. Float32 soft bits run the
reference form every step.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

__all__ = ["viterbi_acs_batched", "viterbi_traceback_batched",
           "viterbi_acs_batched_plain", "viterbi_traceback_batched_plain",
           "pack_decisions", "unpack_decisions", "wide_segment_steps"]

KERNEL_MIN_RATE = 2
KERNEL_MAX_RATE = 32
KERNEL_MAX_STATES = 16384   # order 15


def _states_ok(num_states) -> bool:
    S = int(num_states)
    return 2 <= S <= KERNEL_MAX_STATES and S & (S - 1) == 0


def _check_states(num_states):
    if not _states_ok(num_states):
        raise ValueError(f"the Viterbi kernels take S = 2, 4, ..., "
                         f"{KERNEL_MAX_STATES} states, got {num_states}")


def wide_segment_steps(T: int) -> int:
    """The segment length of the traceback's walk at S > 64 for windows of
    ``T`` steps: 2^(floor(log2 T) / 2), clamped to [32, 4096] (csrc/
    viterbi.cu ``tb_segment_steps``)."""
    return 1 << min(max((int(T).bit_length() - 1) // 2, 5), 12)


def _words_shape(lead, num_states):
    return (*lead, num_states // 64) if num_states > 64 else tuple(lead)


def _bit_weights(num_states, device) -> torch.Tensor:
    """[min(S, 64)] int64: 1 << n (bit 63 as int64's sign bit)."""
    n = torch.arange(min(num_states, 64), device=device)
    return torch.ones(n.shape[0], dtype=torch.int64, device=device) << n


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """[..., S] decisions (nonzero = took (n >> 1) + S / 2), S a power of
    two in [2, 16384] -> [...] int64 words (S <= 64) or [..., S / 64],
    bit n & 63 of word n >> 6 the decision of state n."""
    S = dec.shape[-1]
    if not _states_ok(S):
        raise ValueError(f"decisions must be [..., S] for S = 2, 4, ..., "
                         f"{KERNEL_MAX_STATES}")
    bits = (dec != 0).long()
    if S > 64:
        bits = bits.reshape(*dec.shape[:-1], S // 64, 64)
    return (bits * _bit_weights(S, dec.device)).sum(-1)


def unpack_decisions(words: torch.Tensor, num_states: int = 64
                     ) -> torch.Tensor:
    """Words of ``num_states`` states ([...] for S <= 64, [..., S / 64]
    above) -> [..., S] int8 decisions."""
    _check_states(num_states)
    S = num_states
    n = torch.arange(min(S, 64), device=words.device)
    if S <= 64:
        return ((words[..., None] >> n) & 1).to(torch.int8)
    out = (words[..., None] >> n) & 1
    return out.reshape(*words.shape[:-1], S).to(torch.int8)


def _check_acs(soft, starts, T, expected):
    """Validates the ACS arguments; returns (total, R, T). On CUDA tensors
    the compiled host path (csrc/kernels_host.cpp) makes the same checks."""
    if soft.dtype not in (torch.uint8, torch.float32) or soft.dim() != 2:
        raise ValueError("soft must be uint8 or float32 [total, R]")
    total, R = soft.shape
    if not KERNEL_MIN_RATE <= R <= KERNEL_MAX_RATE:
        raise ValueError(f"soft takes {KERNEL_MIN_RATE} to {KERNEL_MAX_RATE} "
                         f"soft bits a step, got {R}")
    if (expected.dtype != torch.float32 or expected.dim() != 2
            or expected.shape[0] % 2 or not _states_ok(expected.shape[0] // 2)
            or expected.shape[1] != R):
        raise ValueError(f"expected must be float32 [2S, {R}] for S = 2, 4, "
                         f"..., {KERNEL_MAX_STATES} states")
    if starts.dtype != torch.int32 or starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError("starts must be a non-empty int32 vector")
    if expected.device != soft.device or starts.device != soft.device:
        raise ValueError("the Viterbi ACS takes tensors on one device")
    T = int(T)
    if not 1 <= T <= total:
        raise ValueError(f"window length {T} outside [1, {total}]")
    return total, R, T


def _check_traceback(dec, num_states=64):
    _check_states(num_states)
    S = int(num_states)
    if (dec.dtype != torch.int64 or dec.dim() != (3 if S > 64 else 2)
            or dec.shape[0] < 1 or dec.shape[1] < 1
            or (S > 64 and dec.shape[2] != S // 64)):
        form = f"[B, T, {S // 64}]" if S > 64 else "[B, T]"
        raise ValueError(f"dec must be int64 {form} decision words, B and T "
                         f">= 1")


def viterbi_acs_batched_plain(soft, starts, T, expected):
    """Plain PyTorch version of ``viterbi_acs_batched``: the reference form
    (the minimum metric subtracted every step)."""
    total, R, T = _check_acs(soft, starts, T, expected)
    dev = soft.device
    st = starts.long().clamp(0, total - T)
    windows = soft[st[:, None] + torch.arange(T, device=dev)].float()
    B, S = windows.shape[0], expected.shape[0] // 2
    n = torch.arange(S, device=dev)
    p0, p1 = n >> 1, (n >> 1) + S // 2
    m = torch.full((B, S), 1e9, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    words = torch.empty(_words_shape((B, T), S), dtype=torch.int64,
                        device=dev)
    for t in range(T):
        s = windows[:, t, None, :]  # [B, 1, R]
        bm = (s[..., 0] - expected[:, 0]).abs()  # [B, 2S], summed in j order
        for j in range(1, R):
            bm = bm + (s[..., j] - expected[:, j]).abs()
        cand0 = m[:, p0] + bm[:, :S]
        cand1 = m[:, p1] + bm[:, S:]
        take1 = cand1 < cand0
        new = torch.where(take1, cand1, cand0)
        m = new - new.min(dim=1, keepdim=True).values
        words[:, t] = pack_decisions(take1)
    return words


_host = None


def _bind_host():
    """(kernels_host.viterbi_acs, kernels_host.viterbi_traceback)
    (csrc/kernels_host.cpp), bound to the kernel library's C entries (the
    two kernels' and the traceback's scratch size); both built and loaded
    on first use."""
    global _host
    lib = cuda_lib.load("viterbi")
    mod = cuda_lib.load_host("kernels_host")
    mod.bind_viterbi(*(ctypes.cast(getattr(lib, e), ctypes.c_void_p).value
                       for e in ("viterbi_acs", "viterbi_traceback",
                                 "viterbi_traceback_scratch")))
    _host = (mod.viterbi_acs, mod.viterbi_traceback)
    return _host


def viterbi_acs_batched(soft, starts, T, expected, cycles=None):
    """Add-compare-select over B windows of ``T`` steps of the soft-bit
    stream ``soft`` [total, R] (uint8 or float32; 0 = strong 0, 255 =
    strong 1), window b starting at step ``starts[b]`` (int32, clamped to
    [0, total - T]). ``expected`` [2S, R] float32 holds each shift
    register's output bits times 255, S a power of two in [2, 16384].
    Returns [B, T] (S <= 64) or [B, T, S / 64] int64 decision words.
    Metrics start at 0 for state 0 and 1e9 elsewhere. On uint8 soft bits
    with ``expected`` integral in [0, 255] the kernels drop the per-step
    minimum after a window's first K - 1 steps (exactly: csrc/viterbi.cu)."""
    if soft.is_cuda:
        words, general = (_host or _bind_host())[0](soft, starts, T,
                                                     expected, cycles)
        viterbi_acs_batched.launches += 1
        viterbi_acs_batched.launches_general += general
        return words
    _check_acs(soft, starts, T, expected)
    if soft.is_cpu:
        return viterbi_acs_batched_plain(soft, starts, T, expected)
    raise RuntimeError(f"viterbi_acs_batched runs on CUDA or CPU tensors, "
                       f"not {soft.device}")


viterbi_acs_batched.launches = 0
viterbi_acs_batched.launches_general = 0


def viterbi_traceback_batched_plain(dec, num_states=64):
    """Plain PyTorch version of ``viterbi_traceback_batched``."""
    _check_traceback(dec, num_states)
    B, T = dec.shape[:2]
    s = torch.zeros(B, dtype=torch.int64, device=dec.device)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dec.device)
    rows = torch.arange(B, device=dec.device)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (s & 1).to(torch.uint8)
        word = dec[rows, t, s >> 6] if num_states > 64 else dec[:, t]
        s = (s >> 1) + ((word >> (s & 63)) & 1) * (num_states // 2)
    return bits


def viterbi_traceback_batched(dec, cycles=None, num_states=64):
    """Survivor walk of B windows from state 0 at the last step: ``dec``
    the int64 decision words of ``num_states`` states ([B, T] for S <= 64,
    [B, T, S / 64] above) -> [B, T] uint8, the low bit of each step's
    state."""
    if dec.is_cuda:
        bits, general = (_host or _bind_host())[1](dec, cycles, num_states)
        viterbi_traceback_batched.launches += 1
        viterbi_traceback_batched.launches_general += general
        return bits
    _check_traceback(dec, num_states)
    if dec.is_cpu:
        return viterbi_traceback_batched_plain(dec, num_states)
    raise RuntimeError(f"viterbi_traceback_batched runs on CUDA or CPU "
                       f"tensors, not {dec.device}")


viterbi_traceback_batched.launches = 0
viterbi_traceback_batched.launches_general = 0
