// Mueller-Mueller clock recovery over C independent streams (mm_symbols),
// the chunk-parallel M&M (mm_chunked) and the FD synchronizer (fd_symbols),
// for Hopper. The chunked and FD kernels are described where they start,
// below the walker's launch.
//
// mm_symbols:
//
// Replaces the Pallas kernel of the JAX package
//   sdrpp_tpu/ops/clock_recovery_pallas.py:35 _mm_chunk_call
//   (pallas_call :130), the scalar M&M loop with a data-dependent stride.
// The contract is the JAX base class MMClockRecovery
// (sdrpp_tpu/ops/clock_recovery.py:79-159): per symbol, an 8-tap dot of
// the input window at the integer offset with the interpolation bank row
// floor(phase * 128), the (complex or float) M&M timing error clipped to
// +-1, the phase-control-loop advance (CLAMP_PHASE = false) and
// offset += floor(phase). The TPU's 4096-sample SMEM chunking and its
// argsort compaction were TPU memory limits and are gone: one launch runs
// the whole block, and the symbols form a prefix of the output whose
// length the kernel writes as a count.
//
// What bounds it on an H100: each symbol depends on the previous one
// through the offset (which sets the next window) and the phase (which
// picks the bank row), so a stream is one dependent chain, about 31,500
// symbols per meteor block. Latency, not bytes or flops: the chain's
// instructions times their latencies, per symbol.
//
// Design: one CTA of three warps per stream, warp-specialised.
// - Warp 1 streams the row [tail | block] through a ring of kStages
//   shared-memory stages of kStage samples (plus a kT-sample halo, so a
//   window never straddles two stages) with cp.async, and hands each stage
//   to the walker through an mbarrier pair (full / empty).
// - Lane 0 of warp 0 walks the symbols, reading its window and its bank
//   row (8 taps and 128 phases, fixed at compile time) from shared memory
//   only, with the loop state in registers. Its chain is shortened without
//   changing one rounding:
//   * the next offset step and bank row come from one round-down add,
//     np + 1.5 * 2^16, whose low mantissa bits are floor(np * 128): its
//     bits >> 7 and & 127 are floor(np) and floor(frac(np) * 128) for
//     |np| < 2^15 (any other np takes the reference's steps);
//   * the next window and bank row are loaded before the loop's exit and
//     stage checks resolve (at a masked, always valid address), so no
//     branch sits on the chain; the rare check that fails reloads;
//   * tap 0's 0 + x * w is one fma(x, w, 0): it rounds once, like the
//     product, and turns -0 into +0, like the sum;
//   * the error's decision term (c0 - c2) * conj(p1) is computed for all
//     four sign pairs of c0 from the previous symbols, off the chain, and
//     picked by the new signs;
//   * clip(freq + gain * clip(err, -1, 1), lo, hi) is computed as one
//     clip of freq + gain * err to bounds taken from freq +- gain off the
//     chain (both are monotone in err, so for finite err the results are
//     identical).
// - The walker stores each symbol into a shared-memory ring of kOutStage;
//   warp 2 writes each filled stage out coalesced, then zero-fills the
//   output past the count. The walker stores nothing to global memory per
//   symbol.
// A window outside the ring (a negative offset, or a step back across a
// stage, which no caller's gains produce) is read from global memory with
// the reference's clamp; results are the same.
//
// On the H100 the shared-memory window and the fixed taps and phases cut
// the walker's clock64 cycles per symbol by more than half against a
// walker that reads its window from global memory, and the cuts above
// take it lower (chip_smoke.py prints the count). Orderings that looked
// shorter on paper measured longer (the hand-off branch after the next
// loads, a biased stage offset, two symbols per trip) and are not used.
//
// Numerics: built with --fmad=false and no fast math, so every product
// and sum rounds once, in the order of the plain PyTorch version
// (ops/clock_recovery_kernels.mm_symbols_plain): taps summed from 0 to 7
// starting at 0.0f.
//
// C ABI (bound by csrc/kernels_host.cpp): each entry returns
// cudaGetLastError() after the launch. `offset` [C] int32 and `fstate`
// [C, KF] float32 hold the carried state; `offset_out` and `fstate_out`
// receive the next block's (offset relative to the next block). KF = 10
// for complex streams (phase, freq, p1, p2, c1, c2 as re/im pairs), 3 for
// float streams (phase, freq, last). `count` [C] int32 receives each stream's symbol
// count; `cycles` [C] int64, when not null, the walker's clock64() cycles
// over its walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 8;            // interpolation taps
constexpr int kP = 128;          // interpolation phases
constexpr int kStage = 2048;     // input samples per ring stage (power of 2)
constexpr int kSlot = kStage + kT;
constexpr int kStages = 3;
constexpr int kOutStage = 1024;  // symbols per output stage
constexpr int kOutStages = 2;
constexpr int kThreads = 96;     // walker, loader and writer warps
// np + kMagic rounded down has the mantissa step 1/128 for |np| < 2^15
constexpr float kMagic = 98304.0f;           // 1.5 * 2^16, bits 0x47C00000
constexpr int kMagicHi = 0x47C00000 >> 7;    // its low 7 bits are 0
constexpr float kMagicRange = 32768.0f;

template <bool CPLX>
struct Sample;
template <>
struct Sample<true> {
  using T = float2;
};
template <>
struct Sample<false> {
  using T = float;
};

__device__ __forceinline__ float step_sign(float v) {
  return v > 0.0f ? 1.0f : -1.0f;
}

// keeps a value in a register, opaque to the optimizer, so a select
// between precomputed values is not rewritten into arithmetic on the chain
__device__ __forceinline__ float opaque(float v) {
  asm("" : "+f"(v));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

template <bool CPLX>
struct Shared {
  using T = typename Sample<CPLX>::T;
  T ring[kStages][kSlot];
  T out[kOutStages][kOutStage];
  alignas(16) float bank[kP * kT];
  uint64_t in_full[kStages], in_empty[kStages];
  uint64_t out_full[kOutStages], out_empty[kOutStages];
  int out_count[kOutStages], out_last[kOutStages];
};

template <bool CPLX>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const typename Sample<CPLX>::T* __restrict__ x, int n,
          const float* __restrict__ bank, const int* __restrict__ offs_in,
          const float* __restrict__ fst_in, int* __restrict__ offs_out,
          float* __restrict__ fst_out, typename Sample<CPLX>::T* __restrict__ out,
          int* __restrict__ count, int max_syms, float mu, float omega_gain,
          float min_freq, float max_freq, long long* __restrict__ cycles) {
  using T = typename Sample<CPLX>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<CPLX>& sh = *reinterpret_cast<Shared<CPLX>*>(smem_raw);
  const int c = blockIdx.x;
  const int len = n + kT - 1;
  const T* row = x + static_cast<size_t>(c) * len;
  const int nst = (n - 1) / kStage + 1;  // stages a walk can reach

  for (int i = threadIdx.x; i < kP * kT; i += kThreads) sh.bank[i] = bank[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sh.in_full[s], 32);
      mbar_init(&sh.in_empty[s], 1);
    }
    for (int s = 0; s < kOutStages; ++s) {
      mbar_init(&sh.out_full[s], 1);
      mbar_init(&sh.out_empty[s], 32);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 1) {  // loader: stage g holds row[g * kStage, + kSlot)
    for (int g = 0; g < nst; ++g) {
      const int slot = g % kStages;
      if (g >= kStages) mbar_wait(&sh.in_empty[slot], ((g / kStages) - 1) & 1);
      T* dst = sh.ring[slot];
      const int p0 = g * kStage;
      for (int i = lane; i < kSlot; i += 32) {
        if (p0 + i < len)
          cp_async<sizeof(T)>(dst + i, row + p0 + i);
        else
          dst[i] = T{};
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      mbar_arrive(&sh.in_full[slot]);
    }
    return;
  }

  if (warp == 2) {  // writer: each filled output stage, then the zeros
    T* orow = out + static_cast<size_t>(c) * max_syms;
    int done = 0;
    for (int o = 0;; ++o) {
      const int slot = o % kOutStages;
      mbar_wait(&sh.out_full[slot], (o / kOutStages) & 1);
      const int cnt = sh.out_count[slot];
      const int last = sh.out_last[slot];
      for (int i = lane; i < cnt; i += 32) orow[done + i] = sh.out[slot][i];
      done += cnt;
      mbar_arrive(&sh.out_empty[slot]);
      if (last) break;
    }
    for (int i = done + lane; i < max_syms; i += 32) orow[i] = T{};
    return;
  }

  if (lane != 0) return;
  // ---- the walker ----
  constexpr int KF = CPLX ? 10 : 3;
  float st[KF];
#pragma unroll
  for (int j = 0; j < KF; ++j) st[j] = fst_in[c * KF + j];
  float phase = st[0], freq = st[1];
  // complex error history: p1 = out[-1], p2 = out[-2], c1, c2 its signs
  float p1r = st[2], p1i = CPLX ? st[3] : 0.0f;
  float p2r = CPLX ? st[4] : 0.0f, p2i = CPLX ? st[5] : 0.0f;
  float c1r = CPLX ? st[6] : 0.0f, c1i = CPLX ? st[7] : 0.0f;
  float c2r = CPLX ? st[8] : 0.0f, c2i = CPLX ? st[9] : 0.0f;
  int offset = offs_in[c];

  // rel = offset - sbase, the offset in the stage
  int g = 0, sbase = 0, rel = 0, lim = n, ph = 0;
  mbar_wait(&sh.in_full[0], 0);
  const T* slot_ptr = sh.ring[0];
  T win[kT];
  float taps[kT];
  auto fetch_taps = [&](int p) {
    const float4* b = reinterpret_cast<const float4*>(sh.bank + p * kT);
    const float4 b0 = b[0], b1 = b[1];
    taps[0] = b0.x; taps[1] = b0.y; taps[2] = b0.z; taps[3] = b0.w;
    taps[4] = b1.x; taps[5] = b1.y; taps[6] = b1.z; taps[7] = b1.w;
  };
  auto fetch_ring = [&](int r, int p) {  // r masked: always a valid address
    const T* w = slot_ptr + (r & (kStage - 1));
#pragma unroll
    for (int j = 0; j < kT; ++j) win[j] = w[j];
    fetch_taps(p);
  };
  // the window at `offset` (< n) and the row of phase: advance the ring to
  // the offset's stage, or read behind it from global memory
  auto position = [&]() {
    ph = min(max(static_cast<int>(floorf(phase * static_cast<float>(kP))), 0),
             kP - 1);
    while (offset >= sbase + kStage) {
      mbar_arrive(&sh.in_empty[g % kStages]);
      ++g;
      sbase += kStage;
      mbar_wait(&sh.in_full[g % kStages], (g / kStages) & 1);
    }
    slot_ptr = sh.ring[g % kStages];
    rel = offset - sbase;
    lim = n - sbase;
    if (rel >= 0) {
      fetch_ring(rel, ph);
    } else {
      const int base = min(max(offset, 0), n - 1);
#pragma unroll
      for (int j = 0; j < kT; ++j) win[j] = row[base + j];
      fetch_taps(ph);
    }
  };

  // the decision-term candidates and the freq bounds of the next symbol
  float dpp = 0.0f, dpm = 0.0f, dmp = 0.0f, dmm = 0.0f;
  float last_p = 0.0f, last_m = 0.0f, last_s = 0.0f;
  float f_lo = 0.0f, f_hi = 0.0f;
  auto prepare = [&]() {
    if constexpr (CPLX) {
      const float dpr = (1.0f - c2r) * p1r, dmr = (-1.0f - c2r) * p1r;
      const float dpi = (1.0f - c2i) * p1i, dmi = (-1.0f - c2i) * p1i;
      dpp = opaque(dpr + dpi);
      dpm = opaque(dpr + dmi);
      dmp = opaque(dmr + dpi);
      dmm = opaque(dmr + dmi);
    } else {
      last_p = opaque(p1r * 1.0f);
      last_m = opaque(p1r * -1.0f);
      last_s = step_sign(p1r);
    }
    const float a = freq + omega_gain, b = freq - omega_gain;
    f_lo = opaque(fminf(fmaxf(fminf(a, b), min_freq), max_freq));
    f_hi = opaque(fminf(fmaxf(fmaxf(a, b), min_freq), max_freq));
  };

  int o = 0, ko = 0;
  T* optr = sh.out[0];
  const long long t0 = cycles ? clock64() : 0;
  int k = 0;
  bool live = max_syms > 0 && offset < n;
  if (live) {
    position();
    prepare();
  }
  while (live) {
    float err;
    T sym;
    if constexpr (CPLX) {
      // fma(x, w, 0) rounds once, like 0 + x * w (and gives +0 for -0)
      float accr = __fmaf_rn(win[0].x, taps[0], 0.0f);
      float acci = __fmaf_rn(win[0].y, taps[0], 0.0f);
#pragma unroll
      for (int j = 1; j < kT; ++j) {
        accr = accr + win[j].x * taps[j];
        acci = acci + win[j].y * taps[j];
      }
      // ((out - p2) * conj(c1) - (c0 - c2) * conj(p1)).real
      const float d = accr > 0.0f ? (acci > 0.0f ? dpp : dpm)
                                  : (acci > 0.0f ? dmp : dmm);
      err = ((accr - p2r) * c1r + (acci - p2i) * c1i) - d;
      // shift the error history: p2 = p1, p1 = out, c2 = c1, c1 = c0
      p2r = p1r;
      p2i = p1i;
      p1r = accr;
      p1i = acci;
      c2r = c1r;
      c2i = c1i;
      c1r = step_sign(accr);
      c1i = step_sign(acci);
      sym = make_float2(accr, acci);
    } else {
      float acc = __fmaf_rn(win[0], taps[0], 0.0f);
#pragma unroll
      for (int j = 1; j < kT; ++j) acc = acc + win[j] * taps[j];
      err = last_s * acc - (acc > 0.0f ? last_p : last_m);
      p1r = acc;
      sym = acc;
    }
    const float errc = fminf(fmaxf(err, -1.0f), 1.0f);
    freq = fminf(fmaxf(freq + omega_gain * err, f_lo), f_hi);
    const float np = (phase + freq) + mu * errc;
    ++k;
    *optr++ = sym;
    if (++ko == kOutStage) {  // hand the stage to the writer
      const int slot = o % kOutStages;
      sh.out_count[slot] = ko;
      sh.out_last[slot] = 0;
      mbar_arrive(&sh.out_full[slot]);
      ++o;
      ko = 0;
      if (o >= kOutStages)
        mbar_wait(&sh.out_empty[o % kOutStages], ((o / kOutStages) - 1) & 1);
      optr = sh.out[o % kOutStages];
    }
    // the next window and row, loaded before the checks resolve
    const int bits = __float_as_int(__fadd_rd(np, kMagic));
    const int ph_n = bits & (kP - 1);
    const int rel_n = rel + ((bits >> 7) - kMagicHi);
    fetch_ring(rel_n, ph_n);
    const float delta = floorf(np);
    phase = np - delta;
    prepare();
    if (fabsf(np) < kMagicRange && static_cast<unsigned>(rel_n) < kStage &&
        rel_n < lim && k < max_syms) {
      rel = rel_n;
      ph = ph_n;
      continue;
    }
    offset = sbase + rel + static_cast<int>(delta);
    if (k >= max_syms || offset >= n) break;
    position();
  }
  if (cycles) cycles[c] = clock64() - t0;
  const int slot = o % kOutStages;
  sh.out_count[slot] = ko;
  sh.out_last[slot] = 1;
  mbar_arrive(&sh.out_full[slot]);
  // release the stages the loader still has to fill, so it can finish
  mbar_arrive(&sh.in_empty[g % kStages]);
  for (int gg = g + 1; gg < nst; ++gg) {
    mbar_wait(&sh.in_full[gg % kStages], (gg / kStages) & 1);
    mbar_arrive(&sh.in_empty[gg % kStages]);
  }
  st[0] = phase;
  st[1] = freq;
  st[2] = p1r;
  if constexpr (CPLX) {
    st[3] = p1i;
    st[4] = p2r;
    st[5] = p2i;
    st[6] = c1r;
    st[7] = c1i;
    st[8] = c2r;
    st[9] = c2i;
  }
  offs_out[c] = offset - n;
  count[c] = k;
#pragma unroll
  for (int j = 0; j < KF; ++j) fst_out[c * KF + j] = st[j];
}

template <bool CPLX>
int launch(const void* x, int n, int C, const float* bank, const int* offs_in,
           const float* fst_in, int* offs_out, float* fst_out, void* out,
           int* count, int max_syms, float mu, float omega_gain,
           float min_freq, float max_freq, long long* cycles,
           cudaStream_t stream) {
  using T = typename Sample<CPLX>::T;
  if (n < 1 || C < 1 || max_syms < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = sizeof(Shared<CPLX>);
  // the attribute is per device: set it once on each
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(mm_kernel<CPLX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr_set[dev] = true;
  }
  mm_kernel<CPLX><<<C, kThreads, smem, stream>>>(
      static_cast<const T*>(x), n, bank, offs_in, fst_in, offs_out, fst_out,
      static_cast<T*>(out), count, max_syms, mu, omega_gain, min_freq,
      max_freq, cycles);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// mm_chunked: the chunk-parallel M&M
// ---------------------------------------------------------------------------
//
// Replaces the JAX package's group step of
//   sdrpp_tpu/ops/clock_recovery_chunked.py:92 mm_symbols_chunked
// (XLA-lowered: a lax.scan over group steps, not a Pallas kernel). The
// glue around it (ops/clock_recovery_chunked.mm_symbols_chunked: lane
// layout, Oerder-Meyr seeding, emission bounds) runs in torch ops; this
// kernel runs every group step, the seam mask and the carry.
//
// What bounds it on an H100: the chain of group steps. A lane's step
// depends on the previous one through its offset, phase and period, and
// every lane's through the window anchor r0 and the ensemble mean, so a
// call is steps = msc / M dependent rounds of (anchor min, coarse pass,
// K-lane error sums, full pass, K-lane error sums). Bytes are small (the
// block once, the [K, msc] outputs once) and so are flops.
//
// Design: one CTA per call, one thread per lane (K <= 256, rounded up to
// whole warps; threads past K add zeros and the anchor's ceiling), the
// lane state in registers, the 128 x 8 bank in shared memory. A symbol
// reads its taps directly from the extended stream through the read-only
// path at its row r0 + gstat[m] + clip(rel - gstat[m], 0, J - 8): the
// TPU's shared [R, K] window, one-hot selections and bank matmul are
// gone. The M symbols of a group do not depend on each other inside a
// pass (positions come from the previous pass's closed form), so the
// unrolled M-symbol loops issue M independent windows of loads and
// arithmetic; that is the instruction-level parallelism the TPU's group
// form gives this card. The across-lane error sums are one xor-shuffle
// tree a warp (16, 8, 4, 2, 1) and the warps' sums in turn from shared
// memory, the order mm_symbols_chunked_plain copies; the anchor is a
// warp min and the warps' mins. Each thread writes its lane's row of
// symbols, positions and emit flags; after the last step it applies the
// seam mask to its row (its left neighbour's last emitted position from
// shared memory), and lane K-1 writes the carry.
//
// Numerics: --fmad=false; the products and sums round as the plain
// version's, and the four multiply-adds of the position and period
// closed forms are explicit __fmaf_rn (the plain version rounds them once
// too), the contraction XLA's CPU backend makes in the JAX package's
// step, so both packages land on the same positions.
//
// C ABI: `ext` the extended stream (complex64 or float32), lane j at
// j * L; `off0`, `ph0`, `fr0` [K] the lanes' seeds; `emit_lo` [K] float32,
// `emit_hi` [K] int32 the emission floor (a position) and ceiling (an
// offset); `goff` [K] lane position to block position. Outputs `syms`,
// `valid` (bool) and `pos` [K, steps * M], `off_f` (one int32) and `fst`
// [10 | 3] float32, lane K-1's carry.

constexpr int kChunkMaxLanes = 256;
constexpr int kChunkWarps = kChunkMaxLanes / 32;
constexpr int kChunkMaxGroup = 32;

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

__device__ __forceinline__ float sample_re(float2 v) { return v.x; }
__device__ __forceinline__ float sample_re(float v) { return v; }
__device__ __forceinline__ float sample_im(float2 v) { return v.y; }
__device__ __forceinline__ float sample_im(float) { return 0.0f; }

// the lane's rolling error history: the last two symbols and their signs
struct History {
  float y1r, y1i, y2r, y2i, k1r, k1i, k2r, k2i;
};

// the M&M error of symbol (outr, outi) after `h`, and `h` advanced past it
template <bool CPLX>
__device__ __forceinline__ float mm_error(History& h, float outr, float outi) {
  float err;
  if constexpr (CPLX) {
    const float c0r = step_sign(outr), c0i = step_sign(outi);
    err = ((outr - h.y2r) * h.k1r + (outi - h.y2i) * h.k1i) -
          ((c0r - h.k2r) * h.y1r + (c0i - h.k2i) * h.y1i);
    h.y2r = h.y1r;
    h.y2i = h.y1i;
    h.k2r = h.k1r;
    h.k2i = h.k1i;
    h.k1r = c0r;
    h.k1i = c0i;
  } else {
    err = step_sign(h.y1r) * outr - h.y1r * step_sign(outr);
  }
  h.y1r = outr;
  h.y1i = outi;
  return clip1(err);
}

// the CTA's sums of e[0..M) over lanes into sums[warp][m]; synchronises
template <int M>
__device__ __forceinline__ void lane_sums(const float (&e)[M],
                                          float (*sums)[kChunkMaxGroup],
                                          int warp, int lane) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float v = e[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sums[warp][m] = v;
  }
  __syncthreads();
}

// the ensemble mean of symbol m: the warps' sums in turn, over K
__device__ __forceinline__ float ensemble(const float (*sums)[kChunkMaxGroup],
                                          int nw, int m, float fK) {
  float s = sums[0][m];
  for (int w = 1; w < nw; ++w) s = s + sums[w][m];
  return s / fK;
}

template <bool CPLX, int M>
__global__ void __launch_bounds__(kChunkMaxLanes)
mm_chunked_kernel(const typename Sample<CPLX>::T* __restrict__ ext,
                  const float* __restrict__ bank, const int* __restrict__ off0,
                  const float* __restrict__ ph0, const float* __restrict__ fr0,
                  const float* __restrict__ emit_lo,
                  const int* __restrict__ emit_hi,
                  const float* __restrict__ goff, int K, int L, int cols,
                  int R, int J, int steps, int n, float mu, float og,
                  float fmin, float fmax, float half,
                  typename Sample<CPLX>::T* __restrict__ syms,
                  bool* __restrict__ valid, float* __restrict__ pos_out,
                  int* __restrict__ off_f, float* __restrict__ fst) {
  using T = typename Sample<CPLX>::T;
  __shared__ __align__(16) float s_bank[kP * kT];
  __shared__ int s_gstat[kChunkMaxGroup];
  __shared__ int s_min[kChunkWarps];
  __shared__ float s_sum[2][kChunkWarps][kChunkMaxGroup];
  __shared__ float s_last[kChunkMaxLanes];

  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const int nw = blockDim.x >> 5;
  const bool on = k < K;
  for (int i = k; i < kP * kT; i += blockDim.x) s_bank[i] = bank[i];
  // symbol m's static band start, in double as the glue computes it
  if (k < M)
    s_gstat[k] = min(static_cast<int>(floor(static_cast<double>(k) *
                                            static_cast<double>(fmin))),
                     R - J);
  __syncthreads();

  const int msc = steps * M;
  const float fK = static_cast<float>(K), fn = static_cast<float>(n);
  const bool lane0 = k == 0;
  constexpr int d = (kT - 1) / 2;  // the coarse pass's delay
  int offset = on ? off0[k] : 0;
  float phase = on ? ph0[k] : 0.0f, freq = on ? fr0[k] : 0.0f;
  const float elo = on ? emit_lo[k] : 0.0f, go = on ? goff[k] : 0.0f;
  const int ehi = on ? emit_hi[k] : 0;
  History carried{};  // p1 p2 c1 c2 (or last in y1r): zero
  float lastpos = -INFINITY;
  const T* xl = ext + static_cast<size_t>(on ? k : 0) * L;
  T* srow = syms + static_cast<size_t>(on ? k : 0) * msc;
  float* prow = pos_out + static_cast<size_t>(on ? k : 0) * msc;
  bool* vrow = valid + static_cast<size_t>(on ? k : 0) * msc;

  for (int s = 0; s < steps; ++s) {
    const float pos = static_cast<float>(offset) + phase;
    // window anchor: the min offset over lanes below their ceiling
    int a = (on && offset < ehi) ? min(max(offset, 0), cols - kT) : cols - kT;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) s_min[warp] = a;
    __syncthreads();
    int r0 = s_min[0];
    for (int w = 1; w < nw; ++w) r0 = min(r0, s_min[w]);
    r0 = min(max(r0, 0), cols - R);

    // predictor: coarse 2-tap pass at the open-loop positions
    float e[M];
    {
      History h = carried;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        e[m] = 0.0f;
        if (on) {
          const float Pm = __fmaf_rn(static_cast<float>(m), freq, pos);
          const float fl = floorf(Pm);
          const int g = s_gstat[m];
          const int rel2 = min(max(static_cast<int>(fl) - r0 - g, 0), J - kT);
          const float ph = Pm - fl;
          const T* w = xl + (r0 + g + rel2 + d);
          const T x0 = __ldg(w), x1 = __ldg(w + 1);
          const float w0 = 1.0f - ph;
          const float outr = w0 * sample_re(x0) + ph * sample_re(x1);
          const float outi =
              CPLX ? w0 * sample_im(x0) + ph * sample_im(x1) : 0.0f;
          e[m] = mm_error<CPLX>(h, outr, outi);
        }
      }
    }
    lane_sums<M>(e, s_sum[0], warp, lane);

    // the corrected positions: symbol 0 at pos, symbol m at the
    // predictor's closed form for m - 1
    float Pm2[M];
    Pm2[0] = pos;
    {
      float A = 0.0f, B = 0.0f, Ab = 0.0f, Bb = 0.0f;
#pragma unroll
      for (int m = 0; m + 1 < M; ++m) {
        const float eb = ensemble(s_sum[0], nw, m, fK);
        const float fm = static_cast<float>(m);
        A = m == 0 ? e[m] : A + e[m];
        B = m == 0 ? fm * e[m] : B + fm * e[m];
        Ab = m == 0 ? eb : Ab + eb;
        Bb = m == 0 ? fm * eb : Bb + fm * eb;
        const float m1 = static_cast<float>(m + 1);
        const float start = __fmaf_rn(m1, freq, pos);
        const float gain = lane0 ? m1 * A - B : m1 * Ab - Bb;
        Pm2[m + 1] = __fmaf_rn(mu, A, __fmaf_rn(og, gain, start));
      }
    }

    // corrector: the full 8-tap pass, the emissions and the carry
    int nv = 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
      nv += (on && static_cast<int>(floorf(Pm2[m])) < ehi) ? 1 : 0;
    float A = 0.0f, B = 0.0f, A_sel = 0.0f, B_sel = 0.0f;
    History h = carried, h_sel = carried;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      e[m] = 0.0f;
      if (on) {
        const float Pm = Pm2[m];
        const float fl = floorf(Pm);
        const int o = static_cast<int>(fl);
        const int g = s_gstat[m];
        const int rel = o - r0;
        const bool ok = rel >= 0 && rel <= R - kT && rel >= g &&
                        rel <= g + (J - kT);
        const int rel2 = min(max(rel - g, 0), J - kT);
        const float ph = Pm - fl;
        const int row =
            min(max(static_cast<int>(floorf(ph * static_cast<float>(kP))), 0),
                kP - 1);
        const float4* tp = reinterpret_cast<const float4*>(s_bank + row * kT);
        const float4 t0 = tp[0], t1 = tp[1];
        const float taps[kT] = {t0.x, t0.y, t0.z, t0.w,
                                t1.x, t1.y, t1.z, t1.w};
        const T* w = xl + (r0 + g + rel2);
        T win[kT];
#pragma unroll
        for (int j = 0; j < kT; ++j) win[j] = __ldg(w + j);
        float outr = taps[0] * sample_re(win[0]);
        float outi = CPLX ? taps[0] * sample_im(win[0]) : 0.0f;
#pragma unroll
        for (int j = 1; j < kT; ++j) {
          outr = outr + taps[j] * sample_re(win[j]);
          if constexpr (CPLX) outi = outi + taps[j] * sample_im(win[j]);
        }
        e[m] = mm_error<CPLX>(h, outr, outi);
        const float gp = go + Pm;
        const bool emit = ok && o < ehi && Pm >= elo && gp < fn;
        const int slot = s * M + m;
        if constexpr (CPLX)
          srow[slot] = emit ? make_float2(outr, outi) : make_float2(0.0f, 0.0f);
        else
          srow[slot] = emit ? outr : 0.0f;
        prow[slot] = emit ? gp : INFINITY;
        vrow[slot] = emit;
        if (emit) lastpos = fmaxf(lastpos, gp);
        const float fm = static_cast<float>(m);
        A = m == 0 ? e[m] : A + e[m];
        B = m == 0 ? fm * e[m] : B + fm * e[m];
        if (m == nv - 1) {
          A_sel = A;
          B_sel = B;
          h_sel = h;
        }
      }
    }
    lane_sums<M>(e, s_sum[1], warp, lane);

    if (on) {
      float new_pos = pos, new_freq = freq;
      if (nv > 0) {
        float Ab = 0.0f, Bb = 0.0f;
        for (int m = 0; m < nv; ++m) {
          const float eb = ensemble(s_sum[1], nw, m, fK);
          const float fm = static_cast<float>(m);
          Ab = m == 0 ? eb : Ab + eb;
          Bb = m == 0 ? fm * eb : Bb + fm * eb;
        }
        const float m1 = static_cast<float>(nv);
        const float start = __fmaf_rn(m1, freq, pos);
        const float gain = lane0 ? m1 * A_sel - B_sel : m1 * Ab - Bb;
        new_pos = __fmaf_rn(mu, A_sel, __fmaf_rn(og, gain, start));
        new_freq = fminf(fmaxf(__fmaf_rn(og, lane0 ? A_sel : Ab, freq), fmin),
                         fmax);
      }
      const float fl = floorf(new_pos);
      offset = static_cast<int>(fl);
      phase = new_pos - fl;
      freq = new_freq;
      carried = h_sel;
    }
  }

  // the seam mask: drop what the left neighbour already emitted
  s_last[k] = lastpos;
  __syncthreads();
  if (!on) return;
  const float thr = k == 0 ? -INFINITY : s_last[k - 1] + half;
  for (int i = 0; i < msc; ++i) vrow[i] = vrow[i] && prow[i] > thr;
  if (k == K - 1) {
    *off_f = static_cast<int>((static_cast<float>(offset) + go) - fn);
    fst[0] = phase;
    fst[1] = freq;
    fst[2] = carried.y1r;
    if constexpr (CPLX) {
      fst[3] = carried.y1i;
      fst[4] = carried.y2r;
      fst[5] = carried.y2i;
      fst[6] = carried.k1r;
      fst[7] = carried.k1i;
      fst[8] = carried.k2r;
      fst[9] = carried.k2i;
    }
  }
}

template <bool CPLX, int M>
int launch_chunked_m(const void* ext, const float* bank, const int* off0,
                     const float* ph0, const float* fr0, const float* emit_lo,
                     const int* emit_hi, const float* goff, int K, int L,
                     int cols, int R, int J, int steps, int n, float mu,
                     float og, float fmin, float fmax, float half, void* syms,
                     void* valid, float* pos, int* off_f, float* fst,
                     cudaStream_t stream) {
  using T = typename Sample<CPLX>::T;
  const int threads = (K + 31) / 32 * 32;
  mm_chunked_kernel<CPLX, M><<<1, threads, 0, stream>>>(
      static_cast<const T*>(ext), bank, off0, ph0, fr0, emit_lo, emit_hi,
      goff, K, L, cols, R, J, steps, n, mu, og, fmin, fmax, half,
      static_cast<T*>(syms), static_cast<bool*>(valid), pos, off_f, fst);
  return static_cast<int>(cudaGetLastError());
}

template <bool CPLX>
int launch_chunked(const void* ext, const float* bank, const int* off0,
                   const float* ph0, const float* fr0, const float* emit_lo,
                   const int* emit_hi, const float* goff, int K, int L,
                   int cols, int R, int J, int M, int steps, int n, float mu,
                   float og, float fmin, float fmax, float half, void* syms,
                   void* valid, float* pos, int* off_f, float* fst,
                   cudaStream_t stream) {
  if (K < 1 || K > kChunkMaxLanes || L < 1 || steps < 1 || n < 1 ||
      J < kT || R < J || cols < R)
    return static_cast<int>(cudaErrorInvalidValue);
#define MM_CHUNKED_CASE(MV)                                                  \
  case MV:                                                                   \
    return launch_chunked_m<CPLX, MV>(ext, bank, off0, ph0, fr0, emit_lo,    \
                                      emit_hi, goff, K, L, cols, R, J, steps, \
                                      n, mu, og, fmin, fmax, half, syms,     \
                                      valid, pos, off_f, fst, stream);
  switch (M) {
    MM_CHUNKED_CASE(8)
    MM_CHUNKED_CASE(16)
    MM_CHUNKED_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MM_CHUNKED_CASE
}

// ---------------------------------------------------------------------------
// fd_symbols: the FD (early-late) synchronizer
// ---------------------------------------------------------------------------
//
// Replaces the lax.scan of sdrpp_tpu/ops/clock_recovery.py:162
// FDClockRecovery (reference core/src/dsp/clock_recovery/fd.h:95-150):
// per symbol the interpolation at bank row floor(phase * 128) and at its
// two neighbours (one-sided at the bank's edges), the timing error
// dfdt * sign(out) clipped to +-1, the loop advance as the M&M's. One
// dependent chain per stream, like the M&M walker, and bounded the same
// way (latency). A simple form: one CTA per stream, lane 0 walks with the
// bank in shared memory and reads its window from global memory, then the
// CTA zero-fills the output past the count. Each of the three tap sums
// starts at 0.0f and runs in tap order, as fd_symbols_plain's.

__device__ __forceinline__ float fd_dot(const float (&w)[kT], const float* t) {
  float a = 0.0f + w[0] * t[0];
#pragma unroll
  for (int j = 1; j < kT; ++j) a = a + w[j] * t[j];
  return a;
}

__global__ void __launch_bounds__(32)
fd_kernel(const float* __restrict__ x, int n, const float* __restrict__ bank,
          const int* __restrict__ offs_in, const float* __restrict__ fst_in,
          int* __restrict__ offs_out, float* __restrict__ fst_out,
          float* __restrict__ out, int* __restrict__ count, int max_syms,
          float og, float mu, float min_freq, float max_freq) {
  __shared__ float s_bank[kP * kT];
  __shared__ int s_count;
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < kP * kT; i += 32) s_bank[i] = bank[i];
  __syncwarp();
  float* orow = out + static_cast<size_t>(c) * max_syms;
  if (threadIdx.x == 0) {
    const float* row = x + static_cast<size_t>(c) * (n + kT - 1);
    int offset = offs_in[c];
    float phase = fst_in[2 * c], freq = fst_in[2 * c + 1];
    int k = 0;
    while (k < max_syms && offset < n) {
      const int ph =
          min(max(static_cast<int>(floorf(phase * static_cast<float>(kP))), 0),
              kP - 1);
      const int base = min(max(offset, 0), n - 1);
      float w[kT];
#pragma unroll
      for (int j = 0; j < kT; ++j) w[j] = row[base + j];
      const float o = fd_dot(w, s_bank + ph * kT);
      const float lo = fd_dot(w, s_bank + max(ph - 1, 0) * kT);
      const float hi = fd_dot(w, s_bank + min(ph + 1, kP - 1) * kT);
      const float dfdt =
          ph == 0 ? hi - o : (ph == kP - 1 ? o - lo : (hi - lo) * 0.5f);
      const float err = clip1(dfdt * step_sign(o));
      freq = fminf(fmaxf(freq + og * err, min_freq), max_freq);
      const float np = (phase + freq) + mu * err;
      const float delta = floorf(np);
      offset += static_cast<int>(delta);
      phase = np - delta;
      orow[k++] = o;
    }
    s_count = k;
    count[c] = k;
    offs_out[c] = offset - n;
    fst_out[2 * c] = phase;
    fst_out[2 * c + 1] = freq;
  }
  __syncwarp();
  for (int i = s_count + threadIdx.x; i < max_syms; i += 32) orow[i] = 0.0f;
}

}  // namespace

extern "C" {

// Complex M&M: x = [C, n + 7] complex64 rows of [tail | block]; bank
// [128, 8]; out [C, max_syms] complex64; fstate [C, 10].
int mm_symbols_complex(const void* x, int n, int C, const float* bank,
                       const int* offset, const float* fstate,
                       int* offset_out, float* fstate_out, void* out,
                       int* count, int max_syms, float mu, float omega_gain,
                       float min_freq, float max_freq, long long* cycles,
                       void* stream) {
  return launch<true>(x, n, C, bank, offset, fstate, offset_out, fstate_out,
                      out, count, max_syms, mu, omega_gain, min_freq,
                      max_freq, cycles, static_cast<cudaStream_t>(stream));
}

// Float M&M: x = [C, n + 7] float32; out [C, max_syms] float32; fstate
// [C, 3].
int mm_symbols_real(const void* x, int n, int C, const float* bank,
                    const int* offset, const float* fstate, int* offset_out,
                    float* fstate_out, void* out, int* count, int max_syms,
                    float mu, float omega_gain, float min_freq,
                    float max_freq, long long* cycles, void* stream) {
  return launch<false>(x, n, C, bank, offset, fstate, offset_out, fstate_out,
                       out, count, max_syms, mu, omega_gain, min_freq,
                       max_freq, cycles, static_cast<cudaStream_t>(stream));
}

// Chunked M&M, complex: ext complex64; syms [K, steps * M] complex64;
// fst [10]. M is 8, 16 or 32.
int mm_chunked_complex(const void* ext, const float* bank, const int* off0,
                       const float* ph0, const float* fr0,
                       const float* emit_lo, const int* emit_hi,
                       const float* goff, int K, int L, int cols, int R, int J,
                       int M, int steps, int n, float mu, float omega_gain,
                       float min_freq, float max_freq, float half_omega,
                       void* syms, void* valid, float* pos, int* off_f,
                       float* fst, void* stream) {
  return launch_chunked<true>(ext, bank, off0, ph0, fr0, emit_lo, emit_hi,
                              goff, K, L, cols, R, J, M, steps, n, mu,
                              omega_gain, min_freq, max_freq, half_omega, syms,
                              valid, pos, off_f, fst,
                              static_cast<cudaStream_t>(stream));
}

// Chunked M&M, float: ext float32; syms [K, steps * M] float32; fst [3].
int mm_chunked_real(const void* ext, const float* bank, const int* off0,
                    const float* ph0, const float* fr0, const float* emit_lo,
                    const int* emit_hi, const float* goff, int K, int L,
                    int cols, int R, int J, int M, int steps, int n, float mu,
                    float omega_gain, float min_freq, float max_freq,
                    float half_omega, void* syms, void* valid, float* pos,
                    int* off_f, float* fst, void* stream) {
  return launch_chunked<false>(ext, bank, off0, ph0, fr0, emit_lo, emit_hi,
                               goff, K, L, cols, R, J, M, steps, n, mu,
                               omega_gain, min_freq, max_freq, half_omega,
                               syms, valid, pos, off_f, fst,
                               static_cast<cudaStream_t>(stream));
}

// FD synchronizer: x = [C, n + 7] float32 rows of [tail | block]; bank
// [128, 8]; out [C, max_syms] float32; fstate [C, 2] (phase, freq).
int fd_symbols(const float* x, int n, int C, const float* bank,
               const int* offset, const float* fstate, int* offset_out,
               float* fstate_out, float* out, int* count, int max_syms,
               float omega_gain, float mu, float min_freq, float max_freq,
               void* stream) {
  if (n < 1 || C < 1 || max_syms < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fd_kernel<<<C, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, bank, offset, fstate, offset_out, fstate_out, out, count,
      max_syms, omega_gain, mu, min_freq, max_freq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
