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
// block entry (mm_chunked_block_*) also does the glue around it that
// ops/clock_recovery_chunked's plain version does in torch operations:
// the extended stream [hist | x | x[n-1] x pad | zeros] read by index
// (never built), each lane's Oerder-Meyr seed over its W warm-up samples
// (lane 0 on the carried grid), the emission bounds, then the group
// steps, the seam mask and the carry: one launch a block. The lanes entry
// (mm_chunked_complex / _real) takes an extended stream and the seeds as
// arrays and runs the rest.
//
// What bounds it on an H100: the chain of group steps. A lane's step
// depends on the previous one through its offset, phase and period, and
// every lane's through the window anchor r0 and the ensemble mean, so a
// call is steps = msc / M dependent rounds of (anchor min, coarse pass,
// K-lane error sums, full pass, K-lane error sums). Bytes are small (the
// block once, the [K, msc] outputs once) and so are flops; what sets a
// step is its chain of latencies and one SM's issue rate over the lanes
// it holds.
//
// Design: a cluster of ceil(K / 32) CTAs (one CTA, and no cluster, up to
// 32 lanes), each holding 32 lanes, which are one 32-lane group of the
// across-lane sums; G = 4 threads a lane (launch_chunked), each thread
// holding S = M / G consecutive symbols of a pass.
// - The anchor: the CTA's minimum of its warps' minima, pushed into every
//   CTA's shared memory (st.shared::cluster) with an arrival on that CTA's
//   mbarrier; each CTA waits on its own barrier and takes the minimum.
// - The windows: each lane's run of R samples and 8 of slack either side
//   is copied into shared memory during the previous step, as soon as its
//   full pass has read the last window, from the anchor's last advance;
//   when [r0, r0 + R) falls outside it (at the ends), the window is copied
//   again. A run inside the history or inside x is one bulk copy
//   (cp.async.bulk) from the 16-byte boundary at or below it; a run across
//   the history / block / padding / zeros boundaries goes sample by sample
//   by cp.async; either completes on the CTA's window mbarrier. (R samples
//   hold every tap of a group step: a symbol reads at r0 + gstat[m] +
//   clip(rel - gstat[m], 0, J - 8) <= r0 + R - 1.) Every tap of both
//   passes is read from shared memory, beside the 128 x 8 bank. When a
//   CTA's windows do not fit its shared memory (R of ~850 samples or more
//   complex, a symbol period of ~100), each pass copies the window in
//   pieces of the largest buffer that fits, overlapping by 7 samples, and
//   each symbol reads its taps from the piece its first tap starts in.
// - Inside a pass the M symbols are independent given their positions;
//   a symbol's error needs the outputs of symbols m-1 and m-2, which come
//   from the thread's own registers or, for its first two, from the
//   previous thread of the group by a shuffle.
// - The errors go to shared memory [32][M + 4]; each warp sums its M / G
//   columns over the CTA's 32 lanes by the xor-shuffle tree (16, 8, 4, 2,
//   1), pushes the sums into every CTA and arrives on its pass barrier;
//   then threads m < M add the CTAs' sums in turn and divide by K:
//   mm_symbols_chunked_plain's order. The in-order prefix sums A, B (the
//   lane's) and Ab, Bb (the ensemble's) are one float add a row in order
//   over rows loaded into registers, each thread running them over the
//   group without branches (no tree scan) and keeping its own symbols'
//   closed forms.
// - The full pass writes each thread's S consecutive slots of symbols,
//   positions and emit flags as vector stores; the count nv is a group
//   sum; the carry's error history comes from the threads holding
//   symbols nv-1 and nv-2.
// - The seam mask: the left neighbour's last emitted position is known
//   only at the end, but it lies below fl(fl(goff[k-1] + emit_hi[k-1]) +
//   half) (an emitted offset is below emit_hi, and rounding is
//   monotone), so each thread re-reads only its slots of the steps up to
//   the last one that emitted below that bound; the left neighbour of a
//   CTA's first lane is read from the previous CTA's shared memory after a
//   cluster barrier.
// - The seed (block entry): the warm-up copied 256 samples a lane at a
//   time as the windows are, beside a table of the chunk's exp(-2 pi i t /
//   freq0) in shared memory, then each lane's sums of |x_t|^2 cos / sin as 8 strided
//   partials (partial p over t = p, p + 8, ..., in order from 0.0f) and
//   the xor tree 4, 2, 1 over them, the order
//   ops/clock_recovery_chunked._seed_sum copies.
// Every mbarrier wait traps after 2^32 cycles: a barrier that never
// completes is a launch error, not a hang.
//
// Numerics: --fmad=false; the products and sums round as the plain
// version's, and the four multiply-adds of the position and period
// closed forms are explicit __fmaf_rn (the plain version rounds them once
// too), the contraction XLA's CPU backend makes in the JAX package's
// step, so both packages land on the same positions. The seed's cosf,
// sinf and atan2f are the CUDA math library's, as torch.cos / sin /
// atan2 on the card; remainder is fmodf with torch's sign fix-up.
//
// Shared memory a CTA (chunk_smem, exported as mm_chunked_layout;
// ops/clock_recovery_chunked.kernel_layout is its copy for the CPU
// tests): the bank, the errors, every CTA's group sums, a few lane- and
// M-vectors, four mbarriers, then its lanes' windows (R + 16 samples
// rounded to 16-byte units, or the pieces' buffers in the rest of the
// 227 KB), which the block entry's seed uses first for a 256-sample
// rotation table and a 256-sample chunk a lane: 78 KB at hrpt's 32 lanes
// of R = 120 complex. Every geometry fits.
//
// C ABI: the lanes entry: `ext` the extended stream (complex64 or
// float32), lane j at j * L; `off0`, `ph0`, `fr0` [K] the lanes' seeds;
// `emit_lo` [K] float32, `emit_hi` [K] int32 the emission floor (a
// position) and ceiling (an offset); `goff` [K] lane position to block
// position. The block entry: `x` [n], `hist` [W + 7] and the carried
// `offset0` (int32), `phase0`, `freq0` (float32), one element each;
// `allow` and `lo` lane 0's emission allowance below its first position
// and the other lanes' floor. Both: outputs `syms`, `valid` (bool) and
// `pos` [K, steps * M], `off_f` (one int32) and `fst` [10 | 3] float32,
// lane K-1's carry; `cycles`, when not null, [8] int64: the clock64 split
// of thread 0 (total, seed, anchor with the window copy, coarse pass,
// first lane sum with the positions, full pass with its stores, second
// lane sum with the carry, seam), a barrier ending each phase.

constexpr int kChunkMaxLanes = 256;
constexpr int kChunkCtaLanes = 32;     // lanes a CTA: one lane-sum group
constexpr int kChunkMaxCtas = kChunkMaxLanes / kChunkCtaLanes;
constexpr int kChunkPhases = 8;        // the clock64 split's slots
constexpr int kChunkSeedParts = 8;     // the seed sums' strided partials
constexpr int kSeedChunk = 256;        // warm-up samples a lane a round
constexpr int kWindowSlack = 8;        // a prefetched window's margin
constexpr int kChunkSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoPi = static_cast<float>(6.283185307179586);

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

__device__ __forceinline__ float sample_re(float2 v) { return v.x; }
__device__ __forceinline__ float sample_re(float v) { return v; }
__device__ __forceinline__ float sample_im(float2 v) { return v.y; }
__device__ __forceinline__ float sample_im(float) { return 0.0f; }

// torch.remainder for floats: fmod, moved into the divisor's sign
__device__ __forceinline__ float py_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

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

// the errors of a thread's S consecutive symbols of a pass: the history
// before its first symbol is the carried one (thread 0 of the group) or
// the previous thread's last two outputs
template <bool CPLX, int S, int G>
__device__ __forceinline__ void pass_errors(const History& carried,
                                            const float (&outr)[S],
                                            const float (&outi)[S], int t,
                                            float (&e)[S]) {
  const float y1r = __shfl_up_sync(kFull, outr[S - 1], 1, G);
  const float y1i = __shfl_up_sync(kFull, outi[S - 1], 1, G);
  const float y2r = __shfl_up_sync(kFull, outr[S - 2], 1, G);
  const float y2i = __shfl_up_sync(kFull, outi[S - 2], 1, G);
  History h = carried;
  if (t > 0) {
    h.y1r = y1r;
    h.y1i = y1i;
    h.y2r = y2r;
    h.y2i = y2i;
    h.k1r = step_sign(y1r);
    h.k1i = step_sign(y1i);
    h.k2r = step_sign(y2r);
    h.k2i = step_sign(y2i);
  }
#pragma unroll
  for (int j = 0; j < S; ++j) e[j] = mm_error<CPLX>(h, outr[j], outi[j]);
}

// the error rows' stride in floats: 16-byte rows for vector loads
template <int M>
constexpr int kErrStride = M + 4;

// the CTA's 32-lane group sums of e[k][m], by the xor-shuffle tree (16, 8,
// 4, 2, 1; zeros past the CTA's lanes): warp w of G takes the M / G
// columns m = w + i G, their trees interleaved; every lane gets x[i]
template <int M, int G>
__device__ __forceinline__ void group_sums(const float* s_e, int Kl, int warp,
                                           int lane, float (&x)[M / G]) {
  constexpr int N = M / G;
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = lane < Kl ? s_e[lane * kErrStride<M> + warp + i * G] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + __shfl_xor_sync(kFull, x[i], o);
  }
}

// M floats of shared memory (16-byte aligned) into registers
template <int M>
__device__ __forceinline__ void load_row(const float* src, float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(src)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

// the cluster's barrier: every thread of every CTA, shared memory writes
// before it visible to every CTA after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// `p`'s address in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

// the CTAs of a launch: a cluster of C > 1, or one CTA alone
struct Ctas {
  int C;
  // every thread of every CTA; shared memory writes before it visible to
  // every CTA after it
  __device__ __forceinline__ void sync() const {
    if (C > 1)
      cluster_sync();
    else
      __syncthreads();
  }
  // *p in the shared memory of CTA `rank`
  template <class V>
  __device__ __forceinline__ V load(const V* p, int rank) const {
    return C > 1 ? ld_cluster(p, rank) : *p;
  }
};

__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(cluster_addr(p, rank)),
               "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster(int* p, uint32_t rank, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(cluster_addr(p, rank)),
               "r"(v)
               : "memory");
}

// one arrival on the mbarrier `bar` of CTA `rank`, releasing this thread's
// earlier writes (its stores into that CTA among them) at cluster scope
__device__ __forceinline__ void arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// waits for the phase of parity `parity` of the local mbarrier `bar`,
// acquiring at cluster scope what the arrivals released; traps after 2^32
// cycles, as mbar_wait_bounded
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 32)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the ensemble means eb[m] = (the groups' sums s_parts[c][m] in turn) / K,
// for m < M by threads tid < M, once every CTA's sums are in s_parts
__device__ __forceinline__ void ensemble_means(const float* s_parts,
                                               float* s_eb, int M, int C,
                                               float fK, int tid) {
  if (tid < M) {
    float v[kChunkMaxCtas];
#pragma unroll
    for (int c = 0; c < kChunkMaxCtas; ++c)
      v[c] = c < C ? s_parts[c * M + tid] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int c = 1; c < kChunkMaxCtas; ++c)
      if (c < C) s = s + v[c];
    s_eb[tid] = s / fK;
  }
}

struct ChunkArgs {
  // the extended stream [hist | x | x[nx - 1] x pad | zeros], by index
  const void* x;
  const void* hist;
  int nx, hn, pad;
  // the lanes entry's seeds and bounds; null for the block entry
  const int* off0;
  const float* ph0;
  const float* fr0;
  const float* emit_lo;
  const int* emit_hi;
  const float* goff;
  // the block entry's carried state
  const int* offset0;
  const float* phase0;
  const float* freq0;
  const float* bank;
  int K, L, cols, R, J, steps, n, W;
  float mu, og, fmin, fmax, half, allow, lo;
  void* syms;
  bool* valid;
  float* pos;
  int* off_f;
  float* fst;
  long long* cycles;
};

// the dynamic shared memory of a CTA of Kl lanes: byte offsets, a lane's
// window buffer (stride samples) and the pieces a pass stages (0: the
// whole window, prefetched)
struct ChunkSmem {
  size_t e, ysel, last, eb, parts, gstat, min, bar, win, total;
  int stride, pieces;
};

__host__ __device__ inline size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

// a lane's window stride in samples: R samples from any start, copied
// from the 16-byte boundary at or below it, in whole 16-byte units
__host__ __device__ inline int window_stride(int R, int sample) {
  const int a = 16 / sample;
  return (R + a - 1 + a - 1) / a * a;
}

// the samples a piece holds: the most n with window_stride(n) <= stride
__host__ __device__ inline int piece_len(int stride, int sample) {
  return stride - 16 / sample + 1;
}

// The bank, the sums and the barriers, then the windows last, in what is
// left of kChunkSmemLimit: each lane's R samples and kWindowSlack either
// side when they fit (prefetched a step ahead), else the largest buffer a
// lane that fits, the window staged through it in pieces of piece_len
// samples overlapping by kT - 1, so every symbol's kT taps lie in one
// piece. The block entry's seed uses the same region first: a
// kSeedChunk-sample rotation table and a warm-up chunk a lane.
__host__ __device__ inline ChunkSmem chunk_smem(int Kl, int R, int M,
                                                int sample) {
  ChunkSmem s;
  const size_t K = static_cast<size_t>(Kl);
  s.e = kP * kT * sizeof(float);
  s.ysel = round16(s.e + K * (M + 4) * sizeof(float));
  s.last = round16(s.ysel + K * 4 * sizeof(float));
  s.eb = round16(s.last + K * sizeof(float));
  s.parts = round16(s.eb + static_cast<size_t>(M) * sizeof(float));
  s.gstat = round16(s.parts + 2 * kChunkMaxCtas * static_cast<size_t>(M) *
                                  sizeof(float));
  s.min = round16(s.gstat + static_cast<size_t>(M) * sizeof(int));
  s.bar = round16(s.min + (32 + kChunkMaxCtas) * sizeof(int));
  s.win = round16(s.bar + 4 * sizeof(uint64_t));
  const size_t seed = round16(kSeedChunk * 8) +
                      K * window_stride(kSeedChunk, sample) * sample;
  const int whole = window_stride(R + 2 * kWindowSlack, sample);
  const size_t room = kChunkSmemLimit - s.win, a = 16 / sample;
  if (K * whole * sample <= room) {
    s.stride = whole;
    s.pieces = 0;
  } else {
    s.stride = static_cast<int>(room / (K * sample) / a * a);
    const int step = piece_len(s.stride, sample) - (kT - 1);
    s.pieces = (R - kT) / step + 1;
  }
  size_t wb = K * s.stride * sample;
  if (seed > wb) wb = seed;
  s.total = round16(s.win + wb);
  return s;
}

// n floats to a global address aligned to 16 bytes (8 when n % 4 != 0)
template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    static_assert(N % 2 == 0, "pairs of floats");
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  }
}

// n floats from a global address aligned as store_floats's
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(src)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(src)[i];
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  }
}

// n bools (one byte each) to a global address aligned to n bytes
template <int N>
__device__ __forceinline__ void store_flags(bool* dst, const bool (&f)[N]) {
  static_assert(N == 2 || N == 4 || N == 8 || N == 16, "a word of flags");
  uint32_t w[(N + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i)
    w[i / 4] |= static_cast<uint32_t>(f[i]) << (8 * (i % 4));
  if constexpr (N == 2)
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(w[0]);
  else if constexpr (N == 4)
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  else if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// n bools from a global address aligned to n bytes
template <int N>
__device__ __forceinline__ void load_flags(const bool* src, bool (&f)[N]) {
  uint32_t w[(N + 3) / 4];
  if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(src);
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = (w[i / 4] >> (8 * (i % 4))) & 0xffu;
}

// mbar_wait that traps after 2^32 cycles (about two seconds): a barrier
// that never completes is a fault, reported as a launch error, not a hang
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 32)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the sample at index e of the extended stream, or null for a zero
template <class T>
__device__ __forceinline__ const T* ext_at(const ChunkArgs& a, int e) {
  if (e < a.hn) return static_cast<const T*>(a.hist) + e;
  e -= a.hn;
  if (e < a.nx) return static_cast<const T*>(a.x) + e;
  if (e < a.nx + a.pad) return static_cast<const T*>(a.x) + (a.nx - 1);
  return nullptr;
}

// the zeros past the padding, as a copy source
__device__ float2 g_zero_sample;

// samples [e, e + n) of the extended stream into dst (16-byte aligned,
// room for n + 16 / sizeof(T) - 1 samples) for one lane, arriving once on
// `bar` when they have landed; returns where sample e lands in dst. A run
// inside the history or inside x goes as one bulk copy from the 16-byte
// boundary at or below it (thread t == 0 issues it); any other run (across
// a boundary, the padding, the zeros) sample by sample by the lane's G
// threads with cp.async, each thread's copies holding the phase open
// until they land (cp.async.mbarrier.arrive; thread 0's is the lane's
// arrival). Nothing waits here.
template <class T, int G>
__device__ __forceinline__ int stage_run(const ChunkArgs& a, T* dst, int e,
                                         int n, int t, uint64_t* bar) {
  constexpr int A = 16 / static_cast<int>(sizeof(T));
  const bool in_x = e >= a.hn;
  const T* base = static_cast<const T*>(in_x ? a.x : a.hist);
  const int rel = in_x ? e - a.hn : e, lim = in_x ? a.nx : a.hn;
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(base + rel) & 15) / sizeof(T));
  const int nc = (lead + n + A - 1) / A * A;
  if (rel - lead >= 0 && rel - lead + nc <= lim) {
    if (t == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_tx(bar, nc * sizeof(T));
      bulk_copy(dst, base + rel - lead, nc * sizeof(T), bar);
    }
    return lead;
  }
  const T* zero = reinterpret_cast<const T*>(&g_zero_sample);
  for (int i = t; i < n; i += G) {
    const T* p = ext_at<T>(a, e + i);
    cp_async<sizeof(T)>(dst + i, p ? p : zero);
  }
  if (t == 0)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_addr(bar))
                 : "memory");
  else
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                     smem_addr(bar))
                 : "memory");
  return 0;
}

template <bool CPLX, int M, int G, bool WHOLE>
__global__ void __launch_bounds__(kChunkCtaLanes * G, 1)
mm_chunked_kernel(const ChunkArgs a) {
  using T = typename Sample<CPLX>::T;
  constexpr int S = M / G;   // symbols a thread
  constexpr int d = (kT - 1) / 2;  // the coarse pass's delay
  constexpr int A = 16 / static_cast<int>(sizeof(T));  // samples a 16 B unit
  static_assert(S >= 2 && M % G == 0, "two symbols a thread at least");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.K, R = a.R, J = a.J, L = a.L;
  const bool block = a.off0 == nullptr;
  // this CTA's lanes: [k0, k0 + Kl) of K, a 32-lane group of the lane sums
  const int cr = blockIdx.x, C = gridDim.x;
  const Ctas ctas{C};
  const int k0 = cr * kChunkCtaLanes, Kl = min(kChunkCtaLanes, K - k0);
  const ChunkSmem lay = chunk_smem(min(K, kChunkCtaLanes), R, M, sizeof(T));
  const int RS = lay.stride;
  // the window whole and prefetched (npc = 1; lay.pieces == 0), or staged
  // in each pass in npc pieces starting pstep samples apart
  constexpr bool whole = WHOLE;
  const int npc = whole ? 1 : lay.pieces;
  const int plen = piece_len(RS, sizeof(T)), pstep = plen - (kT - 1);
  float* s_bank = reinterpret_cast<float*>(smem_raw);
  T* s_win = reinterpret_cast<T*>(smem_raw + lay.win);
  float* s_e = reinterpret_cast<float*>(smem_raw + lay.e);
  float* s_ysel = reinterpret_cast<float*>(smem_raw + lay.ysel);
  float* s_last = reinterpret_cast<float*>(smem_raw + lay.last);
  float* s_eb = reinterpret_cast<float*>(smem_raw + lay.eb);
  // [2][kChunkMaxCtas][M]: each pass's group sums of every CTA
  float* s_parts = reinterpret_cast<float*>(smem_raw + lay.parts);
  int* s_gstat = reinterpret_cast<int*>(smem_raw + lay.gstat);
  int* s_min = reinterpret_cast<int*>(smem_raw + lay.min);  // warps'
  int* s_amin = s_min + 32;                                  // CTAs'
  // the window's barrier, then the anchor's and each pass's exchange
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int kl = tid / G, t = tid % G, k = k0 + kl;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const bool on = kl < Kl;
  const int kc = on ? k : 0, klc = on ? kl : 0;
  const bool lane0 = k == 0;
  const int msc = a.steps * M;
  const float fK = static_cast<float>(K), fn = static_cast<float>(a.n);
  T* wbuf = s_win + static_cast<size_t>(klc) * RS;
  float* erow = s_e + klc * kErrStride<M>;

  long long split[kChunkPhases] = {};
  long long tick = a.cycles ? clock64() : 0;
  const long long t_start = tick;
  auto mark = [&](int phase) {
    if (a.cycles) {
      __syncthreads();
      const long long now = clock64();
      split[phase] += now - tick;
      tick = now;
    }
  };

  // pass p's group sums into every CTA's s_parts[p][cr], then wait for
  // every CTA's: pushed by each warp's lane c into CTA c with an arrival on
  // its pass barrier, or (one CTA) stored and a barrier
  auto exchange_sums = [&](int p, int step) {
    float x[M / G];
    group_sums<M, G>(s_e, Kl, warp, lane, x);
    float* dst = s_parts + (p * kChunkMaxCtas + cr) * M + warp;
    if (C > 1) {
      if (lane < C) {
#pragma unroll
        for (int i = 0; i < M / G; ++i) st_cluster(dst + i * G, lane, x[i]);
        arrive_cluster(s_bar + 2 + p, lane);
      }
      wait_cluster(s_bar + 2 + p, step & 1);
    } else {
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < M / G; ++i) dst[i * G] = x[i];
      }
      __syncthreads();
    }
  };

  for (int i = tid; i < kP * kT; i += nthreads) s_bank[i] = a.bank[i];
  // symbol m's static band start, in double as the glue computes it
  if (tid < M)
    s_gstat[tid] = min(static_cast<int>(floor(static_cast<double>(tid) *
                                              static_cast<double>(a.fmin))),
                       R - J);
  // the window barrier: one arrival a lane, a phase a group step
  if (tid == 0) {
    mbar_init(s_bar, Kl);
    mbar_init(s_bar + 1, C);
    mbar_init(s_bar + 2, C * G);
    mbar_init(s_bar + 3, C * G);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the window barrier is initialised before the seed's
                    // copies arrive on it

  // ---- the lane's seed and bounds ----
  uint32_t bar_phase = 0;  // the window barrier's phases so far
  int offset = 0, ehi = 0;
  float phase = 0.0f, freq = 0.0f, elo = 0.0f, go = 0.0f;
  if (block) {
    float2* s_rot = reinterpret_cast<float2*>(s_win);
    const float f0 = *a.freq0;
    // the warm-up kSeedChunk samples at a time into shared memory, beside
    // the chunk's rotations exp(-2 pi i t / f0); partial p = t + G * j sums
    // t' = p, p + 8, ... < W in order
    T* sbuf = reinterpret_cast<T*>(smem_raw + lay.win +
                                   round16(8 * kSeedChunk)) +
              static_cast<size_t>(klc) * window_stride(kSeedChunk, sizeof(T));
    constexpr int NP = kChunkSeedParts / G;
    float pre[NP], pim[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      pre[j] = 0.0f;
      pim[j] = 0.0f;
    }
    for (int c0 = 0; c0 < a.W; c0 += kSeedChunk) {
      const int cn = min(kSeedChunk, a.W - c0);
      const int lead =
          on ? stage_run<T, G>(a, sbuf, k * L + c0, cn, t, s_bar)
             : 0;
      for (int i = tid; i < cn; i += nthreads) {
        const float ang = (-kTwoPi * static_cast<float>(c0 + i)) / f0;
        s_rot[i] = make_float2(cosf(ang), sinf(ang));
      }
      __syncthreads();
      mbar_wait_bounded(s_bar, bar_phase & 1);
      ++bar_phase;
      if (on) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          for (int i = t + G * j; i < cn; i += kChunkSeedParts) {
            const T x = sbuf[lead + i];
            const float pw = CPLX ? sample_re(x) * sample_re(x) +
                                        sample_im(x) * sample_im(x)
                                  : sample_re(x) * sample_re(x);
            const float2 r = s_rot[i];
            pre[j] = pre[j] + pw * r.x;
            pim[j] = pim[j] + pw * r.y;
          }
        }
      }
      __syncthreads();  // the chunk is read before the next one lands
    }
    // the xor tree over the partials: 4, 2, 1
#pragma unroll
    for (int o = kChunkSeedParts / 2; o >= 1; o >>= 1) {
      if (o >= G) {
#pragma unroll
        for (int j = 0; j < o / G; ++j) {
          pre[j] = pre[j] + pre[j + o / G];
          pim[j] = pim[j] + pim[j + o / G];
        }
      } else {
        pre[0] = pre[0] + __shfl_xor_sync(kFull, pre[0], o, G);
        pim[0] = pim[0] + __shfl_xor_sync(kFull, pim[0], o, G);
      }
    }
    const float c_re = __shfl_sync(kFull, pre[0], 0, G);
    const float c_im = __shfl_sync(kFull, pim[0], 0, G);
    const float p0 = (static_cast<float>(*a.offset0) + *a.phase0) +
                     static_cast<float>(a.W);
    const float base = static_cast<float>(k) * static_cast<float>(L);
    float pj;
    if (lane0) {
      pj = py_remainder(p0 - base, f0);
    } else {
      // symbol centre to interpolation window start: (T - 1) / 2
      const float t_hat = (-atan2f(c_im, c_re) * f0) / kTwoPi;
      pj = py_remainder(t_hat - 0.5f * static_cast<float>(kT - 1), f0);
    }
    const float fl = floorf(pj);
    offset = static_cast<int>(fl);
    phase = pj - fl;
    freq = f0;
    go = base - static_cast<float>(a.W);
    ehi = k == K - 1 ? a.W + L - a.pad : a.W + L;
    elo = lane0 ? p0 - a.allow : a.lo;
  } else if (on) {
    offset = a.off0[k];
    phase = a.ph0[k];
    freq = a.fr0[k];
    elo = a.emit_lo[k];
    ehi = a.emit_hi[k];
    go = a.goff[k];
  }
  // the seam's bound: lane k-1's emissions lie below fl(go + ehi) of its
  // own offset and ceiling
  float bound = -INFINITY;
  if (on && k > 0) {
    float go1;
    int ehi1;
    if (block) {
      go1 = static_cast<float>(k - 1) * static_cast<float>(L) -
            static_cast<float>(a.W);
      ehi1 = a.W + L;
    } else {
      go1 = a.goff[k - 1];
      ehi1 = a.emit_hi[k - 1];
    }
    bound = (go1 + static_cast<float>(ehi1)) + a.half;
    if (bound != bound) bound = INFINITY;
  }
  ctas.sync();  // every CTA's barriers are initialised before any arrival
  mark(1);

  History carried{};  // p1 p2 c1 c2 (or last in y1r): zero
  float lastpos = -INFINITY;
  int chk = -1;  // the last step with a slot the seam mask may drop
  T* srow = static_cast<T*>(a.syms) + static_cast<size_t>(kc) * msc;
  float* prow = a.pos + static_cast<size_t>(kc) * msc;
  bool* vrow = a.valid + static_cast<size_t>(kc) * msc;
  const int cmax = a.cols - kT;
  // the prefetched window: samples [pre0, pre0 + R + 2 kWindowSlack) of each
  // lane, at pre_lead in its buffer (pre0 < 0: none); the anchor's first
  // advance taken as floor(M * min_freq)
  int pre0 = -1, pre_lead = 0, r0_prev = 0;
  const int first_adv =
      static_cast<int>(floorf(static_cast<float>(M) * a.fmin));

  for (int s = 0; s < a.steps; ++s) {
    const float pos = static_cast<float>(offset) + phase;
    // window anchor: the min offset over lanes below their ceiling
    int am = (on && offset < ehi) ? min(max(offset, 0), cmax) : cmax;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) am = min(am, __shfl_xor_sync(kFull, am, o));
    if (lane == 0) s_min[warp] = am;
    __syncthreads();
    int r0 = s_min[0];
#pragma unroll
    for (int w = 1; w < G; ++w) r0 = min(r0, s_min[w]);
    if (C > 1) {
      // thread c < C pushes the CTA's minimum into CTA c
      if (tid < C) {
        st_cluster(s_amin + cr, tid, r0);
        arrive_cluster(s_bar + 1, tid);
      }
      wait_cluster(s_bar + 1, s & 1);
#pragma unroll
      for (int c = 0; c < kChunkMaxCtas; ++c)
        if (c < C) r0 = min(r0, s_amin[c]);
    }
    r0 = min(max(r0, 0), a.cols - R);
    // the lane's whole window [r0, r0 + R): the prefetched run when it
    // holds it (the same for every lane), else copied now
    int lead = pre_lead + (r0 - pre0);
    if (whole && pre0 >= 0) {
      mbar_wait_bounded(s_bar, bar_phase & 1);
      ++bar_phase;
    }
    if (whole &&
        (pre0 < 0 || r0 < pre0 || r0 + R > pre0 + R + 2 * kWindowSlack)) {
      lead = on ? stage_run<T, G>(a, wbuf, kc * L + r0, R, t, s_bar) : 0;
      mbar_wait_bounded(s_bar, bar_phase & 1);
      ++bar_phase;
    }
    mark(2);
    // window sample `at` (from r0) of piece pc, whose samples [b, b + len)
    // the pass stages first when the window goes in pieces; the piece a
    // run of kT taps starting at `at` lies in
    auto stage_piece = [&](int pc) {
      if (!whole) {
        const int b = pc * pstep;
        lead = (on ? stage_run<T, G>(a, wbuf, kc * L + r0 + b,
                                     min(plen, R - b), t, s_bar)
                   : 0) - b;
        mbar_wait_bounded(s_bar, bar_phase & 1);
        ++bar_phase;
      }
    };
    auto in_piece = [&](int at, int pc) {
      return whole || min(at / pstep, npc - 1) == pc;
    };

    // predictor: coarse 2-tap pass at the open-loop positions
    float outr[S] = {}, outi[S] = {}, e[S];
    for (int pc = 0; pc < npc; ++pc) {
      stage_piece(pc);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int m = t * S + j;
        const float Pm = __fmaf_rn(static_cast<float>(m), freq, pos);
        const float fl = floorf(Pm);
        const int g = s_gstat[m];
        const int rel2 = min(max(static_cast<int>(fl) - r0 - g, 0), J - kT);
        if (in_piece(g + rel2, pc)) {
          const float ph = Pm - fl;
          const T* w = wbuf + (lead + g + rel2 + d);
          const T x0 = w[0], x1 = w[1];
          const float w0 = 1.0f - ph;
          outr[j] = w0 * sample_re(x0) + ph * sample_re(x1);
          outi[j] = CPLX ? w0 * sample_im(x0) + ph * sample_im(x1) : 0.0f;
        }
      }
      if (!whole) __syncthreads();  // the piece is read before the next
    }
    pass_errors<CPLX, S, G>(carried, outr, outi, t, e);
    if (on) {
#pragma unroll
      for (int j = 0; j < S; ++j) erow[t * S + j] = e[j];
    }
    __syncthreads();
    mark(3);
    exchange_sums(0, s);
    ensemble_means(s_parts, s_eb, M, C, fK, tid);
    __syncthreads();

    // the corrected positions: symbol 0 at pos, symbol m at the
    // predictor's closed form for m - 1; every thread runs the in-order
    // sums over the whole group and keeps its own symbols' positions
    float P2[S];
    {
#pragma unroll
      for (int j = 0; j < S; ++j) P2[j] = pos;
      float ev[M], bv[M];
      load_row(erow, ev);
      load_row(s_eb, bv);
      float A_ = 0.0f, B_ = 0.0f, Ab = 0.0f, Bb = 0.0f;
#pragma unroll
      for (int m = 0; m + 1 < M; ++m) {
        const float em = ev[m], eb = bv[m], fm = static_cast<float>(m);
        A_ = m == 0 ? em : A_ + em;
        B_ = m == 0 ? fm * em : B_ + fm * em;
        Ab = m == 0 ? eb : Ab + eb;
        Bb = m == 0 ? fm * eb : Bb + fm * eb;
        // every thread computes it, the symbol's thread keeps it (no
        // branch on t inside the warp)
        const float m1 = static_cast<float>(m + 1);
        const float start = __fmaf_rn(m1, freq, pos);
        const float gain = lane0 ? m1 * A_ - B_ : m1 * Ab - Bb;
        const float pm = __fmaf_rn(a.mu, A_, __fmaf_rn(a.og, gain, start));
        P2[(m + 1) % S] = t == (m + 1) / S ? pm : P2[(m + 1) % S];
      }
    }
    mark(4);

    // corrector: the full 8-tap pass, the emissions and the count
    __syncwarp();  // the group's reads of erow end before it is rewritten
    for (int pc = 0; pc < npc; ++pc) {
      stage_piece(pc);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int m = t * S + j;
        const float Pm = P2[j];
        const float fl = floorf(Pm);
        const int g = s_gstat[m];
        const int rel2 = min(max(static_cast<int>(fl) - r0 - g, 0), J - kT);
        if (in_piece(g + rel2, pc)) {
          const float ph = Pm - fl;
          const int row = min(
              max(static_cast<int>(floorf(ph * static_cast<float>(kP))), 0),
              kP - 1);
          const float4* tp =
              reinterpret_cast<const float4*>(s_bank + row * kT);
          const float4 t0 = tp[0], t1 = tp[1];
          const float taps[kT] = {t0.x, t0.y, t0.z, t0.w,
                                  t1.x, t1.y, t1.z, t1.w};
          const T* w = wbuf + (lead + g + rel2);
          float ar = taps[0] * sample_re(w[0]);
          float ai = CPLX ? taps[0] * sample_im(w[0]) : 0.0f;
#pragma unroll
          for (int q = 1; q < kT; ++q) {
            const T v = w[q];
            ar = ar + taps[q] * sample_re(v);
            if constexpr (CPLX) ai = ai + taps[q] * sample_im(v);
          }
          outr[j] = ar;
          outi[j] = ai;
        }
      }
      if (!whole) __syncthreads();  // the piece is read before the next
    }
    int nv = 0;
    bool emit[S];
    float gps[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int m = t * S + j;
      const float Pm = P2[j];
      const int o = static_cast<int>(floorf(Pm));
      const int g = s_gstat[m];
      const int rel = o - r0;
      const bool ok =
          rel >= 0 && rel <= R - kT && rel >= g && rel <= g + (J - kT);
      const bool below = o < ehi;
      nv += (on && below) ? 1 : 0;
      gps[j] = go + Pm;
      emit[j] = on && ok && below && Pm >= elo && gps[j] < fn;
    }
    pass_errors<CPLX, S, G>(carried, outr, outi, t, e);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) nv += __shfl_xor_sync(kFull, nv, o, G);
    if (on) {
      const int slot = s * M + t * S;
      float sv[CPLX ? 2 * S : S], pv[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if constexpr (CPLX) {
          sv[2 * j] = emit[j] ? outr[j] : 0.0f;
          sv[2 * j + 1] = emit[j] ? outi[j] : 0.0f;
        } else {
          sv[j] = emit[j] ? outr[j] : 0.0f;
        }
        pv[j] = emit[j] ? gps[j] : INFINITY;
        if (emit[j]) {
          lastpos = fmaxf(lastpos, gps[j]);
          if (!(gps[j] > bound)) chk = s;
        }
        erow[t * S + j] = e[j];
        const int m = t * S + j;
        if (m == nv - 1) {
          s_ysel[4 * kl] = outr[j];
          s_ysel[4 * kl + 1] = outi[j];
        }
        if (m == nv - 2) {
          s_ysel[4 * kl + 2] = outr[j];
          s_ysel[4 * kl + 3] = outi[j];
        }
      }
      store_floats(reinterpret_cast<float*>(srow + slot), sv);
      store_floats(prow + slot, pv);
      store_flags(vrow + slot, emit);
    }
    __syncthreads();
    // every read of this window is done: prefetch the next one, from the
    // anchor's last advance less the slack, behind the rest of the step
    pre0 = -1;
    if (whole && s + 1 < a.steps) {
      pre0 = max(r0 + (s > 0 ? r0 - r0_prev : first_adv) - kWindowSlack, 0);
      pre_lead = on ? stage_run<T, G>(a, wbuf, kc * L + pre0,
                                      R + 2 * kWindowSlack, t, s_bar)
                    : 0;
    }
    r0_prev = r0;
    mark(5);
    exchange_sums(1, s);
    ensemble_means(s_parts + kChunkMaxCtas * M, s_eb, M, C, fK, tid);
    __syncthreads();

    // the carry: the closed form at nv, the history after symbol nv - 1
    if (on) {
      float new_pos = pos, new_freq = freq;
      History h = carried;
      if (nv > 0) {
        float ev[M], bv[M];
        load_row(erow, ev);
        load_row(s_eb, bv);
        float A_ = 0.0f, B_ = 0.0f, Ab = 0.0f, Bb = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          // selects, not a branch: nv differs between the warp's lanes
          const bool in = m < nv;
          const float em = ev[m], eb = bv[m];
          const float fm = static_cast<float>(m);
          A_ = in ? (m == 0 ? em : A_ + em) : A_;
          B_ = in ? (m == 0 ? fm * em : B_ + fm * em) : B_;
          Ab = in ? (m == 0 ? eb : Ab + eb) : Ab;
          Bb = in ? (m == 0 ? fm * eb : Bb + fm * eb) : Bb;
        }
        const float m1 = static_cast<float>(nv);
        const float start = __fmaf_rn(m1, freq, pos);
        const float gain = lane0 ? m1 * A_ - B_ : m1 * Ab - Bb;
        new_pos = __fmaf_rn(a.mu, A_, __fmaf_rn(a.og, gain, start));
        new_freq = fminf(fmaxf(__fmaf_rn(a.og, lane0 ? A_ : Ab, freq), a.fmin),
                         a.fmax);
        const float* ys = s_ysel + 4 * kl;
        if (nv == 1) {
          h.y2r = carried.y1r;
          h.y2i = carried.y1i;
          h.k2r = carried.k1r;
          h.k2i = carried.k1i;
        } else {
          h.y2r = ys[2];
          h.y2i = ys[3];
          h.k2r = step_sign(ys[2]);
          h.k2i = step_sign(ys[3]);
        }
        h.y1r = ys[0];
        h.y1i = ys[1];
        h.k1r = step_sign(ys[0]);
        h.k1i = step_sign(ys[1]);
      }
      const float fl = floorf(new_pos);
      offset = static_cast<int>(fl);
      phase = new_pos - fl;
      freq = new_freq;
      carried = h;
    }
    mark(6);
  }

  // the seam mask: drop what the left neighbour already emitted, in the
  // thread's own slots of the steps up to the last that emitted below
  // the bound (four steps' loads before their stores)
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    lastpos = fmaxf(lastpos, __shfl_xor_sync(kFull, lastpos, o, G));
  if (on && t == 0) s_last[kl] = lastpos;
  ctas.sync();
  if (on) {
    const float thr =
        k == 0 ? -INFINITY
               : (kl > 0 ? s_last[kl - 1]
                         : ctas.load(s_last + kChunkCtaLanes - 1, cr - 1)) +
                     a.half;
    for (int s0 = 0; s0 <= chk; s0 += 4) {
      float pv[4][S];
      bool fv[4][S];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s0 + q <= chk) {
          const int slot = (s0 + q) * M + t * S;
          load_floats(prow + slot, pv[q]);
          load_flags(vrow + slot, fv[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s0 + q <= chk) {
#pragma unroll
          for (int j = 0; j < S; ++j) fv[q][j] = fv[q][j] && pv[q][j] > thr;
          store_flags(vrow + (s0 + q) * M + t * S, fv[q]);
        }
      }
    }
  }
  mark(7);
  ctas.sync();  // no CTA leaves while another reads its shared memory
  if (a.cycles && cr == 0 && tid == 0) {
    split[0] = clock64() - t_start;
    for (int i = 0; i < kChunkPhases; ++i) a.cycles[i] = split[i];
  }
  if (on && t == 0 && k == K - 1) {
    *a.off_f = static_cast<int>((static_cast<float>(offset) + go) - fn);
    float* fst = a.fst;
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

// one cluster of ceil(K / 32) CTAs, 32 lanes each, or one CTA
template <bool CPLX, int M, int G, bool WHOLE>
int launch_chunked_ctas(const ChunkArgs& a, size_t smem,
                        cudaStream_t stream) {
  // the attribute is per device: set it once on each
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(mm_chunked_kernel<CPLX, M, G, WHOLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChunkSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr_set[dev] = true;
  }
  const unsigned ctas = (a.K + kChunkCtaLanes - 1) / kChunkCtaLanes;
  if (ctas == 1) {
    mm_chunked_kernel<CPLX, M, G, WHOLE>
        <<<1, kChunkCtaLanes * G, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kChunkCtaLanes * G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mm_chunked_kernel<CPLX, M, G, WHOLE>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the kernel for a's layout: whole windows, or windows in pieces
template <bool CPLX, int M, int G>
int launch_chunked_mg(const ChunkArgs& a, cudaStream_t stream) {
  using T = typename Sample<CPLX>::T;
  const ChunkSmem lay =
      chunk_smem(min(a.K, kChunkCtaLanes), a.R, M, sizeof(T));
  if (lay.total > static_cast<size_t>(kChunkSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  return lay.pieces == 0
             ? launch_chunked_ctas<CPLX, M, G, true>(a, lay.total, stream)
             : launch_chunked_ctas<CPLX, M, G, false>(a, lay.total, stream);
}

template <bool CPLX>
int launch_chunked(const ChunkArgs& a, int M, cudaStream_t stream) {
  if (a.K < 1 || a.K > kChunkMaxLanes || a.L < 1 || a.steps < 1 || a.n < 1 ||
      a.J < kT || a.R < a.J || a.cols < a.R || a.W < 0 ||
      (a.off0 == nullptr && (a.W < 1 || a.pad < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (M) {
    case 8:
      return launch_chunked_mg<CPLX, 8, 4>(a, stream);
    case 16:
      return launch_chunked_mg<CPLX, 16, 4>(a, stream);
    case 32:
      return launch_chunked_mg<CPLX, 32, 4>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

ChunkArgs lanes_args(const void* ext, const float* bank, const int* off0,
                     const float* ph0, const float* fr0, const float* emit_lo,
                     const int* emit_hi, const float* goff, int K, int L,
                     int cols, int R, int J, int steps, int n, float mu,
                     float og, float fmin, float fmax, float half, void* syms,
                     void* valid, float* pos, int* off_f, float* fst,
                     long long* cycles) {
  ChunkArgs a{};
  a.x = ext;
  a.nx = (K - 1) * L + cols;
  a.off0 = off0;
  a.ph0 = ph0;
  a.fr0 = fr0;
  a.emit_lo = emit_lo;
  a.emit_hi = emit_hi;
  a.goff = goff;
  a.bank = bank;
  a.K = K;
  a.L = L;
  a.cols = cols;
  a.R = R;
  a.J = J;
  a.steps = steps;
  a.n = n;
  a.mu = mu;
  a.og = og;
  a.fmin = fmin;
  a.fmax = fmax;
  a.half = half;
  a.syms = syms;
  a.valid = static_cast<bool*>(valid);
  a.pos = pos;
  a.off_f = off_f;
  a.fst = fst;
  a.cycles = cycles;
  return a;
}

ChunkArgs block_args(const void* x, const void* hist, const int* offset0,
                     const float* phase0, const float* freq0,
                     const float* bank, int K, int L, int cols, int R, int J,
                     int steps, int n, int W, int pad, float mu, float og,
                     float fmin, float fmax, float half, float allow, float lo,
                     void* syms, void* valid, float* pos, int* off_f,
                     float* fst, long long* cycles) {
  ChunkArgs a = lanes_args(x, bank, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, K, L, cols, R, J, steps, n, mu,
                           og, fmin, fmax, half, syms, valid, pos, off_f, fst,
                           cycles);
  a.nx = n;
  a.hist = hist;
  a.hn = W + kT - 1;
  a.pad = pad;
  a.offset0 = offset0;
  a.phase0 = phase0;
  a.freq0 = freq0;
  a.W = W;
  a.allow = allow;
  a.lo = lo;
  return a;
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

// Chunked M&M over the lanes of an extended stream, complex: ext
// complex64; syms [K, steps * M] complex64; fst [10]. M is 8, 16 or 32.
int mm_chunked_complex(const void* ext, const float* bank, const int* off0,
                       const float* ph0, const float* fr0,
                       const float* emit_lo, const int* emit_hi,
                       const float* goff, int K, int L, int cols, int R, int J,
                       int M, int steps, int n, float mu, float omega_gain,
                       float min_freq, float max_freq, float half_omega,
                       void* syms, void* valid, float* pos, int* off_f,
                       float* fst, long long* cycles, void* stream) {
  return launch_chunked<true>(
      lanes_args(ext, bank, off0, ph0, fr0, emit_lo, emit_hi, goff, K, L,
                 cols, R, J, steps, n, mu, omega_gain, min_freq, max_freq,
                 half_omega, syms, valid, pos, off_f, fst, cycles),
      M, static_cast<cudaStream_t>(stream));
}

// Chunked M&M, float: ext float32; syms [K, steps * M] float32; fst [3].
int mm_chunked_real(const void* ext, const float* bank, const int* off0,
                    const float* ph0, const float* fr0, const float* emit_lo,
                    const int* emit_hi, const float* goff, int K, int L,
                    int cols, int R, int J, int M, int steps, int n, float mu,
                    float omega_gain, float min_freq, float max_freq,
                    float half_omega, void* syms, void* valid, float* pos,
                    int* off_f, float* fst, long long* cycles, void* stream) {
  return launch_chunked<false>(
      lanes_args(ext, bank, off0, ph0, fr0, emit_lo, emit_hi, goff, K, L,
                 cols, R, J, steps, n, mu, omega_gain, min_freq, max_freq,
                 half_omega, syms, valid, pos, off_f, fst, cycles),
      M, static_cast<cudaStream_t>(stream));
}

// Chunked M&M of a block, complex: x [n] and hist [W + 7] complex64, the
// carried offset0 (int32), phase0 and freq0 (float32); syms [K, steps *
// M] complex64; fst [10]. pad = K * L - n.
int mm_chunked_block_complex(const void* x, const void* hist,
                             const int* offset0, const float* phase0,
                             const float* freq0, const float* bank, int K,
                             int L, int cols, int R, int J, int M, int steps,
                             int n, int W, int pad, float mu,
                             float omega_gain, float min_freq, float max_freq,
                             float half_omega, float allow, float lo,
                             void* syms, void* valid, float* pos, int* off_f,
                             float* fst, long long* cycles, void* stream) {
  return launch_chunked<true>(
      block_args(x, hist, offset0, phase0, freq0, bank, K, L, cols, R, J,
                 steps, n, W, pad, mu, omega_gain, min_freq, max_freq,
                 half_omega, allow, lo, syms, valid, pos, off_f, fst, cycles),
      M, static_cast<cudaStream_t>(stream));
}

// Chunked M&M of a block, float: x [n] and hist [W + 7] float32; syms [K,
// steps * M] float32; fst [3].
int mm_chunked_block_real(const void* x, const void* hist, const int* offset0,
                          const float* phase0, const float* freq0,
                          const float* bank, int K, int L, int cols, int R,
                          int J, int M, int steps, int n, int W, int pad,
                          float mu, float omega_gain, float min_freq,
                          float max_freq, float half_omega, float allow,
                          float lo, void* syms, void* valid, float* pos,
                          int* off_f, float* fst, long long* cycles,
                          void* stream) {
  return launch_chunked<false>(
      block_args(x, hist, offset0, phase0, freq0, bank, K, L, cols, R, J,
                 steps, n, W, pad, mu, omega_gain, min_freq, max_freq,
                 half_omega, allow, lo, syms, valid, pos, off_f, fst, cycles),
      M, static_cast<cudaStream_t>(stream));
}

// The shared memory of a chunked launch's CTA for K lanes, an R-sample
// group window, M symbols a group step and `sample`-byte samples (8
// complex, 4 float): returns its bytes and writes a lane's window buffer
// in samples and the pieces a pass copies the window in (0: whole, and
// prefetched a step ahead).
int mm_chunked_layout(int K, int R, int M, int sample, int* stride,
                      int* pieces) {
  const ChunkSmem s =
      chunk_smem(K < kChunkCtaLanes ? K : kChunkCtaLanes, R, M, sample);
  *stride = s.stride;
  *pieces = s.pieces;
  return static_cast<int>(s.total);
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
