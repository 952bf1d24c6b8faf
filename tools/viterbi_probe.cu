// Two probes of the package's Viterbi kernels on the card, driven by
// tools/viterbi_probe.py; not part of the package and never built by it.
// This file includes the package's csrc/viterbi.cu, so its traceback
// section calls the package's own phase launchers; its copies of older
// kernels live in namespace probe.
//
// The ACS: an instrumented copy of the general Viterbi ACS kernel that
// csrc/viterbi.cu had before its radix-4 redesign (the "baseline",
// acs_cta_kernel<uint8_t, 1, true>: one CTA a window, a thread a state,
// one __syncthreads a trellis step), for measuring where its time goes on
// the card, and the floors of the dependent chain at radix 2, 4 and 8.
//
// acs_probe instantiates the baseline for each `mode` (a template
// argument, so the taken-out parts cost nothing) whose bits take one part
// out of each step (the decisions are then wrong; only the time is read):
//   1: the step's __syncthreads -> __syncwarp
//   2: the two predecessor metrics' shared-memory reads -> registers
//   4: the branch metrics (the soft bits' shared-memory reads, the sums)
//      -> the expected outputs held in registers
//   8: the ballot and lane 0's store of the decision word
//  16: the renormalisation bookkeeping (the `rec` test with its modulo,
//      the warp minima, the subtraction of the minimum)
// cycles[0] = thread 0's clock64() cycles over the window. Mode 0 is the
// baseline with the stamp added; its decisions equal the package's.
//
// acs_floor<kLevels> is the chain alone at radix 2^kLevels: a thread a
// state, metrics double-buffered in shared memory, one barrier every
// kLevels trellis steps; a round reads the 2^kLevels ancestors of the
// thread's state, kLevels levels of add-compare-select with branch metrics
// held in registers (2^kLevels - 1 of them), and one store. Its decisions
// are not kept. Built like the package's kernels (nvcc -O3 --fmad=false
// for sm_90a).

// The traceback: traceback_wide_kernel, the one-lane walk csrc/viterbi.cu
// ran for S > 64 before its segment-parallel walk (the traceback's
// "baseline", copied as it was), and two variants of the new walk's phases
// for its step 0: the maps phase with a merge shortcut (every 32 steps the
// CTA tests whether all its walkers hold one state and stops if so: a
// lower bound on that design's phase 1, whose merged tail is not walked;
// its outputs are not complete) and the chain reading its rows from global
// memory (L2) instead of a shared-memory ring. tb_phase runs one phase of
// the package's walk at any segment length L.
//
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../sdrpp_tpu_torch/csrc/viterbi.cu"

namespace probe {

constexpr int kRegRate = 4;
constexpr int kCtaThreads = 1024;
constexpr int kRenormSteps = 4096;
constexpr int kFastRate = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  return __uint_as_float(__reduce_min_sync(FULL, __float_as_uint(v)));
}

__device__ __forceinline__ float branch_metric(const float* s,
                                               const float (&cached)[kRegRate],
                                               int R) {
  float acc = fabsf(s[0] - cached[0]);
#pragma unroll
  for (int j = 1; j < kRegRate; ++j)
    if (j < R) acc = acc + fabsf(s[j] - cached[j]);
  return acc;
}

__device__ __forceinline__ void cache_row(const float* __restrict__ expected,
                                          int row, int R,
                                          float (&out)[kRegRate]) {
#pragma unroll
  for (int j = 0; j < kRegRate; ++j)
    out[j] = j < R ? expected[row * R + j] : 0.0f;
}

template <int mode>
__global__ void __launch_bounds__(kCtaThreads)
    acs_probe_kernel(const uint8_t* __restrict__ soft,
                     const float* __restrict__ expected,
                     uint32_t* __restrict__ dec, int T, int R, int S, int G,
                     long long* __restrict__ cycles) {
  extern __shared__ __align__(16) float smem[];
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int half = S >> 1, GR = G * R, wps = S >> 5;
  float* const mbuf = smem;
  float* const sst = smem + 2 * S;
  float* const wmin = sst + 2 * GR;
  const long long t_start = clock64();
  const uint8_t* sw = soft;
  const long long nvals = static_cast<long long>(T) * R;
  float e0[kRegRate], e1[kRegRate];
  bool e_ok = true;
  const int n = tid;
  mbuf[n] = n == 0 ? 0.0f : 1e9f;
  cache_row(expected, n, R, e0);
  cache_row(expected, n + S, R, e1);
  for (int j = 0; j < R; ++j) {
    const float x0 = expected[n * R + j], x1 = expected[(n + S) * R + j];
    e_ok = e_ok && x0 == rintf(x0) && x0 >= 0.0f && x0 <= 255.0f &&
           x1 == rintf(x1) && x1 >= 0.0f && x1 <= 255.0f;
  }
  if (tid < GR) sst[tid] = tid < nvals ? static_cast<float>(sw[tid]) : 0.0f;
  const bool fast = __syncthreads_and(e_ok && R <= kFastRate) != 0;
  const int ref_steps = 31 - __clz(S);
  float pre = 0.0f;
  int g = 0, i = 0;
  bool use_mn = false;
  float prev = mbuf[n];
  for (int t = 0; t < T; ++t) {
    const float* mo = mbuf + (t & 1) * S;
    float* mw = mbuf + ((t + 1) & 1) * S;
    if (i == 0) {
      const long long nx = static_cast<long long>(g + 1) * GR + tid;
      pre = tid < GR && nx < nvals ? static_cast<float>(sw[nx]) : 0.0f;
    }
    float mn = 0.0f;
    bool rec = false;
    if constexpr (!(mode & 16)) {
      mn = use_mn ? warp_min(lane < nwarps ? wmin[((t + 1) & 1) * 32 + lane]
                                           : INFINITY)
                  : 0.0f;
      rec = !fast || t < ref_steps || (t + 1) % kRenormSteps == 0;
    }
    const float* sv = sst + (g & 1) * GR + i * R;
    uint32_t* ds = dec + static_cast<long long>(t) * wps;
    float lmin = INFINITY;
    const int p = n >> 1;
    float bm0, bm1;
    if constexpr (mode & 4) {
      bm0 = e0[0];
      bm1 = e1[0];
    } else {
      bm0 = branch_metric(sv, e0, R);
      bm1 = branch_metric(sv, e1, R);
    }
    float a, b;
    if constexpr (mode & 2) {
      a = prev;
      b = prev + 1.0f;
    } else {
      a = mo[p];
      b = mo[p + half];
    }
    if (!(mode & 16) && use_mn) {
      a = a - mn;
      b = b - mn;
    }
    const float c0 = a + bm0, c1 = b + bm1;
    const bool take = c1 < c0;
    const float v = take ? c1 : c0;
    mw[n] = v;
    prev = v;
    lmin = fminf(lmin, v);
    if constexpr (!(mode & 8)) {
      const unsigned word = __ballot_sync(FULL, take);
      if (lane == 0) ds[n >> 5] = word;
    }
    if constexpr (!(mode & 16)) {
      if (rec) {
        const float wm = warp_min(lmin);
        if (lane == 0) wmin[(t & 1) * 32 + warp] = wm;
      }
    }
    if (i == G - 1 && tid < GR) sst[((g + 1) & 1) * GR + tid] = pre;
    if constexpr (mode & 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
    use_mn = rec;
    if (++i == G) {
      i = 0;
      ++g;
    }
  }
  if (tid == 0) cycles[0] = clock64() - t_start;
  if (mode & 8) dec[tid] = __float_as_uint(prev);  // keep the chain alive
}

template <int kLevels>
__global__ void __launch_bounds__(kCtaThreads)
    acs_floor_kernel(const float* __restrict__ expected, int T, int S,
                     float* __restrict__ out, long long* __restrict__ cycles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kAnc = 1 << kLevels;
  const int n = threadIdx.x;
  float bm[kAnc];
#pragma unroll
  for (int j = 0; j < kAnc; ++j) bm[j] = expected[(n + j * S) % (2 * S)];
  smem[n] = n == 0 ? 0.0f : 1e9f;
  __syncthreads();
  const long long t_start = clock64();
  const int a = n >> kLevels, stride = S >> kLevels;
  int r = 0;
  for (int t = 0; t + kLevels <= T; t += kLevels, ++r) {
    const float* mo = smem + (r & 1) * S;
    float m[kAnc];
#pragma unroll
    for (int j = 0; j < kAnc; ++j) m[j] = mo[a + j * stride];
#pragma unroll
    for (int w = kAnc / 2, k = 0; w >= 1; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j, ++k) {
        const float c0 = m[j] + bm[k & (kAnc - 1)];
        const float c1 = m[j + w] + bm[(k + 1) & (kAnc - 1)];
        m[j] = c1 < c0 ? c1 : c0;
      }
    }
    smem[((r + 1) & 1) * S + n] = m[0];
    __syncthreads();
  }
  if (n == 0) cycles[0] = clock64() - t_start;
  out[n] = smem[(r & 1) * S + n];
}


// --- traceback ---

constexpr int kWideStage = 2048;  // words a ring stage of the baseline

// words [k * ch * W, min((k + 1) * ch, T) * W) of a window (W words a
// step, ch steps a stage) into `dst`, as one cp.async group of this thread
__device__ __forceinline__ void stage_wide(unsigned long long* dst,
                                           const unsigned long long* src,
                                           int k, int T, int ch, int W,
                                           int lane) {
  const long long lo = static_cast<long long>(k) * ch * W;
  const int n = (min((k + 1) * ch, T) - k * ch) * W;
  for (int i = lane; i < n; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst + i)),
                 "l"(src + lo + i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// the baseline: S > 64, W = S / 64 words a step, staged kWideStage words
// at a time, lane 0 walking every step
__global__ void __launch_bounds__(32)
    traceback_wide_kernel(const unsigned long long* __restrict__ dec,
                          uint8_t* __restrict__ bits, int T, int S,
                          long long* __restrict__ cycles) {
  __shared__ __align__(16) unsigned long long ring[2][kWideStage];
  __shared__ uint8_t sbits[kWideStage / 2];
  const int lane = threadIdx.x;
  const long long t_start = clock64();
  const int W = S >> 6, ch = kWideStage / W;
  const uint32_t half = static_cast<uint32_t>(S) >> 1;
  const unsigned long long* dw =
      dec + static_cast<long long>(blockIdx.x) * T * W;
  uint8_t* bw = bits + static_cast<long long>(blockIdx.x) * T;
  const int nch = (T + ch - 1) / ch;
  stage_wide(ring[(nch - 1) & 1], dw, nch - 1, T, ch, W, lane);
  uint32_t s = 0;  // the walk starts at state 0
  for (int k = nch - 1; k >= 0; --k) {
    if (k > 0) {
      stage_wide(ring[(k - 1) & 1], dw, k - 1, T, ch, W, lane);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();  // every lane's copies of stage k have landed
    const int lo = k * ch, n = min(ch, T - lo);
    if (lane == 0) {
      const unsigned long long* r = ring[k & 1];
      for (int i = n - 1; i >= 0; --i) {
        const unsigned long long word = r[i * W + (s >> 6)];
        sbits[i] = static_cast<uint8_t>(s & 1u);
        const bool took = (word >> (s & 63u)) & 1ull;
        s = (s >> 1) | (took ? half : 0u);  // (s >> 1) + S / 2 * took
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) bw[lo + i] = sbits[i];
  }
  if (cycles != nullptr && lane == 0) cycles[blockIdx.x] = clock64() - t_start;
}

// the package's tb_map_kernel with the merge shortcut: every kCheck steps
// thread 0 publishes its first state and the CTA stops once every walker
// holds it (timing only: the maps and bits of a merged segment are not
// complete)
constexpr int kCheck = 32;

template <int kPer>
__global__ void __launch_bounds__(1024)
    tb_map_merge_kernel(const uint32_t* __restrict__ dec, int B, int T,
                        int S, int L, uint16_t* __restrict__ maps,
                        uint32_t* __restrict__ packed,
                        long long* __restrict__ seg_cycles) {
  __shared__ __align__(16) uint32_t ring[2][kMapStage];
  __shared__ uint32_t sref;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int W32 = S >> 5, rows = kMapStage / W32;
  const uint32_t half = static_cast<uint32_t>(S) >> 1;
  const int nseg = gridDim.x, j = blockIdx.x;
  const int lo = j * L, n = min(L, T - lo);
  const int nst = (n + rows - 1) / rows;
  const long long t32 = (T + 31) >> 5;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long t_start = clock64();
    const uint32_t* src = dec + (static_cast<long long>(b) * T + lo) * W32;
    uint32_t s[kPer], acc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      s[q] = static_cast<uint32_t>(tid + q * nthr);
      acc[q] = 0;
    }
    stage_rows(ring[(nst - 1) & 1], src, nst - 1, rows, n, W32, tid, nthr);
    int walked = 0;
    bool merged = false;
    for (int k = nst - 1; k >= 0 && !merged; --k) {
      if (k > 0) {
        stage_rows(ring[(k - 1) & 1], src, k - 1, rows, n, W32, tid, nthr);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();
      const uint32_t* st = ring[k & 1];
      const int r0 = k * rows;
      for (int r = min(r0 + rows, n) - 1; r >= r0 && !merged; --r) {
        const uint32_t* row = st + (r - r0) * W32;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const uint32_t w = row[s[q] >> 5];
          acc[q] = __funnelshift_r(acc[q], s[q], 1);
          const uint32_t took = __funnelshift_r(w, w, s[q]) & 1u;
          s[q] = (s[q] >> 1) + took * half;
        }
        if (((lo + r) & 31) == 0) {
          uint32_t* out = packed + (b * t32 + ((lo + r) >> 5)) * S + tid;
#pragma unroll
          for (int q = 0; q < kPer; ++q) out[q * nthr] = acc[q];
        }
        if (++walked % kCheck == 0) {
          if (tid == 0) sref = s[0];
          __syncthreads();
          bool eq = true;
#pragma unroll
          for (int q = 0; q < kPer; ++q) eq = eq && s[q] == sref;
          merged = __syncthreads_and(eq) != 0;
        }
      }
      __syncthreads();
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    uint16_t* m = maps + (static_cast<long long>(b) * nseg + j) * S + tid;
#pragma unroll
    for (int q = 0; q < kPer; ++q) m[q * nthr] = static_cast<uint16_t>(s[q]);
    if (seg_cycles != nullptr && tid == 0)
      seg_cycles[static_cast<long long>(b) * nseg + j] = clock64() - t_start;
  }
}

int tb_maps_merge(const uint32_t* dec, int B, int T, int S, int L, int nseg,
                  uint16_t* maps, uint32_t* packed, long long* seg_cycles,
                  cudaStream_t stream) {
  const dim3 grid(nseg, min(B, 65535));
#define TB_MERGE(P)                                                        \
  case P:                                                                  \
    tb_map_merge_kernel<P><<<grid, S / P, 0, stream>>>(dec, B, T, S, L,    \
                                                       maps, packed,       \
                                                       seg_cycles);        \
    break
  switch (min(kTbMaxPer, S / 128)) {
    TB_MERGE(1);
    TB_MERGE(2);
    TB_MERGE(4);
    TB_MERGE(8);
    default:
      tb_map_merge_kernel<kTbMaxPer><<<grid, S / kTbMaxPer, 0, stream>>>(
          dec, B, T, S, L, maps, packed, seg_cycles);
  }
#undef TB_MERGE
  return static_cast<int>(cudaGetLastError());
}

// the chain with its rows read from global memory: lane 0 alone
__global__ void __launch_bounds__(32)
    tb_chain_l2_kernel(const uint16_t* __restrict__ maps, int S, int nseg,
                       int* __restrict__ entries,
                       long long* __restrict__ cycles) {
  if (threadIdx.x != 0) return;
  const int b = blockIdx.x;
  const long long t_start = clock64();
  const uint16_t* mw = maps + static_cast<long long>(b) * nseg * S;
  int* ew = entries + static_cast<long long>(b) * nseg;
  uint32_t s = 0;
  for (int j = nseg - 1; j >= 0; --j) {
    ew[j] = static_cast<int>(s);
    s = mw[static_cast<long long>(j) * S + s];
  }
  if (cycles != nullptr) cycles[b] = clock64() - t_start;
}

}  // namespace probe

namespace probe {
extern "C" {

#define ACS_MODES(X) X(0) X(1) X(2) X(4) X(8) X(16) X(28) X(31)

// soft [T, R] uint8 from step 0, expected [2S, R] float32 (integers in
// [0, 255]), dec [T, S / 32] uint32 words; S = 64 ... 1024, one window.
int acs_probe(const uint8_t* soft, const float* expected, uint32_t* dec,
              int T, int R, int S, int mode, long long* cycles,
              void* stream) {
  if (S < 64 || S > 1024 || R < 2 || R > kRegRate)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = min(32, S / R);
  const size_t smem = (2 * static_cast<size_t>(S) +
                       2 * static_cast<size_t>(G) * R + 64) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define ACS_CASE(m)                                                        \
  case m:                                                                  \
    acs_probe_kernel<m><<<1, S, smem, s>>>(soft, expected, dec, T, R, S,   \
                                           G, cycles);                     \
    break;
    ACS_MODES(ACS_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int acs_floor(const float* expected, int T, int S, int levels, float* out,
              long long* cycles, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 1:
      acs_floor_kernel<1><<<1, S, smem, s>>>(expected, T, S, out, cycles);
      break;
    case 2:
      acs_floor_kernel<2><<<1, S, smem, s>>>(expected, T, S, out, cycles);
      break;
    case 3:
      acs_floor_kernel<3><<<1, S, smem, s>>>(expected, T, S, out, cycles);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// dec [B, T, S / 64] words -> bits [B, T], the baseline one-lane walk
// (S > 64); cycles null or [B]
int tb_baseline(const unsigned long long* dec, uint8_t* bits, int B, int T,
                int S, long long* cycles, void* stream) {
  if (S <= 64 || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  traceback_wide_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, bits, T, S, cycles);
  return static_cast<int>(cudaGetLastError());
}

// the package's walk at segment length L (0: tb_segment_steps(T)): its
// scratch bytes
long long tb_scratch(int B, int T, int S, int L) {
  return ::tb_layout(B, T, S, L > 0 ? L : ::tb_segment_steps(T)).bytes;
}

// one phase of the package's walk at segment length L (0: its own) on
// tb_scratch(B, T, S, L) bytes of scratch: 0 all three (traceback_segmented;
// cycles [B] the chain's), 1 the maps (cycles [B, nseg] per segment), 2
// the chain (cycles [B]), 3 the bits, 4 the maps with the merge shortcut
// (cycles [B, nseg]), 5 the chain from global memory (cycles [B])
int tb_phase(int phase, const unsigned long long* dec, uint8_t* bits, int B,
             int T, int S, int L, void* scratch, long long* cycles,
             void* stream) {
  if (S <= 64 || B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) L = ::tb_segment_steps(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ::TbLayout l = ::tb_layout(B, T, S, L);
  auto* base = static_cast<char*>(scratch);
  auto* maps = reinterpret_cast<uint16_t*>(base);
  auto* packed = reinterpret_cast<uint32_t*>(base + l.packed);
  auto* entries = reinterpret_cast<int*>(base + l.entries);
  const auto* d32 = reinterpret_cast<const uint32_t*>(dec);
  switch (phase) {
    case 0:
      return ::traceback_segmented(dec, bits, B, T, S, L, scratch, cycles,
                                   st);
    case 1:
      return ::tb_maps(d32, B, T, S, L, l.nseg, maps, packed, cycles, st);
    case 2:
      return ::tb_chain(maps, B, S, l.nseg, entries, cycles, st);
    case 3:
      return ::tb_select(packed, entries, bits, B, T, S, L, l.nseg, st);
    case 4:
      return tb_maps_merge(d32, B, T, S, L, l.nseg, maps, packed, cycles, st);
    case 5:
      tb_chain_l2_kernel<<<B, 32, 0, st>>>(maps, S, l.nseg, entries, cycles);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
}  // namespace probe
