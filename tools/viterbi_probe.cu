// An instrumented copy of the general Viterbi ACS kernel that
// csrc/viterbi.cu had before its radix-4 redesign (the "baseline",
// acs_cta_kernel<uint8_t, 1, true>: one CTA a window, a thread a state,
// one __syncthreads a trellis step), for measuring where its time goes on
// the card, and the floors of the dependent chain at radix 2, 4 and 8.
// Driven by tools/viterbi_probe.py; not part of the package and never
// built by it.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace

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

}  // extern "C"
