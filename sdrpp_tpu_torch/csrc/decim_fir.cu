// Strided decimating FIR over rows of complex64 or float32 samples, for
// Hopper.
//
// Replaces the Pallas kernel of the JAX package
//   sdrpp_tpu/ops/fir_pallas.py:74 _run (pallas_call :79), driven by
//   decimating_fir_pallas, the power-of-2 decimator's high-ratio stages.
// It computes the reference's decimating FIR (decimating_fir.h:49-69):
//   y[o] = sum_{j<m} taps[j] * buf[r*o + j],  buf = [tail | x],
// with real float32 taps, and returns the last m-1 samples of buf as the
// next block's tail. The TPU kernel's [ROWS, r] tiling, its halo built
// outside the kernel and its block-length limit were TPU layout; here any
// row count and any n that is a multiple of r are taken, and tail and x
// are read through two pointers, so [tail | x] is never built.
//
// What bounds it on an H100: bytes. Each output reads r new input
// samples and does 2m float operations per plane, so at r = 32, m = 143
// the kernel needs ~9 flops per input byte against the card's ~20
// (67 TFLOP/s float32 over 3.35 TB/s): it should run at the memory rate,
// provided every input byte comes from device memory once.
//
// Design: one block covers one row and OPB consecutive outputs. It stages
// the input span those outputs read, r*(OPB-1) + m samples, in shared
// memory with coalesced loads (float2 for complex; kLoads of them in
// flight per thread), split into re/im planes and laid out by phase:
// element i of the span goes to plane[(i % r) * LP + i / r]. Output q of the tile then reads
// plane[(j % r) * LP + q + j / r] for tap j: neighbouring threads read
// neighbouring words, free of bank conflicts at every r, and LP is odd so
// the phase-major stores are too. The taps sit in shared memory. Each
// thread sums one output's re and im over j = 0..m-1, in that order, from
// 0.0f; built with --fmad=false, every product and sum rounds once, as in
// the plain PyTorch version (ops/fir_kernels.decimating_fir_plain).
// OPB is the largest multiple of 32 up to 256 whose tile fits a 100 KB
// shared-memory budget (two blocks per SM): 256 at r <= 32, 64 at the
// /128 stage's r = 128, m = 726. The blocks of output tile 0 also write
// the new tail, which handles n < m - 1 (tail samples survive).
//
// C ABI (bound with ctypes): each entry returns cudaGetLastError() after
// the launch. Row counts and lengths are 64-bit; offsets are computed in
// 64 bits inside the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOPB = 256;
constexpr int kLoads = 8;
constexpr int kMinBlocks = 4;  // blocks per SM the registers must allow
constexpr size_t kSmemBudget = 100 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

template <int NC>
struct Sample;
template <>
struct Sample<1> {
  using T = float;
  __device__ static float part(float v, int) { return v; }
};
template <>
struct Sample<2> {
  using T = float2;
  __device__ static float part(float2 v, int c) { return c ? v.y : v.x; }
};

// phase-plane row length: the span's r*(OPB-1) + m samples, odd
__host__ __device__ inline int plane_len(int opb, int m, int r) {
  const int lp = opb + (m - 1) / r;
  return lp | 1;
}

inline size_t smem_bytes(int opb, int m, int r, int nc) {
  return (static_cast<size_t>(m) +
          static_cast<size_t>(nc) * r * plane_len(opb, m, r)) *
         sizeof(float);
}

template <int NC>
__global__ void __launch_bounds__(kMaxOPB, kMinBlocks)
decim_fir_kernel(const typename Sample<NC>::T* __restrict__ tail,
                 const typename Sample<NC>::T* __restrict__ x,
                 const float* __restrict__ taps,
                 typename Sample<NC>::T* __restrict__ new_tail,
                 typename Sample<NC>::T* __restrict__ y, long long n, int m,
                 int r) {
  using T = typename Sample<NC>::T;
  extern __shared__ float smem[];
  const int opb = blockDim.x;
  const int lp = plane_len(opb, m, r);
  float* staps = smem;
  float* planes = smem + m;  // NC planes of r * lp floats

  const long long row = blockIdx.y;
  const long long h = m - 1;  // tail length
  const long long n_out = n / r;
  const T* trow = tail + row * h;
  const T* xrow = x + row * n;
  const long long o0 = static_cast<long long>(blockIdx.x) * opb;

  // buf[g] for g in [0, n + m - 1): the tail, then the block
  auto load = [&](long long g) -> T {
    if (g < h) return trow[g];
    if (g - h < n) return xrow[g - h];
    return T{};
  };

  for (int j = threadIdx.x; j < m; j += opb) staps[j] = taps[j];
  const int span = r * lp;
  const long long g0 = o0 * r;
  // kLoads loads in flight per thread before their stores: one load per
  // thread at a time leaves too few bytes in flight to cover the device
  // memory latency. The decimators' r are powers of 2 (shift and mask).
  const bool pow2 = (r & (r - 1)) == 0;
  const int shift = __ffs(r) - 1;
  auto stage = [&](auto fetch) {
    for (int base = threadIdx.x; base < span; base += opb * kLoads) {
      T v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * opb;
        v[u] = i < span ? fetch(i) : T{};
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * opb;
        if (i < span) {
          const int at = pow2 ? (i & (r - 1)) * lp + (i >> shift)
                              : (i % r) * lp + i / r;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            planes[c * span + at] = Sample<NC>::part(v[u], c);
        }
      }
    }
  };
  if (g0 >= h && g0 + span <= h + n) {  // the span lies inside the block
    const T* src = xrow + (g0 - h);
    stage([&](int i) { return src[i]; });
  } else {
    stage([&](int i) { return load(g0 + i); });
  }
  if (blockIdx.x == 0) {
    T* nt = new_tail + row * h;
    for (long long k = threadIdx.x; k < h; k += opb) nt[k] = load(n + k);
  }
  __syncthreads();

  const int q = threadIdx.x;
  if (o0 + q >= n_out) return;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  int p = 0, at = q;  // at = p * lp + q + j / r
  for (int j = 0; j < m; ++j) {
    const float w = staps[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = acc[c] + w * planes[c * span + at];
    if (++p == r) {
      p = 0;
      at = at - (r - 1) * lp + 1;
    } else {
      at += lp;
    }
  }
  T out;
  if constexpr (NC == 2) {
    out = make_float2(acc[0], acc[1]);
  } else {
    out = acc[0];
  }
  y[row * n_out + o0 + q] = out;
}

template <int NC>
int launch(const void* tail, const void* x, const float* taps, void* new_tail,
           void* y, long long rows, long long n, int m, int r,
           cudaStream_t stream) {
  using T = typename Sample<NC>::T;
  if (rows <= 0 || n <= 0 || m < 1 || r < 1 || n % r || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int opb = kMaxOPB;
  while (opb > 32 && smem_bytes(opb, m, r, NC) > kSmemBudget) opb -= 32;
  const size_t smem = smem_bytes(opb, m, r, NC);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decim_fir_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_out = n / r;
  const dim3 grid(static_cast<unsigned>((n_out + opb - 1) / opb),
                  static_cast<unsigned>(rows));
  decim_fir_kernel<NC><<<grid, opb, smem, stream>>>(
      static_cast<const T*>(tail), static_cast<const T*>(x), taps,
      static_cast<T*>(new_tail), static_cast<T*>(y), n, m, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// complex64 rows: tail [rows, m-1], x [rows, n] -> new_tail [rows, m-1],
// y [rows, n/r]; taps [m] float32.
int decim_fir_c64(const void* tail, const void* x, const float* taps,
                  void* new_tail, void* y, long long rows, long long n, int m,
                  int r, void* stream) {
  return launch<2>(tail, x, taps, new_tail, y, rows, n, m, r,
                   static_cast<cudaStream_t>(stream));
}

// float32 rows, the same layout.
int decim_fir_f32(const void* tail, const void* x, const float* taps,
                  void* new_tail, void* y, long long rows, long long n, int m,
                  int r, void* stream) {
  return launch<1>(tail, x, taps, new_tail, y, rows, n, m, r,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
