// The VFO bank's NCO mix in one pass, for Hopper: ops/mix.py mix_bank,
//
//   y[c, i] = x[i] (or x[c, i]) * exp(j * wrap((phi[c] + hi[c, i / K])
//                                             + lo[c, i % K]))
//   new_phi[c] = wrap(phi[c] + step[c]),
//
// wrap(s) being s mod 2pi in [0, 2pi) as torch.remainder takes it, and
// hi [C, A], lo [C, K] the factored ramp of mix_bank_tables (n = A K, K a
// power of 2).
//
// It replaces no TPU kernel: the JAX package's mix_bank
// (sdrpp_tpu/ops/mix.py) is XLA elementwise code. The port ran the same
// expression as six torch passes over [C, n] (the angle's adds, the
// remainder, cos, sin, the phasor, the product), each reading or writing
// a full-size temporary: ~25 ms of a 64 x 2^24 block on an H100, whose
// least bytes take 2.6.
//
// What bounds it on an H100: bytes, the [C, n] complex64 write (8.6 GB at
// 64 x 2^24: 2.6 ms at 3.35 TB/s; x's [n] read is 134 MB). The angle, its
// wrap, sincosf and the product are ~50 operations a sample, ~1.5 ms of
// the 132 SMs' instruction slots, which has to hide under the write. The
// design:
// - A CTA owns a tile of samples (256 threads, kVecs vectors of 2
//   samples each) and a group of up to kGroup channels. A shared x is
//   loaded once into registers with 16-byte loads, neighbouring threads
//   on neighbouring addresses, and used for every channel of the group;
//   the groups of one tile are neighbouring CTAs, so x leaves device
//   memory once and the other groups find it in L2.
// - The tile is a block of rows of the [A, K] view of a row (i = a K + b)
//   at most 512 samples wide: at K >= 512 a thread's vectors share their
//   column, so the lo entries it needs repeat in every row of its tile
//   (L1 hits), and hi is one broadcast load a row. The tables (2 MB at
//   64 x 2^24) stay in L2.
// - y is written with 16-byte streaming stores (st.global.cs): [C, n]
//   never fits in L2, and the tables and x stay there.
// - 256 threads, registers left to the compiler (the shared-x kernel of
//   64 x 2^24: 48 registers, a 16-byte stack frame for sincosf's argument
//   reduction, five CTAs an SM), CTAs of one tile and group each, in
//   grid order, so the CTAs in flight write neighbouring spans of every
//   row.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 2.91-2.99 ms at 64 x
// 2^24, 87-89.5 % of the bound, as long as a torch fill_ of y; without
// sincosf it takes the same, with x read from L2 2.73: the rest is x's
// device-memory reads among the writes. A register cap through
// __launch_bounds__, persistent CTAs with the next tile's x in registers,
// and L2 prefetches ahead all measured slower.
// An odd n (K = 1), or an x whose rows are not 16-byte aligned, takes the
// same kernel with vectors of one sample (8-byte loads and stores).
//
// Numerics: built with --fmad=false and no fast math. The angle is the
// plain path's float32 order, (phi + hi) + lo, each sum rounded once, and
// its wrap is exact: the result of fmodf, with 2pi added where the sign
// differs, as torch.remainder takes it on either device. So the phase's
// bits equal the plain path's, which the carried phase shows bit for
// bit. sincosf is the accurate CUDA library function (not
// __sincosf); it and the complex product (x * phasor in c10::complex's
// order, each product and sum rounded once) differ from torch's kernels
// in their last ulps only.
//
// C ABI (bound with ctypes): the entry returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for sizes it refuses, before
// launching.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi), _TWO_PI32
constexpr int kThreads = 256;
constexpr int kVecs = 4;    // vectors a thread holds
constexpr int kGroup = 16;  // channels a CTA
constexpr int kMaxLog2Cols = 8;  // a tile row: at most 256 vectors

// s mod 2pi in [0, 2pi), bit for bit torch.remainder(s, 2pi): fmodf,
// then + 2pi where the result is negative.
__device__ __forceinline__ float wrap_2pi(float s) {
  float r = fmodf(s, kTwoPi);
  if (r < 0.0f) r += kTwoPi;
  return r;
}

// V complex samples at p: one 16-byte load for V = 2
template <int V>
__device__ __forceinline__ void load_x(const float2* p, float (&v)[2 * V]) {
  if constexpr (V == 2) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const float2 q = __ldg(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

// grid: one CTA per (tile, channel group), the groups of a tile neighbours.
// A tile is rows [ta * rows_t, +rows_t) and vector columns
// [tb * cols, +cols) of the [A, K / V] view, cols = 2^log2c.
template <int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
    mix_bank_kernel(const float2* __restrict__ x, long long ld,
                    const float* __restrict__ phase,
                    const float* __restrict__ hi,
                    const float* __restrict__ lo,
                    const float* __restrict__ step,
                    float* __restrict__ new_phase, float2* __restrict__ y,
                    int channels, int rows, int log2k, int log2c,
                    int col_tiles, int groups) {
  const int g = static_cast<int>(blockIdx.x % groups);
  const int tile = static_cast<int>(blockIdx.x / groups);
  const int c0 = g * kGroup;
  const int c1 = min(channels, c0 + kGroup);
  if (tile == 0 && static_cast<int>(threadIdx.x) < c1 - c0) {
    const int c = c0 + threadIdx.x;
    new_phase[c] = wrap_2pi(phase[c] + step[c]);
  }
  const int k = 1 << log2k;
  const long long n = static_cast<long long>(rows) << log2k;
  const int rows_t = (kThreads * kVecs) >> log2c;
  const int a0 = (tile / col_tiles) * rows_t;
  const int v0 = (tile % col_tiles) << log2c;
  int a[kVecs], b[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = threadIdx.x + j * kThreads;
    a[j] = a0 + (e >> log2c);
    b[j] = (v0 + (e & ((1 << log2c) - 1))) * V;
  }
  float xv[kVecs][2 * V];
  if constexpr (!kRows) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (a[j] < rows)
        load_x<V>(x + ((static_cast<long long>(a[j]) << log2k) + b[j]),
                  xv[j]);
  }
  for (int c = c0; c < c1; ++c) {
    const float p = phase[c];
    const float* hic = hi + static_cast<long long>(c) * rows;
    const float* loc = lo + static_cast<long long>(c) * k;
    float2* yc = y + c * n;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (a[j] >= rows) continue;
      const long long i = (static_cast<long long>(a[j]) << log2k) + b[j];
      if constexpr (kRows) load_x<V>(x + (c * ld + i), xv[j]);
      const float ph = p + __ldg(hic + a[j]);
      float l[V];
      if constexpr (V == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(loc + b[j]));
        l[0] = q.x;
        l[1] = q.y;
      } else {
        l[0] = __ldg(loc + b[j]);
      }
      float out[2 * V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float sn, cs;
        sincosf(wrap_2pi(ph + l[v]), &sn, &cs);
        const float xr = xv[j][2 * v], xi = xv[j][2 * v + 1];
        out[2 * v] = xr * cs - xi * sn;
        out[2 * v + 1] = xr * sn + xi * cs;
      }
      if constexpr (V == 2)
        __stcs(reinterpret_cast<float4*>(yc + i),
               make_float4(out[0], out[1], out[2], out[3]));
      else
        __stcs(yc + i, make_float2(out[0], out[1]));
    }
  }
}

template <int V, bool kRows>
int launch(const float2* x, long long ld, const float* phase,
           const float* hi, const float* lo, const float* step,
           float* new_phase, float2* y, int channels, int rows, int log2k,
           cudaStream_t stream) {
  const int log2v = log2k - (V == 2 ? 1 : 0);  // K / V vectors a row
  const int log2c = log2v < kMaxLog2Cols ? log2v : kMaxLog2Cols;
  const int rows_t = (kThreads * kVecs) >> log2c;
  const long long col_tiles = 1ll << (log2v - log2c);
  const long long row_tiles = (rows + rows_t - 1) / rows_t;
  const long long groups = (channels + kGroup - 1) / kGroup;
  const long long blocks = row_tiles * col_tiles * groups;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  mix_bank_kernel<V, kRows><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      x, ld, phase, hi, lo, step, new_phase, y, channels, rows, log2k, log2c,
      static_cast<int>(col_tiles), static_cast<int>(groups));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x complex64: [n] shared (ld = 0) or rows of n samples ld samples apart;
// phase, step, new_phase float32 [channels]; hi float32 [channels, rows];
// lo float32 [channels, k]; y complex64 [channels, n], n = rows * k, k a
// power of 2. Contiguous tables; y 16-byte aligned.
int mix_bank(const float2* x, long long ld, const float* phase,
             const float* hi, const float* lo, const float* step,
             float* new_phase, float2* y, int channels, int rows, int k,
             void* stream) {
  if (channels < 1 || rows < 1 || k < 1 || (k & (k - 1)) || ld < 0 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log2k = __builtin_ctz(static_cast<unsigned>(k));
  // vectors of two samples where n is even and every row of x is 16-byte
  // aligned
  const bool pairs = log2k >= 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     ld % 2 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (pairs)
    return ld ? launch<2, true>(x, ld, phase, hi, lo, step, new_phase, y,
                                channels, rows, log2k, s)
              : launch<2, false>(x, ld, phase, hi, lo, step, new_phase, y,
                                 channels, rows, log2k, s);
  return ld ? launch<1, true>(x, ld, phase, hi, lo, step, new_phase, y,
                              channels, rows, log2k, s)
            : launch<1, false>(x, ld, phase, hi, lo, step, new_phase, y,
                               channels, rows, log2k, s);
}

}  // extern "C"
