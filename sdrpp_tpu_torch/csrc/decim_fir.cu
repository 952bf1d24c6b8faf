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
// provided every input byte comes from device memory once and the loads
// never wait for the sums.
//
// Design: persistent CTAs, as many as fit on the SMs (six per SM at the
// /256 stage), walk over output tiles (one row, OPB consecutive outputs
// each). A tile's input span, r*(OPB-1) + m samples, is copied into
// shared memory with cp.async (8-byte granules for complex, 4 for float),
// straight into a phase-major layout: element i of the span goes to
// buf[(i % r) * LP + i / r], LP odd. Output q of the tile then reads
// buf[(j % r) * LP + q + j / r] for tap j: neighbouring threads read
// neighbouring elements for every tap, and the copies' phase-major writes
// are free of bank conflicts too. For a tile inside the block with r a
// power of 2 dividing OPB (every decimator stage but r = 128), each thread
// keeps one phase row, so a copy costs an add of its source and its
// destination; the first tile of a row, the last, and r = 128 take the
// general per-sample form. One buffer per CTA: the CTAs on an SM overlap
// one another's copies and sums. (A second buffer per CTA, so a CTA's own
// next copies overlap its sums, measured slower at /256 on the H100: it
// halves the CTAs that fit, and with them the loads in flight.)
//
// Each thread sums one output's planes over j = 0..m-1, in that order,
// from 0.0f, column by column (tap j = c * r + p is phase row p, column
// q + c), eight phases at a time: eight independent loads, then the
// products and the sums in order, with the eight taps read as two float4
// broadcasts from a shared [column][r rounded up to 8] table. The phase
// rows' length LP is a compile-time 135 for every stage with OPB = 128 and
// (m - 1) / r <= 6 (all the plan's stages with r <= 32), so a group's
// eight loads take immediate offsets from one address; other shapes
// (r = 128) compute LP at run time. __launch_bounds__(128, 1) lets the
// compiler keep more loads in flight (70-79 registers, occupancy unchanged:
// shared memory bounds it). Built with --fmad=false, every product and sum
// rounds once, as in the plain PyTorch version
// (ops/fir_kernels.decimating_fir_plain). OPB is the largest multiple of
// 32 up to 128 whose buffer fits a 113 KB budget: 128 at r <= 32, 96 at
// the /128 stage's r = 128, m = 726. The CTA that takes a row's tile 0
// also writes the row's new tail, which handles n < m - 1 (tail samples
// survive).
//
// Host side: the dynamic shared-memory attribute is set once per device
// and kernel, and the grid size (occupancy times SMs) is cached per
// (device, kernel, OPB, bytes), so a launch makes no driver call but the
// launch itself.
//
// C ABI (called through its address by decim_fir of kernels_host.cpp, the
// compiled host path): each entry returns cudaGetLastError() after the
// launch. Row counts and lengths are 64-bit; offsets are computed in 64
// bits inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOPB = 128;
constexpr size_t kSmemBudget = 113 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxDevices = 64;
// the phase-row length every plan stage with r <= 32 fits at OPB = 128
// ((m - 1) / r <= 6), fixed at compile time
constexpr int kFixedLP = 135;

template <int NC>
struct Sample;
template <>
struct Sample<1> {
  using T = float;
};
template <>
struct Sample<2> {
  using T = float2;
};

// phase-plane row length: the span's r*(OPB-1) + m samples, odd
__host__ __device__ inline int plane_len(int opb, int m, int r) {
  const int lp = opb + (m - 1) / r;
  return lp | 1;
}

// the taps as a [ceil(m / r)][rp] table, rp = r rounded up to 8 (tap
// j = t * r + p at t * rp + p, zeros between), then the buffer of r * LP
// samples
__host__ __device__ inline int taps_row(int r) { return (r + 7) & ~7; }

__host__ __device__ inline size_t taps_bytes(int m, int r) {
  return static_cast<size_t>((m + r - 1) / r) * taps_row(r) * sizeof(float);
}

inline size_t smem_bytes(int m, int r, int lp, int nc) {
  return taps_bytes(m, r) + static_cast<size_t>(r) * lp * nc *
                                sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// LPC > 0: the phase rows' length is LPC, a compile-time constant, so a
// group's eight loads take immediate offsets from one address; 0: lp is
// computed at run time
template <int NC, int LPC>
__global__ void __launch_bounds__(kMaxOPB, 1)
decim_fir_kernel(const typename Sample<NC>::T* __restrict__ tail,
                 const typename Sample<NC>::T* __restrict__ x,
                 const float* __restrict__ taps,
                 typename Sample<NC>::T* __restrict__ new_tail,
                 typename Sample<NC>::T* __restrict__ y, long long n, int m,
                 int r, int lp_run, long long tiles_per_row, long long total) {
  using T = typename Sample<NC>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* staps = reinterpret_cast<float*>(smem_raw);
  T* bufs = reinterpret_cast<T*>(smem_raw + taps_bytes(m, r));
  const int opb = blockDim.x;
  const int lp = LPC ? LPC : lp_run;
  const int span = r * lp;
  const long long h = m - 1;  // tail length
  const long long n_out = n / r;
  const bool pow2 = (r & (r - 1)) == 0;
  const int shift = __ffs(r) - 1;
  const int rp = taps_row(r);
  const bool fast = pow2 && opb % r == 0;

  for (int i = threadIdx.x; i < (m + r - 1) / r * rp; i += opb) {
    const int t = i / rp, p = i - t * rp, j = t * r + p;
    staps[i] = p < r && j < m ? taps[j] : 0.0f;
  }

  // copy tile t's span into the buffer, phase-major; samples past the
  // block are zeros
  auto issue = [&](long long t) {
    const long long row = t / tiles_per_row;
    const long long g0 = (t - row * tiles_per_row) * opb * r;
    const T* trow = tail + row * h;
    const T* xrow = x + row * n;
    T* dst = bufs;
    if (fast && g0 >= h && g0 + span <= h + n) {
      // inside the block, r dividing OPB: each thread keeps its phase row,
      // and its column steps by OPB / r
      const T* src = xrow + (g0 - h) + threadIdx.x;
      const int step = opb >> shift;
      int at = (threadIdx.x & (r - 1)) * lp + (threadIdx.x >> shift);
      for (int i = threadIdx.x; i < span; i += opb, src += opb, at += step)
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                         smem_addr(dst + at)),
                     "l"(src), "n"(sizeof(T))
                     : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
      return;
    }
    for (int i = threadIdx.x; i < span; i += opb) {
      const int at = pow2 ? (i & (r - 1)) * lp + (i >> shift)
                          : (i % r) * lp + i / r;
      const long long g = g0 + i;
      const T* src = g < h ? trow + g : (g - h < n ? xrow + (g - h) : nullptr);
      if (src) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                         smem_addr(dst + at)),
                     "l"(src), "n"(sizeof(T))
                     : "memory");
      } else {
        dst[at] = T{};
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    issue(t);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // tile t's span (and the taps) visible to all

    const long long row = t / tiles_per_row;
    const long long blk = t - row * tiles_per_row;
    if (blk == 0) {  // the row's new tail: buf[n + k], k < m - 1
      const T* trow = tail + row * h;
      const T* xrow = x + row * n;
      T* nt = new_tail + row * h;
      for (long long k = threadIdx.x; k < h; k += opb) {
        const long long g = n + k;
        nt[k] = g < h ? trow[g] : xrow[g - h];
      }
    }
    const int q = threadIdx.x;
    const long long o = blk * opb + q;
    if (o < n_out) {
      // tap j = c * r + p reads phase row p, column q + c: columns outer,
      // phases inner, j ascending; 8 phases at a time with their taps as
      // two float4 from the padded [column][rp] tap table
      const T* col = bufs + q;
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int c = 0, j = 0; j < m; ++c, ++col) {
        const int pe = min(r, m - j);
        const float* w = staps + c * rp;
        int p = 0;
        for (const T* g8 = col; p + 8 <= pe; p += 8, g8 += 8 * lp) {
          const float4 wa = *reinterpret_cast<const float4*>(w + p);
          const float4 wb = *reinterpret_cast<const float4*>(w + p + 4);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          T v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = g8[u * lp];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if constexpr (NC == 2) {
              acc0 = acc0 + wv[u] * v[u].x;
              acc1 = acc1 + wv[u] * v[u].y;
            } else {
              acc0 = acc0 + wv[u] * v[u];
            }
          }
        }
        for (; p < pe; ++p) {
          const T v = col[p * lp];
          if constexpr (NC == 2) {
            acc0 = acc0 + w[p] * v.x;
            acc1 = acc1 + w[p] * v.y;
          } else {
            acc0 = acc0 + w[p] * v;
          }
        }
        j += pe;
      }
      if constexpr (NC == 2) {
        y[row * n_out + o] = make_float2(acc0, acc1);
      } else {
        y[row * n_out + o] = acc0;
      }
    }
    __syncthreads();  // the buffer is refilled by the next tile's copies
  }
}

// per-device launch facts, looked up once
struct GridEntry {
  int dev, nc, lpc, opb;
  size_t smem;
  int blocks;  // resident CTAs on the whole card
};
GridEntry g_grid[64];
int g_grid_used = 0;

template <int NC, int LPC>
int run(const void* tail, const void* x, const float* taps, void* new_tail,
        void* y, long long n, int m, int r, int opb, int lp, size_t smem,
        long long tiles_per_row, long long total, cudaStream_t stream) {
  using T = typename Sample<NC>::T;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the attribute is per device and kernel: set it once on each
  static bool attr_set[kMaxDevices] = {};
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(decim_fir_kernel<NC, LPC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  int resident = 0;
  for (int i = 0; i < g_grid_used && !resident; ++i) {
    const GridEntry& e = g_grid[i];
    if (e.dev == dev && e.nc == NC && e.lpc == LPC && e.opb == opb &&
        e.smem == smem)
      resident = e.blocks;
  }
  if (!resident) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decim_fir_kernel<NC, LPC>, opb, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = (per_sm > 0 ? per_sm : 1) * sms;
    if (g_grid_used < 64)
      g_grid[g_grid_used++] = {dev, NC, LPC, opb, smem, resident};
  }
  const long long grid = total < resident ? total : resident;
  decim_fir_kernel<NC, LPC>
      <<<static_cast<unsigned>(grid), opb, smem, stream>>>(
          static_cast<const T*>(tail), static_cast<const T*>(x), taps,
          static_cast<T*>(new_tail), static_cast<T*>(y), n, m, r, lp,
          tiles_per_row, total);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch(const void* tail, const void* x, const float* taps, void* new_tail,
           void* y, long long rows, long long n, int m, int r,
           cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || m < 1 || r < 1 || n % r)
    return static_cast<int>(cudaErrorInvalidValue);
  int opb = kMaxOPB;
  while (opb > 32 && smem_bytes(m, r, plane_len(opb, m, r), NC) > kSmemBudget)
    opb -= 32;
  int lp = plane_len(opb, m, r);
  const bool fixed = opb == kMaxOPB && lp <= kFixedLP;
  if (fixed) lp = kFixedLP;
  const size_t smem = smem_bytes(m, r, lp, NC);
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_out = n / r;
  const long long tiles_per_row = (n_out + opb - 1) / opb;
  const long long total = rows * tiles_per_row;
  return fixed ? run<NC, kFixedLP>(tail, x, taps, new_tail, y, n, m, r, opb,
                                   lp, smem, tiles_per_row, total, stream)
               : run<NC, 0>(tail, x, taps, new_tail, y, n, m, r, opb, lp,
                            smem, tiles_per_row, total, stream);
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
