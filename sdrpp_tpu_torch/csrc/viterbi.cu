// Batched Viterbi add-compare-select and survivor traceback for the
// K = 7 (64-state) convolutional codes, for Hopper.
//
// Replaces three Pallas kernels of the JAX package:
//   - sdrpp_tpu/ops/fec_pallas.py:51 viterbi_acs_pallas_batched
//     (pallas_call :112): B windows in lock-step, [B, T, R] soft bits ->
//     [B, T, 64] int8 decisions. Entry viterbi_acs_batched.
//   - sdrpp_tpu/ops/fec_pallas.py:221 viterbi_acs_pallas (pallas_call
//     :296), the single-stream ACS: the same entry with B = 1.
//   - sdrpp_tpu/ops/fec_pallas.py:132 viterbi_traceback_pallas_batched
//     (pallas_call :197): [B, T, 64] decisions -> [B, T] bits, walking back
//     from state 0. Entry viterbi_traceback_batched.
//
// ACS design: one warp per window. Lane l keeps the path metrics of states
// l and l + 32 in registers. The predecessors of next state n are n >> 1
// and (n >> 1) + 32, read from the owning lanes with four warp shuffles;
// the 0/1 expansion matmuls of the TPU kernel (fec_pallas.py:40-48) were a
// layout device of the TPU and are gone. The branch metrics
// sum_j |soft[t, j] - expected[r, j]| of the four registers a lane needs
// (n and n + 64 for its two states) are computed in the kernel; the
// per-step minimum is a warp shuffle reduction, with no shared memory and
// no block barrier. Each step writes one byte per state (two per lane,
// 32 neighbouring bytes per store across the warp).
//
// Traceback design: one thread per window walks t = T-1 .. 0 from state 0:
// bit = state & 1, then state = (state >> 1) + 32 * decision[t][state].
//
// What bounds them on an H100: the ACS is a dependent chain of T steps per
// window (about 30 instructions and 5 shuffle rounds each), so one window
// is latency-bound; throughput comes from running many windows (warps) at
// once, several per SM. The traceback is a pointer chase of T dependent
// byte loads per window, bound by load latency.
//
// Numerics: decisions and bits are bit-exact against the JAX kernels and
// the plain PyTorch versions: metrics start at 0 / 1e9, every candidate is
// one float32 add, the comparison is cand1 < cand0 (ties take the p0
// branch), and the minimum is subtracted each step; with integral soft
// bits every branch metric is exact. Built with --fmad=false.
//
// C ABI (bound with ctypes): each entry returns cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 64;        // states (K = 7)
constexpr int MAX_RATE = 4;  // soft bits per trellis step handled

__global__ void acs_kernel(const float* __restrict__ soft,
                           const float* __restrict__ expected,
                           signed char* __restrict__ dec, int B, int T,
                           int R) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= B) return;  // whole warps leave together
  const unsigned full = 0xffffffffu;

  // expected outputs of the four registers this lane needs:
  // [0] state lane via p0 (register lane), [1] state lane via p1
  // (register lane + 64), [2]/[3] the same for state lane + 32
  float e[4][MAX_RATE];
  const int regs[4] = {lane, lane + S, lane + 32, lane + 32 + S};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < MAX_RATE; ++j)
      e[q][j] = j < R ? expected[regs[q] * R + j] : 0.0f;

  float ma = lane == 0 ? 0.0f : 1e9f;  // metric of state lane
  float mb = 1e9f;                     // metric of state lane + 32
  const int src_a = lane >> 1, src_b = 16 + (lane >> 1);
  const float* sw = soft + static_cast<size_t>(w) * T * R;
  signed char* dw = dec + static_cast<size_t>(w) * T * S;

  for (int t = 0; t < T; ++t) {
    float s[MAX_RATE];
#pragma unroll
    for (int j = 0; j < MAX_RATE; ++j) s[j] = j < R ? sw[t * R + j] : 0.0f;
    float bm[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_RATE; ++j)
        if (j < R) acc = acc + fabsf(s[j] - e[q][j]);
      bm[q] = acc;
    }
    // predecessors: state lane <- (lane >> 1, lane >> 1 + 32);
    // state lane + 32 <- (16 + lane >> 1, 48 + lane >> 1)
    const float pa0 = __shfl_sync(full, ma, src_a);
    const float pa1 = __shfl_sync(full, mb, src_a);
    const float pb0 = __shfl_sync(full, ma, src_b);
    const float pb1 = __shfl_sync(full, mb, src_b);
    const float ca0 = pa0 + bm[0], ca1 = pa1 + bm[1];
    const float cb0 = pb0 + bm[2], cb1 = pb1 + bm[3];
    const bool ta = ca1 < ca0, tb = cb1 < cb0;
    float na = ta ? ca1 : ca0, nb = tb ? cb1 : cb0;
    float mn = fminf(na, nb);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mn = fminf(mn, __shfl_xor_sync(full, mn, o));
    ma = na - mn;
    mb = nb - mn;
    dw[t * S + lane] = ta ? 1 : 0;
    dw[t * S + lane + 32] = tb ? 1 : 0;
  }
}

__global__ void traceback_kernel(const signed char* __restrict__ dec,
                                 unsigned char* __restrict__ bits, int B,
                                 int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const signed char* d = dec + static_cast<size_t>(b) * T * S;
  unsigned char* out = bits + static_cast<size_t>(b) * T;
  int s = 0;
  for (int t = T - 1; t >= 0; --t) {
    out[t] = static_cast<unsigned char>(s & 1);
    s = (s >> 1) + (d[static_cast<size_t>(t) * S + s] != 0 ? S / 2 : 0);
  }
}

}  // namespace

extern "C" {

// soft [B, T, R] float32, expected [2 * 64, R] float32 (register outputs
// times 255), dec [B, T, 64] int8; R <= 4.
int viterbi_acs_batched(const float* soft, const float* expected,
                        signed char* dec, int B, int T, int R, void* stream) {
  if (R < 1 || R > MAX_RATE) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = 4;
  const int blocks = (B + kWarps - 1) / kWarps;
  acs_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      soft, expected, dec, B, T, R);
  return static_cast<int>(cudaGetLastError());
}

// dec [B, T, 64] int8 -> bits [B, T] uint8 (the state's low bit per step).
int viterbi_traceback_batched(const signed char* dec, unsigned char* bits,
                              int B, int T, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (B + kThreads - 1) / kThreads;
  traceback_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(dec, bits, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
