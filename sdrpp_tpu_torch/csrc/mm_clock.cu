// Mueller-Mueller clock recovery over C independent streams, for Hopper.
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
// the whole block, and the valid symbols form a prefix of the output.
//
// Design: one thread per stream walks symbols while offset < n (and at
// most max_syms of them), keeps the loop and error state in registers and
// reads its input row [tail | block] from global memory (consecutive
// symbols read overlapping 8-sample windows, so the loads hit L1). The
// 128 x 8 bank (4 KB) sits in shared memory, loaded once per block.
//
// What bounds it on an H100: each symbol depends on the previous one
// through the offset (which sets the addresses of the next window) and the
// phase (which picks the bank row), so a stream runs one dependent chain
// per symbol: load latency plus the sequential 8-tap sums, the error and
// the loop arithmetic. It is latency-bound, not bandwidth- or FLOP-bound;
// more streams per launch would fill the card, this slice has one.
//
// Numerics: built with --fmad=false and no fast math, so every product
// and sum rounds once, in the order of the plain PyTorch version
// (ops/clock_recovery_kernels.mm_symbols_plain): taps summed from 0 to
// T-1 starting at 0.0f.
//
// C ABI (bound with ctypes): each entry returns cudaGetLastError() after
// the launch. `offset` [C] int32 and `fstate` [C, KF] float32 hold the
// carried state on entry and the next block's state on exit (offset
// relative to the next block). KF = 10 for complex streams
// (phase, freq, p1, p2, c1, c2 as re/im pairs), 3 for float streams
// (phase, freq, last).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float step_sign(float v) {
  return v > 0.0f ? 1.0f : -1.0f;
}

template <bool CPLX>
__global__ void mm_kernel(const float* __restrict__ xr,
                          const float* __restrict__ xi, int n, int C,
                          const float* __restrict__ bank, int P, int T,
                          int* __restrict__ offs, float* __restrict__ fst,
                          float* __restrict__ outr, float* __restrict__ outi,
                          unsigned char* __restrict__ valid, int max_syms,
                          float mu, float omega_gain, float min_freq,
                          float max_freq) {
  extern __shared__ float sbank[];
  for (int i = threadIdx.x; i < P * T; i += blockDim.x) sbank[i] = bank[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  constexpr int KF = CPLX ? 10 : 3;
  const size_t row = static_cast<size_t>(c) * (n + T - 1);
  const float* br = xr + row;
  const float* bi = CPLX ? xi + row : nullptr;
  float s[KF];
#pragma unroll
  for (int j = 0; j < KF; ++j) s[j] = fst[c * KF + j];
  int offset = offs[c];
  float phase = s[0], freq = s[1];
  const size_t orow = static_cast<size_t>(c) * max_syms;

  int k = 0;
  for (; k < max_syms && offset < n; ++k) {
    const int ph = min(max(static_cast<int>(floorf(phase * static_cast<float>(P))), 0),
                       P - 1);
    const int base = min(max(offset, 0), n - 1);
    const float* w = sbank + ph * T;
    float accr = 0.0f, acci = 0.0f;
#pragma unroll 8
    for (int j = 0; j < T; ++j) {
      accr = accr + br[base + j] * w[j];
      if (CPLX) acci = acci + bi[base + j] * w[j];
    }
    float err;
    if (CPLX) {
      // ((out - p2) * conj(c1) - (c0 - c2) * conj(p1)).real
      const float c0r = step_sign(accr), c0i = step_sign(acci);
      const float ar = accr - s[4], ai = acci - s[5];
      const float dr = c0r - s[8], di = c0i - s[9];
      err = (ar * s[6] + ai * s[7]) - (dr * s[2] + di * s[3]);
      // shift the error history: p2 = p1, p1 = out, c2 = c1, c1 = c0
      s[4] = s[2];
      s[5] = s[3];
      s[2] = accr;
      s[3] = acci;
      s[8] = s[6];
      s[9] = s[7];
      s[6] = c0r;
      s[7] = c0i;
    } else {
      const float last = s[2];
      err = step_sign(last) * accr - last * step_sign(accr);
      s[2] = accr;
    }
    err = fminf(fmaxf(err, -1.0f), 1.0f);
    freq = fminf(fmaxf(freq + omega_gain * err, min_freq), max_freq);
    const float np = (phase + freq) + mu * err;
    const float delta = floorf(np);
    offset += static_cast<int>(delta);
    phase = np - delta;
    outr[orow + k] = accr;
    if (CPLX) outi[orow + k] = acci;
    valid[orow + k] = 1;
  }
  for (; k < max_syms; ++k) {
    outr[orow + k] = 0.0f;
    if (CPLX) outi[orow + k] = 0.0f;
    valid[orow + k] = 0;
  }
  s[0] = phase;
  s[1] = freq;
  offs[c] = offset - n;
#pragma unroll
  for (int j = 0; j < KF; ++j) fst[c * KF + j] = s[j];
}

template <bool CPLX>
int launch(const float* xr, const float* xi, int n, int C, const float* bank,
           int P, int T, int* offs, float* fst, float* outr, float* outi,
           unsigned char* valid, int max_syms, float mu, float omega_gain,
           float min_freq, float max_freq, cudaStream_t stream) {
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  const int blocks = (C + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(P) * T * sizeof(float);
  mm_kernel<CPLX><<<blocks, threads, smem, stream>>>(
      xr, xi, n, C, bank, P, T, offs, fst, outr, outi, valid, max_syms, mu,
      omega_gain, min_freq, max_freq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Complex M&M: xr/xi = [C, n + T - 1] planes of [tail | block]; outr/outi
// and valid = [C, max_syms]; fstate [C, 10].
int mm_symbols_complex(const float* xr, const float* xi, int n, int C,
                       const float* bank, int P, int T, int* offset,
                       float* fstate, float* outr, float* outi,
                       unsigned char* valid, int max_syms, float mu,
                       float omega_gain, float min_freq, float max_freq,
                       void* stream) {
  return launch<true>(xr, xi, n, C, bank, P, T, offset, fstate, outr, outi,
                      valid, max_syms, mu, omega_gain, min_freq, max_freq,
                      static_cast<cudaStream_t>(stream));
}

// Float M&M: x = [C, n + T - 1]; out and valid = [C, max_syms];
// fstate [C, 3].
int mm_symbols_real(const float* x, const float* unused, int n, int C,
                    const float* bank, int P, int T, int* offset,
                    float* fstate, float* out, float* unused_out,
                    unsigned char* valid, int max_syms, float mu,
                    float omega_gain, float min_freq, float max_freq,
                    void* stream) {
  (void)unused;
  (void)unused_out;
  return launch<false>(x, nullptr, n, C, bank, P, T, offset, fstate, out,
                       nullptr, valid, max_syms, mu, omega_gain, min_freq,
                       max_freq, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
