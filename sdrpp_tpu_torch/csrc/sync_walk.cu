// The three sequential synchronisation walks of the ATV and DAB OFDM
// decoders, for Hopper: one launch per block each.
//
// They replace XLA-lowered lax.scans of the JAX package (not Pallas
// kernels):
//   line_sync_walk     sdrpp_tpu/decoders/atv.py:97-127, LineSync's scan
//                      over lines;
//   chroma_burst_walk  sdrpp_tpu/decoders/atv.py:178-203, ChromaPLL's scan
//                      over lines with the inner scan over each line's
//                      28-sample colour burst;
//   cyclic_sync_walk   sdrpp_tpu/ops/ofdm.py:109-126, CyclicSync's scan over
//                      every sample.
// A Python loop of torch operations would cost tens of launches a line or
// a sample; each walk here is one CTA whose loop is the chain.
//
// What bounds them on an H100: the chain, not bytes or operations. Each
// line (LineSync), burst sample (ChromaPLL) or sample (CyclicSync) depends
// on the carry of the one before, so a block is one dependent sequence.
// The designs keep everything else off that chain:
// - LineSync: 736 threads compute a line's 720 interpolated samples at
//   once (the 8-tap windows from device memory, the 128 x 8 bank from
//   shared memory), warp 0 sums the two 44-sample sync regions with a
//   fixed shuffle tree, and lane 0 updates pos / freq / locked. Two
//   barriers a line.
// - ChromaPLL: the free-run segments before and after the burst are
//   parallel mixes done outside (torch operations on the phases this walk
//   records); lane 0 walks only the burst's phase and frequency carry,
//   its loads independent of the chain.
// - CyclicSync: lane 0 walks the peak / since / average carry and records
//   each emit's sample index; warps 1.. stage the next tile of the
//   correlation and the delayed samples in shared memory meanwhile. The
//   symbols are gathered afterwards in parallel from the samples (an
//   emitted symbol is always the last symbol_samps samples up to its emit,
//   since a peak restarts the count). The walker also keeps the carried
//   symbol buffer, one store a sample, so the state equals the JAX
//   scan's.
//
// Numerics: built with --fmad=false and no fast math, so every product and
// sum rounds once. LineSync and CyclicSync use only + - * / floor and
// comparisons, in the order of their plain PyTorch versions
// (ops/sync_walks.py), and match them bit for bit. ChromaPLL calls cosf,
// sinf and atan2f, which differ from the host's by ulps: it is held to its
// plain version at a tolerance.
//
// C ABI (bound with ctypes): each entry returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments it refuses, before
// launching). Carried state is read from and written to device memory, so
// a block needs no host synchronisation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- LineSync
constexpr int kLineLen = 720;
constexpr int kTaps = 8;
constexpr int kPhases = 128;
constexpr int kLineThreads = 736;  // 23 warps: one thread a line sample
constexpr int kSyncLen = 44;       // samples of each sync half

// The sum of v[0..43] in the plain version's tree: v zero-padded to 64,
// s[i] = v[i] + v[i + 32], then halves added pairwise down to lane 0.
__device__ __forceinline__ float tree44(float a, float b) {
  float s = a + b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = s + __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(kLineThreads, 1)
line_sync_kernel(const float* __restrict__ buf, int n,
                 const float* __restrict__ bank,
                 const float* __restrict__ carry_in,
                 const bool* __restrict__ locked_in,
                 float* __restrict__ carry_out, bool* __restrict__ locked_out,
                 float* __restrict__ lines, int* __restrict__ count,
                 int max_lines, float omega_gain, float mu_gain,
                 float min_freq, float max_freq, float sync_level,
                 float sync_bias) {
  __shared__ float sbank[kPhases * kTaps];
  __shared__ float sline[kLineLen];
  __shared__ float s_pos, s_freq;
  __shared__ int s_locked;
  const int tid = threadIdx.x;
  for (int i = tid; i < kPhases * kTaps; i += blockDim.x) sbank[i] = bank[i];
  if (tid == 0) {
    s_pos = carry_in[0];
    s_freq = carry_in[1];
    s_locked = locked_in[0] ? 1 : 0;
  }
  __syncthreads();
  const float fn = static_cast<float>(n);
  int l = 0;
  for (; l < max_lines; ++l) {
    const float pos = s_pos, freq = s_freq;
    if (!(pos + 720.0f * freq < fn)) break;  // the same for every thread
    if (tid < kLineLen) {
      const float p = pos + static_cast<float>(tid) * freq;
      const float fp = floorf(p);
      const float mu = p - fp;
      const int ph = min(max(static_cast<int>(mu * 128.0f), 0), kPhases - 1);
      const int base = min(max(static_cast<int>(fp), 0), n - 1);
      const float* w = buf + base;
      const float* b = sbank + ph * kTaps;
      float acc = w[0] * b[0];
#pragma unroll
      for (int j = 1; j < kTaps; ++j) acc = acc + w[j] * b[j];
      sline[tid] = acc;
      lines[static_cast<size_t>(l) * kLineLen + tid] = acc;
    }
    __syncthreads();
    if (tid < 32) {
      // left: line[703..719] then line[0..26]; right: line[27..70]
      const int lane = tid;
      const float la = lane < 17 ? sline[703 + lane] : sline[lane - 17];
      const float lb = lane + 32 < kSyncLen ? sline[lane + 15] : 0.0f;
      const float ra = sline[27 + lane];
      const float rb = lane + 32 < kSyncLen ? sline[59 + lane] : 0.0f;
      const float sl = tree44(la, lb);
      const float sr = tree44(ra, rb);
      if (lane == 0) {
        const float left = sl / 44.0f, right = sr / 44.0f;
        const bool ok = (left < sync_level) && (right < sync_level);
        const float err = ok ? (left + sync_bias) - right : 0.0f;
        const float nf =
            fminf(fmaxf(freq + omega_gain * err, min_freq), max_freq);
        s_pos = ((pos + 719.0f * freq) + nf) + mu_gain * err;
        s_freq = nf;
        s_locked = ok ? 1 : 0;
      }
    }
    __syncthreads();
  }
  const size_t total = static_cast<size_t>(max_lines) * kLineLen;
  for (size_t i = static_cast<size_t>(l) * kLineLen + tid; i < total;
       i += blockDim.x)
    lines[i] = 0.0f;
  if (tid == 0) {
    carry_out[0] = s_pos;
    carry_out[1] = s_freq;
    locked_out[0] = s_locked != 0;
    count[0] = l;
  }
}

// --------------------------------------------------------------- ChromaPLL
constexpr float kPi = 3.1415926535f;  // FL_PI
constexpr float kTwoPi = 2.0f * kPi;

__device__ __forceinline__ float normalize_phase(float d) {
  d = d > kPi ? d - kTwoPi : d;
  d = d <= -kPi ? d + kTwoPi : d;
  return d;
}

// jnp.mod / torch.remainder: the sign of the divisor
__device__ __forceinline__ float py_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((y < 0.0f) != (r < 0.0f))) r = r + y;
  return r;
}

__global__ void __launch_bounds__(32, 1)
chroma_burst_kernel(const float2* __restrict__ burst, int L, int nb,
                    const float* __restrict__ ref_phases,
                    const float* __restrict__ carry_in,
                    float* __restrict__ carry_out,
                    float* __restrict__ line_phase,
                    float2* __restrict__ burst_out, int pre_len,
                    int post_len, float alpha, float beta, float min_freq,
                    float max_freq) {
  if (threadIdx.x != 0) return;
  float phase = carry_in[0], freq = carry_in[1];
  for (int l = 0; l < L; ++l) {
    line_phase[4 * l + 0] = phase;
    line_phase[4 * l + 1] = freq;
    float ph = pre_len > 0
                   ? (phase + static_cast<float>(pre_len - 1) * freq) + freq
                   : phase;
    float fr = freq;
    const float ref = ref_phases[l];
    const float2* v = burst + static_cast<size_t>(l) * nb;
    float2* out = burst_out + static_cast<size_t>(l) * nb;
    for (int j = 0; j < nb; ++j) {
      const float2 x = v[j];
      const float c = cosf(-ph), s = sinf(-ph);
      const float ore = x.x * c - x.y * s;
      const float oim = x.x * s + x.y * c;
      out[j] = make_float2(ore, oim);
      const float err = normalize_phase(atan2f(oim, ore) - ref);
      fr = fminf(fmaxf(fr + beta * err, min_freq), max_freq);
      ph = (ph + fr) + alpha * err;
      ph = normalize_phase(py_mod(ph + kPi, kTwoPi) - kPi);
    }
    line_phase[4 * l + 2] = ph;
    line_phase[4 * l + 3] = fr;
    const float p3 =
        post_len > 0 ? (ph + static_cast<float>(post_len - 1) * fr) + fr : ph;
    phase = normalize_phase(py_mod(p3 + kPi, kTwoPi) - kPi);
    freq = fr;
  }
  carry_out[0] = phase;
  carry_out[1] = freq;
}

// -------------------------------------------------------------- CyclicSync
constexpr int kSyncThreads = 256;  // warp 0 walks, warps 1-7 stage tiles
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kSyncThreads, 1)
cyclic_sync_kernel(const float* __restrict__ rcorr,
                   const float2* __restrict__ vals, int n,
                   const float* __restrict__ carry_in,
                   const int* __restrict__ since_in,
                   const float2* __restrict__ symbuf_in, int sym, float agc,
                   float agc_inv, float* __restrict__ carry_out,
                   int* __restrict__ since_out,
                   float2* __restrict__ symbuf_out, int* __restrict__ emits,
                   int max_syms, int* __restrict__ count) {
  __shared__ float rt[2][kTile];
  __shared__ float2 vt[2][kTile];
  const int tid = threadIdx.x;
  for (int i = tid; i < sym; i += blockDim.x) symbuf_out[i] = symbuf_in[i];
  for (int i = tid; i < kTile && i < n; i += blockDim.x) {
    rt[0][i] = rcorr[i];
    vt[0][i] = vals[i];
  }
  __syncthreads();
  float avg = carry_in[0], peak = carry_in[1], last = carry_in[2];
  int since = since_in[0], cnt = 0;
  const int tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const int base = t * kTile;
    if (tid == 0) {
      const int len = min(kTile, n - base);
      for (int k = 0; k < len; ++k) {
        const float rc = rt[cur][k];
        const bool is_peak = (rc > avg) && (rc > peak);
        peak = is_peak ? rc : peak;
        since = is_peak ? 0 : since;
        symbuf_out[min(max(since, 0), sym - 1)] = vt[cur][k];
        since = since + 1;
        if (since >= sym) {
          if (cnt < max_syms) emits[cnt] = base + k;
          ++cnt;
          since = 0;
          peak = 0.0f;
        }
        avg = agc * rc + agc_inv * avg;
        last = rc;
      }
    } else if (tid >= 32 && t + 1 < tiles) {
      const int nbase = base + kTile;
      const int len = min(kTile, n - nbase);
      for (int i = tid - 32; i < len; i += kSyncThreads - 32) {
        rt[cur ^ 1][i] = rcorr[nbase + i];
        vt[cur ^ 1][i] = vals[nbase + i];
      }
    }
    __syncthreads();
  }
  __shared__ int s_cnt;
  if (tid == 0) {
    carry_out[0] = avg;
    carry_out[1] = peak;
    carry_out[2] = last;
    since_out[0] = since;
    s_cnt = min(cnt, max_syms);
    count[0] = s_cnt;
  }
  __syncthreads();
  for (int i = s_cnt + tid; i < max_syms; i += blockDim.x) emits[i] = -1;
}

}  // namespace

extern "C" {

// LineSync over one block: buf = [tail(7) | x] float32 [n + 7]; bank
// [128, 8]; carry_in / carry_out float32 [2] (pos, freq), locked bool [1];
// lines [max_lines, 720] float32 (rows past the count are 0); count int32.
int line_sync_walk(const float* buf, int n, const float* bank,
                   const float* carry_in, const bool* locked_in,
                   float* carry_out, bool* locked_out, float* lines,
                   int* count, int max_lines, float omega_gain, float mu_gain,
                   float min_freq, float max_freq, float sync_level,
                   float sync_bias, void* stream) {
  if (n < 1 || max_lines < 1) return static_cast<int>(cudaErrorInvalidValue);
  line_sync_kernel<<<1, kLineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, n, bank, carry_in, locked_in, carry_out, locked_out, lines, count,
      max_lines, omega_gain, mu_gain, min_freq, max_freq, sync_level,
      sync_bias);
  return static_cast<int>(cudaGetLastError());
}

// ChromaPLL's burst carry over L lines: burst [L, nb] complex64 (the
// lines' samples [pre_len, pre_len + nb)); ref_phases [L]; carry float32
// [2] (phase, freq); line_phase [L, 4] float32 receives each line's
// (phase, freq) before its pre-burst segment and (phase, freq) after its
// burst; burst_out [L, nb] complex64 the burst's mixed samples.
int chroma_burst_walk(const void* burst, int L, int nb,
                      const float* ref_phases, const float* carry_in,
                      float* carry_out, float* line_phase, void* burst_out,
                      int pre_len, int post_len, float alpha, float beta,
                      float min_freq, float max_freq, void* stream) {
  if (L < 0 || nb < 0 || pre_len < 0 || post_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  chroma_burst_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(burst), L, nb, ref_phases, carry_in,
      carry_out, line_phase, static_cast<float2*>(burst_out), pre_len,
      post_len, alpha, beta, min_freq, max_freq);
  return static_cast<int>(cudaGetLastError());
}

// CyclicSync's framing walk over one block: rcorr [n] float32, vals [n]
// complex64; carry float32 [3] (avg, peak, last), since int32 [1],
// symbuf [sym] complex64; emits [max_syms] int32 receives the emit
// samples (-1 past the count), count int32 [1] the emits (at most
// max_syms).
int cyclic_sync_walk(const float* rcorr, const void* vals, int n,
                     const float* carry_in, const int* since_in,
                     const void* symbuf_in, int sym, float agc, float agc_inv,
                     float* carry_out, int* since_out, void* symbuf_out,
                     int* emits, int max_syms, int* count, void* stream) {
  if (n < 1 || sym < 1 || max_syms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cyclic_sync_kernel<<<1, kSyncThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rcorr, static_cast<const float2*>(vals), n, carry_in, since_in,
      static_cast<const float2*>(symbuf_in), sym, agc, agc_inv, carry_out,
      since_out, static_cast<float2*>(symbuf_out), emits, max_syms, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
