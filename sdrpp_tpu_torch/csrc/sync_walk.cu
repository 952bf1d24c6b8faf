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
//   records); inside the burst lane 0 walks only the phase and frequency
//   carry, from angles the other warps take beforehand; they also mix the
//   outputs afterwards from the phases it records (chroma_burst_kernel).
// - CyclicSync: the average, the peak / count machine and the symbol
//   buffer are three passes on three warps a tile apart, the walker's
//   words of 32 samples a prefix maximum over the lanes, so the
//   average's own chain sets the pace (cyclic_sync_kernel). The
//   symbols are gathered afterwards in parallel from the samples (an
//   emitted symbol is always the last symbol_samps samples up to its emit,
//   since a peak restarts the count); the carried buffer equals the JAX
//   scan's.
//
// Numerics: built with --fmad=false and no fast math, so every product and
// sum rounds once. LineSync and CyclicSync use only + - * / floor and
// comparisons, in the order of their plain PyTorch versions
// (ops/sync_walks.py), and match them bit for bit. ChromaPLL calls
// sincosf and atan2f, which differ from the host's cos / sin / arctan2 by
// ulps, and takes the mixed sample's angle as a difference of angles: it
// is held to its plain version at a tolerance.
//
// C ABI (bound with ctypes): each entry returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments it refuses, before
// launching). Carried state is read from and written to device memory, so
// a block needs no host synchronisation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Time stamps for tools/sync_walk_probe.cu, which includes this file with
// them defined (each role's clock64() cycles a round); empty here.
#ifndef WALK_ROUND
#define WALK_ROUND()
#define WALK_DONE(slot)
#endif

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
constexpr int kBurstThreads = 128;    // lane 0 walks, warps 1-3 stage
constexpr int kBurstTile = 1024;      // burst samples staged a round

// The plain version's two conditional steps (d > pi: -2 pi; then d <= -pi:
// +2 pi) with both tests on d: after the first, d - 2 pi > -pi (exact by
// Sterbenz's lemma for d in (pi, 4 pi], and above it too), so the second
// never fires on its result and the two selects can share one input.
__device__ __forceinline__ float normalize_phase(float d) {
  return d > kPi ? d - kTwoPi : (d <= -kPi ? d + kTwoPi : d);
}

// jnp.mod / torch.remainder: the sign of the divisor
__device__ __forceinline__ float py_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((y < 0.0f) != (r < 0.0f))) r = r + y;
  return r;
}

// normalize(py_mod(ph + pi, 2 pi) - pi), the plain version's phase wrap,
// with fmodf (a software loop) only outside (-2 pi, 4 pi). Inside, t =
// fl(ph + pi) gives py_mod(t, 2 pi) bit for bit without it:
// - t in [0, 2 pi): fmodf(t) = t, no sign fix (also t = -0: fmodf keeps
//   -0, and -0 < 0 is false here too);
// - t in [2 pi, 4 pi): fmodf(t) = t - 2 pi exactly (quotient 1), and
//   fl(t - 2 pi) is exact by Sterbenz's lemma (2 pi <= t <= 2 * 2 pi);
// - t in (-2 pi, 0): fmodf(t) = t (|t| < 2 pi), then the sign fix adds
//   2 pi: the same fl(t + 2 pi).
// (kTwoPi and 2 * kTwoPi are exact doublings of kPi.) kInside: the caller
// knows t is inside (short_wrap below), and the test and its branch go.
template <bool kInside>
__device__ __forceinline__ float wrap_phase(float ph) {
  const float t = ph + kPi;
  float r = t >= kTwoPi ? t - kTwoPi : (t < 0.0f ? t + kTwoPi : t);
  if (!kInside && !(t > -kTwoPi && t < 2.0f * kTwoPi)) r = py_mod(t, kTwoPi);
  return normalize_phase(r - kPi);
}

// Whether every burst step of a line after its first lands inside (-2 pi,
// 4 pi): such a step starts from ph in (-pi, pi] (a wrapped phase) and
// adds fr, clamped into [min(min_freq, max_freq), max_freq], and alpha *
// err, where err = normalize(g - ref) with g in [-pi, pi] is within
// [-pi, pi] when |ref| <= 2 pi; so t lies in (lo - |alpha| pi, 2 pi +
// max_freq + |alpha| pi] before rounding, and 1e-3 covers the roundings
// (a few ulps of 4 pi). True for the decoders' limits and reference
// phases (|fr| <= pi, |ref| <= pi, alpha < 1); NaN gives false.
__device__ __forceinline__ bool short_wrap(float alpha, float min_freq,
                                           float max_freq, float ref) {
  const float a = fabsf(alpha) * kPi;
  return fminf(min_freq, max_freq) - a > 1e-3f - kTwoPi &&
         max_freq + a < kTwoPi - 1e-3f && fabsf(ref) <= kTwoPi;
}

__device__ __forceinline__ float2 mix(float2 x, float ph) {
  float s, c;
  sincosf(-ph, &s, &c);
  return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
}

// One burst step's loop update from the mixed sample's angle g.
template <bool kInside = false>
__device__ __forceinline__ void burst_step(float g, float ref, float& ph,
                                           float& fr, float alpha,
                                           float beta, float min_freq,
                                           float max_freq) {
  const float err = normalize_phase(g - ref);
  fr = fminf(fmaxf(fr + beta * err, min_freq), max_freq);
  ph = wrap_phase<kInside>((ph + fr) + alpha * err);
}

// A staged line's steps after its first: ph in (-pi, pi], so the mixed
// sample's angle is normalize(angle(x) - ph); `used` records the phase
// each step mixes with.
template <bool kInside>
__device__ __forceinline__ void burst_rest(const float* __restrict__ a,
                                           float* __restrict__ used, int nb,
                                           float ref, float& ph, float& fr,
                                           float alpha, float beta,
                                           float min_freq, float max_freq) {
  float next = nb > 1 ? a[1] : 0.0f;  // each angle loaded a step ahead
  for (int j = 1; j < nb; ++j) {
    const float aj = next;
    if (j + 1 < nb) next = a[j + 1];
    used[j] = ph;
    burst_step<kInside>(normalize_phase(aj - ph), ref, ph, fr, alpha, beta,
                        min_freq, max_freq);
  }
}

// ChromaPLL over L lines, one CTA: lane 0 walks the lines' burst steps in
// order; warps 1-3 stage the next tile of bursts in shared memory and
// take each sample's angle atan2(x) meanwhile, and mix the previous tile's
// outputs from the phases the walker recorded. A line's first step starts
// from the phase advanced over the pre-burst segment (tens of radians),
// so it mixes its sample and takes atan2 of the product, as the plain
// version does; from the second on ph is in (-pi, pi] and the mixed
// sample's angle is normalize(angle(x) - ph): the chain is that
// difference, two normalizations, the loop update and the wrap, with
// sin / cos and atan2 off it. This rounds differently from atan2 of the
// product by ulps; the kernel is held to the plain version at WALK_TOL.
// A burst longer than a tile (none of the decoders') is walked from
// device memory, every step mixed and atan2 on the chain.
__global__ void __launch_bounds__(kBurstThreads, 1)
chroma_burst_kernel(const float2* __restrict__ burst, int L, int nb,
                    const float* __restrict__ ref_phases,
                    const float* __restrict__ carry_in,
                    float* __restrict__ carry_out,
                    float* __restrict__ line_phase,
                    float2* __restrict__ burst_out, int pre_len,
                    int post_len, float alpha, float beta, float min_freq,
                    float max_freq) {
  __shared__ __align__(16) float2 sx[3][kBurstTile];
  __shared__ float sa[2][kBurstTile];
  __shared__ float sph[2][kBurstTile];
  const int tid = threadIdx.x;
  const bool staged = nb > 0 && nb <= kBurstTile;
  const int per = staged ? kBurstTile / nb : L;  // lines a round
  const int rounds = staged ? (L + per - 1) / per : (L > 0 ? 1 : 0);
  // tile r's samples and angles (threads h, h + stride, ...)
  auto stage = [&](int r, int h, int stride) {
    const size_t first = static_cast<size_t>(r) * per * nb;
    const int len = min(per, L - r * per) * nb;
    for (int i = h; i < len; i += stride) {
      const float2 x = burst[first + i];
      sx[r % 3][i] = x;
      sa[r & 1][i] = atan2f(x.y, x.x);
    }
  };
  if (staged && rounds > 0) stage(0, tid, kBurstThreads);
  __syncthreads();
  float phase = carry_in[0], freq = carry_in[1];
  for (int r = 0; r <= rounds; ++r) {
    WALK_ROUND();
    if (tid == 0 && r < rounds) {
      const int l1 = min(L, (r + 1) * per);
      for (int l = r * per; l < l1; ++l) {
        line_phase[4 * l + 0] = phase;
        line_phase[4 * l + 1] = freq;
        float ph = pre_len > 0 ? (phase + static_cast<float>(pre_len - 1)
                                              * freq) + freq
                               : phase;
        float fr = freq;
        const float ref = ref_phases[l];
        if (staged) {
          const int k = (l - r * per) * nb;
          const float2* x = &sx[r % 3][k];
          const float* a = &sa[r & 1][k];
          float* used = &sph[r & 1][k];
          used[0] = ph;
          const float2 o = mix(x[0], ph);
          burst_step(atan2f(o.y, o.x), ref, ph, fr, alpha, beta, min_freq,
                     max_freq);
          if (short_wrap(alpha, min_freq, max_freq, ref))
            burst_rest<true>(a, used, nb, ref, ph, fr, alpha, beta, min_freq,
                             max_freq);
          else
            burst_rest<false>(a, used, nb, ref, ph, fr, alpha, beta,
                              min_freq, max_freq);
        } else {
          const size_t off = static_cast<size_t>(l) * nb;
          for (int j = 0; j < nb; ++j) {
            const float2 o = mix(burst[off + j], ph);
            burst_out[off + j] = o;
            burst_step(atan2f(o.y, o.x), ref, ph, fr, alpha, beta, min_freq,
                       max_freq);
          }
        }
        line_phase[4 * l + 2] = ph;
        line_phase[4 * l + 3] = fr;
        const float p3 = post_len > 0
                             ? (ph + static_cast<float>(post_len - 1) * fr) + fr
                             : ph;
        phase = wrap_phase<false>(p3);
        freq = fr;
      }
      WALK_DONE(0);
    } else if (tid >= 32 && staged) {
      if (r + 1 < rounds) stage(r + 1, tid - 32, kBurstThreads - 32);
      if (r > 0) {
        const int t = r - 1;
        const size_t first = static_cast<size_t>(t) * per * nb;
        const int len = min(per, L - t * per) * nb;
        for (int i = tid - 32; i < len; i += kBurstThreads - 32)
          burst_out[first + i] = mix(sx[t % 3][i], sph[t & 1][i]);
      }
      WALK_DONE(1);
    }
    __syncthreads();
  }
  if (tid == 0) {
    carry_out[0] = phase;
    carry_out[1] = freq;
  }
}

// -------------------------------------------------------------- CyclicSync
//
// Four warps, one role each, a tile of kCycTile samples a role a round,
// one barrier a round: at round r warp 3 stages the correlation of tile
// r + 1 and the samples of tile r - 1 in shared memory (asynchronous
// copies); warp 1 (lane 0) walks the average over tile r, avg = agc * rc +
// agc_inv * avg in the plain version's order, and packs one bit a sample,
// rc > avg (the average before the update), 32 to a word; warp 0 walks
// the peak / count machine over tile r - 1 from those bits; warp 2 writes
// tile r - 2's samples into the symbol buffer. The average never depends
// on the peak or the count, so its chain (a product and a sum a sample)
// runs beside the walker's, and sets the kernel's pace.
//
// The walker keeps the count as a deadline d, the sample at which the
// count reaches sym (since = i - d + sym - 1), and takes 32-sample words
// with one lane a sample. In words that cannot hold an emit (sym > 32 and
// d past the word; four at once when sym > 128 and d past them) a sample
// is a peak iff its bit is set and rc beats the running maximum of such
// samples before it (the carried peak first): a prefix maximum over the
// lanes (shuffles), the peaks a ballot, the deadline from the last. Max and
// comparisons are exact in any order, so this is the plain version's
// select chain, but for which of two equal zeros the maximum is (the
// select keeps the first: taken from a ballot when the peak ends at zero)
// and a NaN peak (such a word takes the plain step). Other words (an emit
// due, sym <= 32, a ragged end) take the plain step a sample, every lane
// alike. Either way the walker records each sample's reset (the count
// restarts: a peak, or the sample after an emit) as a bit. From those,
// warp 2 recovers every sample's write index min(max(since, 0), sym - 1)
// (lane L: L minus its word's last reset at or before L, or the carried
// count plus one plus L) and stores the sample there; when two lanes of a
// word can share an index (a reset past lane 0, or a negative count) only
// the last lane of each index writes (__match_any_sync), as in the
// sequential version. The buffer is in shared memory when sym fits
// (kCycBufMax, ~24k samples), else in device memory, and written out once.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kCycThreads = 128;
constexpr int kCycTile = 1024;
constexpr int kCycWords = kCycTile / 32;
constexpr int kCycStatic = 3 * kCycTile * 4 + 2 * kCycTile * 8
                           + 2 * 2 * kCycWords * 4 + 16;
constexpr int kCycBufMax = 227 * 1024 - kCycStatic - 1024;  // bytes
constexpr int kCycDefaultDyn = 48 * 1024 - kCycStatic;
constexpr unsigned kAll = 0xffffffffu;

// G words that hold no emit (rc: their samples; bw: their rc > avg bits;
// rs: their reset words), lane `lane` of the walker warp; peak / d / pend
// are the walker's carry, the same in every lane.
template <int G>
__device__ __forceinline__ void peak_words(const float* rc,
                                           const uint32_t* bw, uint32_t* rs,
                                           int c0, int lane, int sym,
                                           float& peak, long long& d,
                                           bool& pend) {
  float m[G], p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = (bw[g] >> lane) & 1u ? rc[32 * g + lane] : -INFINITY;
    p[g] = m[g];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float q = __shfl_up_sync(kAll, p[g], off);
      if (lane >= off) p[g] = fmaxf(p[g], q);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float before = __shfl_up_sync(kAll, p[g], 1);
    if (lane == 0) before = -INFINITY;
    const float total = __shfl_sync(kAll, p[g], 31);
    const uint32_t isp = __ballot_sync(kAll, m[g] > fmaxf(peak, before));
    float next = fmaxf(peak, total);
    if (next == 0.0f) {
      // the select keeps the first zero: the carried peak's, else the
      // first lane's whose sample is zero
      if (peak == 0.0f)
        next = peak;
      else
        next = __shfl_sync(kAll, m[g],
                           __ffs(__ballot_sync(kAll, m[g] == 0.0f)) - 1);
    }
    peak = next;
    if (isp)
      d = static_cast<long long>(c0) + 32 * g + (31 - __clz(isp)) + sym - 1;
    if (lane == 0) rs[g] = isp | (pend ? 1u : 0u);
    pend = false;
  }
}

__global__ void __launch_bounds__(kCycThreads, 1)
cyclic_sync_kernel(const float* __restrict__ rcorr,
                   const float2* __restrict__ vals, int n,
                   const float* __restrict__ carry_in,
                   const int* __restrict__ since_in,
                   const float2* __restrict__ symbuf_in, int sym, float agc,
                   float agc_inv, float* __restrict__ carry_out,
                   int* __restrict__ since_out,
                   float2* __restrict__ symbuf_out, int* __restrict__ emits,
                   int max_syms, int* __restrict__ count, bool buf_shared) {
  __shared__ __align__(16) float rt[3][kCycTile];
  __shared__ __align__(16) float2 vt[2][kCycTile];
  __shared__ uint32_t bits[2][kCycWords];
  __shared__ uint32_t rst[2][kCycWords];
  __shared__ int s_cnt;
  extern __shared__ float2 sbuf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float2* buf = buf_shared ? sbuf : symbuf_out;
  for (int i = tid; i < sym; i += kCycThreads) buf[i] = symbuf_in[i];
  for (int i = tid; i < kCycTile && i < n; i += kCycThreads)
    rt[0][i] = rcorr[i];
  __syncthreads();
  const int tiles = (n + kCycTile - 1) / kCycTile;
  // walker (warp 0)
  float peak = carry_in[1];
  long long d = static_cast<long long>(sym) - 1 - since_in[0];
  bool pend = false;
  int cnt = 0;
  // average (tid 32)
  float avg = carry_in[0];
  // buffer writer (warp 2): the write index of the sample before the tile
  long long c = static_cast<long long>(since_in[0]) - 1;
  for (int r = 0; r < tiles + 2; ++r) {
    WALK_ROUND();
    if (tid == 32 && r < tiles) {
      const int len = min(kCycTile, n - r * kCycTile);
      const float4* r4 = reinterpret_cast<const float4*>(rt[r % 3]);
      const int whole = len / 32;
      float4 v[8];  // the word's samples, loaded a word ahead
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (whole > 0) v[q] = r4[q];
      for (int w = 0; w < whole; ++w) {
        float4 next[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (w + 1 < whole) next[q] = r4[8 * (w + 1) + q];
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float e[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            word |= e[u] > avg ? 1u << (4 * q + u) : 0u;
            avg = agc * e[u] + agc_inv * avg;
          }
        }
        bits[r & 1][w] = word;
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = next[q];
      }
      if (whole * 32 < len) {
        const float* rc_ = rt[r % 3];
        uint32_t word = 0;
        for (int k = 0; whole * 32 + k < len; ++k) {
          const float rc = rc_[whole * 32 + k];
          word |= rc > avg ? 1u << k : 0u;
          avg = agc * rc + agc_inv * avg;
        }
        bits[r & 1][whole] = word;
      }
      WALK_DONE(0);
    } else if (warp == 0 && r >= 1 && r <= tiles) {
      const int t = r - 1, base = t * kCycTile;
      const int len = min(kCycTile, n - base);
      const float* rc_ = rt[t % 3];
      const uint32_t* bw_ = bits[t & 1];
      uint32_t* rs_ = rst[t & 1];
      for (int w = 0; w * 32 < len;) {
        const int c0 = base + w * 32;
        const int full = (len - w * 32) / 32;  // whole words left
        if (full >= 4 && sym > 128 && d >= c0 + 128 && peak == peak) {
          peak_words<4>(rc_ + w * 32, bw_ + w, rs_ + w, c0, lane, sym, peak,
                        d, pend);
          w += 4;
        } else if (full >= 1 && sym > 32 && d >= c0 + 32 && peak == peak) {
          peak_words<1>(rc_ + w * 32, bw_ + w, rs_ + w, c0, lane, sym, peak,
                        d, pend);
          w += 1;
        } else {
          // the plain step a sample, in every lane alike
          const int cl = min(32, len - w * 32);
          const uint32_t bw = bw_[w];
          uint32_t reset = 0;
          for (int k = 0; k < cl; ++k) {
            const long long i = c0 + k;
            const float rc = rc_[w * 32 + k];
            const bool due = i >= d;
            const bool p = (((bw >> k) & 1u) != 0) & (rc > peak);
            const bool e = p ? sym == 1 : due;
            reset |= (p || pend) ? 1u << k : 0u;
            pend = e;
            peak = e ? 0.0f : (p ? rc : peak);
            d = e ? i + sym : (p ? i + sym - 1 : d);
            if (e) {
              if (lane == 0 && cnt < max_syms) emits[cnt] = static_cast<int>(i);
              ++cnt;
            }
          }
          if (lane == 0) rs_[w] = reset;
          w += 1;
        }
      }
      WALK_DONE(1);
    } else if (warp == 2 && r >= 2) {
      const int t = r - 2, base = t * kCycTile;
      const int len = min(kCycTile, n - base);
      for (int w = 0; w * 32 < len; ++w) {
        const uint32_t rw = rst[t & 1][w];
        const uint32_t m = rw & (kAll >> (31 - lane));
        const long long s = m ? static_cast<long long>(lane - (31 - __clz(m)))
                              : c + 1 + lane;
        const bool valid = w * 32 + lane < len;
        const int at = static_cast<int>(
            min(max(s, 0LL), static_cast<long long>(sym - 1)));
        // one segment (no reset past lane 0) counting from >= 0: every
        // lane's index differs; otherwise the last lane of each index
        bool write = valid;
        if ((rw & ~1u) != 0 || (!(rw & 1u) && c + 1 < 0)) {
          const unsigned same = __match_any_sync(kAll, valid ? at : -1 - lane);
          write = valid && 31 - __clz(same) == lane;
        }
        if (write) buf[at] = vt[t & 1][w * 32 + lane];
        c = rw ? static_cast<long long>(__clz(rw)) : c + 32;
        __syncwarp();
      }
      WALK_DONE(2);
    } else if (warp == 3) {
      if (r + 1 < tiles) {
        const int base = (r + 1) * kCycTile;
        const int len = min(kCycTile, n - base);
        for (int i = lane; i < len; i += 32)
          cp_async<4>(&rt[(r + 1) % 3][i], rcorr + base + i);
      }
      if (r >= 1 && r <= tiles) {
        const int base = (r - 1) * kCycTile;
        const int len = min(kCycTile, n - base);
        for (int i = lane; i < len; i += 32)
          cp_async<8>(&vt[(r - 1) & 1][i], vals + base + i);
      }
      cp_async_wait_all();
      WALK_DONE(3);
    }
    __syncthreads();
  }
  if (tid == 0) {
    carry_out[1] = peak;
    carry_out[2] = rcorr[n - 1];
    since_out[0] = static_cast<int>(static_cast<long long>(n) + sym - 1 - d);
    s_cnt = min(cnt, max_syms);
    count[0] = s_cnt;
  }
  if (tid == 32) carry_out[0] = avg;
  __syncthreads();
  for (int i = s_cnt + tid; i < max_syms; i += kCycThreads) emits[i] = -1;
  if (buf_shared)
    for (int i = tid; i < sym; i += kCycThreads) symbuf_out[i] = sbuf[i];
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
  chroma_burst_kernel<<<1, kBurstThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
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
  // the symbol buffer in shared memory when it fits, else in device memory
  size_t dyn = static_cast<size_t>(sym) * sizeof(float2);
  if (dyn > static_cast<size_t>(kCycBufMax)) {
    dyn = 0;
  } else if (dyn > static_cast<size_t>(kCycDefaultDyn) &&
             cudaFuncSetAttribute(cyclic_sync_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kCycBufMax) != cudaSuccess) {
    cudaGetLastError();
    dyn = 0;
  }
  cyclic_sync_kernel<<<1, kCycThreads, dyn,
                       static_cast<cudaStream_t>(stream)>>>(
      rcorr, static_cast<const float2*>(vals), n, carry_in, since_in,
      static_cast<const float2*>(symbuf_in), sym, agc, agc_inv, carry_out,
      since_out, static_cast<float2*>(symbuf_out), emits, max_syms, count,
      dyn != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
