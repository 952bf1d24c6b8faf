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
// - LineSync: one warp walks only the sync chain (the 88 samples of the
//   two 44-sample sync regions, from a shared-memory ring another warp
//   stages ahead with cp.async, summed by the plain version's tree, and
//   the update in registers), recording each line's (pos, freq) and window
//   base; eleven warps draw the 720-sample lines from those records behind
//   it. The position is an integer base and a float fraction, rebased
//   every line, so the float parts stay below 2^22 in any block. No CTA
//   barrier after the set-up (line_sync_kernel). Measured by clock64
//   ablation before the redesign (tools/sync_walk_probe.py, PERF.md): the
//   736-thread form lost its time to the windows' device loads, the two
//   barriers and the trees, all on every line's chain.
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
// comparisons (LineSync takes a floor by a rounded-down add where that is
// exact, locate and rebase), in the order of their plain PyTorch versions
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

// Asynchronous copies of 4, 8 or 16 bytes into shared memory (cp.async,
// through L1), and the wait for this thread's.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 ... 7) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait_groups(int n) {
  switch (n) {
#define WAIT_GROUPS(k) \
  case k:              \
    asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); \
    break;
    WAIT_GROUPS(0) WAIT_GROUPS(1) WAIT_GROUPS(2) WAIT_GROUPS(3)
    WAIT_GROUPS(4) WAIT_GROUPS(5) WAIT_GROUPS(6)
#undef WAIT_GROUPS
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------- LineSync
constexpr int kLineLen = 720;
constexpr int kTaps = 8;
constexpr int kPhases = 128;
constexpr int kSyncLen = 44;        // samples of each sync half
constexpr int kLineThreads = 512;   // 16 warps, see line_sync_kernel
constexpr int kLineDrawers = 11;    // warps 2 ... 15 but 4, 8 and 12
constexpr int kLineStager = 1;      // the stager's warp
constexpr int kLineRing = 16384;    // buf samples staged (a power of two)
constexpr int kLineRecs = 1024;     // line records (a power of two)
constexpr int kStageGroup = 1024;   // samples a stager copy group
constexpr int kStageDepth = 8;      // stager groups in flight
constexpr unsigned kLinePoll = 256;  // ns between a waiting warp's polls
constexpr unsigned long long kNoRec = ~0ull;  // an empty record (pos NaN)
constexpr int kLineSmem =           // dynamic: bank, ring + mirror, records
    (kPhases * kTaps + kLineRing + kTaps) * 4 + kLineRecs * 16;
constexpr float kFreqLimit = 4096.0f;  // |freq| a line is drawn at
constexpr int kBaseClip = 1 << 23;     // the window base's guard band

// A wait on another warp that has not ended after 2^32 cycles (about two
// seconds) is a protocol fault: trap, so the launch fails instead of
// hanging.
__device__ __forceinline__ void check_wait(long long since) {
  if (clock64() - since > (1ll << 32)) __trap();
}

// Shared-memory words that one warp writes and another polls.
__device__ __forceinline__ int ld_flag(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ void st_flag(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}
// s_hi, the stager's staged frontier, with acquire / release order: the
// walker's ring loads after the acquire see every sample the stager wrote
// before its release (a volatile load is relaxed, and the ring loads could
// be performed ahead of it, reading a stale window below a newer hi).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_rec(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void st_rec(unsigned long long* p,
                                       unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// sum_j w[j] * b[j] in j order (the plain version's), b the 16-byte
// aligned bank row
__device__ __forceinline__ float taps8(const float (&w)[kTaps],
                                      const float* b) {
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  const float4 b1 = *reinterpret_cast<const float4*>(b + 4);
  float acc = w[0] * b0.x;
  acc = acc + w[1] * b0.y;
  acc = acc + w[2] * b0.z;
  acc = acc + w[3] * b0.w;
  acc = acc + w[4] * b1.x;
  acc = acc + w[5] * b1.y;
  acc = acc + w[6] * b1.z;
  acc = acc + w[7] * b1.w;
  return acc;
}

// Sample position base + p's bank row and window start in buf = [head |
// x], as the plain version: phase min(max(int(mu * 128), 0), 127) of mu =
// p - floor(p), window min(max(floor(p) + base + hoff, 0), nh - 1), where
// hoff = head - 7 and nh = n + hoff (position 0 is x's first sample; a
// window reaches back into the head, and the clip is a guard no carried
// line reaches). bc = base + hoff clipped to [-kBaseClip, nh + kBaseClip]:
// with |floor(p)| < 2^22 the window's clip is the same, in int32.
// No conversion instruction (F2I / FRND issue at a quarter of the rate
// and sit on the walker's chain), for |p| < 2^22: t = p + 1.5 * 2^23
// rounded down lies in [2^23, 2^24), where floats are the integers, so t =
// 1.5 * 2^23 + floor(p) exactly; its bits minus those of 1.5 * 2^23 are
// floor(p), and t - 1.5 * 2^23 is floor(p) as a float (exact, Sterbenz).
// mu * 128 is exact and in [0, 128], so 2^23 + mu * 128 rounded down is
// 2^23 + floor(mu * 128), the truncation the plain version takes (mu >= 0:
// no clamp at 0 is needed). Every p here is pos + k freq with pos in [0,
// 1] and |freq| <= kFreqLimit: |p| <= 1 + 720 * 4096 < 2^22.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagicMax = 4194304.0f;  // 2^22
__device__ __forceinline__ void locate(float p, int bc, int nh, int& ph,
                                       int& win) {
  const float t = __fadd_rd(p, kMagic);
  const float mu = p - (t - kMagic);
  const float u = __fadd_rd(mu * 128.0f, 8388608.0f);
  ph = min(__float_as_int(u) - 0x4B000000, kPhases - 1);
  win = min(max(__float_as_int(t) - kMagicBits + bc, 0), nh - 1);
}

// The plain version's rebase: (pos, base) -> (pos - fl, base + fl), fl =
// floor(pos) (+0 for -0); by the rounded-down add below 2^22 (every line
// of a walk but a jump of millions of samples), by floorf and a 64-bit
// conversion (exact for integers) below 2^62, else pos = NaN (the walk
// ends).
__device__ __forceinline__ void rebase(float& pos, long long& base) {
  if (fabsf(pos) < kMagicMax) {
    const float t = __fadd_rd(pos, kMagic);
    pos = pos - (t - kMagic);
    base += __float_as_int(t) - kMagicBits;
  } else if (fabsf(pos) < 4.611686018427387904e18f) {  // 2^62
    const float fl = floorf(pos) + 0.0f;
    pos = pos - fl;
    base += static_cast<long long>(fl);
  } else {
    pos = __int_as_float(0x7fc00000);
  }
}

// q < m for an integer m, exactly, where |q| < 2^22 (or NaN: false): m
// clipped to [-2^22, 2^22] is a float by the rounded-down add's inverse
__device__ __forceinline__ bool less_than(float q, long long m) {
  const int c = static_cast<int>(max(min(m, 4194304ll), -4194304ll));
  return q < __int_as_float(kMagicBits + c) - kMagic;
}

// bc: base + hoff clipped to the guard band (see locate)
__device__ __forceinline__ int window_base(long long base, int hoff,
                                           int nh) {
  return static_cast<int>(max(min(base + hoff,
                                  static_cast<long long>(nh) + kBaseClip),
                              static_cast<long long>(-kBaseClip)));
}

// One CTA of 16 warps, no CTA barrier after its set-up. Warp 0 walks the
// sync chain; warp 1 stages buf into a shared-memory ring ahead of it;
// the eleven warps 2 ... 15 but 4, 8 and 12 draw the lines from the
// walker's records; warps 4, 8 and 12 leave after the set-up (warps share
// a scheduler by w % 4, so the walker has its scheduler to itself).
//
// The walker: lanes 0-15 the left sum, 16-31 the right; lane L of a half
// interpolates samples v[L], v[L + 16] and (L < 12) v[L + 32] of its half
// (left: v[i] = line[703 + i] for i < 17, else line[i - 17]; right: v[i]
// = line[27 + i]), adds them in the tree's first two levels, s[L] = v[L] +
// v[L + 32] (or + 0) and t[L] = s[L] + (v[L + 16] + 0), then xor shuffles
// 8, 4, 2, 1 finish the tree in every lane of the half (lane i adds t[i]
// and t[i ^ k]; addition commutes, so each lane holds the plain version's
// value) and one xor 16 brings the other half's. Every lane then does the
// update with the plain version's rounding, so pos / freq stay in
// registers. A line's windows come from the ring when all of them (those
// of k = 0 and 719 bound them) lie at or above the release (the walker's
// own lowest window so far, raised line by line; the stager overwrites
// only samples below the release it last read) and below s_hi (staged),
// else from device memory: a jump past the staged tile costs time, never
// a wrong value. The ring is read first, speculatively, so the 24 loads
// wait for nothing but the positions; the test follows, and a line that
// fails it reads again from device memory. Positions are located without
// conversion instructions (locate). Lane 0 puts
// each line's record into a ring, waiting for a free slot only past
// kLineRecs lines: (pos, freq) in one 64-bit word, then (bc, the line's
// index) in a second, written first; a drawer takes the record when both
// words show its line (each word is read whole), so the two need no
// fence between them. After a line's update it rebases the position
// (rebase) and keeps the frequency integrator's remainder (freq_lo, a
// Fast2Sum), as the plain version.
//
// The stager: copies buf in groups of kStageGroup samples with cp.async
// (16 bytes where buf is 16-byte aligned, else 4), up to kStageDepth
// groups in flight, a group only when the samples its slots held lie
// below the release; samples at ring slots 0-7 also go to kLineRing +
// slot, so a window reads eight consecutive words. As each oldest group
// lands it publishes s_hi; when the walker has passed all it issued, it
// drains and starts again at the release.
//
// A drawer takes lines j, j + 11, ...: waits for the record (past
// kLineRecs lines, also for the slot's previous line to have been taken),
// frees its slot, and interpolates the line's 720 samples at base + (pos
// + k freq) from device memory into `lines`, as the plain version does.
// When the walker has finished (s_count >= 0) a drawer past the count
// zeroes its remaining rows.
__global__ void __launch_bounds__(kLineThreads, 1)
line_sync_kernel(const float* __restrict__ buf, int n, int head,
                 const float* __restrict__ bank,
                 const float* __restrict__ carry_in,
                 const long long* __restrict__ base_in,
                 const bool* __restrict__ locked_in,
                 float* __restrict__ carry_out,
                 long long* __restrict__ base_out,
                 bool* __restrict__ locked_out,
                 float* __restrict__ lines, int* __restrict__ count,
                 int max_lines, float omega_gain, float mu_gain,
                 float min_freq, float max_freq, float sync_level,
                 float sync_bias) {
  extern __shared__ __align__(16) float lsm[];
  float* const sbank = lsm;
  float* const ring = lsm + kPhases * kTaps;
  unsigned long long* const recs = reinterpret_cast<unsigned long long*>(
      ring + kLineRing + kTaps);
  unsigned long long* const tags = recs + kLineRecs;  // (bc, line index)
  __shared__ int s_hi, s_release, s_count, s_next[kLineDrawers];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kPhases * kTaps; i += kLineThreads) sbank[i] = bank[i];
  for (int i = tid; i < 2 * kLineRecs; i += kLineThreads) recs[i] = kNoRec;
  if (tid < kLineDrawers) s_next[tid] = tid;  // each drawer's next line
  if (tid == 0) {
    s_hi = 0;
    s_release = 0;
    s_count = -1;
  }
  __syncthreads();
  const int total = n + head;  // buf's samples
  const int hoff = head - (kTaps - 1), nh = n + hoff;
  if (warp == 0) {
    WALK_ROUND();
    const int half = lane >> 4, L = lane & 15;
    const bool third = L + 32 < kSyncLen;
    float kf[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = r < 2 || third ? L + 16 * r : L;
      kf[r] = static_cast<float>(half ? 27 + i : (i < 17 ? 703 + i : i - 17));
    }
    float pos = carry_in[0], freq = carry_in[1], freq_lo = carry_in[2];
    long long base = base_in[0];
    rebase(pos, base);
    bool locked = locked_in[0];
    const bool fits = fabsf(freq) <= kFreqLimit;
    int release = 0, l = 0;
    for (; l < max_lines && fits; ++l) {
      if (!less_than(pos + 720.0f * freq, n - base)) break;
      const int hi = ld_acquire(&s_hi);  // before the ring loads
      const int bc = window_base(base, hoff, nh);
      // the line's positions lie between pos and pos + 720 freq
      int ph[3], b[3], bases[2], unused;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        locate(pos + kf[r] * freq, bc, nh, ph[r], b[r]);
      locate(pos, bc, nh, unused, bases[0]);
      locate(pos + 719.0f * freq, bc, nh, unused, bases[1]);
      // the windows from the ring, whether staged or not (the test below
      // is off the loads' path); device memory when not
      float w[3][kTaps];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* x = ring + (b[r] & (kLineRing - 1));
#pragma unroll
        for (int j = 0; j < kTaps; ++j) w[r][j] = x[j];
      }
      float v[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) v[r] = taps8(w[r], sbank + ph[r] * kTaps);
      // the line reads the ring only if all its windows lie in [release,
      // hi): its lowest and highest are those of k = 0 and 719 (swapped
      // if freq < 0), each lane's own copies (bases[0], bases[1])
      const int lo = min(bases[0], bases[1]);
      release = max(release, lo);
      if (!(lo >= release && max(bases[0], bases[1]) + kTaps <= hi)) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int j = 0; j < kTaps; ++j) w[r][j] = __ldg(buf + b[r] + j);
          v[r] = taps8(w[r], sbank + ph[r] * kTaps);
        }
      }
      if (lane == 0) {
        unsigned long long* slot = recs + (l & (kLineRecs - 1));
        if (l >= kLineRecs) {
          const long long since = clock64();
          while (ld_rec(slot) != kNoRec) check_wait(since);
        }
        st_rec(tags + (l & (kLineRecs - 1)),
               static_cast<unsigned long long>(static_cast<unsigned>(bc)) |
                   (static_cast<unsigned long long>(l) << 32));
        st_rec(slot, static_cast<unsigned long long>(__float_as_uint(pos)) |
                         (static_cast<unsigned long long>(
                              __float_as_uint(freq))
                          << 32));
        st_flag(&s_release, release);
      }
      float t = (v[0] + (third ? v[2] : 0.0f)) + (v[1] + 0.0f);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        t = t + __shfl_xor_sync(kAll, t, off);
      const float o = __shfl_xor_sync(kAll, t, 16);
      const float left = (half ? o : t) / 44.0f;
      const float right = (half ? t : o) / 44.0f;
      const bool ok = (left < sync_level) && (right < sync_level);
      const float err = ok ? (left + sync_bias) - right : 0.0f;
      const float y = omega_gain * err + freq_lo;
      const float fy = freq + y;
      const float nf = fminf(fmaxf(fy, min_freq), max_freq);
      freq_lo = nf == fy ? y - (fy - freq) : 0.0f;
      pos = ((pos + 719.0f * freq) + nf) + mu_gain * err;
      rebase(pos, base);
      freq = nf;
      locked = ok;
    }
    if (lane == 0) {
      carry_out[0] = pos;
      carry_out[1] = freq;
      carry_out[2] = freq_lo;
      base_out[0] = base;
      locked_out[0] = locked;
      count[0] = l;
      __threadfence_block();
      st_flag(&s_count, l);
    }
    WALK_DONE(0);
  } else if (warp == kLineStager) {
    WALK_ROUND();
    // groups of kStageGroup samples, up to kStageDepth in flight;
    // [done, issued) in flight, s_hi = done published
    const bool v4 = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
    int issued = 0, done = 0, inflight = 0;
    long long since = clock64();  // the last progress
    for (;;) {
      check_wait(since);
      if (__shfl_sync(kAll, ld_flag(&s_count), 0) >= 0) break;
      const int rel = __shfl_sync(kAll, ld_flag(&s_release), 0);
      if (rel > issued) {
        // the walker is past all that was issued: drain, and go on from
        // the release (nothing below it is read from the ring)
        cp_async_wait_all();
        inflight = 0;
        issued = done = rel & ~3;
      }
      if (inflight < kStageDepth && issued < total &&
          issued + kStageGroup - kLineRing <= rel) {
        const int end = min(total, issued + kStageGroup);
        if (v4) {  // 16-byte copies; slots and addresses both aligned
          const int end4 = end & ~3;
          for (int i = issued + 4 * lane; i < end4; i += 128) {
            const int at = i & (kLineRing - 1);
            cp_async<16>(ring + at, buf + i);
            if (at < kTaps) cp_async<16>(ring + kLineRing + at, buf + i);
          }
          for (int i = end4 + lane; i < end; i += 32)
            cp_async<4>(ring + (i & (kLineRing - 1)), buf + i);
        } else {
          for (int i = issued + lane; i < end; i += 32) {
            const int at = i & (kLineRing - 1);
            cp_async<4>(ring + at, buf + i);
            if (at < kTaps) cp_async<4>(ring + kLineRing + at, buf + i);
          }
        }
        cp_async_commit();
        ++inflight;
        issued = end;
        continue;
      }
      if (inflight == 0) {
        if (issued >= total) break;
        __nanosleep(kLinePoll);
        continue;
      }
      cp_async_wait_groups(inflight - 1);  // the oldest group has landed
      --inflight;
      __threadfence_block();
      __syncwarp();
      done = min(total, done + kStageGroup);
      if (lane == 0) st_release(&s_hi, done);
      since = clock64();
    }
    cp_async_wait_all();
    WALK_DONE(1);
  } else if (warp >= 2 && warp % 4 != 0) {
    WALK_ROUND();
    const int j = warp - 2 - (warp >> 2);  // 0 ... 10
    int d = j;
    for (;; d += kLineDrawers) {
      unsigned long long* slot = recs + (d & (kLineRecs - 1));
      // past kLineRecs lines the slot held line d - kLineRecs first: its
      // drawer must have taken it (s_next) before this one reads the slot
      const int prev = d - kLineRecs;
      unsigned long long rec = kNoRec;
      int bc = 0;
      bool got = false;
      const long long since = clock64();
      for (;;) {
        check_wait(since);
        const int c = __shfl_sync(kAll, ld_flag(&s_count), 0);
        if (c >= 0 && d >= c) break;  // no such line
        if (prev < 0 || __shfl_sync(kAll, ld_flag(s_next + prev % kLineDrawers),
                                    0) > prev) {
          __threadfence_block();
          const unsigned long long tag =
              __shfl_sync(kAll, ld_rec(tags + (d & (kLineRecs - 1))), 0);
          rec = __shfl_sync(kAll, ld_rec(slot), 0);
          if (rec != kNoRec && static_cast<int>(tag >> 32) == d) {
            bc = static_cast<int>(static_cast<unsigned>(tag));
            got = true;
            break;
          }
        }
        // a line takes the walker ~0.5 us: poll rarely, so the waiting
        // drawers keep off the shared-memory pipe the walker reads through
        __nanosleep(kLinePoll);
      }
      if (!got) break;
      __syncwarp();
      if (lane == 0) {
        st_rec(slot, kNoRec);
        __threadfence_block();
        st_flag(s_next + j, d + kLineDrawers);
      }
      const float pos = __uint_as_float(static_cast<unsigned>(rec));
      const float freq = __uint_as_float(static_cast<unsigned>(rec >> 32));
      float* out = lines + static_cast<size_t>(d) * kLineLen;
#pragma unroll 4
      for (int k = lane; k < kLineLen; k += 32) {
        int ph, b;
        locate(pos + static_cast<float>(k) * freq, bc, nh, ph, b);
        float w[kTaps];
#pragma unroll
        for (int q = 0; q < kTaps; ++q) w[q] = __ldg(buf + b + q);
        out[k] = taps8(w, sbank + ph * kTaps);
      }
    }
    for (; d < max_lines; d += kLineDrawers) {
      float* out = lines + static_cast<size_t>(d) * kLineLen;
      for (int k = lane; k < kLineLen; k += 32) out[k] = 0.0f;
    }
    WALK_DONE(2);
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

constexpr int kCycThreads = 128;
constexpr int kCycTile = 1024;
constexpr int kCycWords = kCycTile / 32;
constexpr int kCycStatic = 3 * kCycTile * 4 + 2 * kCycTile * 8
                           + 2 * 2 * kCycWords * 4 + 16;
constexpr int kCycBufMax = 227 * 1024 - kCycStatic - 1024;  // bytes
constexpr int kCycDefaultDyn = 48 * 1024 - kCycStatic;
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

// LineSync over one block: buf = [head | x] float32 [head + n], head >= 7
// (the blocks before's last samples: a line carried into this block, at a
// position down to -720 max_freq, reads them); bank [128, 8]; carry_in /
// carry_out float32 [3] (pos, freq, freq_lo) and base_in / base_out int64
// [1]: the next line's position base + pos from x's first sample, the
// frequency freq + freq_lo; locked bool [1]; lines [max_lines, 720]
// float32 (rows past the count are 0); count int32. |min_freq| and
// |max_freq| at most 4096; head + n below 2^31 - 2^24.
int line_sync_walk(const float* buf, int n, int head, const float* bank,
                   const float* carry_in, const long long* base_in,
                   const bool* locked_in, float* carry_out,
                   long long* base_out, bool* locked_out, float* lines,
                   int* count, int max_lines, float omega_gain, float mu_gain,
                   float min_freq, float max_freq, float sync_level,
                   float sync_bias, void* stream) {
  if (n < 1 || max_lines < 1 || head < kTaps - 1 ||
      static_cast<long long>(n) + head > (1ll << 31) - (1ll << 24) ||
      !(fabsf(min_freq) <= kFreqLimit && fabsf(max_freq) <= kFreqLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      line_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLineSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  line_sync_kernel<<<1, kLineThreads, kLineSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      buf, n, head, bank, carry_in, base_in, locked_in, carry_out, base_out,
      locked_out, lines, count, max_lines, omega_gain, mu_gain, min_freq,
      max_freq, sync_level, sync_bias);
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
