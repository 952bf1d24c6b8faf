// Batched Viterbi add-compare-select and survivor traceback for the
// K = 7 (64-state) and K = 5 (16-state) convolutional codes, for Hopper.
//
// Replaces three Pallas kernels of the JAX package:
//   - sdrpp_tpu/ops/fec_pallas.py:51 viterbi_acs_pallas_batched
//     (pallas_call :112): B windows in lock-step, [B, T, R] soft bits ->
//     [B, T, S] int8 decisions. Entry viterbi_acs.
//   - sdrpp_tpu/ops/fec_pallas.py:221 viterbi_acs_pallas (pallas_call
//     :296), the single-stream ACS: the same entry with B = 1, start 0 and
//     T the whole stream. The JAX kernel takes any state count; this one
//     takes the two the decoders use: S = 64 (Meteor LRPT and KG-STV,
//     K = 7) and S = 16 (M17's LSF and stream payload, K = 5).
//   - sdrpp_tpu/ops/fec_pallas.py:132 viterbi_traceback_pallas_batched
//     (pallas_call :197): decisions -> [B, T] bits, walking back from state
//     0. Entry viterbi_traceback.
//
// Decisions are packed: one 64-bit word a trellis step, bit n the decision
// of state n (1 = it took the predecessor (n >> 1) + S / 2), bits >= S
// zero; ops/fec_kernels.unpack_decisions gives the JAX kernels' int8 form.
// A window's 4288 words are 34 KB, 8x fewer bytes than int8 decisions: the
// 30-s pass's 528 windows write 18 MB, a 1024-window launch 35 MB, which
// stays in the 50 MB L2 for the traceback that reads it next.
//
// What bounds them on an H100: each is a dependent chain of T steps per
// window, so the time is T times the latency of one step's chain (tens of
// cycles), not bytes or operations; a launch has a few windows per SM, too
// few for other warps to hide a latency on the chain. The designs take
// everything they can off that chain.
//
// ACS design, S = 64 (viterbi_acs): one warp per window, four windows a
// CTA. Lane l keeps the path metrics of states l and l + 32 in registers;
// the predecessors of state n are n >> 1 and (n >> 1) + 32, read from the
// owning lanes with four independent warp shuffles. The window is read
// where it lies in the [total, R] soft-bit stream (uint8 or float32), from
// its start (clamped to [0, total - T]): lane l loads step g*32 + l of the
// next 32-step group while the current group runs. uint8 bits then pass
// through shared memory once a group, after which every lane holds all 32
// steps' bits in registers (a byte becomes a float by a byte permute and
// an exact subtraction); float32 bits reach every lane by one shuffle a
// step. So no load and no branch metric sits on the chain. The step's
// value is fminf of the two candidates, its decision (cand1 < cand0) goes
// to two ballots off the chain, and lane 0 stores the word to shared
// memory; after each group the warp writes its 32 words with one
// coalesced 256-byte store. The chain of a step is then one shuffle, one
// add and one min.
//
// ACS design, S = 16: the same warp per window, the same loads and the
// same group schedule; lane l keeps the metric of state l & 15 (lanes
// 16-31 compute a copy of lanes 0-15, so every shuffle and ballot stays a
// full-warp one), reads its predecessors (l & 15) >> 1 and ((l & 15) >> 1)
// + 8 with two shuffles, and one ballot's low 16 bits make the word. It is
// the simple layout: M17 decodes 148- and 244-step frames, one or two
// windows a launch, where the launch and not the chain sets the time.
//
// Normalisation off the chain, exactly. The reference subtracts the
// minimum metric every step. For uint8 soft bits every branch metric
// sum_j |s_j - e_j| is an integer. The first K - 1 steps of a window (6
// for S = 64, 4 for S = 16) run the reference form: the 1e9 metrics of
// states not yet reachable round, so they must be computed as the
// reference computes them. After K - 1 steps every state is reachable
// from state 0 (a state's K - 1 bits are the last K - 1 input bits), and
// from then on every state is reachable from every state in K - 1 steps,
// so all metrics are integers within (K - 1) * R * 255 of the minimum,
// and leaving out a common offset changes no comparison and no tie. The
// kernel subtracts the minimum only after every 4096th step: between two
// such steps no metric exceeds (4096 + K - 1) * R * 255 < 2^24 (R <= 4,
// K - 1 = 6 or 4), so every float32 add is exact and the decisions equal
// the reference's bit for bit. That needs the expected outputs to be
// integers in [0, 255] as well, which each window checks once; float32
// soft bits, which need not be integral, and other expected outputs run
// the reference form every step. The warp minimum is one redux.sync on the
// metrics' bit patterns, which order non-negative floats as their values.
//
// Traceback design (viterbi_traceback): one CTA of one warp per window,
// which stages the window's words into a shared-memory ring of two
// 1024-word stages with 8-byte cp.async, walking backwards: the copy of
// the stage before overlaps the walk of this one. Lane 0 walks: per step
// a select of the word's half by the state's bit 5, a shift by its low
// five bits and a test; the words come from shared memory into registers
// eight at a time, a batch ahead (their addresses do not depend on the
// state), and the bits go back eight at a time; the warp writes each
// stage's bits out coalesced. 17 KB a CTA, so a 1024-window launch runs in
// one wave. For S = 16 the walk keeps the state whole: the decision is
// bit s of the word's low half and the predecessor (s >> 1) + 8 * took.
//
// Numerics: decisions and bits are bit-exact against the JAX kernels and
// the plain PyTorch versions: metrics start at 0 / 1e9, every candidate is
// one float32 add, the comparison is cand1 < cand0 (ties take the p0
// branch), branch metrics are summed over j in order. Built with
// --fmad=false.
//
// C ABI: the two entries below, called by the compiled host paths
// (viterbi_acs / viterbi_traceback of csrc/kernels_host.cpp) through their
// addresses; each returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_RATE = 4;         // soft bits per trellis step handled
constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 4;           // windows per ACS CTA
constexpr int kRenormGroups = 128;  // 32-step groups between renormalisations
constexpr int kChunk = 1024;        // words per traceback ring stage

// The soft bits of one 32-step group as loaded: lane l holds step base + l.
template <typename In, int R>
struct Tile;

template <int R>
struct Tile<uint8_t, R> {
  uint32_t v;  // byte j: soft bit j
  __device__ __forceinline__ void load(const uint8_t* p, bool ok) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < R; ++j)
      x |= (ok ? static_cast<uint32_t>(p[j]) : 0u) << (8 * j);
    v = x;
  }
};

template <int R>
struct Tile<float, R> {
  float v[R];
  __device__ __forceinline__ void load(const float* p, bool ok) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = ok ? p[j] : 0.0f;
  }
};

// The soft bits of one 32-step group as every lane reads them: get(i, s)
// gives step i's.
template <typename In, int R>
struct Steps;

// uint8: the warp's 32 words pass through shared memory once a group and
// every lane keeps all of them (eight broadcast 16-byte loads), so a step
// reads its bits from registers; byte j becomes a float by one byte
// permute (2^23 + byte as a bit pattern) and one exact subtraction.
template <int R>
struct Steps<uint8_t, R> {
  uint4 w[8];  // word i: step i
  __device__ __forceinline__ Steps(const Tile<uint8_t, R>& t, uint32_t* buf,
                                   int lane) {
    buf[lane] = t.v;
    __syncwarp();
    const uint4* b = reinterpret_cast<const uint4*>(buf);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = b[k];
  }
  __device__ __forceinline__ void get(int i, float (&s)[R]) const {
    const uint4& q = w[i >> 2];
    const uint32_t x = (i & 3) == 0   ? q.x
                       : (i & 3) == 1 ? q.y
                       : (i & 3) == 2 ? q.z
                                      : q.w;
#pragma unroll
    for (int j = 0; j < R; ++j)
      s[j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7650u | j)) -
             8388608.0f;
  }
};

// float32: step i's bits by one shuffle each from lane i
template <int R>
struct Steps<float, R> {
  float v[R];
  __device__ __forceinline__ Steps(const Tile<float, R>& t, uint32_t*, int) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = t.v[j];
  }
  __device__ __forceinline__ void get(int i, float (&s)[R]) const {
#pragma unroll
    for (int j = 0; j < R; ++j) s[j] = __shfl_sync(FULL, v[j], i);
  }
};

// the warp's minimum of non-negative metrics (never -0 or NaN for finite
// soft bits), taken on their bit patterns
__device__ __forceinline__ float warp_min(float v) {
  return __uint_as_float(__reduce_min_sync(FULL, __float_as_uint(v)));
}

// The state layout of one warp for S states. Trellis<64>: lane l holds
// states l (`ma`) and l + 32 (`mb`); Trellis<16>: lane l holds state l & 15
// in `ma` (lanes 16-31 a copy of lanes 0-15), `mb` unused. kRef = K - 1,
// a window's reference-form steps.
template <int S>
struct Trellis;

template <>
struct Trellis<64> {
  static constexpr int kRef = 6;
  static constexpr int kRegs = 4;  // registers whose outputs a lane needs
  // [0] state lane via p0 (register lane), [1] via p1 (lane + 64), [2] / [3]
  // the same for state lane + 32
  __device__ static void regs(int lane, int (&r)[kRegs]) {
    r[0] = lane; r[1] = lane + 64; r[2] = lane + 32; r[3] = lane + 96;
  }
  __device__ static void init(int lane, float& ma, float& mb) {
    ma = lane == 0 ? 0.0f : 1e9f;
    mb = 1e9f;
  }
  // one step: candidates from the predecessors' metrics, the decisions'
  // word and the new metrics (before any renormalisation)
  __device__ static unsigned long long step(const float (&bm)[kRegs],
                                            int lane, float& ma, float& mb) {
    // predecessors: state lane <- (lane >> 1, lane >> 1 + 32);
    // state lane + 32 <- (16 + lane >> 1, 48 + lane >> 1)
    const int src_a = lane >> 1, src_b = 16 + (lane >> 1);
    const float pa0 = __shfl_sync(FULL, ma, src_a);
    const float pa1 = __shfl_sync(FULL, mb, src_a);
    const float pb0 = __shfl_sync(FULL, ma, src_b);
    const float pb1 = __shfl_sync(FULL, mb, src_b);
    const float ca0 = pa0 + bm[0], ca1 = pa1 + bm[1];
    const float cb0 = pb0 + bm[2], cb1 = pb1 + bm[3];
    const unsigned lo = __ballot_sync(FULL, ca1 < ca0);
    const unsigned hi = __ballot_sync(FULL, cb1 < cb0);
    // fminf equals the reference's select (cand1 < cand0 ? cand1 : cand0)
    ma = fminf(ca0, ca1);
    mb = fminf(cb0, cb1);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
  }
  __device__ static float lane_min(float ma, float mb) {
    return fminf(ma, mb);
  }
};

template <>
struct Trellis<16> {
  static constexpr int kRef = 4;
  static constexpr int kRegs = 2;
  // [0] state n = lane & 15 via p0 (register n), [1] via p1 (n + 16)
  __device__ static void regs(int lane, int (&r)[kRegs]) {
    r[0] = lane & 15; r[1] = (lane & 15) + 16;
  }
  __device__ static void init(int lane, float& ma, float& mb) {
    ma = (lane & 15) == 0 ? 0.0f : 1e9f;
    mb = 0.0f;
  }
  __device__ static unsigned long long step(const float (&bm)[kRegs],
                                            int lane, float& ma, float&) {
    // predecessors of state n: n >> 1 and (n >> 1) + 8
    const int n = lane & 15;
    const float p0 = __shfl_sync(FULL, ma, n >> 1);
    const float p1 = __shfl_sync(FULL, ma, (n >> 1) + 8);
    const float c0 = p0 + bm[0], c1 = p1 + bm[1];
    const unsigned d = __ballot_sync(FULL, c1 < c0);
    ma = fminf(c0, c1);
    return d & 0xffffu;  // lanes 16-31 repeat lanes 0-15's decisions
  }
  __device__ static float lane_min(float ma, float) { return ma; }
};

// Steps of one group; kMode 0: the fast form, 1: a window's first group
// (steps < kRef in the reference form, the rest fast), 2: every step in
// the reference form. Lane 0 writes step i's word to buf[i].
template <int S, int kMode, typename In, int R>
__device__ __forceinline__ void acs_group(
    const Steps<In, R>& steps, const float (&e)[Trellis<S>::kRegs][R],
    int lane, float& ma, float& mb, unsigned long long* buf) {
  using Tr = Trellis<S>;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float s[R];
    steps.get(i, s);
    // the registers' branch metrics, summed over j in order
    float bm[Tr::kRegs];
#pragma unroll
    for (int q = 0; q < Tr::kRegs; ++q) {
      float acc = fabsf(s[0] - e[q][0]);
#pragma unroll
      for (int j = 1; j < R; ++j) acc = acc + fabsf(s[j] - e[q][j]);
      bm[q] = acc;
    }
    const unsigned long long word = Tr::step(bm, lane, ma, mb);
    if (kMode == 2 || (kMode == 1 && i < Tr::kRef)) {
      const float mn = warp_min(Tr::lane_min(ma, mb));
      ma = ma - mn;
      mb = mb - mn;
    }
    if (lane == 0) buf[i] = word;
  }
}

template <int S, typename In, int R>
__global__ void __launch_bounds__(kWarps * 32)
    acs_kernel(const In* __restrict__ soft, const int* __restrict__ starts,
               const float* __restrict__ expected,
               unsigned long long* __restrict__ dec, int B, int T,
               long long total, long long* __restrict__ cycles) {
  using Tr = Trellis<S>;
  constexpr bool kU8 = sizeof(In) == 1;  // integral soft bits
  __shared__ unsigned long long sbuf[kWarps][2][32];
  __shared__ __align__(16) uint32_t sbits[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // whole warps leave together
  const long long t_start = clock64();

  // expected outputs of the registers this lane needs
  float e[Tr::kRegs][R];
  int regs[Tr::kRegs];
  Tr::regs(lane, regs);
  bool e_ok = true;  // integers in [0, 255]
#pragma unroll
  for (int q = 0; q < Tr::kRegs; ++q)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float x = expected[regs[q] * R + j];
      e_ok = e_ok && x == rintf(x) && x >= 0.0f && x <= 255.0f;
      e[q][j] = x;
    }
  // the fast form needs integral metrics: uint8 soft bits and expected
  // outputs that are integers in [0, 255] in every lane
  const bool fast = __all_sync(FULL, kU8 && e_ok);

  const long long start =
      min(max(static_cast<long long>(starts[w]), 0LL), total - T);
  const In* sw = soft + start * R;
  unsigned long long* dw = dec + static_cast<long long>(w) * T;
  float ma, mb;
  Tr::init(lane, ma, mb);
  const int groups = (T + 31) / 32;

  Tile<In, R> cur, nxt;
  cur.load(sw + static_cast<long long>(lane) * R, lane < T);
  for (int g = 0; g < groups; ++g) {
    const int tn = (g + 1) * 32 + lane;
    nxt.load(sw + static_cast<long long>(tn) * R, tn < T);
    const Steps<In, R> steps(cur, sbits[warp], lane);
    unsigned long long* buf = sbuf[warp][g & 1];
    if (!fast) {
      acs_group<S, 2>(steps, e, lane, ma, mb, buf);
    } else if constexpr (kU8) {
      if (g == 0)
        acs_group<S, 1>(steps, e, lane, ma, mb, buf);
      else
        acs_group<S, 0>(steps, e, lane, ma, mb, buf);
      if ((g + 1) % kRenormGroups == 0) {
        const float mn = warp_min(Tr::lane_min(ma, mb));
        ma = ma - mn;
        mb = mb - mn;
      }
    }
    __syncwarp();
    const int t = g * 32 + lane;
    if (t < T) dw[t] = buf[lane];
    cur = nxt;
  }
  if (cycles != nullptr && lane == 0) cycles[w] = clock64() - t_start;
}

template <int S, typename In, int R>
int launch_acs(const void* soft, const int* starts, const float* expected,
               unsigned long long* dec, int B, int T, long long total,
               long long* cycles, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  acs_kernel<S, In, R><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const In*>(soft), starts, expected, dec, B, T, total,
      cycles);
  return static_cast<int>(cudaGetLastError());
}

template <int S, typename In>
int dispatch_acs(int R, const void* soft, const int* starts,
                 const float* expected, unsigned long long* dec, int B, int T,
                 long long total, long long* cycles, cudaStream_t stream) {
  switch (R) {
    case 1:
      return launch_acs<S, In, 1>(soft, starts, expected, dec, B, T, total,
                                  cycles, stream);
    case 2:
      return launch_acs<S, In, 2>(soft, starts, expected, dec, B, T, total,
                                  cycles, stream);
    case 3:
      return launch_acs<S, In, 3>(soft, starts, expected, dec, B, T, total,
                                  cycles, stream);
    default:
      return launch_acs<S, In, 4>(soft, starts, expected, dec, B, T, total,
                                  cycles, stream);
  }
}

template <int S>
int dispatch_soft(int soft_u8, int R, const void* soft, const int* starts,
                  const float* expected, unsigned long long* dec, int B,
                  int T, long long total, long long* cycles,
                  cudaStream_t stream) {
  return soft_u8 ? dispatch_acs<S, uint8_t>(R, soft, starts, expected, dec, B,
                                            T, total, cycles, stream)
                 : dispatch_acs<S, float>(R, soft, starts, expected, dec, B,
                                          T, total, cycles, stream);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// words [k * kChunk, min((k + 1) * kChunk, T)) of a window into `dst`, as
// one cp.async group of this thread
__device__ __forceinline__ void stage(unsigned long long* dst,
                                      const unsigned long long* src, int k,
                                      int T, int lane) {
  const int lo = k * kChunk, n = min(kChunk, T - lo);
  for (int i = lane; i < n; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst + i)),
                 "l"(src + lo + i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The walker of S states: step(word) returns the step's bit (the state's
// low bit) and moves to the predecessor, starting from state 0.
template <int S>
struct Walker;

// S = 64: the state kept as 32 * top + sh
template <>
struct Walker<64> {
  uint32_t sh = 0;
  bool top = false;
  __device__ __forceinline__ uint32_t step(unsigned long long word) {
    const uint32_t bit = sh & 1u;
    const uint32_t half = top ? static_cast<uint32_t>(word >> 32)
                              : static_cast<uint32_t>(word);
    const bool took = (half >> sh) & 1u;  // the decision of the state
    // state (s >> 1) + 32 * took: bits 0-4 are s >> 1, bit 5 is took
    sh = (sh >> 1) | (top ? 16u : 0u);
    top = took;
    return bit;
  }
};

// S = 16: the state whole; its decision is bit s of the word's low half
template <>
struct Walker<16> {
  uint32_t s = 0;
  __device__ __forceinline__ uint32_t step(unsigned long long word) {
    const uint32_t bit = s & 1u;
    const uint32_t took = (static_cast<uint32_t>(word) >> s) & 1u;
    s = (s >> 1) | (took << 3);  // (s >> 1) + 8 * took
    return bit;
  }
};

// n steps of one stage, backwards; writes each step's bit to out (8-byte
// aligned). Past the n % 8 ragged top steps, the words come into
// registers 8 at a time, a batch ahead of the steps that read them, and
// the bits leave 8 at a time: no load or store sits on the walk's chain.
template <int S>
__device__ __forceinline__ void walk(const unsigned long long* __restrict__ w,
                                     uint8_t* __restrict__ out, int n,
                                     Walker<S>& walker) {
  int i = n;
  while (i & 7) {
    --i;
    out[i] = static_cast<uint8_t>(walker.step(w[i]));
  }
  if (i == 0) return;
  unsigned long long cur[8], nxt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cur[k] = w[i - 8 + k];
  for (; i > 0; i -= 8) {
    const int lo = max(i - 16, 0);  // the batch below (a stale one at i = 8)
#pragma unroll
    for (int k = 0; k < 8; ++k) nxt[k] = w[lo + k];
    unsigned long long b = 0;
#pragma unroll
    for (int k = 7; k >= 0; --k)
      b |= static_cast<unsigned long long>(walker.step(cur[k])) << (8 * k);
    *reinterpret_cast<unsigned long long*>(out + i - 8) = b;
#pragma unroll
    for (int k = 0; k < 8; ++k) cur[k] = nxt[k];
  }
}

template <int S>
__global__ void __launch_bounds__(32)
    traceback_kernel(const unsigned long long* __restrict__ dec,
                     uint8_t* __restrict__ bits, int T,
                     long long* __restrict__ cycles) {
  __shared__ __align__(16) unsigned long long ring[2][kChunk];
  __shared__ __align__(8) uint8_t sbits[kChunk];
  const int lane = threadIdx.x;
  const long long t_start = clock64();
  const unsigned long long* dw = dec + static_cast<long long>(blockIdx.x) * T;
  uint8_t* bw = bits + static_cast<long long>(blockIdx.x) * T;
  const int nch = (T + kChunk - 1) / kChunk;
  stage(ring[(nch - 1) & 1], dw, nch - 1, T, lane);
  Walker<S> walker;  // the walk starts at state 0
  for (int k = nch - 1; k >= 0; --k) {
    if (k > 0) {
      stage(ring[(k - 1) & 1], dw, k - 1, T, lane);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();  // every lane's copies of stage k have landed
    const int lo = k * kChunk, n = min(kChunk, T - lo);
    if (lane == 0) walk(ring[k & 1], sbits, n, walker);
    __syncwarp();
    for (int i = lane; i < n; i += 32) bw[lo + i] = sbits[i];
  }
  if (cycles != nullptr && lane == 0) cycles[blockIdx.x] = clock64() - t_start;
}

}  // namespace

extern "C" {

// soft [total, R] uint8 (soft_u8) or float32, starts [B] int32 (each
// clamped to [0, total - T]), expected [2S, R] float32 (register outputs
// times 255) -> dec [B, T] 64-bit decision words; cycles: null or [B]
// int64, each window's clock64 cycles. 1 <= T <= total, R <= 4, S = 16
// or 64.
int viterbi_acs(const void* soft, int soft_u8, const int* starts,
                const float* expected, long long* dec, int B, int T,
                long long total, int R, int S, long long* cycles,
                void* stream) {
  if (B < 1 || T < 1 || total < T || R < 1 || R > MAX_RATE ||
      (S != 16 && S != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* d = reinterpret_cast<unsigned long long*>(dec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return S == 64 ? dispatch_soft<64>(soft_u8, R, soft, starts, expected, d, B,
                                     T, total, cycles, s)
                 : dispatch_soft<16>(soft_u8, R, soft, starts, expected, d, B,
                                     T, total, cycles, s);
}

// dec [B, T] 64-bit decision words of S = 16 or 64 states -> bits [B, T]
// uint8 (the state's low bit per step, walking back from state 0);
// cycles: null or [B] int64.
int viterbi_traceback(const long long* dec, unsigned char* bits, int B,
                      int T, int S, long long* cycles, void* stream) {
  if (B < 1 || T < 1 || (S != 16 && S != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = reinterpret_cast<const unsigned long long*>(dec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 64)
    traceback_kernel<64><<<B, 32, 0, s>>>(d, bits, T, cycles);
  else
    traceback_kernel<16><<<B, 32, 0, s>>>(d, bits, T, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
