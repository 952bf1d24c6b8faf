// Batched Viterbi add-compare-select and survivor traceback, for Hopper:
// warp-per-window kernels for S <= 64 states (orders 2 to 7: the K = 7
// codes of Meteor LRPT and KG-STV, M17's K = 5) at rates R <= 4, and
// general kernels for every other state count S = 2 ... 16384 (orders 2
// to 15) and rate R = 2 ... 32.
//
// Replaces three Pallas kernels of the JAX package:
//   - sdrpp_tpu/ops/fec_pallas.py:51 viterbi_acs_pallas_batched
//     (pallas_call :112): B windows in lock-step, [B, T, R] soft bits ->
//     [B, T, S] int8 decisions. Entry viterbi_acs.
//   - sdrpp_tpu/ops/fec_pallas.py:221 viterbi_acs_pallas (pallas_call
//     :296), the single-stream ACS of any state count: the same entry with
//     B = 1, start 0 and T the whole stream.
//   - sdrpp_tpu/ops/fec_pallas.py:132 viterbi_traceback_pallas_batched
//     (pallas_call :197): decisions -> [B, T] bits, walking back from state
//     0. Entry viterbi_traceback.
//
// Decisions are packed: bit n & 63 of 64-bit word n >> 6 of a trellis step
// is the decision of state n (1 = it took the predecessor (n >> 1) + S /
// 2); S <= 64 is one word a step with bits >= S zero, S > 64 is S / 64
// words a step; ops/fec_kernels.unpack_decisions gives the JAX kernels'
// int8 form.
// A window's 4288 words are 34 KB, 8x fewer bytes than int8 decisions: the
// 30-s pass's 528 windows write 18 MB, a 1024-window launch 35 MB, which
// stays in the 50 MB L2 for the traceback that reads it next.
//
// What bounds them on an H100: each is a dependent chain of T steps per
// window, so the time is T times the latency of one step's chain (tens of
// cycles), not bytes or operations; a launch has a few windows per SM, too
// few for other warps to hide a latency on the chain. The designs take
// everything they can off that chain; the general traceback (below) cuts
// it into segments walked in parallel.
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
// ACS design, S <= 32 (S = 16 for M17): the same warp per window, the
// same loads and the same group schedule; lane l keeps the metric of
// state l % S (the lanes above S compute copies, so every shuffle and
// ballot stays a full-warp one), reads its predecessors (l % S) >> 1 and
// ((l % S) >> 1) + S / 2 with two shuffles, and one ballot's low S bits
// make the word.
//
// Normalisation off the chain, exactly. The reference subtracts the
// minimum metric every step. For uint8 soft bits every branch metric
// sum_j |s_j - e_j| is an integer. The first K - 1 = log2(S) steps of a
// window run the reference form: the 1e9 metrics of
// states not yet reachable round, so they must be computed as the
// reference computes them. After K - 1 steps every state is reachable
// from state 0 (a state's K - 1 bits are the last K - 1 input bits), and
// from then on every state is reachable from every state in K - 1 steps,
// so all metrics are integers within (K - 1) * R * 255 of the minimum,
// and leaving out a common offset changes no comparison and no tie. The
// kernel subtracts the minimum only after every 4096th step: between two
// such steps no metric exceeds (4096 + K - 1) * R * 255 < 2^24 (R <= 4,
// K <= 7), so every float32 add is exact and the decisions equal
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
// bit s of the word's low half and the predecessor (s >> 1) + 8 * took;
// for S = 2, 4, 8 and 32 likewise, with the predecessor (s >> 1) + S / 2
// * took.
//
// General ACS (S >= 128, and every S at R > 4):
//   - uint8 soft bits at S = 64 ... 1024 (S = 64 only at R > 4) and R <=
//     16 (acs_r4_kernel): one CTA of S threads a window, a state a thread,
//     two trellis steps a barrier (radix 4). Thread n reads the four
//     ancestors of its state two steps back, computes the two
//     intermediate states n >> 1 and (n >> 1) + S / 2 (each also computed
//     by thread n ^ 1) and then its own, every candidate one float32 add
//     and the reference's c1 < c0; the intermediate words come from one
//     shuffle and one ballot a warp (acs_r4_kernel's comment). Branch
//     metrics of the six rows a thread needs are taken from soft bits
//     loaded a unit ahead (rows in registers for R <= 4: kR = R), so
//     after the barrier the chain is four reads, two add-compare-selects
//     and a store. A window's first K - 1 steps, every 4096th and the
//     one after it, and a plain run's odd last step take the radix-2
//     reference step; so does every step when the expected outputs are
//     not integers in [0, 255]. Measured by clock64 ablation before the
//     redesign (tools/viterbi_probe.py, PERF.md): the one-step-a-barrier
//     form lost its time to the branch metrics read after the barrier
//     and to the per-step renormalisation bookkeeping, not to the barrier.
//   - float32 soft bits, R > 16, and S >= 2048 (acs_cta_kernel): one CTA
//     a window
//     with min(S, 1024) threads, thread i keeping states i, i + threads,
//     ...; the metrics
//     are double-buffered in shared memory (2 x S floats: 128 KB at S =
//     16384, as dynamic shared memory), one __syncthreads a step.
//     Decisions leave as one 32-bit ballot a warp a step, at word n >> 5
//     of the step's S / 32. A step's minimum is not a second barrier:
//     where a step records it, each warp writes its minimum beside the
//     new metrics, and the next step reduces those (at most 32) and
//     subtracts the minimum as it reads a predecessor, (m_old[p] - min)
//     + bm, which is the reference's m[p] + bm to the bit. Float32 soft
//     bits record it every step (the reference form); uint8 soft bits
//     with integral expected outputs at R <= 16 record it only on a
//     window's first K - 1 steps and every 4096th, as the tuned kernels
//     do: (4096 + K - 1) * R * 255 < 2^24 at K <= 15. Soft bits are read
//     where they lie in the stream, a group of G steps (G * R <= the
//     threads, G <= 32) per load: a thread loads its value of the next
//     group at a group's first step and stores it to shared memory at
//     its last, so the load's latency is off the chain; a step's branch
//     metrics are read beside its predecessors' metrics, after the
//     barrier (computing the next step's before the barrier was measured
//     slower: their shared-memory reads then add to the chain). A thread
//     keeps its states' expected rows in registers for R <= 4 (at most
//     two states a thread); otherwise it reads them through the
//     read-only cache.
//   - S <= 32 at R > 4 (acs_warp_kernel): one warp a window, four windows
//     a CTA, lane l keeping state l % S, the reference form every step.
//
// General traceback (S > 64): a segment-parallel survivor walk. The walk
// is a composition of per-step maps, state -> predecessor, and
// composition is associative, so the card walks every segment of L steps
// at once (L = 2^(floor(log2 T) / 2) in [32, 4096]: 1024 at fec-k9's 2^21
// steps, 64 at a 4288-step window) from each of its S possible end states,
// and one chain of T / L lookups then picks each segment's end state. Three
// launches, every step exact for any words (no early exit; a walk that
// never merges, as under words where state s takes s & 1, costs the same):
//   1. maps (tb_map_kernel): a CTA a (window, segment), min(16, S / 128)
//      end states a thread (128 ... 1024 threads); the segment's words
//      pass through a two-stage cp.async ring of 4 KB, every thread walks
//      its states one step a row (a shared-memory load, a funnel shift, a
//      multiply-add) and keeps their bits in a register, storing 32 steps'
//      bits a state as one word (packed [B, T / 32, S] uint32, coalesced
//      across the CTA) and, at the bottom, the state each leaves in (maps
//      [B, T / L, S] uint16). Issue-bound: S * T walk steps of ~8
//      instructions.
//   2. chain (tb_chain_kernel): a warp a window, from state 0 at the top:
//      entry[j] = s, s = maps[j][s]. The rows' addresses do not depend on
//      s, so the warp stages them ahead through a two-stage 32-KB ring and
//      a link is one shared-memory load of lane 0 (up to S = 2048; above,
//      lane 0 reads the one entry from global memory). A dependent chain
//      of T / L loads.
//   3. bits (tb_select_kernel): a thread a 4-step group reads the packed
//      word of its segment's entry state and writes the group's 4 bits as
//      one 4-byte store (coalesced across the warp).
// Recording every end state's bits (S * T / 8 bytes, the size of the
// words) costs phase 1 one funnel shift a walk step and a store every 32,
// which its issue-bound loop hides; walking each segment again from its
// entry would cost a dependent chain of L loads a segment. No merge
// shortcut (stopping a segment's walkers once they hold one state): it
// ran the maps 11x faster on a noisy K = 9 stream's words but 1.5x slower
// on words that never merge, and would need a tail walk and a second bits
// path (tools/viterbi_probe.py). On an H100 the three take 0.32 ms at
// fec-k9's [1, 2097162] words at S = 256, where one lane walking every
// step took 60 ms; the bound is the words' 67 MB read once, 20 us.
// The scratch (tb_layout) comes from the caller, the host path's caching
// allocator.
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

constexpr int MAX_RATE = 4;         // soft bits a step of the tuned kernels
constexpr int MIN_RATE = 2;         // the general kernels' rates
constexpr int MAX_ANY_RATE = 32;
constexpr int MAX_STATES = 16384;   // order 15
constexpr int kRegRate = 4;         // expected rows kept in registers up to
constexpr int kCtaThreads = 1024;   // the general ACS's largest CTA
constexpr int kMapStage = 1024;     // 32-bit words a ring stage of the wide
                                    // walk's maps (4 KB)
constexpr int kChainStage = 16384;  // map entries a ring stage of its chain
constexpr int kChainDirect = 4096;  // its chain reads global memory from here
constexpr int kTbMaxPer = 16;       // most end states a thread of its maps
constexpr int kTbMinLog = 5;        // its segments: 32 ... 4096 steps
constexpr int kTbMaxLog = 12;
constexpr int kRenormSteps = 4096;  // the general ACS's fast-form interval
// the general ACS's fast form: (4096 + K - 1) * R * 255 < 2^24 for every
// K <= 15 at R <= 16
constexpr int kFastRate = 16;
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
// states l (`ma`) and l + 32 (`mb`); Trellis<S> for S <= 32: lane l holds
// state l % S in `ma` (the lanes above S a copy of lanes 0 to S - 1), `mb`
// unused. kRef = K - 1 = log2(S), a window's reference-form steps.
template <int S>
struct Trellis {
  static_assert(S >= 2 && S <= 32 && (S & (S - 1)) == 0,
                "one state a lane: S = 2, 4, 8, 16 or 32");
  static constexpr int kRef = S == 2 ? 1 : S == 4 ? 2 : S == 8 ? 3
                              : S == 16 ? 4 : 5;
  static constexpr int kRegs = 2;
  // [0] state n = lane % S via p0 (register n), [1] via p1 (n + S)
  __device__ static void regs(int lane, int (&r)[kRegs]) {
    r[0] = lane & (S - 1); r[1] = (lane & (S - 1)) + S;
  }
  __device__ static void init(int lane, float& ma, float& mb) {
    ma = (lane & (S - 1)) == 0 ? 0.0f : 1e9f;
    mb = 0.0f;
  }
  __device__ static unsigned long long step(const float (&bm)[kRegs],
                                            int lane, float& ma, float&) {
    // predecessors of state n: n >> 1 and (n >> 1) + S / 2
    const int n = lane & (S - 1);
    const float p0 = __shfl_sync(FULL, ma, n >> 1);
    const float p1 = __shfl_sync(FULL, ma, (n >> 1) + S / 2);
    const float c0 = p0 + bm[0], c1 = p1 + bm[1];
    const unsigned d = __ballot_sync(FULL, c1 < c0);
    ma = fminf(c0, c1);
    // the lanes above S repeat lanes 0 to S - 1's decisions
    return d & static_cast<unsigned>((1ull << S) - 1);
  }
  __device__ static float lane_min(float ma, float) { return ma; }
};

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
  __device__ explicit Walker(int) {}
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
  __device__ explicit Walker(int) {}
  __device__ __forceinline__ uint32_t step(unsigned long long word) {
    const uint32_t bit = s & 1u;
    const uint32_t took = (static_cast<uint32_t>(word) >> s) & 1u;
    s = (s >> 1) | (took << 3);  // (s >> 1) + 8 * took
    return bit;
  }
};

// Walker<0>: any S <= 64; the decision is bit s of the word
template <>
struct Walker<0> {
  uint32_t s = 0;
  uint32_t half;
  __device__ explicit Walker(int S) : half(static_cast<uint32_t>(S) >> 1) {}
  __device__ __forceinline__ uint32_t step(unsigned long long word) {
    const uint32_t bit = s & 1u;
    const bool took = (word >> s) & 1ull;
    s = (s >> 1) | (took ? half : 0u);  // (s >> 1) + S / 2 * took
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
                     uint8_t* __restrict__ bits, int T, int num_states,
                     long long* __restrict__ cycles) {
  __shared__ __align__(16) unsigned long long ring[2][kChunk];
  __shared__ __align__(8) uint8_t sbits[kChunk];
  const int lane = threadIdx.x;
  const long long t_start = clock64();
  const unsigned long long* dw = dec + static_cast<long long>(blockIdx.x) * T;
  uint8_t* bw = bits + static_cast<long long>(blockIdx.x) * T;
  const int nch = (T + kChunk - 1) / kChunk;
  stage(ring[(nch - 1) & 1], dw, nch - 1, T, lane);
  Walker<S> walker(num_states);  // the walk starts at state 0
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


// ---------------------------------------------------------------------------
// General ACS and traceback: every S = 2 ... 16384, every R = 2 ... 32
// ---------------------------------------------------------------------------

__device__ __forceinline__ float soft_value(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float soft_value(float v) { return v; }

// The branch metric of register row `row` at soft bits s[0, R): sum_j
// |s_j - e[row, j]| in j order, the row's expected outputs from `cached`
// (kReg: R <= kRegRate, in registers) or from `expected` [2S, R].
template <bool kReg>
__device__ __forceinline__ float branch_metric(
    const float* s, const float* __restrict__ expected,
    const float (&cached)[kRegRate], int row, int R) {
  if constexpr (kReg) {
    float acc = fabsf(s[0] - cached[0]);
#pragma unroll
    for (int j = 1; j < kRegRate; ++j)
      if (j < R) acc = acc + fabsf(s[j] - cached[j]);
    return acc;
  } else {
    const float* e = expected + static_cast<long long>(row) * R;
    float acc = fabsf(s[0] - __ldg(e));
    for (int j = 1; j < R; ++j) acc = acc + fabsf(s[j] - __ldg(e + j));
    return acc;
  }
}

// register row `row`'s expected outputs into registers (kReg only)
template <bool kReg>
__device__ __forceinline__ void cache_row(const float* __restrict__ expected,
                                          int row, int R,
                                          float (&out)[kRegRate]) {
#pragma unroll
  for (int j = 0; j < kRegRate; ++j)
    out[j] = kReg && j < R ? expected[row * R + j] : 0.0f;
}

// S <= 32: one warp a window (lane l: state l % S), kWarps windows a CTA;
// G = 32 / R steps of soft bits a group, staged through shared memory.
template <typename In, bool kReg>
__global__ void __launch_bounds__(kWarps * 32)
    acs_warp_kernel(const In* __restrict__ soft,
                    const int* __restrict__ starts,
                    const float* __restrict__ expected,
                    unsigned long long* __restrict__ dec, int B, int T,
                    long long total, int R, int S,
                    long long* __restrict__ cycles) {
  __shared__ float sst[kWarps][2][32];
  __shared__ unsigned long long sbuf[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= B) return;  // whole warps leave together
  const long long t_start = clock64();
  const int n = lane & (S - 1);
  const int p0 = n >> 1, p1 = (n >> 1) + (S >> 1);
  const unsigned long long keep = (1ull << S) - 1;
  float e0[kRegRate], e1[kRegRate];
  cache_row<kReg>(expected, n, R, e0);
  cache_row<kReg>(expected, n + S, R, e1);
  const long long start =
      min(max(static_cast<long long>(starts[w]), 0LL), total - T);
  const In* sw = soft + start * R;
  const long long nvals = static_cast<long long>(T) * R;
  const int G = 32 / R, GR = G * R;
  sst[warp][0][lane] = lane < GR && lane < nvals ? soft_value(sw[lane]) : 0.0f;
  __syncwarp();
  unsigned long long* dw = dec + static_cast<long long>(w) * T;
  float m = n == 0 ? 0.0f : 1e9f;
  for (int t0 = 0, g = 0; t0 < T; t0 += G, ++g) {
    // the next group's value of this lane, loaded off the chain
    const long long nx = static_cast<long long>(t0 + G) * R + lane;
    const float pre = lane < GR && nx < nvals ? soft_value(sw[nx]) : 0.0f;
    const float* sg = sst[warp][g & 1];
    const int steps = min(G, T - t0);
    for (int i = 0; i < steps; ++i) {
      const float* sv = sg + i * R;
      const float bm0 = branch_metric<kReg>(sv, expected, e0, n, R);
      const float bm1 = branch_metric<kReg>(sv, expected, e1, n + S, R);
      const float c0 = __shfl_sync(FULL, m, p0) + bm0;
      const float c1 = __shfl_sync(FULL, m, p1) + bm1;
      const bool take = c1 < c0;
      const float v = take ? c1 : c0;
      const unsigned word = __ballot_sync(FULL, take);
      m = v - warp_min(v);
      if (lane == 0) sbuf[warp][i] = word & keep;
    }
    sst[warp][(g + 1) & 1][lane] = pre;
    __syncwarp();
    if (lane < steps) dw[t0 + lane] = sbuf[warp][lane];
    __syncwarp();
  }
  if (cycles != nullptr && lane == 0) cycles[w] = clock64() - t_start;
}

// S >= 64: one CTA of S / K threads a window, K states a thread. Dynamic
// shared memory: metrics [2][S], soft bits [2][G * R], warp minima [2][32].
template <typename In, int K, bool kReg>
__global__ void __launch_bounds__(kCtaThreads)
    acs_cta_kernel(const In* __restrict__ soft,
                   const int* __restrict__ starts,
                   const float* __restrict__ expected,
                   uint32_t* __restrict__ dec, int T, long long total, int R,
                   int S, int G, long long* __restrict__ cycles) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kU8 = sizeof(In) == 1;  // integral soft bits
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int half = S >> 1, GR = G * R, wps = S >> 5;  // 32-bit words a step
  float* const mbuf = smem;
  float* const sst = smem + 2 * S;
  float* const wmin = sst + 2 * GR;
  const int w = blockIdx.x;
  const long long t_start = clock64();
  const long long start =
      min(max(static_cast<long long>(starts[w]), 0LL), total - T);
  const In* sw = soft + start * R;
  const long long nvals = static_cast<long long>(T) * R;
  float e0[K][kRegRate], e1[K][kRegRate];
  bool e_ok = true;  // this thread's expected rows: integers in [0, 255]
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = k * nthr + tid;
    mbuf[n] = n == 0 ? 0.0f : 1e9f;
    cache_row<kReg>(expected, n, R, e0[k]);
    cache_row<kReg>(expected, n + S, R, e1[k]);
    for (int j = 0; kU8 && j < R; ++j) {
      const float x0 = expected[n * R + j], x1 = expected[(n + S) * R + j];
      e_ok = e_ok && x0 == rintf(x0) && x0 >= 0.0f && x0 <= 255.0f &&
             x1 == rintf(x1) && x1 >= 0.0f && x1 <= 255.0f;
    }
  }
  if (tid < GR) sst[tid] = tid < nvals ? soft_value(sw[tid]) : 0.0f;
  // the fast form (integral metrics, the minimum off the chain) for uint8
  // soft bits and integral expected outputs at R <= kFastRate
  const bool fast =
      __syncthreads_and(kU8 && e_ok && R <= kFastRate) != 0;
  const int ref_steps = 31 - __clz(S);  // K - 1
  uint32_t* dw = dec + static_cast<long long>(w) * T * wps;
  float pre = 0.0f;
  int g = 0, i = 0;
  bool use_mn = false;  // the previous step recorded its minimum
  for (int t = 0; t < T; ++t) {
    const float* mo = mbuf + (t & 1) * S;
    float* mw = mbuf + ((t + 1) & 1) * S;
    if (i == 0) {  // the next group's value of this thread, off the chain
      const long long nx = static_cast<long long>(g + 1) * GR + tid;
      pre = tid < GR && nx < nvals ? soft_value(sw[nx]) : 0.0f;
    }
    // the previous step's minimum, from its warps' minima
    const float mn =
        use_mn ? warp_min(lane < nwarps ? wmin[((t + 1) & 1) * 32 + lane]
                                        : INFINITY)
               : 0.0f;
    // this step records its minimum: every step in the reference form;
    // in the fast form a window's first K - 1 steps and every 4096th
    const bool rec =
        !fast || t < ref_steps || (t + 1) % kRenormSteps == 0;
    const float* sv = sst + (g & 1) * GR + i * R;
    uint32_t* ds = dw + static_cast<long long>(t) * wps;
    float lmin = INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int n = k * nthr + tid, p = n >> 1;
      const float bm0 = branch_metric<kReg>(sv, expected, e0[k], n, R);
      const float bm1 = branch_metric<kReg>(sv, expected, e1[k], n + S, R);
      float a = mo[p], b = mo[p + half];
      if (use_mn) {  // (m_old[p] - min) is the reference's metric m[p]
        a = a - mn;
        b = b - mn;
      }
      const float c0 = a + bm0, c1 = b + bm1;
      const bool take = c1 < c0;
      const float v = take ? c1 : c0;
      mw[n] = v;
      lmin = fminf(lmin, v);
      const unsigned word = __ballot_sync(FULL, take);
      if (lane == 0) ds[n >> 5] = word;
    }
    if (rec) {
      const float wm = warp_min(lmin);
      if (lane == 0) wmin[(t & 1) * 32 + warp] = wm;
    }
    if (i == G - 1 && tid < GR) sst[((g + 1) & 1) * GR + tid] = pre;
    __syncthreads();
    use_mn = rec;
    if (++i == G) {
      i = 0;
      ++g;
    }
  }
  if (cycles != nullptr && tid == 0) cycles[w] = clock64() - t_start;
}

// uint8 soft bits at S = 64 ... 1024, R <= kFastRate: a thread a state
// (n = threadIdx.x), two trellis steps a barrier. Dynamic shared memory:
// metrics [2][S], warp minima [2][32], decision words [2][32][S / 32]
// (a group of 32 steps each), soft bits [2][CH * R] as floats (a chunk of
// CH = 2^cs steps each, CH * R <= 4 S: four values a thread to stage).
//
// Thread n's state at step t + 2 has the intermediate predecessors q0 =
// n >> 1 and q1 = q0 + S / 2 at t + 1, and those have the four
// predecessors a = n >> 2, a + S / 4, a + S / 2 and a + 3 S / 4 at t. A
// pair reads the four, computes q0's and q1's metrics with the reference's
// rule (c1 < c0 takes the second, one float32 add each), then state n's;
// the pair of threads n, n ^ 1 computes the same q0 and q1, so each
// intermediate decision is known twice. The intermediate step's words:
// lane l < 16 takes q0's decision from lane 2 l, lane l >= 16 q1's from
// lane 2 (l - 16) (one shuffle), and one ballot gives states [16 w, 16 w
// + 16) in its low half and [S / 2 + 16 w, ...) in its high half, the u16
// halves at indices w and S / 32 + w of the step's words. The final step's
// ballot is word w. Rows (expected outputs) of the six branches a thread
// needs (q0, q0 + S, q1, q1 + S, n, n + S) stay in registers (kReg: R <=
// kRegRate) or are read through the cache; a pair's branch metrics are
// computed from soft bits loaded a unit ahead, so after the barrier the
// chain is the four metric reads, two levels of add-compare-select and the
// store.
//
// Steps that record or subtract a minimum (a window's first K - 1, every
// 4096th and the one after it) and a plain run's odd last step run the
// radix-2 reference step; so does every step when the expected outputs
// are not integers in [0, 255] (the reference form). The split loop
// tests only its bounds and one event index a unit: the soft-bit chunk
// c + 1 is loaded into registers at step c CH and stored at c CH + CH / 2
// (at least two steps before any unit reads it), and each group of 32
// steps' words leave, one coalesced word a thread, in the first unit after
// the group; both happen before that unit's barrier.
template <int kR, int kThreads>
__global__ void __launch_bounds__(kThreads)
    acs_r4_kernel(const uint8_t* __restrict__ soft,
                  const int* __restrict__ starts,
                  const float* __restrict__ expected,
                  uint32_t* __restrict__ dec, int T, long long total, int R,
                  int S, int cs, long long* __restrict__ cycles) {
  extern __shared__ __align__(16) float smem[];
  const int n = threadIdx.x, lane = n & 31, warp = n >> 5;
  const int nwarps = S >> 5, wps = S >> 5;  // 32-bit words a step
  const int half = S >> 1, quarter = S >> 2;
  const int CH = 1 << cs, CHR = CH * R;  // a chunk's steps and values
  constexpr bool kReg = kR > 0;          // R known, rows in registers
  float* const mbuf = smem;
  float* const wmin = mbuf + 2 * S;
  uint32_t* const stage = reinterpret_cast<uint32_t*>(wmin + 64);
  float* const sbuf = reinterpret_cast<float*>(stage + 2 * 32 * wps);
  const int w = blockIdx.x;
  const long long t_start = clock64();
  const long long start =
      min(max(static_cast<long long>(starts[w]), 0LL), total - T);
  const uint8_t* sw = soft + start * R;
  const long long nvals = static_cast<long long>(T) * R;
  uint32_t* dw = dec + static_cast<long long>(w) * T * wps;
  // the six rows: q0, q0 + S, q1, q1 + S (step t), n, n + S (step t + 1)
  const int q0 = n >> 1, a = n >> 2;
  const int rows[6] = {q0, q0 + S, q0 + half, q0 + half + S, n, n + S};
  float e[6][kRegRate];
#pragma unroll
  for (int k = 0; k < 6; ++k) cache_row<kReg>(expected, rows[k], R, e[k]);
  bool e_ok = true;  // rows n and n + S: integers in [0, 255]
  for (int j = 0; j < R; ++j) {
    const float x0 = expected[n * R + j], x1 = expected[(n + S) * R + j];
    e_ok = e_ok && x0 == rintf(x0) && x0 >= 0.0f && x0 <= 255.0f &&
           x1 == rintf(x1) && x1 >= 0.0f && x1 <= 255.0f;
  }
  mbuf[n] = n == 0 ? 0.0f : 1e9f;
  // soft-bit chunk 0, and chunk 1 into registers (value k: index n + k S)
  float pend[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = n + k * S;
    if (i < CHR) sbuf[i] = i < nvals ? static_cast<float>(sw[i]) : 0.0f;
    pend[k] = 0.0f;
  }
  const bool fast = __syncthreads_and(e_ok) != 0;
  const int ref_steps = 31 - __clz(S);  // K - 1
  // a step records its minimum: every step in the reference form, else a
  // window's first K - 1 and every 4096th
  auto rec = [&](int t) {
    return !fast || t < ref_steps || ((t + 1) & (kRenormSteps - 1)) == 0;
  };
  // step t's soft bits: chunk c in half c & 1 of the buffer
  auto soft_at = [&](int t) -> const float* {
    return sbuf + (t & (2 * CH - 1)) * R;
  };
  constexpr int kP = kReg ? kR : 1;
  float pf0[kP], pf1[kP];  // the next unit's soft bits (kReg)
  auto prefetch = [&](int t) {
    if constexpr (kReg) {
      // past the window's end: values of no step, never used
      const float* s0 = soft_at(t);
      const float* s1 = soft_at(t + 1);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        pf0[j] = s0[j];
        pf1[j] = s1[j];
      }
    }
  };
  // the branch metric of row k at soft bits s (kR = 0) or pf (kR > 0):
  // sum_j |s_j - e_j| in j order
  auto bm = [&](int k, const float* s, const float (&pf)[kP]) {
    if constexpr (kReg) {
      float acc = fabsf(pf[0] - e[k][0]);
#pragma unroll
      for (int j = 1; j < kR; ++j) acc = acc + fabsf(pf[j] - e[k][j]);
      return acc;
    } else {
      return branch_metric<false>(s, expected, e[k], rows[k], R);
    }
  };
  int cur = 0, wb = 0;             // metric buffer, warp-minima buffer
  int flush_at = 32, chunk_ev = 0, chunk_phase = 0, next_ev = 0;
  auto flush = [&](int g) {  // group g's words, one a thread
    const int lo = g * 32, steps = min(32, T - lo);
    if (n < steps * wps)
      dw[static_cast<long long>(lo) * wps + n] = stage[(g & 1) * 32 * wps + n];
  };
  // a unit's events, before its barrier: the unit of step t is the first
  // past each point, so the barrier before it has made the group's words
  // and the chunk's readers complete
  auto events = [&](int t) {
    if (t < next_ev) return;
    if (t >= flush_at) {
      flush((flush_at >> 5) - 1);
      flush_at += 32;
    }
    if (t >= chunk_ev) {
      const int c = (chunk_ev >> cs) + 1;  // the chunk being staged
      const long long base = static_cast<long long>(c) * CHR;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = n + k * S;
        if (chunk_phase == 0) {
          pend[k] = i < CHR && base + i < nvals
                        ? static_cast<float>(sw[base + i])
                        : 0.0f;
        } else if (i < CHR) {
          sbuf[(c & 1) * CHR + i] = pend[k];
        }
      }
      chunk_phase ^= 1;
      chunk_ev += CH >> 1;
    }
    next_ev = min(flush_at, chunk_ev);
  };
  // the radix-2 step t: subtracts the previous step's minimum (use_mn) as
  // it reads a predecessor, records its own (record)
  auto step2 = [&](int t, bool use_mn, bool record) {
    const float* mo = mbuf + cur * S;
    float* mw = mbuf + (cur ^ 1) * S;
    const float mn =
        use_mn ? warp_min(lane < nwarps ? wmin[wb * 32 + lane] : INFINITY)
               : 0.0f;
    const float* sv = soft_at(t);
    const float bm0 = bm(4, sv, pf0), bm1 = bm(5, sv, pf0);
    prefetch(t + 1);
    float x = mo[q0], y = mo[q0 + half];
    if (use_mn) {  // (m_old[p] - min) is the reference's metric m[p]
      x = x - mn;
      y = y - mn;
    }
    const float c0 = x + bm0, c1 = y + bm1;
    const bool take = c1 < c0;
    const float v = take ? c1 : c0;
    mw[n] = v;
    const unsigned word = __ballot_sync(FULL, take);
    if (lane == 0) stage[(t & 63) * wps + warp] = word;
    if (record) {
      const float wm = warp_min(v);
      if (lane == 0) wmin[(wb ^ 1) * 32 + warp] = wm;
    }
    events(t);
    __syncthreads();
    if (record) wb ^= 1;
    cur ^= 1;
  };
  prefetch(0);
  int t = 0;
  while (t < T) {
    if (rec(t) || (t > 0 && rec(t - 1))) {
      step2(t, t > 0 && rec(t - 1), rec(t));
      ++t;
      continue;
    }
    // a plain run: steps [t, e) record and subtract nothing
    const int e_end = min(T, t | (kRenormSteps - 1));
    auto pair = [&](int t, bool ev) {
      const float* mo = mbuf + cur * S;
      float* mw = mbuf + (cur ^ 1) * S;
      const float m0 = mo[a], m1 = mo[a + quarter];
      const float m2 = mo[a + half], m3 = mo[a + half + quarter];
      const float* s0 = soft_at(t);
      const float* s1 = soft_at(t + 1);
      const float b0 = bm(0, s0, pf0), b1 = bm(1, s0, pf0);
      const float b2 = bm(2, s0, pf0), b3 = bm(3, s0, pf0);
      const float b4 = bm(4, s1, pf1), b5 = bm(5, s1, pf1);
      prefetch(t + 2);
      const float c00 = m0 + b0, c01 = m2 + b1;
      const bool tq0 = c01 < c00;
      const float mq0 = tq0 ? c01 : c00;
      const float c10 = m1 + b2, c11 = m3 + b3;
      const bool tq1 = c11 < c10;
      const float mq1 = tq1 ? c11 : c10;
      // the intermediate decisions' exchange overlaps the last level
      const unsigned both = __shfl_sync(
          FULL, (tq0 ? 1u : 0u) | (tq1 ? 2u : 0u), (2 * lane) & 31);
      const float c0 = mq0 + b4, c1 = mq1 + b5;
      const bool tn = c1 < c0;
      mw[n] = tn ? c1 : c0;
      const unsigned x = __ballot_sync(FULL, (both >> (lane >> 4)) & 1u);
      const unsigned f = __ballot_sync(FULL, tn);
      uint32_t* row0 = stage + (t & 63) * wps;
      uint32_t* row1 = stage + ((t + 1) & 63) * wps;
      if (lane < 2)
        reinterpret_cast<uint16_t*>(row0)[lane ? (S >> 5) + warp : warp] =
            static_cast<uint16_t>(lane ? x >> 16 : x);
      if (lane == 0) row1[warp] = f;
      if (ev) events(t);
      __syncthreads();
      cur ^= 1;
    };
    // pairs that reach no event point run without the test
    while (t + 1 < e_end) {
      const int quiet = min(e_end - 1, next_ev);
      for (; t < quiet; t += 2) pair(t, false);
      if (t + 1 < e_end) {
        pair(t, true);
        t += 2;
      }
    }
    if (t < e_end) {  // the run's odd last step
      step2(t, false, false);
      ++t;
    }
  }
  for (; flush_at - 32 < T; flush_at += 32) flush((flush_at >> 5) - 1);
  if (cycles != nullptr && n == 0) cycles[w] = clock64() - t_start;
}

template <typename In, bool kReg>
int launch_warp(const void* soft, const int* starts, const float* expected,
                unsigned long long* dec, int B, int T, long long total, int R,
                int S, long long* cycles, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  acs_warp_kernel<In, kReg><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const In*>(soft), starts, expected, dec, B, T, total, R, S,
      cycles);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int K, bool kReg>
int launch_cta(const void* soft, const int* starts, const float* expected,
               unsigned long long* dec, int B, int T, long long total, int R,
               int S, long long* cycles, cudaStream_t stream) {
  const int nthr = S / K;
  const int G = min(32, nthr / R);
  const size_t smem = (2 * static_cast<size_t>(S) +
                       2 * static_cast<size_t>(G) * R + 64) * sizeof(float);
  auto* kernel = acs_cta_kernel<In, K, kReg>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, nthr, smem, stream>>>(static_cast<const In*>(soft), starts,
                                    expected, reinterpret_cast<uint32_t*>(dec),
                                    T, total, R, S, G, cycles);
  return static_cast<int>(cudaGetLastError());
}

template <int kR, int kThreads>
int launch_r4(const void* soft, const int* starts, const float* expected,
              unsigned long long* dec, int B, int T, long long total, int R,
              int S, long long* cycles, cudaStream_t stream) {
  int cs = 0;  // CH = 2^cs steps a soft-bit chunk, CH * R <= 4 S
  while ((2 << cs) * R <= 4 * S) ++cs;
  const size_t smem =
      (2 * static_cast<size_t>(S) + 64 + 2 * static_cast<size_t>(S) +
       2 * (static_cast<size_t>(R) << cs)) *
      sizeof(float);
  auto* kernel = acs_r4_kernel<kR, kThreads>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, S, smem, stream>>>(static_cast<const uint8_t*>(soft), starts,
                                 expected, reinterpret_cast<uint32_t*>(dec),
                                 T, total, R, S, cs, cycles);
  return static_cast<int>(cudaGetLastError());
}

// the radix-4 kernel's instance: R = 2, 3, 4 known (rows in registers)
// or not (kR = 0), and a launch bound of 256, 512 or 1024 threads (the
// registers a thread may keep)
template <int kThreads>
int dispatch_r4(const void* soft, const int* starts, const float* expected,
                unsigned long long* dec, int B, int T, long long total,
                int R, int S, long long* cycles, cudaStream_t stream) {
#define VITERBI_R4_ARGS \
  soft, starts, expected, dec, B, T, total, R, S, cycles, stream
  switch (R) {
    case 2:
      return launch_r4<2, kThreads>(VITERBI_R4_ARGS);
    case 3:
      return launch_r4<3, kThreads>(VITERBI_R4_ARGS);
    case 4:
      return launch_r4<4, kThreads>(VITERBI_R4_ARGS);
    default:
      return launch_r4<0, kThreads>(VITERBI_R4_ARGS);
  }
#undef VITERBI_R4_ARGS
}

template <typename In>
int acs_general(int R, int S, const void* soft, const int* starts,
                const float* expected, unsigned long long* dec, int B, int T,
                long long total, long long* cycles, cudaStream_t stream) {
  const bool reg = R <= kRegRate;
#define VITERBI_GENERAL_ARGS \
  soft, starts, expected, dec, B, T, total, R, S, cycles, stream
  if (S <= 32)
    return reg ? launch_warp<In, true>(VITERBI_GENERAL_ARGS)
               : launch_warp<In, false>(VITERBI_GENERAL_ARGS);
  switch (S) {
    case 2048:
      return reg ? launch_cta<In, 2, true>(VITERBI_GENERAL_ARGS)
                 : launch_cta<In, 2, false>(VITERBI_GENERAL_ARGS);
    case 4096:
      return launch_cta<In, 4, false>(VITERBI_GENERAL_ARGS);
    case 8192:
      return launch_cta<In, 8, false>(VITERBI_GENERAL_ARGS);
    case 16384:
      return launch_cta<In, 16, false>(VITERBI_GENERAL_ARGS);
    default:  // 64 ... 1024: a thread a state
      if constexpr (sizeof(In) == 1) {
        static_assert(kRegRate <= kFastRate, "uint8 rows past kFastRate");
        if (R <= kFastRate)  // radix 4 (acs_r4_kernel)
          return S <= 256   ? dispatch_r4<256>(VITERBI_GENERAL_ARGS)
                 : S == 512 ? dispatch_r4<512>(VITERBI_GENERAL_ARGS)
                            : dispatch_r4<1024>(VITERBI_GENERAL_ARGS);
        return launch_cta<In, 1, false>(VITERBI_GENERAL_ARGS);
      } else {
        return reg ? launch_cta<In, 1, true>(VITERBI_GENERAL_ARGS)
                   : launch_cta<In, 1, false>(VITERBI_GENERAL_ARGS);
      }
  }
#undef VITERBI_GENERAL_ARGS
}

// ---------------------------------------------------------------------------
// General traceback (S > 64): the segment-parallel survivor walk
// ---------------------------------------------------------------------------

// the wide walk's segment length for T steps: 2^(floor(log2 T) / 2), in
// [2^kTbMinLog, 2^kTbMaxLog] (ops/fec_kernels.wide_segment_steps mirrors it)
int tb_segment_steps(int T) {
  const int e = (31 - __builtin_clz(static_cast<unsigned>(T))) / 2;
  return 1 << (e < kTbMinLog ? kTbMinLog : e > kTbMaxLog ? kTbMaxLog : e);
}

// the scratch of B windows of T steps in segments of L: the maps [B, nseg,
// S] uint16 at its start, then the bits of every end state [B, ceil(T /
// 32), S] uint32 and the entries [B, nseg] int32, each at a 256-byte
// offset
struct TbLayout {
  int nseg;
  long long packed, entries, bytes;
};

TbLayout tb_layout(int B, int T, int S, int L) {
  TbLayout l;
  l.nseg = (T + L - 1) / L;
  const long long t32 = (T + 31) / 32;
  auto up = [](long long x) { return (x + 255) / 256 * 256; };
  l.packed = up(static_cast<long long>(B) * l.nseg * S * 2);
  l.entries = l.packed + up(static_cast<long long>(B) * t32 * S * 4);
  l.bytes = l.entries + up(static_cast<long long>(B) * l.nseg * 4);
  return l;
}

// rows [k * rows, min((k + 1) * rows, n)) of a segment's words (W32 32-bit
// words a step) into `dst`, 8 bytes a copy, as one cp.async group of this
// thread
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* src,
                                           int k, int rows, int n, int W32,
                                           int tid, int nthr) {
  const long long lo = static_cast<long long>(k) * rows * W32;
  const int cnt = (min((k + 1) * rows, n) - k * rows) * W32 / 2;
  for (int i = tid; i < cnt; i += nthr)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst + 2 * i)),
                 "l"(src + lo + 2 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Phase 1, the maps: one CTA a (segment j, window b), thread i walking the
// kPer end states i, i + nthr, ... from the segment's top step down through
// its n steps. Writes the state each leaves the segment in (maps[b, j, e])
// and, after every step t = 0 mod 32, the bits its walk gave steps [t, t +
// 32) (packed[b, t / 32, e], step t + i at bit 31 - i; the steps of a
// block lie in one segment, since L is a multiple of 32). The words pass
// through a two-stage ring of kMapStage 32-bit words. seg_cycles (null, or
// [B, nseg]) receives thread 0's clock64 cycles.
template <int kPer>
__global__ void __launch_bounds__(kCtaThreads)
    tb_map_kernel(const uint32_t* __restrict__ dec, int B, int T, int S,
                  int L, uint16_t* __restrict__ maps,
                  uint32_t* __restrict__ packed,
                  long long* __restrict__ seg_cycles) {
  __shared__ __align__(16) uint32_t ring[2][kMapStage];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int W32 = S >> 5, rows = kMapStage / W32;
  const uint32_t half = static_cast<uint32_t>(S) >> 1;
  const int nseg = gridDim.x, j = blockIdx.x;
  const int lo = j * L, n = min(L, T - lo);
  const int nst = (n + rows - 1) / rows;
  const long long t32 = (T + 31) >> 5;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long t_start = clock64();
    const uint32_t* src = dec + (static_cast<long long>(b) * T + lo) * W32;
    uint32_t s[kPer], acc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      s[q] = static_cast<uint32_t>(tid + q * nthr);
      acc[q] = 0;
    }
    stage_rows(ring[(nst - 1) & 1], src, nst - 1, rows, n, W32, tid, nthr);
    for (int k = nst - 1; k >= 0; --k) {
      if (k > 0) {
        stage_rows(ring[(k - 1) & 1], src, k - 1, rows, n, W32, tid, nthr);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();  // every thread's copies of stage k have landed
      const uint32_t* st = ring[k & 1];
      const int r0 = k * rows;
#pragma unroll 4
      for (int r = min(r0 + rows, n) - 1; r >= r0; --r) {
        const uint32_t* row = st + (r - r0) * W32;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const uint32_t w = row[s[q] >> 5];
          acc[q] = __funnelshift_r(acc[q], s[q], 1);  // bit 31: s & 1
          // bit s & 31 of w: the decision; the predecessor (s >> 1) + S / 2
          const uint32_t took = __funnelshift_r(w, w, s[q]) & 1u;
          s[q] = (s[q] >> 1) + took * half;
        }
        if (((lo + r) & 31) == 0) {
          uint32_t* out = packed + (b * t32 + ((lo + r) >> 5)) * S + tid;
#pragma unroll
          for (int q = 0; q < kPer; ++q) out[q * nthr] = acc[q];
        }
      }
      __syncthreads();  // stage k's buffer takes stage k - 2 next
    }
    uint16_t* m = maps + (static_cast<long long>(b) * nseg + j) * S + tid;
#pragma unroll
    for (int q = 0; q < kPer; ++q) m[q * nthr] = static_cast<uint16_t>(s[q]);
    if (seg_cycles != nullptr && tid == 0)
      seg_cycles[static_cast<long long>(b) * nseg + j] = clock64() - t_start;
  }
}

// map rows [k * R, min((k + 1) * R, nseg)) of a window (S entries a row)
// into `dst`, 16 bytes a copy, as one cp.async group of this lane
__device__ __forceinline__ void stage_maps(uint16_t* dst, const uint16_t* src,
                                           int k, int R, int nseg, int S,
                                           int lane) {
  const long long lo = static_cast<long long>(k) * R * S;
  const int cnt = (min((k + 1) * R, nseg) - k * R) * S / 8;
  for (int i = lane; i < cnt; i += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst + 8 * i)),
                 "l"(src + lo + 8 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Phase 2, the chain: one warp a window. From state 0 at the top, entry[j]
// = s and s = maps[j][s] for j = nseg - 1 down to 0. The rows' addresses
// do not depend on s, so below kChainDirect states the warp stages them
// ahead through a two-stage ring of kChainStage entries (dynamic shared
// memory) and each link is one shared-memory load of lane 0 (~62 cycles
// at S = 128 and 256 on the H100); from kChainDirect on, a stage holds
// four rows or fewer and copying them takes longer than reading the one
// entry a link needs from global memory (~290 cycles a link against
// ~470 staged at S = 4096; tools/viterbi_probe.py). cycles (null, or [B])
// receives the window's clock64 cycles.
__global__ void __launch_bounds__(32)
    tb_chain_kernel(const uint16_t* __restrict__ maps, int S, int nseg,
                    int* __restrict__ entries,
                    long long* __restrict__ cycles) {
  extern __shared__ __align__(16) uint16_t cring[];
  __shared__ int sent[kChainStage / 128];
  const int lane = threadIdx.x, b = blockIdx.x;
  const long long t_start = clock64();
  const int R = max(1, kChainStage / S);  // rows a stage
  const uint16_t* mw = maps + static_cast<long long>(b) * nseg * S;
  int* ew = entries + static_cast<long long>(b) * nseg;
  uint32_t s = 0;  // the walk starts at state 0
  if (S >= kChainDirect) {
    if (lane == 0) {
      for (int j = nseg - 1; j >= 0; --j) {
        ew[j] = static_cast<int>(s);
        s = mw[static_cast<long long>(j) * S + s];
      }
      if (cycles != nullptr) cycles[b] = clock64() - t_start;
    }
    return;
  }
  const int nst = (nseg + R - 1) / R;
  stage_maps(cring + ((nst - 1) & 1) * kChainStage, mw, nst - 1, R, nseg, S,
             lane);
  for (int k = nst - 1; k >= 0; --k) {
    if (k > 0) {
      stage_maps(cring + ((k - 1) & 1) * kChainStage, mw, k - 1, R, nseg, S,
                 lane);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();  // every lane's copies of stage k have landed
    const int lo = k * R, n = min(R, nseg - lo);
    if (lane == 0) {
      // a row's address off the chain: a link is one add and one load
      const uint16_t* row = cring + (k & 1) * kChainStage + (n - 1) * S;
#pragma unroll 4
      for (int i = n - 1; i >= 0; --i, row -= S) {
        sent[i] = static_cast<int>(s);
        s = row[s];
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) ew[lo + i] = sent[i];
    __syncwarp();  // sent and stage k's buffer are rewritten next
  }
  if (cycles != nullptr && lane == 0) cycles[b] = clock64() - t_start;
}

// Phase 3, the bits: a thread a (window b, 32-step block q, group k of 4
// steps) reads the packed word of the end state the block's segment was
// entered in and writes steps 32 q + 4 k ... + 3: one 4-byte store where
// the four lie before T and their address is 4-byte aligned, else byte by
// byte.
__global__ void __launch_bounds__(256)
    tb_select_kernel(const uint32_t* __restrict__ packed,
                     const int* __restrict__ entries,
                     uint8_t* __restrict__ bits, int B, int T, int S, int L,
                     int nseg) {
  const long long t32 = (T + 31) >> 5, total = B * t32 * 8;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < total; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bq = g >> 3, b = bq / t32;
    const int lo = static_cast<int>(bq - b * t32) << 5;
    const int t = lo + 4 * static_cast<int>(g & 7);
    if (t >= T) continue;
    const uint32_t w = packed[bq * S + entries[b * nseg + lo / L]];
    const uint32_t v = w >> (28 - (t - lo));  // steps t ... t + 3: bits 3 ... 0
    uint8_t* out = bits + b * T + t;
    if (t + 4 <= T && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(out) =
          ((v >> 3) & 1u) | ((v >> 2) & 1u) << 8 | ((v >> 1) & 1u) << 16 |
          (v & 1u) << 24;
    } else {
      for (int i = 0; i < 4 && t + i < T; ++i)
        out[i] = static_cast<uint8_t>((v >> (3 - i)) & 1u);
    }
  }
}

template <int kPer>
int launch_tb_map(const uint32_t* dec, int B, int T, int S, int L, int nseg,
                  uint16_t* maps, uint32_t* packed, long long* seg_cycles,
                  cudaStream_t stream) {
  const dim3 grid(nseg, min(B, 65535));
  tb_map_kernel<kPer><<<grid, S / kPer, 0, stream>>>(dec, B, T, S, L, maps,
                                                      packed, seg_cycles);
  return static_cast<int>(cudaGetLastError());
}

// phase 1 at S = 128 ... 16384: min(kTbMaxPer, S / 128) end states a thread
int tb_maps(const uint32_t* dec, int B, int T, int S, int L, int nseg,
            uint16_t* maps, uint32_t* packed, long long* seg_cycles,
            cudaStream_t stream) {
  switch (min(kTbMaxPer, S / 128)) {
    case 1:
      return launch_tb_map<1>(dec, B, T, S, L, nseg, maps, packed,
                              seg_cycles, stream);
    case 2:
      return launch_tb_map<2>(dec, B, T, S, L, nseg, maps, packed,
                              seg_cycles, stream);
    case 4:
      return launch_tb_map<4>(dec, B, T, S, L, nseg, maps, packed,
                              seg_cycles, stream);
    case 8:
      return launch_tb_map<8>(dec, B, T, S, L, nseg, maps, packed,
                              seg_cycles, stream);
    default:
      return launch_tb_map<kTbMaxPer>(dec, B, T, S, L, nseg, maps, packed,
                                      seg_cycles, stream);
  }
}

int tb_chain(const uint16_t* maps, int B, int S, int nseg, int* entries,
             long long* cycles, cudaStream_t stream) {
  const int smem = S >= kChainDirect
                       ? 0
                       : 2 * kChainStage * static_cast<int>(sizeof(uint16_t));
  const cudaError_t e = cudaFuncSetAttribute(
      tb_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kChainStage * static_cast<int>(sizeof(uint16_t)));
  if (e != cudaSuccess) return static_cast<int>(e);
  tb_chain_kernel<<<B, 32, smem, stream>>>(maps, S, nseg, entries, cycles);
  return static_cast<int>(cudaGetLastError());
}

int tb_select(const uint32_t* packed, const int* entries, uint8_t* bits,
              int B, int T, int S, int L, int nseg, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * ((T + 31) / 32) * 8;
  const int blocks = static_cast<int>(min(total / 256 + 1, 16384LL));
  tb_select_kernel<<<blocks, 256, 0, stream>>>(packed, entries, bits, B, T, S,
                                               L, nseg);
  return static_cast<int>(cudaGetLastError());
}

// the three phases in segments of L steps, the scratch laid out by
// tb_layout
int traceback_segmented(const unsigned long long* dec, uint8_t* bits, int B,
                        int T, int S, int L, void* scratch, long long* cycles,
                        cudaStream_t stream) {
  const TbLayout l = tb_layout(B, T, S, L);
  auto* base = static_cast<char*>(scratch);
  auto* maps = reinterpret_cast<uint16_t*>(base);
  auto* packed = reinterpret_cast<uint32_t*>(base + l.packed);
  auto* entries = reinterpret_cast<int*>(base + l.entries);
  int rc = tb_maps(reinterpret_cast<const uint32_t*>(dec), B, T, S, L,
                   l.nseg, maps, packed, nullptr, stream);
  if (rc == 0) rc = tb_chain(maps, B, S, l.nseg, entries, cycles, stream);
  if (rc == 0)
    rc = tb_select(packed, entries, bits, B, T, S, L, l.nseg, stream);
  return rc;
}

bool states_ok(int S) {
  return S >= 2 && S <= MAX_STATES && (S & (S - 1)) == 0;
}

}  // namespace

extern "C" {

// soft [total, R] uint8 (soft_u8) or float32, starts [B] int32 (each
// clamped to [0, total - T]), expected [2S, R] float32 (register outputs
// times 255) -> dec [B, T, max(S / 64, 1)] 64-bit decision words; cycles:
// null or [B] int64, each window's clock64 cycles. 1 <= T <= total,
// 2 <= R <= 32, S a power of two in [2, 16384]. S <= 64 at R <= 4 takes
// the tuned kernels, everything else the general ones; *general (if not
// null) receives which: 0 tuned, 1 general.
int viterbi_acs(const void* soft, int soft_u8, const int* starts,
                const float* expected, long long* dec, int B, int T,
                long long total, int R, int S, long long* cycles,
                void* stream, int* general) {
  if (B < 1 || T < 1 || total < T || R < MIN_RATE || R > MAX_ANY_RATE ||
      !states_ok(S))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* d = reinterpret_cast<unsigned long long*>(dec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tuned = S <= 64 && R <= MAX_RATE;
  if (general != nullptr) *general = tuned ? 0 : 1;
  if (tuned) {
#define VITERBI_TUNED(N)                                                    \
  case N:                                                                   \
    return dispatch_soft<N>(soft_u8, R, soft, starts, expected, d, B, T,    \
                            total, cycles, s)
    switch (S) {
      VITERBI_TUNED(64);
      VITERBI_TUNED(32);
      VITERBI_TUNED(16);
      VITERBI_TUNED(8);
      VITERBI_TUNED(4);
      VITERBI_TUNED(2);
    }
#undef VITERBI_TUNED
  }
  return soft_u8 ? acs_general<uint8_t>(R, S, soft, starts, expected, d, B, T,
                                        total, cycles, s)
                 : acs_general<float>(R, S, soft, starts, expected, d, B, T,
                                      total, cycles, s);
}

// the bytes of scratch viterbi_traceback needs for B windows of T steps
// of S states: 0 for S <= 64, else the segment-parallel walk's maps, bits
// and entries (tb_layout); -1 for arguments viterbi_traceback refuses
long long viterbi_traceback_scratch(int B, int T, int S) {
  if (B < 1 || T < 1 || !states_ok(S)) return -1;
  return S <= 64 ? 0 : tb_layout(B, T, S, tb_segment_steps(T)).bytes;
}

// dec [B, T, max(S / 64, 1)] 64-bit decision words of S states (a power
// of two in [2, 16384]) -> bits [B, T] uint8 (the state's low bit per
// step, walking back from state 0); cycles: null or [B] int64, each
// window's clock64 cycles (for S > 64 those of the segment chain); scratch:
// viterbi_traceback_scratch(B, T, S) bytes of device memory, 256-byte
// aligned (unused for S <= 64); *general (if not null) receives 1 where
// the general walk (S > 64) runs, else 0.
int viterbi_traceback(const long long* dec, unsigned char* bits, int B,
                      int T, int S, long long* cycles, void* scratch,
                      void* stream, int* general) {
  if (B < 1 || T < 1 || !states_ok(S) || (S > 64 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = reinterpret_cast<const unsigned long long*>(dec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (general != nullptr) *general = S > 64 ? 1 : 0;
  if (S == 64)
    traceback_kernel<64><<<B, 32, 0, s>>>(d, bits, T, S, cycles);
  else if (S == 16)
    traceback_kernel<16><<<B, 32, 0, s>>>(d, bits, T, S, cycles);
  else if (S < 64)
    traceback_kernel<0><<<B, 32, 0, s>>>(d, bits, T, S, cycles);
  else
    return traceback_segmented(d, bits, B, T, S, tb_segment_steps(T),
                               scratch, cycles, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
