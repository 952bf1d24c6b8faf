// Instrumented copies of the walk kernels that csrc/sync_walk.cu had
// before their redesigns (the "baseline": the one-lane ChromaPLL and
// CyclicSync walks, the 736-thread LineSync walk with two barriers a
// line), for measuring where their time goes on the card. Driven by
// tools/sync_walk_probe.py; not part of the package and never built by it.
//
// Each probe is instantiated for each `mode` (a template argument, so the
// taken-out parts cost nothing) whose bits take one part out of the
// walker's step (the result is then wrong; only its time is read), and
// records clock64() stamps:
//   chroma_probe   1: cosf / sinf -> a two-operation stand-in on ph
//                  2: atan2f -> a two-operation stand-in on (ore, oim)
//                  4: the burst step's py_mod (fmodf) -> its argument
//                  8: the burst sample's load and the output's store
//                  cycles[0] = the walk's cycles (lane 0, first to last
//                  line)
//   cyclic_probe   1: the symbol-buffer store
//                  2: the emit branch -> branch-free selects, no store
//                  4: the average's update (avg stays the carried one)
//                  8: the peak / since logic (only the average is walked)
//                  cycles[0] = the walker's cycles over every tile,
//                  cycles[1] = the walker's cycles inside the tile
//                  barriers (waiting for the staging warps),
//                  cycles[2] = the staging warps' cycles (warp 1, lane 0)
//   line_probe     1: the 8-tap windows' loads from device memory
//                  2: both barriers a line
//                  4: the two shuffle trees
//                  8: the update (divisions, err, clamp, pos)
//                  16: the line's stores
//                  cycles[0] = warp 0's cycles, cycles[1] = lines walked
// Mode 0 is the baseline kernel with the stamps added; its outputs equal
// the baseline's. line_floor is LineSync's sync chain alone on one warp
// (the floor of the redesign's walker). The file also builds the
// package's csrc/sync_walk.cu with each role's cycles a round stamped
// (its entries keep their names: line_sync_walk, chroma_burst_walk,
// cyclic_sync_walk). Built like the package's kernels (nvcc -O3
// --fmad=false for sm_90a).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.1415926535f;
constexpr float kTwoPi = 2.0f * kPi;

__device__ __forceinline__ float normalize_phase(float d) {
  d = d > kPi ? d - kTwoPi : d;
  d = d <= -kPi ? d + kTwoPi : d;
  return d;
}

__device__ __forceinline__ float py_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((y < 0.0f) != (r < 0.0f))) r = r + y;
  return r;
}

template <int mode>
__global__ void __launch_bounds__(32, 1)
chroma_probe_kernel(const float2* __restrict__ burst, int L, int nb,
                    const float* __restrict__ ref_phases,
                    const float* __restrict__ carry_in,
                    float* __restrict__ carry_out,
                    float* __restrict__ line_phase,
                    float2* __restrict__ burst_out, int pre_len,
                    int post_len, float alpha, float beta, float min_freq,
                    float max_freq, long long* cycles) {
  if (threadIdx.x != 0) return;
  const long long t0 = clock64();
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
      const float2 x = (mode & 8) ? make_float2(1.0f, 0.0f) : v[j];
      float c, s;
      if (mode & 1) {
        c = 1.0f - ph * 1e-3f;
        s = ph * 1e-3f;
      } else {
        c = cosf(-ph);
        s = sinf(-ph);
      }
      const float ore = x.x * c - x.y * s;
      const float oim = x.x * s + x.y * c;
      if (!(mode & 8)) out[j] = make_float2(ore, oim);
      const float a = (mode & 2) ? oim - ore * 1e-3f : atan2f(oim, ore);
      const float err = normalize_phase(a - ref);
      fr = fminf(fmaxf(fr + beta * err, min_freq), max_freq);
      ph = (ph + fr) + alpha * err;
      ph = normalize_phase(((mode & 4) ? ph + kPi : py_mod(ph + kPi, kTwoPi))
                           - kPi);
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
  cycles[0] = clock64() - t0;
}

constexpr int kSyncThreads = 256;
constexpr int kTile = 1024;

template <int mode>
__global__ void __launch_bounds__(kSyncThreads, 1)
cyclic_probe_kernel(const float* __restrict__ rcorr,
                    const float2* __restrict__ vals, int n,
                    const float* __restrict__ carry_in,
                    const int* __restrict__ since_in,
                    const float2* __restrict__ symbuf_in, int sym, float agc,
                    float agc_inv, float* __restrict__ carry_out,
                    int* __restrict__ since_out,
                    float2* __restrict__ symbuf_out, int* __restrict__ emits,
                    int max_syms, int* __restrict__ count,
                    long long* cycles) {
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
  long long walk = 0, waits = 0, staging = 0;
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const int base = t * kTile;
    const long long a = clock64();
    if (tid == 0) {
      const int len = min(kTile, n - base);
      for (int k = 0; k < len; ++k) {
        const float rc = rt[cur][k];
        if (!(mode & 8)) {
          const bool is_peak = (rc > avg) && (rc > peak);
          peak = is_peak ? rc : peak;
          since = is_peak ? 0 : since;
          if (!(mode & 1))
            symbuf_out[min(max(since, 0), sym - 1)] = vt[cur][k];
          since = since + 1;
          if (mode & 2) {
            const bool e = since >= sym;
            cnt += e ? 1 : 0;
            since = e ? 0 : since;
            peak = e ? 0.0f : peak;
          } else if (since >= sym) {
            if (cnt < max_syms) emits[cnt] = base + k;
            ++cnt;
            since = 0;
            peak = 0.0f;
          }
        }
        if (!(mode & 4)) avg = agc * rc + agc_inv * avg;
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
    const long long b = clock64();
    __syncthreads();
    const long long c = clock64();
    walk += c - a;
    waits += c - b;
    staging += b - a;
  }
  __shared__ int s_cnt;
  if (tid == 0) {
    carry_out[0] = avg;
    carry_out[1] = peak;
    carry_out[2] = last;
    since_out[0] = since;
    s_cnt = min(cnt, max_syms);
    count[0] = s_cnt;
    cycles[0] = walk;
    cycles[1] = waits;
  }
  if (tid == 32) cycles[2] = staging;
  __syncthreads();
  for (int i = s_cnt + tid; i < max_syms; i += blockDim.x) emits[i] = -1;
}


// ---------------------------------------------------------------- LineSync
// The 736-thread line_sync_kernel (two barriers a line). Mode bits:
//   1: the 8-tap windows' loads from device memory -> the position itself
//   2: both barriers a line
//   4: the two 44-sample shuffle trees -> one add each
//   8: the update (two divisions, err, the clamp, pos) -> pos + 720 freq
//  16: the line's stores to `lines`
// cycles[0] = warp 0's cycles over the walk, cycles[1] = the lines walked.
constexpr int kLineLen = 720;
constexpr int kTaps = 8;
constexpr int kPhases = 128;
constexpr int kLineThreads = 736;
constexpr int kSyncLen = 44;

__device__ __forceinline__ float tree44(float a, float b) {
  float s = a + b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = s + __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

template <int mode>
__global__ void __launch_bounds__(kLineThreads, 1)
line_probe_kernel(const float* __restrict__ buf, int n, int head,
                  const float* __restrict__ bank,
                  const float* __restrict__ carry_in,
                  const bool* __restrict__ locked_in,
                  float* __restrict__ carry_out, bool* __restrict__ locked_out,
                  float* __restrict__ lines, int* __restrict__ count,
                  int max_lines, float omega_gain, float mu_gain,
                  float min_freq, float max_freq, float sync_level,
                  float sync_bias, long long* cycles) {
  __shared__ float sbank[kPhases * kTaps];
  __shared__ float sline[kLineLen];
  __shared__ float s_pos, s_freq, s_keep;
  __shared__ int s_locked;
  const int tid = threadIdx.x;
  for (int i = tid; i < kPhases * kTaps; i += blockDim.x) sbank[i] = bank[i];
  if (tid == 0) {
    s_pos = carry_in[0];
    s_freq = carry_in[1];
    s_locked = locked_in[0] ? 1 : 0;
  }
  __syncthreads();
  const long long t0 = clock64();
  const float fn = static_cast<float>(n);
  int l = 0;
  for (; l < max_lines; ++l) {
    const float pos = s_pos, freq = s_freq;
    if (!(pos + 720.0f * freq < fn)) break;
    if (tid < kLineLen) {
      const float p = pos + static_cast<float>(tid) * freq;
      const float fp = floorf(p);
      const float mu = p - fp;
      const int ph = min(max(static_cast<int>(mu * 128.0f), 0), kPhases - 1);
      const int hoff = head - (kTaps - 1);
      const int base = min(max(static_cast<int>(fp) + hoff, 0), n + hoff - 1);
      const float* w = buf + base;
      const float* b = sbank + ph * kTaps;
      float acc = ((mode & 1) ? p : w[0]) * b[0];
#pragma unroll
      for (int j = 1; j < kTaps; ++j)
        acc = acc + ((mode & 1) ? p : w[j]) * b[j];
      sline[tid] = acc;
      if (!(mode & 16)) lines[static_cast<size_t>(l) * kLineLen + tid] = acc;
    }
    if (!(mode & 2)) __syncthreads();
    if (tid < 32) {
      const int lane = tid;
      const float la = lane < 17 ? sline[703 + lane] : sline[lane - 17];
      const float lb = lane + 32 < kSyncLen ? sline[lane + 15] : 0.0f;
      const float ra = sline[27 + lane];
      const float rb = lane + 32 < kSyncLen ? sline[59 + lane] : 0.0f;
      const float sl = (mode & 4) ? la + lb : tree44(la, lb);
      const float sr = (mode & 4) ? ra + rb : tree44(ra, rb);
      if (lane == 0) {
        if (mode & 8) {
          s_keep = sl + sr;
          s_pos = pos + 720.0f * freq;
        } else {
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
    }
    if (!(mode & 2)) __syncthreads();
  }
  if (tid == 0) {
    cycles[0] = clock64() - t0;
    cycles[1] = l;
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

// The sync chain alone, the floor of a one-warp walker: lanes 0-15 the
// left sum, 16-31 the right, up to three of the 88 sync samples a lane
// (v[L], v[L + 16], v[L + 32]), their 8-tap windows from a shared tile
// (the index wrapped into it: latencies of shared memory, values not the
// line's), the trees by xor shuffles within each half (8, 4, 2, 1) and
// one across (16), the update in every lane; no barrier, no store.
constexpr int kFloorTile = 4096;

__global__ void __launch_bounds__(32, 1)
line_floor_kernel(const float* __restrict__ buf, int n, int head,
                  const float* __restrict__ bank,
                  const float* __restrict__ carry_in, int max_lines,
                  float omega_gain, float mu_gain, float min_freq,
                  float max_freq, float sync_level, float sync_bias,
                  float* __restrict__ carry_out, long long* cycles) {
  __shared__ __align__(16) float sbank[kPhases * kTaps];
  __shared__ float tile[kFloorTile + kTaps];
  const int lane = threadIdx.x;
  for (int i = lane; i < kPhases * kTaps; i += 32) sbank[i] = bank[i];
  for (int i = lane; i < kFloorTile + kTaps; i += 32)
    tile[i] = buf[min(i & (kFloorTile - 1), n - 1)];
  __syncwarp();
  const int half = lane >> 4, L = lane & 15;
  // this lane's sync samples: k (the line index) of v[L], v[L + 16],
  // v[L + 32] of its half (left: v[i] = line[703 + i] for i < 17, else
  // line[i - 17]; right: line[27 + i])
  float kf[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int i = L + 16 * r;
    kf[r] = static_cast<float>(half ? 27 + i : (i < 17 ? 703 + i : i - 17));
  }
  const bool third = L + 32 < kSyncLen;
  float pos = carry_in[0], freq = carry_in[1];
  const float fn = static_cast<float>(n);
  const long long t0 = clock64();
  int l = 0;
  for (; l < max_lines; ++l) {
    if (!(pos + 720.0f * freq < fn)) break;
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float p = pos + kf[r] * freq;
      const float fp = floorf(p);
      const float mu = p - fp;
      const int ph = min(max(static_cast<int>(mu * 128.0f), 0), kPhases - 1);
      const int hoff = head - (kTaps - 1);
      const int base = min(max(static_cast<int>(fp) + hoff, 0), n + hoff - 1);
      const float* w = tile + (base & (kFloorTile - 1));
      const float4 b0 = *reinterpret_cast<const float4*>(sbank + ph * kTaps);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sbank + ph * kTaps + 4);
      float acc = w[0] * b0.x;
      acc = acc + w[1] * b0.y;
      acc = acc + w[2] * b0.z;
      acc = acc + w[3] * b0.w;
      acc = acc + w[4] * b1.x;
      acc = acc + w[5] * b1.y;
      acc = acc + w[6] * b1.z;
      acc = acc + w[7] * b1.w;
      v[r] = acc;
    }
    float s = (v[0] + (third ? v[2] : 0.0f)) + (v[1] + 0.0f);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s = s + __shfl_xor_sync(0xffffffffu, s, off);
    const float o = __shfl_xor_sync(0xffffffffu, s, 16);
    const float sl = half ? o : s, sr = half ? s : o;
    const float left = sl / 44.0f, right = sr / 44.0f;
    const bool ok = (left < sync_level) && (right < sync_level);
    const float err = ok ? (left + sync_bias) - right : 0.0f;
    const float nf = fminf(fmaxf(freq + omega_gain * err, min_freq), max_freq);
    pos = ((pos + 719.0f * freq) + nf) + mu_gain * err;
    freq = nf;
  }
  if (lane == 0) {
    cycles[0] = clock64() - t0;
    cycles[1] = l;
    carry_out[0] = pos;
    carry_out[1] = freq;
  }
}

}  // namespace

extern "C" {

#define PROBE_MODES(X) X(0) X(1) X(2) X(3) X(4) X(7) X(8) X(11) X(15)

int chroma_probe(const void* burst, int L, int nb, const float* ref_phases,
                 const float* carry_in, float* carry_out, float* line_phase,
                 void* burst_out, int pre_len, int post_len, float alpha,
                 float beta, float min_freq, float max_freq, int mode,
                 long long* cycles, void* stream) {
  switch (mode) {
#define CHROMA_CASE(m)                                                      \
  case m:                                                                   \
    chroma_probe_kernel<m><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>( \
        static_cast<const float2*>(burst), L, nb, ref_phases, carry_in,     \
        carry_out, line_phase, static_cast<float2*>(burst_out), pre_len,    \
        post_len, alpha, beta, min_freq, max_freq, cycles);                 \
    break;
    PROBE_MODES(CHROMA_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int cyclic_probe(const float* rcorr, const void* vals, int n,
                 const float* carry_in, const int* since_in,
                 const void* symbuf_in, int sym, float agc, float agc_inv,
                 float* carry_out, int* since_out, void* symbuf_out,
                 int* emits, int max_syms, int* count, int mode,
                 long long* cycles, void* stream) {
  switch (mode) {
#define CYCLIC_CASE(m)                                                      \
  case m:                                                                   \
    cyclic_probe_kernel<m><<<1, kSyncThreads, 0,                            \
                             static_cast<cudaStream_t>(stream)>>>(          \
        rcorr, static_cast<const float2*>(vals), n, carry_in, since_in,     \
        static_cast<const float2*>(symbuf_in), sym, agc, agc_inv,           \
        carry_out, since_out, static_cast<float2*>(symbuf_out), emits,      \
        max_syms, count, cycles);                                           \
    break;
    PROBE_MODES(CYCLIC_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


#define LINE_MODES(X) X(0) X(1) X(2) X(4) X(8) X(16) X(31)

int line_probe(const float* buf, int n, int head, const float* bank,
               const float* carry_in, const bool* locked_in,
               float* carry_out, bool* locked_out, float* lines, int* count,
               int max_lines, float omega_gain, float mu_gain,
               float min_freq, float max_freq, float sync_level,
               float sync_bias, int mode, long long* cycles, void* stream) {
  switch (mode) {
#define LINE_CASE(m)                                                        \
  case m:                                                                   \
    line_probe_kernel<m><<<1, kLineThreads, 0,                              \
                           static_cast<cudaStream_t>(stream)>>>(            \
        buf, n, head, bank, carry_in, locked_in, carry_out, locked_out,     \
        lines, count, max_lines, omega_gain, mu_gain, min_freq, max_freq,   \
        sync_level, sync_bias, cycles);                                     \
    break;
    LINE_MODES(LINE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int line_floor(const float* buf, int n, int head, const float* bank,
               const float* carry_in, int max_lines, float omega_gain,
               float mu_gain, float min_freq, float max_freq,
               float sync_level, float sync_bias, float* carry_out,
               long long* cycles, void* stream) {
  line_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, n, head, bank, carry_in, max_lines, omega_gain, mu_gain,
      min_freq, max_freq, sync_level, sync_bias, carry_out, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The package's kernels (csrc/sync_walk.cu as it stands), each role's
// clock64() cycles a round summed into walk_cycles by lane 0 of each warp:
// line 0 the walker, 1 the stager, 2 the drawers (eleven warps, summed);
// chroma 0 the walker, 1 the staging warps (three); cyclic 0 the average,
// 1 the walker, 2 the buffer writer, 3 the stager.
__device__ unsigned long long walk_cycles[8];
#define WALK_ROUND() const long long walk_t0 = clock64()
#define WALK_DONE(slot)                                                   \
  if ((threadIdx.x & 31) == 0)                                            \
  atomicAdd(&walk_cycles[slot],                                           \
            static_cast<unsigned long long>(clock64() - walk_t0))
namespace pkg {
#include "../sdrpp_tpu_torch/csrc/sync_walk.cu"
}  // namespace pkg

extern "C" int walk_stamps(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, walk_cycles, sizeof(walk_cycles));
  const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(walk_cycles, zero, sizeof(walk_cycles));
  return static_cast<int>(cudaGetLastError());
}
