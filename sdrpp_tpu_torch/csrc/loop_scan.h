// The C interface between the loop-scan kernel (csrc/loop_scan.cu) and its
// compiled host path (loop_scan of csrc/kernels_host.cpp): the bodies, and
// one launch's tensors as base pointers and element strides.
#ifndef SDRPP_TPU_TORCH_LOOP_SCAN_H_
#define SDRPP_TPU_TORCH_LOOP_SCAN_H_

#ifdef __cplusplus
extern "C" {
#endif

// The bodies, in the order of ops/scans_kernels._BODY_IDS.
enum {
  LOOP_PLL = 0,
  LOOP_AGC,
  LOOP_FAST_AGC,
  LOOP_COSTAS2,
  LOOP_COSTAS4,
  LOOP_COSTAS8,
  LOOP_COSTAS_METEOR,
  LOOP_BODIES
};

// Lanes a CTA walks, one walker thread each.
enum { LOOP_LANES = 32 };

typedef struct {
  const char* name;
  int k;         // carries
  int nstreams;  // input streams
  int nparams;   // float32 parameters
} LoopBodyInfo;

static const LoopBodyInfo kLoopBodies[LOOP_BODIES] = {
    {"pll", 2, 1, 4},     {"agc", 2, 2, 7},     {"fast_agc", 1, 1, 3},
    {"costas2", 2, 2, 4}, {"costas4", 2, 2, 4}, {"costas8", 2, 2, 4},
    {"costas_meteor", 2, 2, 4}};

// One launch over C lanes and n steps. Lane c has the lane indices
// c0 = c / C1 and c1 = c % C1, and element (t, c) of a tensor X lies at
// X + t * X_t + c0 * X_l0 + c1 * X_l1 (strides in elements). Steps
// t < valid advance the carry; step t >= skip is stored at row t - skip of
// `out`, and step t in [skip - nside, skip) at row t - skip + nside of
// `side`; stored steps at or past `valid` are written as 0.
typedef struct {
  const float* in[2];  // the body's input streams
  long long in_t[2], in_l0[2], in_l1[2];
  float* out;
  long long out_t, out_l0, out_l1;
  float* side;  // null when nside == 0
  long long side_t, side_l0, side_l1;
  const float* seed;  // carry j of lane c at seed + j * seed_k + ...
  long long seed_k, seed_l0, seed_l1;
  float* fin;          // the final carry, [k, C] contiguous
  long long* cycles;   // [ceil(C / LOOP_LANES)] walker clock64 cycles, or null
  int n, C, C1, valid, skip, nside;
} LoopScanArgs;

// Launches `body` on `stream`; returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for an unknown body or parameter count.
typedef int (*LoopScanEntry)(int body, const LoopScanArgs* args,
                             const float* params, int nparams, void* stream);

#ifdef __cplusplus
}
#endif

#endif  // SDRPP_TPU_TORCH_LOOP_SCAN_H_
