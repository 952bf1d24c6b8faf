// The compiled host paths of the port's kernel wrappers, one Python
// extension module: each entry makes its wrapper's argument checks, its
// allocations and its kernel's launch on the current stream of its tensors'
// device in one CPython call. At the paths' shapes a kernel takes about as
// long on the device as a Python wrapper's checks, allocations and ctypes
// call took on the host.
//
//   decim_fir(tail, x, taps, r) -> (new_tail, y)
//       ops/fir_kernels.decimating_fir: tail [..., m-1], x [..., n]
//       complex64 or float32 on one CUDA device, taps [m] float32, r >= 1
//       dividing n.
//   loop_scan(body, params, state, streams, valid, out, skip, side, cycles,
//             single) -> (out, fin)
//       ops/scans_kernels.lane_scan / single_scan: body, an index into
//       loop_scan.h's kLoopBodies; params, its float parameters; state
//       [k, *lanes] and streams (a sequence of [n, *lanes]; lanes: none
//       when `single`, else one or two axes), float32 on one CUDA device,
//       any strides; valid: None or an int in [0, n]; out: None or a
//       [n - skip, *lanes] float32 view with no overlapping elements,
//       written in place; skip in [0, n]; side: None or a [m <= skip,
//       *lanes] float32 view receiving steps [skip - m, skip); cycles: None
//       or a contiguous int64 [ceil(C / 32)] tensor receiving the walkers'
//       clock64 cycles. Allocates `out` when None and the final carry
//       `fin` [k, *lanes].
//   viterbi_acs(soft, starts, T, expected, cycles) -> (dec, general)
//       ops/fec_kernels.viterbi_acs_batched: soft [total, R] uint8 or
//       float32 (2 <= R <= 32), starts int32 [B], 1 <= T <= total,
//       expected [2S, R] float32 for S a power of two in [2, 16384], all
//       on one CUDA device; cycles None or a contiguous int64 [B] tensor
//       receiving each window's clock64 cycles. Allocates dec [B, T]
//       int64 (S <= 64) or [B, T, S / 64] (S > 64); general: whether the
//       launch took a general kernel (viterbi.cu's dispatch says).
//   viterbi_traceback(dec, cycles[, num_states]) -> (bits, general)
//       ops/fec_kernels.viterbi_traceback_batched: dec, the words of
//       num_states (64 by default; a power of two in [2, 16384]) states,
//       int64 [B, T] (S <= 64) or [B, T, S / 64], on a CUDA device;
//       cycles as above (for S > 64 the segment chain's cycles).
//       Allocates bits [B, T] uint8 and, for S > 64, the segment-parallel
//       walk's scratch (viterbi_traceback_scratch bytes); general as above.
//   mm_symbols(buf, offset, fstate, bank, max_syms, params, cycles)
//       -> (syms, count, offset_out, fstate_out)
//       ops/clock_recovery_kernels.mm_symbols: buf [C, n + 7] complex64 or
//       float32, offset int32 [C], fstate float32 [C, 10 | 3], bank
//       float32 [128, 8], on one CUDA device; params (mu, omega_gain,
//       min_freq, max_freq); cycles None or a contiguous int64 [C] tensor.
//   mm_chunked(ext, off0, ph0, fr0, emit_lo, emit_hi, goff, bank, geom,
//              params) -> (syms, valid, pos, offset, fstate)
//       ops/clock_recovery_chunked.mm_symbols_chunked_lanes: ext a
//       complex64 or float32 vector, the [K] seeds and bounds (int32 off0
//       and emit_hi, float32 the rest), bank float32 [128, 8]; geom (K, L,
//       cols, R, J, M, steps, n) with K <= 256 and M in {8, 16, 32};
//       params (mu, omega_gain, min_freq, max_freq, half_omega).
//   mm_chunked_block(x, hist, offset0, phase0, freq0, bank, geom, W, pad,
//                    params[, cycles]) -> (syms, valid, pos, offset, fstate)
//       ops/clock_recovery_chunked.mm_symbols_chunked_block: x [n] and
//       hist [W + 7] complex64 or float32, the carried offset0 (int32),
//       phase0 and freq0 (float32) one element each, bank float32 [128, 8];
//       geom as mm_chunked's, W warm-up samples, pad = K * L - n; params
//       (mu, omega_gain, min_freq, max_freq, half_omega, allow, lo).
//       Both chunked entries take a cycles tensor (None or int64 [8]).
//   fd_symbols(buf, offset, fstate, bank, max_syms, params)
//       -> (syms, count, offset_out, fstate_out)
//       ops/clock_recovery_kernels.fd_symbols: buf float32 [C, n + 7],
//       offset int32 [C], fstate float32 [C, 2], bank float32 [128, 8];
//       params (omega_gain, mu, min_freq, max_freq).
//   bind_decim_fir(c64_entry, f32_entry), bind_loop_scan(entry),
//   bind_viterbi(acs_entry, traceback_entry, traceback_scratch_entry),
//   bind_mm_clock(mm_complex,
//   mm_real, chunked_complex, chunked_real, fd),
//   bind_mm_chunked_block(block_complex, block_real)
//       the addresses of the kernel libraries' C entries (decim_fir.cu's
//       decim_fir_c64 / decim_fir_f32, loop_scan.cu's loop_scan,
//       viterbi.cu's viterbi_acs / viterbi_traceback /
//       viterbi_traceback_scratch, mm_clock.cu's
//       mm_symbols_complex / mm_symbols_real / mm_chunked_complex /
//       mm_chunked_real / fd_symbols, mm_chunked_block_complex /
//       mm_chunked_block_real).
//
// Each entry raises ValueError on a wrong argument, with the checks, the
// order and the messages of its wrapper's Python `_check`, and
// RuntimeError when the launch fails. Built by utils/cuda_lib.build_host
// with the host C++ compiler against torch's headers and libraries; the
// kernels stay in their .cu libraries. KERNELS_HOST_CUDA is defined for
// the build that launches; without it (against a CPU-only torch) the
// checks are the same and any call that passes them raises, as no tensor
// can be on a CUDA device: tests/test_torch_host_checks.py holds those
// checks against the Python ones.

#include <torch/csrc/Exceptions.h>
#include <torch/csrc/autograd/python_variable.h>
#include <torch/csrc/utils/object_ptr.h>

#include <ATen/ops/empty.h>
#ifdef KERNELS_HOST_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <algorithm>
#include <climits>
#include <string>
#include <utility>
#include <vector>

#include "loop_scan.h"

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

PyObject* value_error(const std::string& msg) {
  PyErr_SetString(PyExc_ValueError, msg.c_str());
  return nullptr;
}

PyObject* type_error(const char* msg) {
  PyErr_SetString(PyExc_TypeError, msg);
  return nullptr;
}

std::string shape_str(c10::IntArrayRef s) {
  std::string out = "[";
  for (size_t i = 0; i < s.size(); ++i)
    out += (i ? ", " : "") + std::to_string(s[i]);
  return out + "]";
}

// a geometry tuple as Python prints it
std::string geom_str(const int64_t* geom) {
  std::string g = "(";
  for (int i = 0; i < 8; ++i) g += (i ? ", " : "") + std::to_string(geom[i]);
  return g + ")";
}

// str(dtype) as Python prints it
std::string dtype_name(c10::ScalarType t) {
  switch (t) {
    case c10::kComplexFloat: return "torch.complex64";
    case c10::kComplexDouble: return "torch.complex128";
    case c10::kFloat: return "torch.float32";
    case c10::kDouble: return "torch.float64";
    case c10::kHalf: return "torch.float16";
    case c10::kBFloat16: return "torch.bfloat16";
    case c10::kByte: return "torch.uint8";
    case c10::kChar: return "torch.int8";
    case c10::kShort: return "torch.int16";
    case c10::kInt: return "torch.int32";
    case c10::kLong: return "torch.int64";
    case c10::kBool: return "torch.bool";
    default: return c10::toString(t);
  }
}

// a C entry's address from bind_*; false (ValueError set) for a null one
template <class Entry>
bool entry_arg(PyObject* o, Entry* out) {
  void* p = PyLong_AsVoidPtr(o);
  if (PyErr_Occurred()) return false;
  if (p == nullptr) {
    value_error("bind: a null entry");
    return false;
  }
  *out = reinterpret_cast<Entry>(p);
  return true;
}

// the current stream of `device`, which is the current device while this
// lives
struct OnStream {
#ifdef KERNELS_HOST_CUDA
  explicit OnStream(c10::Device device)
      : guard(device),
        stream(c10::cuda::getCurrentCUDAStream(device.index()).stream()) {}
  c10::cuda::CUDAGuard guard;
  void* stream;
#else
  explicit OnStream(c10::Device) {}
  void* stream = nullptr;
#endif
};

// (a, b) as a new tuple, taking both references; nullptr if either is
PyObject* pair(PyObject* a, PyObject* b) {
  PyObject* t = a && b ? PyTuple_New(2) : nullptr;
  if (t == nullptr) {
    Py_XDECREF(a);
    Py_XDECREF(b);
    return nullptr;
  }
  PyTuple_SET_ITEM(t, 0, a);
  PyTuple_SET_ITEM(t, 1, b);
  return t;
}

// ---------------------------------------------------------------------------
// decimating_fir (csrc/decim_fir.cu)
// ---------------------------------------------------------------------------

using DecimFirEntry = int (*)(const void* tail, const void* x,
                              const float* taps, void* new_tail, void* y,
                              long long rows, long long n, int m, int r,
                              void* stream);

DecimFirEntry g_fir_c64 = nullptr;
DecimFirEntry g_fir_f32 = nullptr;

PyObject* decim_fir(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 4 || !THPVariable_Check(args[0]) ||
      !THPVariable_Check(args[1]) || !THPVariable_Check(args[2]))
    return type_error(
        "decim_fir(tail, x, taps, r) takes three tensors and an int");
  const at::Tensor& tail = THPVariable_Unpack(args[0]);
  const at::Tensor& x = THPVariable_Unpack(args[1]);
  const at::Tensor& taps = THPVariable_Unpack(args[2]);
  const long long r = PyLong_AsLongLong(args[3]);
  if (r == -1 && PyErr_Occurred()) return nullptr;

  // the checks of fir_kernels._check, in its order and with its messages
  const c10::ScalarType dtype = x.scalar_type();
  const bool c64 = dtype == c10::kComplexFloat;
  if (!c64 && dtype != c10::kFloat)
    return value_error("x must be complex64 or float32");
  if (taps.scalar_type() != c10::kFloat || taps.dim() != 1 ||
      taps.size(0) < 1)
    return value_error("taps must be a float32 vector");
  const int64_t m = taps.size(0);
  const c10::IntArrayRef ts = tail.sizes(), xs = x.sizes();
  const size_t nd = xs.size();
  bool tail_ok = nd >= 1 && tail.scalar_type() == dtype &&
                 ts.size() == nd && ts[nd - 1] == m - 1;
  for (size_t i = 0; tail_ok && i + 1 < nd; ++i) tail_ok = ts[i] == xs[i];
  if (!tail_ok) {
    std::vector<int64_t> want(xs.begin(), xs.end());
    if (want.empty()) want.push_back(0);
    want.back() = m - 1;
    return value_error("tail must be " + dtype_name(dtype) + " " +
                       shape_str(want) + ", got " +
                       dtype_name(tail.scalar_type()) + " " + shape_str(ts));
  }
  if (tail.device() != x.device() || taps.device() != x.device())
    return value_error("decimating_fir takes tensors on one device");
  const int64_t n = xs[nd - 1];
  if (r < 1 || n % r)
    return value_error("block length " + std::to_string(n) +
                       " must be a multiple of decimation " +
                       std::to_string(r));
  // the kernel's own conditions
  if (!x.is_cuda())
    return value_error("the compiled decimating_fir takes CUDA tensors");
  if (n < 1) return value_error("decimating_fir takes a non-empty block");
  if (m > INT_MAX || r > INT_MAX)
    return value_error("taps and decimation must fit an int");
  const DecimFirEntry fn = c64 ? g_fir_c64 : g_fir_f32;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "decim_fir: the kernel entries are not bound");
    return nullptr;
  }

  const at::Tensor tc = tail.is_contiguous() ? tail : tail.contiguous();
  const at::Tensor xc = x.is_contiguous() ? x : x.contiguous();
  const at::Tensor wc = taps.is_contiguous() ? taps : taps.contiguous();
  std::vector<int64_t> ysize(xs.begin(), xs.end());
  ysize.back() = n / r;
  at::Tensor y = at::empty(ysize, x.options());
  at::Tensor new_tail = at::empty(ts, tail.options());
  const long long rows = x.numel() / n;

  const OnStream on(x.device());
  const int rc = fn(tc.data_ptr(), xc.data_ptr(), wc.data_ptr<float>(),
                    new_tail.data_ptr(), y.data_ptr(), rows, n,
                    static_cast<int>(m), static_cast<int>(r), on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "decimating_fir launch failed: CUDA error %d at rows=%lld, "
                 "n=%lld, m=%lld, r=%lld", rc, rows,
                 static_cast<long long>(n), static_cast<long long>(m), r);
    return nullptr;
  }
  return pair(THPVariable_Wrap(std::move(new_tail)),
              THPVariable_Wrap(std::move(y)));
  END_HANDLE_TH_ERRORS
}

PyObject* bind_decim_fir(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 2) return type_error("bind_decim_fir(c64_entry, f32_entry)");
  DecimFirEntry c64, f32;
  if (!entry_arg(args[0], &c64) || !entry_arg(args[1], &f32)) return nullptr;
  g_fir_c64 = c64;
  g_fir_f32 = f32;
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// lane_scan / single_scan (csrc/loop_scan.cu)
// ---------------------------------------------------------------------------

LoopScanEntry g_loop_scan = nullptr;

// true unless the elements are at distinct addresses: the dims of size > 1,
// by stride, must each step past the span of the smaller ones
bool overlaps(const at::Tensor& t) {
  std::vector<std::pair<int64_t, int64_t>> dims;
  for (int64_t i = 0; i < t.dim(); ++i)
    if (t.size(i) > 1) dims.emplace_back(t.stride(i), t.size(i));
  std::sort(dims.begin(), dims.end());
  int64_t span = 0;
  for (const auto& [stride, size] : dims) {
    if (stride <= span) return true;
    span += stride * (size - 1);
  }
  return false;
}

// a tensor argument, or nullptr for None; sets TypeError otherwise
bool optional_tensor(PyObject* o, const at::Tensor** t) {
  *t = nullptr;
  if (o == Py_None) return true;
  if (!THPVariable_Check(o)) {
    type_error("loop_scan: out, side and cycles are tensors or None");
    return false;
  }
  *t = &THPVariable_Unpack(o);
  return true;
}

// the lane strides (l0, l1) of a tensor whose lane axes start at `first`
void lane_strides(const at::Tensor& t, int64_t first, int64_t nlanes,
                  long long* l0, long long* l1) {
  *l0 = nlanes == 2 ? t.stride(first) : 0;
  *l1 = nlanes >= 1 ? t.stride(first + nlanes - 1) : 0;
}

PyObject* loop_scan(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 10 || !THPVariable_Check(args[2]))
    return type_error(
        "loop_scan(body, params, state, streams, valid, out, skip, side, "
        "cycles, single)");
  const long body = PyLong_AsLong(args[0]);
  if (body == -1 && PyErr_Occurred()) return nullptr;
  if (body < 0 || body >= LOOP_BODIES)
    return value_error("loop_scan: unknown body " + std::to_string(body));
  const LoopBodyInfo& info = kLoopBodies[body];
  const int single = PyObject_IsTrue(args[9]);
  if (single < 0) return nullptr;

  float params[8];
  {
    THPObjectPtr seq(
        PySequence_Fast(args[1], "loop_scan: params is a sequence"));
    if (!seq) return nullptr;
    const Py_ssize_t np = PySequence_Fast_GET_SIZE(seq.get());
    if (np != info.nparams)
      return value_error(std::string(info.name) + " takes " +
                         std::to_string(info.nparams) + " parameters, got " +
                         std::to_string(np));
    for (Py_ssize_t i = 0; i < np; ++i) {
      const double v = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq.get(), i));
      if (v == -1.0 && PyErr_Occurred()) return nullptr;
      params[i] = static_cast<float>(v);
    }
  }
  const at::Tensor& state = THPVariable_Unpack(args[2]);
  std::vector<at::Tensor> streams;
  {
    THPObjectPtr seq(
        PySequence_Fast(args[3], "loop_scan: streams is a sequence"));
    if (!seq) return nullptr;
    const Py_ssize_t ns = PySequence_Fast_GET_SIZE(seq.get());
    if (ns != info.nstreams)
      return value_error(std::string(info.name) + " takes " +
                         std::to_string(info.nstreams) + " streams, got " +
                         std::to_string(ns));
    for (Py_ssize_t i = 0; i < ns; ++i) {
      PyObject* o = PySequence_Fast_GET_ITEM(seq.get(), i);
      if (!THPVariable_Check(o))
        return type_error("loop_scan: streams are tensors");
      streams.push_back(THPVariable_Unpack(o));
    }
  }
  const at::Tensor *out_arg, *side_arg, *cycles_arg;
  if (!optional_tensor(args[5], &out_arg) ||
      !optional_tensor(args[7], &side_arg) ||
      !optional_tensor(args[8], &cycles_arg))
    return nullptr;

  // the checks of scans_kernels._check, in its order and with its messages
  if (state.scalar_type() != c10::kFloat)
    return value_error("loop scans take float32 tensors on one device");
  for (const at::Tensor& s : streams)
    if (s.scalar_type() != c10::kFloat || s.device() != state.device())
      return value_error("loop scans take float32 tensors on one device");
  const c10::IntArrayRef shape = streams[0].sizes();
  const int64_t nd = static_cast<int64_t>(shape.size());
  bool shape_ok = single ? nd == 1 : (nd == 2 || nd == 3);
  for (const at::Tensor& s : streams) shape_ok = shape_ok && s.sizes() == shape;
  if (!shape_ok)
    return value_error(single ? "streams must share one 1-D shape"
                              : "streams must share one 2- or 3-D shape");
  const int64_t n = shape[0];
  const c10::IntArrayRef lanes = shape.slice(1);
  std::vector<int64_t> want{info.k};
  want.insert(want.end(), lanes.begin(), lanes.end());
  if (state.sizes() != c10::IntArrayRef(want))
    return value_error("state shape " + shape_str(state.sizes()) + " != " +
                       shape_str(want));
  long long valid = n;
  if (args[4] != Py_None) {
    valid = PyLong_AsLongLong(args[4]);
    if (valid == -1 && PyErr_Occurred()) return nullptr;
  }
  if (valid < 0 || valid > n)
    return value_error("valid " + std::to_string(valid) + " outside [0, " +
                       std::to_string(n) + "]");
  const long long skip = PyLong_AsLongLong(args[6]);
  if (skip == -1 && PyErr_Occurred()) return nullptr;
  if (skip < 0 || skip > n)
    return value_error("skip " + std::to_string(skip) + " outside [0, " +
                       std::to_string(n) + "]");
  std::vector<int64_t> out_size{n - skip};
  out_size.insert(out_size.end(), lanes.begin(), lanes.end());
  for (int which = 0; which < 2; ++which) {
    const at::Tensor* t = which == 0 ? out_arg : side_arg;
    const char* name = which == 0 ? "out" : "side";
    if (t == nullptr) continue;
    if (t->scalar_type() != c10::kFloat || t->device() != state.device())
      return value_error(std::string(name) +
                         " must be float32 on the streams' device");
    bool ok = t->dim() == nd && t->sizes().slice(1) == lanes &&
              (which == 0 ? t->size(0) == n - skip : t->size(0) <= skip);
    if (!ok)
      return value_error(
          std::string(name) + " shape " + shape_str(t->sizes()) +
          (which == 0 ? " != " + shape_str(out_size)
                      : " must have m <= " + std::to_string(skip) +
                            " rows of " + shape_str(lanes)));
    if (overlaps(*t))
      return value_error(std::string(name) +
                         " has overlapping elements: the kernel cannot "
                         "write it");
  }
  // the kernel's own conditions
  if (!state.is_cuda())
    return value_error("the compiled loop scan takes CUDA tensors");
  int64_t C = 1;
  for (int64_t v : lanes) C *= v;
  const int64_t groups = (C + LOOP_LANES - 1) / LOOP_LANES;
  if (cycles_arg != nullptr &&
      (cycles_arg->scalar_type() != c10::kLong || cycles_arg->dim() != 1 ||
       cycles_arg->size(0) != groups || !cycles_arg->is_contiguous() ||
       cycles_arg->device() != state.device()))
    return value_error("cycles must be a contiguous int64 [" +
                       std::to_string(groups) +
                       "] tensor on the streams' device");
  if (n > INT_MAX || C > INT_MAX)
    return value_error("loop scans take fewer than 2^31 steps and lanes");
  if (g_loop_scan == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "loop_scan: the kernel entry is not bound");
    return nullptr;
  }

  const at::Tensor out =
      out_arg != nullptr ? *out_arg : at::empty(out_size, state.options());
  const at::Tensor fin = at::empty(want, state.options());
  const int64_t nl = nd - 1;
  LoopScanArgs a{};
  for (int j = 0; j < 2; ++j) {
    const at::Tensor& s = streams[std::min<int>(j, info.nstreams - 1)];
    a.in[j] = s.data_ptr<float>();
    a.in_t[j] = s.stride(0);
    lane_strides(s, 1, nl, &a.in_l0[j], &a.in_l1[j]);
  }
  a.out = out.data_ptr<float>();
  a.out_t = out.stride(0);
  lane_strides(out, 1, nl, &a.out_l0, &a.out_l1);
  if (side_arg != nullptr) {
    a.side = side_arg->data_ptr<float>();
    a.side_t = side_arg->stride(0);
    lane_strides(*side_arg, 1, nl, &a.side_l0, &a.side_l1);
    a.nside = static_cast<int>(side_arg->size(0));
  }
  a.seed = state.data_ptr<float>();
  a.seed_k = state.stride(0);
  lane_strides(state, 1, nl, &a.seed_l0, &a.seed_l1);
  a.fin = fin.data_ptr<float>();
  a.cycles = cycles_arg != nullptr
                 ? reinterpret_cast<long long*>(cycles_arg->data_ptr<int64_t>())
                 : nullptr;
  a.n = static_cast<int>(n);
  a.C = static_cast<int>(C);
  a.C1 = nl == 0 ? 1 : std::max(static_cast<int>(lanes[nl - 1]), 1);
  a.valid = static_cast<int>(valid);
  a.skip = static_cast<int>(skip);

  const OnStream on(state.device());
  const int rc = g_loop_scan(static_cast<int>(body), &a, params, info.nparams,
                             on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "loop_scan_%s launch failed: CUDA error %d at n=%lld, C=%lld",
                 info.name, rc, static_cast<long long>(n),
                 static_cast<long long>(C));
    return nullptr;
  }
  PyObject* o = out_arg != nullptr ? args[5] : THPVariable_Wrap(out);
  if (out_arg != nullptr) Py_INCREF(o);
  return pair(o, THPVariable_Wrap(fin));
  END_HANDLE_TH_ERRORS
}

PyObject* bind_loop_scan(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 1) return type_error("bind_loop_scan(entry)");
  LoopScanEntry entry;
  if (!entry_arg(args[0], &entry)) return nullptr;
  g_loop_scan = entry;
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// viterbi_acs_batched / viterbi_traceback_batched (csrc/viterbi.cu)
// ---------------------------------------------------------------------------

using ViterbiAcsEntry = int (*)(const void* soft, int soft_u8,
                                const int* starts, const float* expected,
                                long long* dec, int B, int T, long long total,
                                int R, int S, long long* cycles, void* stream,
                                int* general);
using ViterbiTracebackEntry = int (*)(const long long* dec,
                                      unsigned char* bits, int B, int T, int S,
                                      long long* cycles, void* scratch,
                                      void* stream, int* general);
using ViterbiScratchEntry = long long (*)(int B, int T, int S);

ViterbiAcsEntry g_viterbi_acs = nullptr;
ViterbiTracebackEntry g_viterbi_traceback = nullptr;
ViterbiScratchEntry g_viterbi_traceback_scratch = nullptr;

constexpr int64_t kViterbiMinRate = 2;   // fec_kernels.KERNEL_MIN_RATE
constexpr int64_t kViterbiMaxRate = 32;  // fec_kernels.KERNEL_MAX_RATE
constexpr int64_t kViterbiMaxStates = 16384;

// fec_kernels._states_ok: a power of two in [2, 16384]
bool viterbi_states_ok(int64_t S) {
  return S >= 2 && S <= kViterbiMaxStates && (S & (S - 1)) == 0;
}

// the optional cycles argument: None, or a contiguous int64 [B] tensor on
// `device`; false with the error set otherwise
bool viterbi_cycles(PyObject* o, int64_t B, c10::Device device,
                    const char* what, long long** out) {
  *out = nullptr;
  if (o == Py_None) return true;
  if (!THPVariable_Check(o)) {
    type_error("viterbi: cycles is a tensor or None");
    return false;
  }
  const at::Tensor& c = THPVariable_Unpack(o);
  if (c.scalar_type() != c10::kLong || c.dim() != 1 || c.size(0) != B ||
      !c.is_contiguous() || c.device() != device) {
    value_error("cycles must be a contiguous int64 [" + std::to_string(B) +
                "] tensor on " + what + "'s device");
    return false;
  }
  *out = reinterpret_cast<long long*>(c.data_ptr<int64_t>());
  return true;
}

PyObject* viterbi_acs(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 5 || !THPVariable_Check(args[0]) ||
      !THPVariable_Check(args[1]) || !THPVariable_Check(args[3]))
    return type_error(
        "viterbi_acs(soft, starts, T, expected, cycles) takes three tensors, "
        "an int and a tensor or None");
  const at::Tensor& soft = THPVariable_Unpack(args[0]);
  const at::Tensor& starts = THPVariable_Unpack(args[1]);
  const at::Tensor& expected = THPVariable_Unpack(args[3]);
  const long long T = PyLong_AsLongLong(args[2]);
  if (T == -1 && PyErr_Occurred()) return nullptr;

  // the checks of fec_kernels._check_acs, in its order and with its messages
  const bool u8 = soft.scalar_type() == c10::kByte;
  if ((!u8 && soft.scalar_type() != c10::kFloat) || soft.dim() != 2)
    return value_error("soft must be uint8 or float32 [total, R]");
  const int64_t total = soft.size(0), R = soft.size(1);
  if (R < kViterbiMinRate || R > kViterbiMaxRate)
    return value_error("soft takes " + std::to_string(kViterbiMinRate) +
                       " to " + std::to_string(kViterbiMaxRate) +
                       " soft bits a step, got " + std::to_string(R));
  if (expected.scalar_type() != c10::kFloat || expected.dim() != 2 ||
      expected.size(0) % 2 != 0 ||
      !viterbi_states_ok(expected.size(0) / 2) || expected.size(1) != R)
    return value_error("expected must be float32 [2S, " + std::to_string(R) +
                       "] for S = 2, 4, ..., 16384 states");
  const int64_t S = expected.size(0) / 2;
  if (starts.scalar_type() != c10::kInt || starts.dim() != 1 ||
      starts.size(0) < 1)
    return value_error("starts must be a non-empty int32 vector");
  if (expected.device() != soft.device() || starts.device() != soft.device())
    return value_error("the Viterbi ACS takes tensors on one device");
  if (T < 1 || T > total)
    return value_error("window length " + std::to_string(T) +
                       " outside [1, " + std::to_string(total) + "]");
  // the kernel's own conditions
  if (!soft.is_cuda())
    return value_error("the compiled Viterbi ACS takes CUDA tensors");
  const int64_t B = starts.size(0);
  if (total > INT_MAX || B > INT_MAX)
    return value_error("the Viterbi ACS takes fewer than 2^31 steps and "
                       "windows");
  long long* cycles = nullptr;
  if (!viterbi_cycles(args[4], B, soft.device(), "soft", &cycles))
    return nullptr;
  if (g_viterbi_acs == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "viterbi_acs: the kernel entry is not bound");
    return nullptr;
  }

  const at::Tensor sc = soft.is_contiguous() ? soft : soft.contiguous();
  const at::Tensor stc = starts.is_contiguous() ? starts : starts.contiguous();
  const at::Tensor ec =
      expected.is_contiguous() ? expected : expected.contiguous();
  at::Tensor dec =
      S <= 64 ? at::empty({B, T}, soft.options().dtype(c10::kLong))
              : at::empty({B, T, S / 64}, soft.options().dtype(c10::kLong));

  const OnStream on(soft.device());
  int general = 0;
  const int rc = g_viterbi_acs(
      sc.data_ptr(), u8 ? 1 : 0, stc.data_ptr<int32_t>(), ec.data_ptr<float>(),
      reinterpret_cast<long long*>(dec.data_ptr<int64_t>()),
      static_cast<int>(B), static_cast<int>(T), static_cast<long long>(total),
      static_cast<int>(R), static_cast<int>(S), cycles, on.stream, &general);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "viterbi_acs_batched launch failed: CUDA error %d at B=%lld, "
                 "T=%lld, R=%lld", rc, static_cast<long long>(B), T,
                 static_cast<long long>(R));
    return nullptr;
  }
  return Py_BuildValue("(NN)", THPVariable_Wrap(std::move(dec)),
                       PyBool_FromLong(general));
  END_HANDLE_TH_ERRORS
}

PyObject* viterbi_traceback(PyObject*, PyObject* const* args,
                            Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if ((nargs != 2 && nargs != 3) || !THPVariable_Check(args[0]))
    return type_error("viterbi_traceback(dec, cycles[, num_states]) takes a "
                      "tensor, a tensor or None and an int");
  const at::Tensor& dec = THPVariable_Unpack(args[0]);
  long long S = 64;
  if (nargs == 3) {
    S = PyLong_AsLongLong(args[2]);
    if (S == -1 && PyErr_Occurred()) return nullptr;
  }

  // the checks of fec_kernels._check_traceback, in its order and with its
  // messages
  if (!viterbi_states_ok(S))
    return value_error("the Viterbi kernels take S = 2, 4, ..., 16384 "
                       "states, got " + std::to_string(S));
  const bool wide = S > 64;
  if (dec.scalar_type() != c10::kLong || dec.dim() != (wide ? 3 : 2) ||
      dec.size(0) < 1 || dec.size(1) < 1 ||
      (wide && dec.size(2) != S / 64))
    return value_error(std::string("dec must be int64 ") +
                       (wide ? "[B, T, " + std::to_string(S / 64) + "]"
                             : std::string("[B, T]")) +
                       " decision words, B and T >= 1");
  // the kernel's own conditions
  if (!dec.is_cuda())
    return value_error("the compiled Viterbi traceback takes CUDA tensors");
  const int64_t B = dec.size(0), T = dec.size(1);
  if (B > INT_MAX || T > INT_MAX)
    return value_error("the Viterbi traceback takes fewer than 2^31 steps "
                       "and windows");
  long long* cycles = nullptr;
  if (!viterbi_cycles(args[1], B, dec.device(), "dec", &cycles))
    return nullptr;
  if (g_viterbi_traceback == nullptr ||
      g_viterbi_traceback_scratch == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "viterbi_traceback: the kernel entry is not bound");
    return nullptr;
  }

  const at::Tensor dc = dec.is_contiguous() ? dec : dec.contiguous();
  at::Tensor bits = at::empty({B, T}, dec.options().dtype(c10::kByte));

  const OnStream on(dec.device());
  // S > 64: the segment-parallel walk's maps, bits and entries, from the
  // caching allocator on the launch's stream
  const long long need = g_viterbi_traceback_scratch(
      static_cast<int>(B), static_cast<int>(T), static_cast<int>(S));
  at::Tensor scratch;
  if (need > 0)
    scratch = at::empty({need}, dec.options().dtype(c10::kByte));
  int general = 0;
  const int rc = g_viterbi_traceback(
      reinterpret_cast<const long long*>(dc.data_ptr<int64_t>()),
      bits.data_ptr<uint8_t>(), static_cast<int>(B), static_cast<int>(T),
      static_cast<int>(S), cycles,
      need > 0 ? scratch.data_ptr() : nullptr, on.stream, &general);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "viterbi_traceback_batched launch failed: CUDA error %d at "
                 "B=%lld, T=%lld", rc, static_cast<long long>(B),
                 static_cast<long long>(T));
    return nullptr;
  }
  return Py_BuildValue("(NN)", THPVariable_Wrap(std::move(bits)),
                       PyBool_FromLong(general));
  END_HANDLE_TH_ERRORS
}

PyObject* bind_viterbi(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 3)
    return type_error(
        "bind_viterbi(acs_entry, traceback_entry, traceback_scratch_entry)");
  ViterbiAcsEntry acs;
  ViterbiTracebackEntry tb;
  ViterbiScratchEntry scratch;
  if (!entry_arg(args[0], &acs) || !entry_arg(args[1], &tb) ||
      !entry_arg(args[2], &scratch))
    return nullptr;
  g_viterbi_acs = acs;
  g_viterbi_traceback = tb;
  g_viterbi_traceback_scratch = scratch;
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// mm_symbols / mm_chunked / fd_symbols (csrc/mm_clock.cu)
// ---------------------------------------------------------------------------

using MmSymbolsEntry = int (*)(const void* x, int n, int C, const float* bank,
                               const int* offset, const float* fstate,
                               int* offset_out, float* fstate_out, void* out,
                               int* count, int max_syms, float mu,
                               float omega_gain, float min_freq,
                               float max_freq, long long* cycles,
                               void* stream);
using MmChunkedEntry = int (*)(const void* ext, const float* bank,
                               const int* off0, const float* ph0,
                               const float* fr0, const float* emit_lo,
                               const int* emit_hi, const float* goff, int K,
                               int L, int cols, int R, int J, int M, int steps,
                               int n, float mu, float omega_gain,
                               float min_freq, float max_freq,
                               float half_omega, void* syms, void* valid,
                               float* pos, int* off_f, float* fst,
                               long long* cycles, void* stream);
using MmChunkedBlockEntry = int (*)(const void* x, const void* hist,
                                    const int* offset0, const float* phase0,
                                    const float* freq0, const float* bank,
                                    int K, int L, int cols, int R, int J,
                                    int M, int steps, int n, int W, int pad,
                                    float mu, float omega_gain,
                                    float min_freq, float max_freq,
                                    float half_omega, float allow, float lo,
                                    void* syms, void* valid, float* pos,
                                    int* off_f, float* fst, long long* cycles,
                                    void* stream);
using FdSymbolsEntry = int (*)(const float* x, int n, int C, const float* bank,
                               const int* offset, const float* fstate,
                               int* offset_out, float* fstate_out, float* out,
                               int* count, int max_syms, float omega_gain,
                               float mu, float min_freq, float max_freq,
                               void* stream);

MmSymbolsEntry g_mm_complex = nullptr;
MmSymbolsEntry g_mm_real = nullptr;
MmChunkedEntry g_chunked_complex = nullptr;
MmChunkedEntry g_chunked_real = nullptr;
MmChunkedBlockEntry g_block_complex = nullptr;
MmChunkedBlockEntry g_block_real = nullptr;
FdSymbolsEntry g_fd = nullptr;

constexpr int64_t kMmPhases = 128;  // clock_recovery_kernels.KERNEL_PHASES
constexpr int64_t kMmTaps = 8;      // clock_recovery_kernels.KERNEL_TAPS
constexpr int64_t kChunkMaxLanes = 256;
constexpr int64_t kChunkPhases = 8;  // mm_clock.cu's clock64 split
// `count` floats from a Python sequence into `out`; false with the error set
bool float_params(PyObject* o, const char* what, Py_ssize_t count,
                  float* out) {
  THPObjectPtr seq(PySequence_Fast(o, what));
  if (!seq) return false;
  if (PySequence_Fast_GET_SIZE(seq.get()) != count) {
    PyErr_Format(PyExc_TypeError, "%s: %zd parameters", what, count);
    return false;
  }
  for (Py_ssize_t i = 0; i < count; ++i) {
    const double v = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(seq.get(), i));
    if (v == -1.0 && PyErr_Occurred()) return false;
    out[i] = static_cast<float>(v);
  }
  return true;
}

std::string bank_shape_error(const char* kernel, const at::Tensor& bank) {
  return std::string("the ") + kernel + " kernel takes a [" +
         std::to_string(kMmPhases) + ", " + std::to_string(kMmTaps) +
         "] bank, not " + shape_str(bank.sizes());
}

bool bank_ok(const at::Tensor& bank) {
  return bank.size(0) == kMmPhases && bank.size(1) == kMmTaps;
}

at::Tensor contiguous(const at::Tensor& t) {
  return t.is_contiguous() ? t : t.contiguous();
}

// the geometry (K, L, cols, R, J, M, steps, n) from a Python sequence;
// false with the error set
bool chunk_geom(PyObject* o, const char* what, int64_t* geom) {
  THPObjectPtr seq(PySequence_Fast(o, what));
  if (!seq) return false;
  if (PySequence_Fast_GET_SIZE(seq.get()) != 8) {
    PyErr_Format(PyExc_TypeError, "%s is (K, L, cols, R, J, M, steps, n)",
                 what);
    return false;
  }
  for (int i = 0; i < 8; ++i) {
    geom[i] = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq.get(), i));
    if (geom[i] == -1 && PyErr_Occurred()) return false;
  }
  return true;
}

// the geometry check of clock_recovery_chunked._check; empty when it holds
std::string chunk_geom_error(const int64_t* geom, int64_t T) {
  const int64_t K = geom[0], L = geom[1], cols = geom[2], R = geom[3],
                J = geom[4], M = geom[5], steps = geom[6], n = geom[7];
  if (K < 1 || L < 1 || M < 1 || steps < 1 || n < 1 || J < T || R < J ||
      cols < R)
    return "bad geometry " + geom_str(geom) + " for " + std::to_string(T) +
           " taps";
  return "";
}

// the chunked kernel's own conditions; empty when it takes the call
std::string chunk_kernel_error(const at::Tensor& bank, const int64_t* geom,
                               int64_t samples) {
  const int64_t K = geom[0], M = geom[5], steps = geom[6], n = geom[7];
  if (!bank_ok(bank)) return bank_shape_error("mm_symbols_chunked", bank);
  if (K > kChunkMaxLanes)
    return "the mm_symbols_chunked kernel takes at most " +
           std::to_string(kChunkMaxLanes) + " lanes, got " +
           std::to_string(K);
  if (M != 8 && M != 16 && M != 32)
    return "the mm_symbols_chunked kernel takes M = 8, 16 or 32, got " +
           std::to_string(M);
  if (samples > INT_MAX || K * steps * M > INT_MAX || n > INT_MAX)
    return "mm_symbols_chunked takes fewer than 2^31 samples and symbols";
  return "";
}

// the optional cycles tensor of a chunked entry; false with the error set
bool chunk_cycles(PyObject* const* args, Py_ssize_t nargs, Py_ssize_t i,
                  const at::Tensor& like, long long** out) {
  *out = nullptr;
  if (nargs <= i || args[i] == Py_None) return true;
  if (!THPVariable_Check(args[i])) {
    type_error("mm_chunked: cycles is a tensor or None");
    return false;
  }
  const at::Tensor& cy = THPVariable_Unpack(args[i]);
  if (cy.scalar_type() != c10::kLong || cy.dim() != 1 ||
      cy.size(0) != kChunkPhases || !cy.is_contiguous() ||
      cy.device() != like.device()) {
    value_error("cycles must be a contiguous int64 [" +
                std::to_string(kChunkPhases) + "] tensor on the block's "
                "device");
    return false;
  }
  *out = reinterpret_cast<long long*>(cy.data_ptr<int64_t>());
  return true;
}

// (syms, valid, pos, offset, fstate) of a chunked call
PyObject* chunk_result(at::Tensor syms, at::Tensor valid, at::Tensor pos,
                       at::Tensor off_f, at::Tensor fst) {
  return Py_BuildValue("(NNNNN)", THPVariable_Wrap(std::move(syms)),
                       THPVariable_Wrap(std::move(valid)),
                       THPVariable_Wrap(std::move(pos)),
                       THPVariable_Wrap(std::move(off_f)),
                       THPVariable_Wrap(std::move(fst)));
}

// (syms, count, offset_out, fstate_out) from a walker entry's launch
PyObject* walk_result(at::Tensor syms, at::Tensor count, at::Tensor off,
                      at::Tensor fst) {
  return Py_BuildValue("(NNNN)", THPVariable_Wrap(std::move(syms)),
                       THPVariable_Wrap(std::move(count)),
                       THPVariable_Wrap(std::move(off)),
                       THPVariable_Wrap(std::move(fst)));
}

PyObject* mm_symbols(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 7 || !THPVariable_Check(args[0]) ||
      !THPVariable_Check(args[1]) || !THPVariable_Check(args[2]) ||
      !THPVariable_Check(args[3]))
    return type_error(
        "mm_symbols(buf, offset, fstate, bank, max_syms, params, cycles)");
  const at::Tensor& buf = THPVariable_Unpack(args[0]);
  const at::Tensor& offset = THPVariable_Unpack(args[1]);
  const at::Tensor& fstate = THPVariable_Unpack(args[2]);
  const at::Tensor& bank = THPVariable_Unpack(args[3]);
  const long long max_syms = PyLong_AsLongLong(args[4]);
  if (max_syms == -1 && PyErr_Occurred()) return nullptr;
  float params[4];
  if (!float_params(args[5], "mm_symbols: params", 4, params)) return nullptr;

  // the checks of clock_recovery_kernels._check, in its order and with its
  // messages
  if (buf.dim() != 2) return value_error("buf must be [C, n + taps - 1]");
  const int64_t C = buf.size(0);
  const bool cplx = buf.scalar_type() == c10::kComplexFloat;
  const int64_t kf = cplx ? 10 : 3;
  if (!cplx && buf.scalar_type() != c10::kFloat)
    return value_error("buf must be complex64 or float32");
  if (offset.scalar_type() != c10::kInt || offset.dim() != 1 ||
      offset.size(0) != C)
    return value_error("offset must be int32 [C]");
  if (fstate.scalar_type() != c10::kFloat || fstate.dim() != 2 ||
      fstate.size(0) != C || fstate.size(1) != kf)
    return value_error("fstate must be float32 [C, " + std::to_string(kf) +
                       "]");
  if (bank.scalar_type() != c10::kFloat || bank.dim() != 2)
    return value_error("bank must be float32 [phases, taps]");
  if (offset.device() != buf.device() || fstate.device() != buf.device() ||
      bank.device() != buf.device())
    return value_error("mm_symbols takes tensors on one device");
  const int64_t n = buf.size(1) - (bank.size(1) - 1);
  if (n < 1) return value_error("empty block");
  // the kernel's own conditions
  if (!bank_ok(bank)) return value_error(bank_shape_error("mm_symbols", bank));
  if (!buf.is_cuda())
    return value_error("the compiled mm_symbols takes CUDA tensors");
  if (max_syms < 0 || max_syms > INT_MAX || buf.size(1) > INT_MAX ||
      C > INT_MAX)
    return value_error("mm_symbols takes fewer than 2^31 samples, streams "
                       "and symbols, max_syms >= 0");
  long long* cycles = nullptr;
  if (args[6] != Py_None) {
    if (!THPVariable_Check(args[6]))
      return type_error("mm_symbols: cycles is a tensor or None");
    const at::Tensor& cy = THPVariable_Unpack(args[6]);
    if (cy.scalar_type() != c10::kLong || cy.dim() != 1 || cy.size(0) != C ||
        !cy.is_contiguous() || cy.device() != buf.device())
      return value_error("cycles must be a contiguous int64 [C] tensor on "
                         "buf's device");
    cycles = reinterpret_cast<long long*>(cy.data_ptr<int64_t>());
  }
  const MmSymbolsEntry fn = cplx ? g_mm_complex : g_mm_real;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "mm_symbols: the kernel entries are not bound");
    return nullptr;
  }

  const at::Tensor bc = contiguous(buf), oc = contiguous(offset),
                   fc = contiguous(fstate), kc = contiguous(bank);
  at::Tensor syms = at::empty({C, max_syms}, buf.options());
  at::Tensor count = at::empty({C}, offset.options());
  at::Tensor off = at::empty({C}, offset.options());
  at::Tensor fst = at::empty({C, kf}, fstate.options());

  const OnStream on(buf.device());
  const int rc = fn(bc.data_ptr(), static_cast<int>(n), static_cast<int>(C),
                    kc.data_ptr<float>(), oc.data_ptr<int32_t>(),
                    fc.data_ptr<float>(), off.data_ptr<int32_t>(),
                    fst.data_ptr<float>(), syms.data_ptr(),
                    count.data_ptr<int32_t>(), static_cast<int>(max_syms),
                    params[0], params[1], params[2], params[3], cycles,
                    on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "mm_symbols launch failed: CUDA error %d at n=%lld, C=%lld",
                 rc, static_cast<long long>(n), static_cast<long long>(C));
    return nullptr;
  }
  return walk_result(std::move(syms), std::move(count), std::move(off),
                     std::move(fst));
  END_HANDLE_TH_ERRORS
}

PyObject* mm_chunked(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  bool tensors = nargs == 10 || nargs == 11;
  for (int i = 0; tensors && i < 8; ++i) tensors = THPVariable_Check(args[i]);
  if (!tensors)
    return type_error("mm_chunked(ext, off0, ph0, fr0, emit_lo, emit_hi, "
                      "goff, bank, geom, params[, cycles]) takes eight "
                      "tensors, two sequences and a tensor or None");
  const at::Tensor& ext = THPVariable_Unpack(args[0]);
  const at::Tensor& bank = THPVariable_Unpack(args[7]);
  int64_t geom[8];
  if (!chunk_geom(args[8], "mm_chunked: geom", geom)) return nullptr;
  float params[5];
  if (!float_params(args[9], "mm_chunked: params", 5, params)) return nullptr;

  // the checks of clock_recovery_chunked._check, in its order and with its
  // messages
  const bool cplx = ext.scalar_type() == c10::kComplexFloat;
  if ((!cplx && ext.scalar_type() != c10::kFloat) || ext.dim() != 1)
    return value_error("ext must be a complex64 or float32 vector");
  if (bank.scalar_type() != c10::kFloat || bank.dim() != 2 ||
      bank.size(1) < 2)
    return value_error("bank must be float32 [phases, taps >= 2]");
  const int64_t K = geom[0], L = geom[1], cols = geom[2], R = geom[3],
                J = geom[4], M = geom[5], steps = geom[6], n = geom[7];
  const std::string bad_geom = chunk_geom_error(geom, bank.size(1));
  if (!bad_geom.empty()) return value_error(bad_geom);
  const int64_t need = (K - 1) * L + cols;
  if (ext.size(0) < need)
    return value_error("ext holds " + std::to_string(ext.size(0)) +
                       " samples, the lanes need " + std::to_string(need));
  const char* names[6] = {"off0", "ph0", "fr0", "emit_lo", "emit_hi", "goff"};
  const bool is_int[6] = {true, false, false, false, true, false};
  for (int i = 0; i < 6; ++i) {
    const at::Tensor& t = THPVariable_Unpack(args[1 + i]);
    if (t.scalar_type() != (is_int[i] ? c10::kInt : c10::kFloat) ||
        t.dim() != 1 || t.size(0) != K)
      return value_error(std::string(names[i]) + " must be " +
                         (is_int[i] ? "int32" : "float32") + " [" +
                         std::to_string(K) + "]");
  }
  for (int i = 1; i < 8; ++i)
    if (THPVariable_Unpack(args[i]).device() != ext.device())
      return value_error("mm_symbols_chunked takes tensors on one device");
  // the kernel's own conditions
  const std::string bad_kernel =
      chunk_kernel_error(bank, geom, ext.size(0));
  if (!bad_kernel.empty()) return value_error(bad_kernel);
  if (!ext.is_cuda())
    return value_error("the compiled mm_symbols_chunked takes CUDA tensors");
  long long* cycles;
  if (!chunk_cycles(args, nargs, 10, ext, &cycles)) return nullptr;
  const MmChunkedEntry fn = cplx ? g_chunked_complex : g_chunked_real;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "mm_chunked: the kernel entries are not bound");
    return nullptr;
  }

  at::Tensor in[8];
  for (int i = 0; i < 8; ++i) in[i] = contiguous(THPVariable_Unpack(args[i]));
  const int64_t msc = steps * M;
  at::Tensor syms = at::empty({K, msc}, ext.options());
  at::Tensor valid = at::empty({K, msc}, ext.options().dtype(c10::kBool));
  at::Tensor pos = at::empty({K, msc}, ext.options().dtype(c10::kFloat));
  at::Tensor off_f = at::empty({}, ext.options().dtype(c10::kInt));
  at::Tensor fst = at::empty({cplx ? 10 : 3}, ext.options().dtype(c10::kFloat));

  const OnStream on(ext.device());
  const int rc = fn(
      in[0].data_ptr(), in[7].data_ptr<float>(), in[1].data_ptr<int32_t>(),
      in[2].data_ptr<float>(), in[3].data_ptr<float>(),
      in[4].data_ptr<float>(), in[5].data_ptr<int32_t>(),
      in[6].data_ptr<float>(), static_cast<int>(K), static_cast<int>(L),
      static_cast<int>(cols), static_cast<int>(R), static_cast<int>(J),
      static_cast<int>(M), static_cast<int>(steps), static_cast<int>(n),
      params[0], params[1], params[2], params[3], params[4], syms.data_ptr(),
      valid.data_ptr(), pos.data_ptr<float>(), off_f.data_ptr<int32_t>(),
      fst.data_ptr<float>(), cycles, on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "mm_symbols_chunked launch failed: CUDA error %d at K=%lld, "
                 "M=%lld, steps=%lld", rc, static_cast<long long>(K),
                 static_cast<long long>(M), static_cast<long long>(steps));
    return nullptr;
  }
  return chunk_result(std::move(syms), std::move(valid), std::move(pos),
                      std::move(off_f), std::move(fst));
  END_HANDLE_TH_ERRORS
}

PyObject* mm_chunked_block(PyObject*, PyObject* const* args,
                           Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  bool tensors = nargs == 10 || nargs == 11;
  for (int i = 0; tensors && i < 6; ++i) tensors = THPVariable_Check(args[i]);
  if (!tensors)
    return type_error("mm_chunked_block(x, hist, offset0, phase0, freq0, "
                      "bank, geom, W, pad, params[, cycles]) takes six "
                      "tensors, a sequence, two ints, a sequence and a "
                      "tensor or None");
  const at::Tensor& x = THPVariable_Unpack(args[0]);
  const at::Tensor& hist = THPVariable_Unpack(args[1]);
  const at::Tensor& bank = THPVariable_Unpack(args[5]);
  int64_t geom[8];
  if (!chunk_geom(args[6], "mm_chunked_block: geom", geom)) return nullptr;
  const long long W = PyLong_AsLongLong(args[7]);
  if (W == -1 && PyErr_Occurred()) return nullptr;
  const long long pad = PyLong_AsLongLong(args[8]);
  if (pad == -1 && PyErr_Occurred()) return nullptr;
  float params[7];
  if (!float_params(args[9], "mm_chunked_block: params", 7, params))
    return nullptr;

  // the checks of clock_recovery_chunked._check_block, in its order and
  // with its messages
  const bool cplx = x.scalar_type() == c10::kComplexFloat;
  if ((!cplx && x.scalar_type() != c10::kFloat) || x.dim() != 1)
    return value_error("x must be a complex64 or float32 vector");
  if (bank.scalar_type() != c10::kFloat || bank.dim() != 2 ||
      bank.size(1) < 2)
    return value_error("bank must be float32 [phases, taps >= 2]");
  const int64_t K = geom[0], L = geom[1], cols = geom[2], R = geom[3],
                J = geom[4], M = geom[5], steps = geom[6], n = geom[7];
  const int64_t T = bank.size(1);
  const std::string bad_geom = chunk_geom_error(geom, T);
  if (!bad_geom.empty()) return value_error(bad_geom);
  if (x.size(0) != n || W < 1 || W > L || pad != K * L - n)
    return value_error("bad layout: " + std::to_string(x.size(0)) +
                       " samples, W " + std::to_string(W) + ", pad " +
                       std::to_string(pad) + " for the geometry " +
                       geom_str(geom));
  if (hist.scalar_type() != x.scalar_type() || hist.dim() != 1 ||
      hist.size(0) != W + T - 1)
    return value_error(std::string("hist must be ") +
                       (cplx ? "complex64" : "float32") + " [" +
                       std::to_string(W + T - 1) + "]");
  const char* names[3] = {"offset0", "phase0", "freq0"};
  for (int i = 0; i < 3; ++i) {
    const at::Tensor& v = THPVariable_Unpack(args[2 + i]);
    if (v.scalar_type() != (i == 0 ? c10::kInt : c10::kFloat) ||
        v.numel() != 1)
      return value_error(std::string(names[i]) + " must be one " +
                         (i == 0 ? "int32" : "float32"));
  }
  for (int i = 1; i < 6; ++i)
    if (THPVariable_Unpack(args[i]).device() != x.device())
      return value_error("mm_symbols_chunked takes tensors on one device");
  // the kernel's own conditions
  const std::string bad_kernel =
      chunk_kernel_error(bank, geom, (K - 1) * L + cols);
  if (!bad_kernel.empty()) return value_error(bad_kernel);
  if (!x.is_cuda())
    return value_error("the compiled mm_symbols_chunked takes CUDA tensors");
  long long* cycles;
  if (!chunk_cycles(args, nargs, 10, x, &cycles)) return nullptr;
  const MmChunkedBlockEntry fn = cplx ? g_block_complex : g_block_real;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "mm_chunked_block: the kernel entries are not bound");
    return nullptr;
  }

  at::Tensor in[6];
  for (int i = 0; i < 6; ++i) in[i] = contiguous(THPVariable_Unpack(args[i]));
  const int64_t msc = steps * M;
  at::Tensor syms = at::empty({K, msc}, x.options());
  at::Tensor valid = at::empty({K, msc}, x.options().dtype(c10::kBool));
  at::Tensor pos = at::empty({K, msc}, x.options().dtype(c10::kFloat));
  at::Tensor off_f = at::empty({}, x.options().dtype(c10::kInt));
  at::Tensor fst = at::empty({cplx ? 10 : 3}, x.options().dtype(c10::kFloat));

  const OnStream on(x.device());
  const int rc = fn(
      in[0].data_ptr(), in[1].data_ptr(), in[2].data_ptr<int32_t>(),
      in[3].data_ptr<float>(), in[4].data_ptr<float>(),
      in[5].data_ptr<float>(), static_cast<int>(K), static_cast<int>(L),
      static_cast<int>(cols), static_cast<int>(R), static_cast<int>(J),
      static_cast<int>(M), static_cast<int>(steps), static_cast<int>(n),
      static_cast<int>(W), static_cast<int>(pad), params[0], params[1],
      params[2], params[3], params[4], params[5], params[6], syms.data_ptr(),
      valid.data_ptr(), pos.data_ptr<float>(), off_f.data_ptr<int32_t>(),
      fst.data_ptr<float>(), cycles, on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "mm_symbols_chunked launch failed: CUDA error %d at K=%lld, "
                 "M=%lld, steps=%lld", rc, static_cast<long long>(K),
                 static_cast<long long>(M), static_cast<long long>(steps));
    return nullptr;
  }
  return chunk_result(std::move(syms), std::move(valid), std::move(pos),
                      std::move(off_f), std::move(fst));
  END_HANDLE_TH_ERRORS
}

PyObject* fd_symbols(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 6 || !THPVariable_Check(args[0]) ||
      !THPVariable_Check(args[1]) || !THPVariable_Check(args[2]) ||
      !THPVariable_Check(args[3]))
    return type_error(
        "fd_symbols(buf, offset, fstate, bank, max_syms, params)");
  const at::Tensor& buf = THPVariable_Unpack(args[0]);
  const at::Tensor& offset = THPVariable_Unpack(args[1]);
  const at::Tensor& fstate = THPVariable_Unpack(args[2]);
  const at::Tensor& bank = THPVariable_Unpack(args[3]);
  const long long max_syms = PyLong_AsLongLong(args[4]);
  if (max_syms == -1 && PyErr_Occurred()) return nullptr;
  float params[4];
  if (!float_params(args[5], "fd_symbols: params", 4, params)) return nullptr;

  // the checks of clock_recovery_kernels._check_fd, in its order and with
  // its messages
  if (buf.scalar_type() != c10::kFloat || buf.dim() != 2)
    return value_error("buf must be float32 [C, n + taps - 1]");
  const int64_t C = buf.size(0);
  if (offset.scalar_type() != c10::kInt || offset.dim() != 1 ||
      offset.size(0) != C)
    return value_error("offset must be int32 [C]");
  if (fstate.scalar_type() != c10::kFloat || fstate.dim() != 2 ||
      fstate.size(0) != C || fstate.size(1) != 2)
    return value_error("fstate must be float32 [C, 2]");
  if (bank.scalar_type() != c10::kFloat || bank.dim() != 2)
    return value_error("bank must be float32 [phases, taps]");
  if (offset.device() != buf.device() || fstate.device() != buf.device() ||
      bank.device() != buf.device())
    return value_error("fd_symbols takes tensors on one device");
  const int64_t n = buf.size(1) - (bank.size(1) - 1);
  if (n < 1) return value_error("empty block");
  // the kernel's own conditions
  if (!bank_ok(bank)) return value_error(bank_shape_error("fd_symbols", bank));
  if (!buf.is_cuda())
    return value_error("the compiled fd_symbols takes CUDA tensors");
  if (max_syms < 0 || max_syms > INT_MAX || buf.size(1) > INT_MAX ||
      C > INT_MAX)
    return value_error("fd_symbols takes fewer than 2^31 samples, streams "
                       "and symbols, max_syms >= 0");
  if (g_fd == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "fd_symbols: the kernel entry is not bound");
    return nullptr;
  }

  const at::Tensor bc = contiguous(buf), oc = contiguous(offset),
                   fc = contiguous(fstate), kc = contiguous(bank);
  at::Tensor syms = at::empty({C, max_syms}, buf.options());
  at::Tensor count = at::empty({C}, offset.options());
  at::Tensor off = at::empty({C}, offset.options());
  at::Tensor fst = at::empty({C, 2}, fstate.options());

  const OnStream on(buf.device());
  const int rc = g_fd(bc.data_ptr<float>(), static_cast<int>(n),
                      static_cast<int>(C), kc.data_ptr<float>(),
                      oc.data_ptr<int32_t>(), fc.data_ptr<float>(),
                      off.data_ptr<int32_t>(), fst.data_ptr<float>(),
                      syms.data_ptr<float>(), count.data_ptr<int32_t>(),
                      static_cast<int>(max_syms), params[0], params[1],
                      params[2], params[3], on.stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "fd_symbols launch failed: CUDA error %d at n=%lld, C=%lld",
                 rc, static_cast<long long>(n), static_cast<long long>(C));
    return nullptr;
  }
  return walk_result(std::move(syms), std::move(count), std::move(off),
                     std::move(fst));
  END_HANDLE_TH_ERRORS
}

PyObject* bind_mm_clock(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 5)
    return type_error("bind_mm_clock(mm_complex, mm_real, chunked_complex, "
                      "chunked_real, fd)");
  MmSymbolsEntry mc, mr;
  MmChunkedEntry cc, cr;
  FdSymbolsEntry fd;
  if (!entry_arg(args[0], &mc) || !entry_arg(args[1], &mr) ||
      !entry_arg(args[2], &cc) || !entry_arg(args[3], &cr) ||
      !entry_arg(args[4], &fd))
    return nullptr;
  g_mm_complex = mc;
  g_mm_real = mr;
  g_chunked_complex = cc;
  g_chunked_real = cr;
  g_fd = fd;
  Py_RETURN_NONE;
}

PyObject* bind_mm_chunked_block(PyObject*, PyObject* const* args,
                                Py_ssize_t nargs) {
  if (nargs != 2)
    return type_error("bind_mm_chunked_block(block_complex, block_real)");
  MmChunkedBlockEntry bc, br;
  if (!entry_arg(args[0], &bc) || !entry_arg(args[1], &br)) return nullptr;
  g_block_complex = bc;
  g_block_real = br;
  Py_RETURN_NONE;
}

template <PyObject* (*F)(PyObject*, PyObject* const*, Py_ssize_t)>
PyCFunction fastcall() {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(F));
}

PyMethodDef kMethods[] = {
    {"decim_fir", fastcall<decim_fir>(), METH_FASTCALL,
     "decim_fir(tail, x, taps, r) -> (new_tail, y): check, allocate and "
     "launch decimating_fir's kernel on x's current stream."},
    {"loop_scan", fastcall<loop_scan>(), METH_FASTCALL,
     "loop_scan(body, params, state, streams, valid, out, skip, side, "
     "cycles, single) -> (out, fin): check, allocate and launch the "
     "loop-scan kernel on the state's current stream."},
    {"bind_decim_fir", fastcall<bind_decim_fir>(), METH_FASTCALL,
     "bind_decim_fir(c64_entry, f32_entry): decim_fir.cu's C entries."},
    {"bind_loop_scan", fastcall<bind_loop_scan>(), METH_FASTCALL,
     "bind_loop_scan(entry): loop_scan.cu's C entry."},
    {"viterbi_acs", fastcall<viterbi_acs>(), METH_FASTCALL,
     "viterbi_acs(soft, starts, T, expected, cycles) -> (dec, general): "
     "check, allocate and launch the Viterbi ACS kernel on soft's current "
     "stream."},
    {"viterbi_traceback", fastcall<viterbi_traceback>(), METH_FASTCALL,
     "viterbi_traceback(dec, cycles[, num_states]) -> (bits, general): "
     "check, allocate and launch the Viterbi traceback kernel on dec's "
     "current stream."},
    {"bind_viterbi", fastcall<bind_viterbi>(), METH_FASTCALL,
     "bind_viterbi(acs_entry, traceback_entry): viterbi.cu's C entries."},
    {"mm_symbols", fastcall<mm_symbols>(), METH_FASTCALL,
     "mm_symbols(buf, offset, fstate, bank, max_syms, params, cycles) -> "
     "(syms, count, offset, fstate): check, allocate and launch the M&M "
     "walker on buf's current stream."},
    {"mm_chunked", fastcall<mm_chunked>(), METH_FASTCALL,
     "mm_chunked(ext, off0, ph0, fr0, emit_lo, emit_hi, goff, bank, geom, "
     "params) -> (syms, valid, pos, offset, fstate): check, allocate and "
     "launch the chunked M&M on ext's current stream."},
    {"mm_chunked_block", fastcall<mm_chunked_block>(), METH_FASTCALL,
     "mm_chunked_block(x, hist, offset0, phase0, freq0, bank, geom, W, pad, "
     "params[, cycles]) -> (syms, valid, pos, offset, fstate): check, "
     "allocate and launch one block of the chunked M&M, glue included, on "
     "x's current stream."},
    {"fd_symbols", fastcall<fd_symbols>(), METH_FASTCALL,
     "fd_symbols(buf, offset, fstate, bank, max_syms, params) -> (syms, "
     "count, offset, fstate): check, allocate and launch the FD walker on "
     "buf's current stream."},
    {"bind_mm_clock", fastcall<bind_mm_clock>(), METH_FASTCALL,
     "bind_mm_clock(mm_complex, mm_real, chunked_complex, chunked_real, fd): "
     "mm_clock.cu's C entries."},
    {"bind_mm_chunked_block", fastcall<bind_mm_chunked_block>(),
     METH_FASTCALL,
     "bind_mm_chunked_block(block_complex, block_real): mm_clock.cu's block "
     "entries of the chunked M&M."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "kernels_host",
                       "The compiled host paths of the kernel wrappers.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_kernels_host() { return PyModule_Create(&kModule); }
