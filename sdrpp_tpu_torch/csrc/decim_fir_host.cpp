// The host path of decimating_fir as one compiled call: the argument
// checks, the two output allocations and the launch on the current stream
// of x's device. At the receive and meteor shapes the kernel takes about
// as long on the device as the host takes to launch it, so a Python
// wrapper's checks, allocations and ctypes call decided the time of a
// call there, and lost to the strided conv1d's C++ dispatch.
//
//   decim_fir(tail, x, taps, r) -> (new_tail, y)
//       tail [..., m-1], x [..., n] complex64 or float32 on one CUDA
//       device, taps [m] float32, r >= 1 dividing n; raises ValueError on
//       any other argument and RuntimeError when the launch fails.
//   bind(c64_entry, f32_entry)
//       the addresses of decim_fir.cu's C entries decim_fir_c64 and
//       decim_fir_f32, which launch the kernel.
//
// Built with the host C++ compiler against torch's headers and libraries
// by utils/cuda_lib.py (build_host) and imported as a Python module; the
// kernel itself stays in decim_fir.cu.

#include <torch/csrc/Exceptions.h>
#include <torch/csrc/autograd/python_variable.h>

#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <climits>
#include <string>
#include <vector>

namespace {

using Entry = int (*)(const void* tail, const void* x, const float* taps,
                      void* new_tail, void* y, long long rows, long long n,
                      int m, int r, void* stream);

Entry g_c64 = nullptr;
Entry g_f32 = nullptr;

PyObject* value_error(const std::string& msg) {
  PyErr_SetString(PyExc_ValueError, msg.c_str());
  return nullptr;
}

std::string shape_str(c10::IntArrayRef s) {
  std::string out = "[";
  for (size_t i = 0; i < s.size(); ++i)
    out += (i ? ", " : "") + std::to_string(s[i]);
  return out + "]";
}

const char* dtype_name(c10::ScalarType t) {
  switch (t) {
    case c10::kComplexFloat: return "torch.complex64";
    case c10::kFloat: return "torch.float32";
    default: return c10::toString(t);
  }
}

PyObject* decim_fir(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  HANDLE_TH_ERRORS
  if (nargs != 4 || !THPVariable_Check(args[0]) ||
      !THPVariable_Check(args[1]) || !THPVariable_Check(args[2])) {
    PyErr_SetString(PyExc_TypeError,
                    "decim_fir(tail, x, taps, r) takes three tensors and an "
                    "int");
    return nullptr;
  }
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
    return value_error(std::string("tail must be ") + dtype_name(dtype) +
                       " " + shape_str(want) + ", got " +
                       dtype_name(tail.scalar_type()) + " " + shape_str(ts));
  }
  if (tail.device() != x.device() || taps.device() != x.device())
    return value_error("decimating_fir takes tensors on one device");
  const int64_t n = xs[nd - 1];
  if (r < 1 || n % r)
    return value_error("block length " + std::to_string(n) +
                       " must be a multiple of decimation " +
                       std::to_string(r));
  if (!x.is_cuda())
    return value_error("the compiled decimating_fir takes CUDA tensors");
  if (n < 1) return value_error("decimating_fir takes a non-empty block");
  if (m > INT_MAX || r > INT_MAX)
    return value_error("taps and decimation must fit an int");

  const at::Tensor tc = tail.is_contiguous() ? tail : tail.contiguous();
  const at::Tensor xc = x.is_contiguous() ? x : x.contiguous();
  const at::Tensor wc = taps.is_contiguous() ? taps : taps.contiguous();
  std::vector<int64_t> ysize(xs.begin(), xs.end());
  ysize.back() = n / r;
  at::Tensor y = at::empty(ysize, x.options());
  at::Tensor new_tail = at::empty(ts, tail.options());
  const long long rows = x.numel() / n;

  const Entry fn = c64 ? g_c64 : g_f32;
  if (fn == nullptr) {
    PyErr_SetString(PyExc_RuntimeError,
                    "decim_fir: the kernel entries are not bound");
    return nullptr;
  }
  const c10::cuda::CUDAGuard guard(x.device());
  cudaStream_t stream =
      c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  const int rc = fn(tc.data_ptr(), xc.data_ptr(), wc.data_ptr<float>(),
                    new_tail.data_ptr(), y.data_ptr(), rows, n,
                    static_cast<int>(m), static_cast<int>(r), stream);
  if (rc != 0) {
    PyErr_Format(PyExc_RuntimeError,
                 "decimating_fir launch failed: CUDA error %d at rows=%lld, "
                 "n=%lld, m=%lld, r=%lld", rc, rows,
                 static_cast<long long>(n), static_cast<long long>(m), r);
    return nullptr;
  }
  PyObject* out = PyTuple_New(2);
  if (out == nullptr) return nullptr;
  PyObject* a = THPVariable_Wrap(std::move(new_tail));
  PyObject* b = a ? THPVariable_Wrap(std::move(y)) : nullptr;
  if (b == nullptr) {
    Py_XDECREF(a);
    Py_DECREF(out);
    return nullptr;
  }
  PyTuple_SET_ITEM(out, 0, a);
  PyTuple_SET_ITEM(out, 1, b);
  return out;
  END_HANDLE_TH_ERRORS
}

PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "bind(c64_entry, f32_entry)");
    return nullptr;
  }
  void* c64 = PyLong_AsVoidPtr(args[0]);
  void* f32 = PyLong_AsVoidPtr(args[1]);
  if (PyErr_Occurred()) return nullptr;
  if (c64 == nullptr || f32 == nullptr) {
    PyErr_SetString(PyExc_ValueError, "bind: a null entry");
    return nullptr;
  }
  g_c64 = reinterpret_cast<Entry>(c64);
  g_f32 = reinterpret_cast<Entry>(f32);
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"decim_fir", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(
                      decim_fir)),
     METH_FASTCALL,
     "decim_fir(tail, x, taps, r) -> (new_tail, y): check, allocate and "
     "launch decimating_fir's kernel on x's current stream."},
    {"bind", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(
                 bind)),
     METH_FASTCALL,
     "bind(c64_entry, f32_entry): the kernel library's C entries."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "decim_fir_host",
                       "decimating_fir's compiled host path.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_decim_fir_host() { return PyModule_Create(&kModule); }
