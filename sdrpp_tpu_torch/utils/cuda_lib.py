"""Build and load the port's CUDA kernels (csrc/*.cu) as plain C-ABI
shared libraries bound with ctypes, and a kernel's compiled host path
(csrc/*.cpp) as a Python extension module.

Each source is compiled with nvcc for sm_90a at first use into
``sdrpp_tpu_torch/_build/`` (named by a hash of the source and the flags,
so an edited source is rebuilt), and nvcc's output, including the
``-Xptxas -v`` register and spill report, is kept beside the library as
a ``.log``. A failed build raises; nothing runs without its kernel.

``bind`` returns a C entry with its ``restype`` and ``argtypes`` set once,
and ``launch`` calls it on the current CUDA stream of a tensor's device,
entering that device's context only when it is not the current one: the
host path of a kernel wrapper is a few attribute reads and the ctypes
call. ``load_host`` builds csrc/<name>.cpp with the host C++ compiler
against this torch's headers and libraries (its log kept beside it too)
and imports it: csrc/kernels_host.cpp, one module for every wrapper whose
host path costs more than its kernel (decimating_fir, the loop scans),
checks, allocates and launches in one C++ call. A build's hash covers its
source and the csrc/ headers.

The engine, builder and preheater threads of ``misc.webui`` may reach a
kernel's first use together: one module lock serialises ``build``,
``build_host``, ``load`` and ``load_host``, so each library is compiled
once and loaded once a process, and a temporary build file is named by
process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "bind", "build", "build_host", "launch", "load",
           "load_host"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict = {}   # name -> ctypes.CDLL or extension module
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.RLock()  # builds and loads, across threads


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ((cuda_home and str(Path(cuda_home) / "bin" / "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(src: Path, lib: Path, command, tool: str) -> Path:
    """Run ``command(out)``, the command line that writes the library to
    ``out``, unless ``lib`` exists; keeps the tool's output as ``lib``'s
    .log and raises if the tool fails."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(
        f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(command(tmp), capture_output=True, text=True,
                          timeout=900)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _source_bytes(src: Path) -> bytes:
    """A source and the csrc/ headers it may include, for a build's hash."""
    return src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(CSRC.glob("*.h")))


def build(name: str) -> Path:
    """Compile csrc/<name>.cu to _build/lib<name>-<hash>.so unless it is
    already built; returns the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(_source_bytes(src)
                            + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    with _lock:
        return _compile(src, lib, lambda out: [_nvcc(), *NVCC_FLAGS, "-o",
                                               str(out), str(src)], "nvcc")


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib


def build_host(name: str, cuda: bool = True) -> Path:
    """Compile csrc/<name>.cpp, the kernels' compiled host paths, into a
    Python extension module _build/<name>-<hash>.so against this torch's
    headers and libraries (the hash covers the sources, the command line,
    the torch and the Python version) unless it is already built. With
    ``cuda`` it is built to launch (KERNELS_HOST_CUDA, the CUDA headers
    next to nvcc, c10_cuda); without, against any torch, it makes the same
    argument checks and launches nothing (the CPU tests hold its checks
    against the Python ones)."""
    src = CSRC / f"{name}.cpp"
    torch_dir = Path(torch.__file__).resolve().parent
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    with_cuda = []
    if cuda:
        cuda_inc = Path(_nvcc()).resolve().parent.parent / "include"
        with_cuda = ["-DKERNELS_HOST_CUDA", "-isystem", str(cuda_inc)]

    def command(out):
        return [cxx, "-O2", "-std=c++20", "-shared", "-fPIC",
                f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
                "-isystem", str(torch_dir / "include"),
                "-isystem", str(torch_dir / "include" / "torch" / "csrc"
                                / "api" / "include"),
                "-isystem", sysconfig.get_paths()["include"], *with_cuda,
                str(src), "-o", str(out),
                f"-L{torch_dir / 'lib'}", f"-Wl,-rpath,{torch_dir / 'lib'}",
                "-lc10", *(["-lc10_cuda"] if cuda else []), "-ltorch_cpu",
                "-ltorch_python"]

    key = command("") + [torch.__version__, sys.version]
    digest = hashlib.sha256(_source_bytes(src) + " ".join(key).encode())
    lib = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    with _lock:
        return _compile(src, lib, command, "the host compiler")


def load_host(name: str, cuda: bool = True):
    """The Python module built from csrc/<name>.cpp (``build_host``), built
    on first use."""
    key = f"{name}.cpp" if cuda else f"{name}.cpp:cpu"
    with _lock:
        mod = _loaded.get(key)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                name, build_host(name, cuda))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[key] = mod
        return mod


def bind(name: str, entry: str, argtypes, restype=ctypes.c_int):
    """The C function ``entry`` of csrc/<name>.cu (built and loaded on
    first use) with its result and argument types set, once."""
    fn = _bound.get((name, entry))
    if fn is None:
        with _lock:
            fn = _bound.get((name, entry))
            if fn is None:
                fn = getattr(load(name), entry)
                fn.restype = restype
                fn.argtypes = list(argtypes)
                _bound[(name, entry)] = fn
    return fn


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current CUDA stream, in that
    device's context; returns the entry's result (its cudaGetLastError).
    The device index and the raw stream handle come from the calls torch's
    own kernel launchers use, without building a ``torch.cuda.Stream``
    (a launch happens after CUDA is initialised: its tensors are on the
    card)."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)
