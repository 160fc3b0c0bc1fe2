"""Builds the port's CUDA kernels from the sources in this checkout.

Each `csrc/*.cu` file has a plain C interface. At first use every source
is compiled by its own `nvcc` process, all started together, into a shared
library under `build/gaitlab_torch_ext/` (listed in .gitignore), named by
the hash of the source so that an edited kernel is rebuilt; the libraries
are then loaded with ctypes. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
SRC_DIR = osp.join(_PKG_DIR, "csrc")
BUILD_DIR = osp.join(osp.dirname(_PKG_DIR), "build", "gaitlab_torch_ext")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of each library's launch function (pointers and the stream as
# c_void_p, so ctypes never cuts them to 32 bits)
SIGNATURES = {
    "blendshapes": ("gaitlab_blendshapes",
                    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "keypoint_attention": ("gaitlab_keypoint_attention",
                           (_P, _L, _L, _L, _I, _P, _L, _L, _L, _I,
                            _P, _L, _L, _L, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P)),
}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the gaitlab_torch kernels")
    return osp.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> tuple[str, str]:
    src = osp.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:12]
    return src, osp.join(BUILD_DIR, f"{name}-{tag}.so")


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel that is not built yet (one nvcc each, in
    parallel) and load all of them. Returns {name: ctypes.CDLL}. With
    `verbose`, prints ptxas's register and shared-memory report."""
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = []
        for name in SIGNATURES:
            src, so = _target(name)
            if osp.isfile(so) and not verbose:
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, src]
            jobs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            if verbose:
                print(f"[nvcc {name}]\n{log}", flush=True)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name, (fn, argtypes) in SIGNATURES.items():
            lib = ctypes.CDLL(_target(name)[1])
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
            lib.gaitlab_cuda_error_string.argtypes = (_I,)
            lib.gaitlab_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    return build_all()[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.gaitlab_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")
