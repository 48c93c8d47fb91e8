"""Builds and loads the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``ops/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` (Hopper) by ``torch.utils.cpp_extension.load`` into one shared
library under ``build/torch_kernels/`` beside the package (a directory git
ignores), at the first call of :func:`kernel_library` in a process.
``load`` caches by content, so a second process reuses the build.

The sources include no PyTorch header: each kernel is exported as a plain
C function that takes device pointers, shapes, a device index and a CUDA
stream, and returns the ``cudaError_t`` of its launch.  That keeps the
build to seconds (PyTorch's headers cost minutes of ``nvcc`` time); the
library is called through ``ctypes``.  A build failure raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_kernels")
LIBRARY_NAME = "yolov3_torch_kernels"
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xptxas=-v",
              "-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported C function -> argument types (pointers, ints, device, stream)
_SIGNATURES = {
    "yolo_bn_pool_relu_eval": [_P] * 4 + [_I] * 9 + [_P],
    "yolo_bn_pool_relu_fwd": [_P] * 5 + [_I] * 9 + [_P],
    "yolo_bn_pool_relu_bwd": [_P] * 8 + [_I] * 9 + [_P],
    "yolo_max_pool_s2_eval": [_P] * 2 + [_I] * 9 + [_P],
    "yolo_max_pool_s2_fwd": [_P] * 3 + [_I] * 9 + [_P],
    "yolo_max_pool_s2_bwd": [_P] * 3 + [_I] * 9 + [_P],
    "yolo_noisy_normalize": [_P] * 5 + [_I] * 4 + [_P],
    "yolo_winograd_f2x3": [_P] * 14 + [_I] * 13 + [_P],
}


@functools.lru_cache(maxsize=None)
def kernel_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (or reuse) and load the kernel library; ``verbose`` prints
    the compiler's output, ptxas register and spill counts included."""
    from torch.utils.cpp_extension import load

    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = load(name=LIBRARY_NAME, sources=sources,
                build_directory=BUILD_DIR, extra_cuda_cflags=NVCC_FLAGS,
                is_python_module=False, verbose=verbose)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise on a refused or failed launch (the C wrappers return
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.yolo_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"{msg} (cudaError {err})")
