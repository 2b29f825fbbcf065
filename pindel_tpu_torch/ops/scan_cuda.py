"""Build and bind the CUDA scan kernel (``csrc/scan.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, under ``pindel_tpu_torch/build/``, at first use
(or when the source is newer), and loaded with ctypes.  ``scan_rows_cuda``
has the signature and output contract of ``pallas_scan_rows``; it checks
its inputs, allocates the outputs, launches on PyTorch's current stream and
counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from pindel_tpu_torch.ops.scan import dead_level, key_shift

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "scan.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libpt_scan.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = 0        # kernel launches since import (or the last reset)

_LOCK = threading.Lock()
_LIB = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile the kernel unless the library is newer than its source.
    Returns nvcc's diagnostics (with ``ptxas_info``, the registers, shared
    memory and spills of every instantiation); raises if nvcc fails."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
           "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return res.stderr


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            lib.pt_scan_rows.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 9
                                         + [ctypes.c_void_p])
            lib.pt_scan_rows.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check(name, x, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def scan_rows_cuda(tiles, qq, valid_w, qlen, thr, off=None,
                   *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """CUDA scan: the contract of ``scan_rows_ref`` on CUDA tensors."""
    global LAUNCHES
    lsteps = lsteps or lmax
    device = tiles.device
    if device.type != "cuda":
        raise ValueError(f"scan_rows_cuda needs CUDA tensors, got {device}")
    if tiles.dim() != 2:
        raise ValueError(f"tiles must be [R, T], got {tuple(tiles.shape)}")
    r, t = tiles.shape
    we = t - lmax
    if we < w:
        raise ValueError(f"tile width {t} < w + lmax = {w + lmax}")
    if not 1 <= lsteps <= lmax:
        raise ValueError(f"lsteps {lsteps} outside [1, {lmax}]")
    if off is None:
        if we != w:
            raise ValueError("off omitted: tiles must be exactly w + lmax")
        off = torch.zeros((r,), dtype=torch.int32, device=device)
    _check("tiles", tiles, torch.int8, (r, t), device)
    _check("qq", qq, torch.int8, (r, lmax), device)
    for name, x in (("valid_w", valid_w), ("qlen", qlen), ("thr", thr),
                    ("off", off)):
        _check(name, x, torch.int32, (r,), device)
    shift = key_shift(w)
    dead = dead_level(lmax)
    if ((dead + lmax) << shift) + (1 << shift) >= 2 ** 31:
        raise ValueError(f"packed key overflows int32 at w={w} lmax={lmax}")
    kmin = torch.empty((r, lmax), dtype=torch.int32, device=device)
    k2 = torch.empty((r, lmax), dtype=torch.int32, device=device)
    if r == 0:
        return kmin, k2
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_scan_rows(
            tiles.data_ptr(), qq.data_ptr(), valid_w.data_ptr(),
            qlen.data_ptr(), thr.data_ptr(), off.data_ptr(),
            kmin.data_ptr(), k2.data_ptr(),
            r, t, we, w, lmax, lsteps, mpm, shift, dead, stream)
    if err != 0:
        raise RuntimeError(f"pt_scan_rows launch failed: CUDA error {err} "
                           f"(rows={r} t={t} w={w} lmax={lmax})")
    LAUNCHES += 1
    return kmin, k2
