"""Build and bind the CUDA shard kernel of the window-parallel search
(``csrc/sharded_search.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, under ``pindel_tpu_torch/build/``, at first use
(or when the source is newer), and loaded with ctypes.
``shard_partials_cuda`` has the signature and output contract of
``ops/sharded_search.py:shard_partials_ref``; it checks its inputs,
allocates the outputs, launches on PyTorch's current stream of the inputs'
card and counts its launches in ``LAUNCHES`` (and per card index in
``LAUNCHES_BY_DEVICE``).
"""
from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

from pindel_tpu_torch.ops.scan_cuda import check_tensor, compile_library

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sharded_search.cu")
LIBRARY = os.path.join(_PKG, "build", "libpt_sharded.so")
MAX_SMEM = 227 * 1024       # dynamic shared memory a block may take (H100)

LAUNCHES = 0        # kernel launches since import (or the last reset)
LAUNCHES_BY_DEVICE = collections.Counter()   # the same, per card index

_LOCK = threading.Lock()
_LIB = None


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile the shard kernel (``scan_cuda.compile_library``)."""
    return compile_library(SOURCE, LIBRARY, force, ptxas_info)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            lib.pt_shard_partials.argtypes = (
                [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            lib.pt_shard_partials.restype = ctypes.c_int
            lib.pt_shard_smem.argtypes = [ctypes.c_int] * 4
            lib.pt_shard_smem.restype = ctypes.c_size_t
            _LIB = lib
        return _LIB


def shard_partials_cuda(chrom, slice_start, reverse, qq, valid_w, max_snp,
                        tsec_minus, *, off: int, w_total: int, w_local: int,
                        lmax: int, nl: int, mpm: int, t_levels: int,
                        s_levels: int):
    """CUDA shard kernel: the contract of ``shard_partials_ref`` on CUDA
    tensors."""
    global LAUNCHES
    device = chrom.device
    if device.type != "cuda":
        raise ValueError(f"shard_partials_cuda needs CUDA tensors, got "
                         f"{device}")
    b = qq.shape[0]
    check_tensor("chrom", chrom, torch.int8, (chrom.shape[0],), device)
    check_tensor("slice_start", slice_start, torch.int32, (b, nl), device)
    check_tensor("reverse", reverse, torch.bool, (b, nl), device)
    check_tensor("qq", qq, torch.int8, (b, nl, lmax), device)
    check_tensor("valid_w", valid_w, torch.int32, (b, nl), device)
    check_tensor("max_snp", max_snp, torch.int32, (b,), device)
    check_tensor("tsec_minus", tsec_minus, torch.int32, (b,), device)
    if chrom.shape[0] < w_local + lmax:
        raise ValueError(f"chromosome of {chrom.shape[0]} codes is shorter "
                         f"than a tile of {w_local + lmax}")
    if not 0 <= t_levels < 127 or not 0 <= s_levels < 127:
        raise ValueError(f"levels T={t_levels} S={s_levels} outside "
                         "[0, DEAD)")
    if nl * w_total >= 1 << 30:
        raise ValueError(f"keys of {nl} lanes x {w_total} columns reach "
                         "2^30")
    lib = _lib()
    smem = lib.pt_shard_smem(lmax, nl, t_levels, s_levels)
    if smem > MAX_SMEM:
        raise ValueError(f"shard kernel needs {smem} bytes of shared "
                         f"memory at lmax={lmax} nl={nl} T={t_levels} "
                         f"S={s_levels}, above {MAX_SMEM}")
    cnt = torch.empty((b, lmax, t_levels + 2), dtype=torch.int32,
                      device=device)
    key = torch.empty((b, lmax, s_levels + 2), dtype=torch.int32,
                      device=device)
    if b == 0:
        return cnt, key
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pt_shard_partials(
            chrom.data_ptr(), chrom.shape[0], slice_start.data_ptr(),
            reverse.data_ptr(), qq.data_ptr(), valid_w.data_ptr(),
            tsec_minus.data_ptr(), cnt.data_ptr(), key.data_ptr(),
            b, nl, w_total, w_local, off, lmax, mpm, t_levels, s_levels,
            stream)
    if err != 0:
        raise RuntimeError(f"pt_shard_partials launch failed: CUDA error "
                           f"{err} (rows={b} nl={nl} w_local={w_local} "
                           f"lmax={lmax})")
    LAUNCHES += 1
    LAUNCHES_BY_DEVICE[device.index] += 1
    return cnt, key
