"""Build and bind the CUDA shard kernel of the window-parallel search
(``csrc/sharded_search.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, under ``pindel_tpu_torch/build/``, at first use
(or when the source is newer), and loaded with ctypes.
``shard_partials_cuda`` has the signature and output contract of
``ops/sharded_search.py:shard_partials_ref``; it checks its inputs,
allocates the outputs, chooses how many blocks share a row
(``row_splits``) and whether a block's histograms fit in shared memory,
launches on PyTorch's current stream of the inputs' card and counts its
launches in ``LAUNCHES`` (and per card index in ``LAUNCHES_BY_DEVICE``).
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
# a call of fewer rows splits each row's columns over several blocks, so
# that it launches at least FILL_BLOCKS blocks (eight 256-thread blocks on
# each of the H100's 132 SMs, twice over), each with at least MIN_COLS
# columns of every lane (two passes of its 256 threads, 4 columns each;
# split blocks cost a fill and a last pass besides)
FILL_BLOCKS = 2 * 8 * 132
MIN_COLS = 2048

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
                + [ctypes.c_int] * 11 + [ctypes.c_void_p])
            lib.pt_shard_partials.restype = ctypes.c_int
            lib.pt_shard_smem.argtypes = [ctypes.c_int] * 3
            lib.pt_shard_smem.restype = ctypes.c_size_t
            _LIB = lib
        return _LIB


def check_shape(chrom_len: int, *, nl: int, w_total: int, w_local: int,
                lmax: int, t_levels: int, s_levels: int) -> None:
    """Raise ValueError for a call the kernel does not take: lmax not a
    multiple of 4, a tile longer than the chromosome, positions past int32,
    negative levels, or keys (lane * w_total + column) reaching 2^30.
    Levels are int32 and take any budget; shared memory sets no limit:
    histograms that do not fit go to device memory."""
    if lmax % 4:
        raise ValueError(f"lmax {lmax} is not a multiple of 4 (the kernel "
                         "reads the queries a word at a time)")
    if chrom_len < w_local + lmax:
        raise ValueError(f"chromosome of {chrom_len} codes is shorter "
                         f"than a tile of {w_local + lmax}")
    if chrom_len >= 1 << 31:
        raise ValueError(f"chromosome of {chrom_len} codes: positions "
                         "past int32")
    if t_levels < 0 or s_levels < 0:
        raise ValueError(f"levels T={t_levels} S={s_levels} below 0")
    if nl * w_total >= 1 << 30:
        raise ValueError(f"keys of {nl} lanes x {w_total} columns reach "
                         "2^30")


def row_splits(rows: int, w_local: int) -> int:
    """Blocks per row: the least power of two that brings the launch to
    FILL_BLOCKS blocks, at most one per MIN_COLS columns."""
    splits = 1
    while (rows * splits < FILL_BLOCKS
           and w_local // (2 * splits) >= MIN_COLS):
        splits *= 2
    return splits


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
    check_shape(chrom.shape[0], nl=nl, w_total=w_total, w_local=w_local,
                lmax=lmax, t_levels=t_levels, s_levels=s_levels)
    # the kernel reads chrom and qq a 4-byte word at a time
    for name, t in (("chrom", chrom), ("qq", qq)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} does not start on a 4-byte boundary")
    lib = _lib()
    # a block keeps its histograms in shared memory where they fit, else
    # it adds into the output in device memory
    use_smem = lib.pt_shard_smem(lmax, t_levels, s_levels) <= MAX_SMEM
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
            row_splits(b, w_local), int(use_smem), stream)
    if err != 0:
        raise RuntimeError(f"pt_shard_partials launch failed: CUDA error "
                           f"{err} (rows={b} nl={nl} w_local={w_local} "
                           f"lmax={lmax})")
    LAUNCHES += 1
    LAUNCHES_BY_DEVICE[device.index] += 1
    return cnt, key
