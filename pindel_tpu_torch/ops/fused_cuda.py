"""Build and bind the fused search kernels (``csrc/fused_search.cu``).

``pt_close`` computes ``engine_fused._close_kernel_ref`` (K2), ``pt_far``
``engine_fused._far_kernel_ref`` (K3) and ``pt_far_win``
``engine_fused._far_win_kernel_ref`` (K4), bit for bit, each in one launch
on CUDA tensors: the tiles are read straight from the chromosome layout, the
scan (K1's walk, ``csrc/scan_walk.cuh``) and the emission rules run in the
block, and only the packed output row of each read reaches device memory.
The library is compiled with ``nvcc`` for ``sm_90a`` under
``pindel_tpu_torch/build/`` at first use (or when a source is newer), as
``scan_cuda.compile_library`` builds the scan, and loaded with ctypes.  Each
wrapper checks its inputs, allocates its output, launches on PyTorch's
current stream and counts its launches in ``LAUNCHES`` (per card index in
``LAUNCHES_BY_DEVICE``, per kernel, ``close``, ``far`` or ``far_win``, in
``LAUNCHES_BY_KERNEL``); a failed build or launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

from pindel_tpu_torch.config import MAX_READ_LENGTH
from pindel_tpu_torch.genome import SPACER
from pindel_tpu_torch.ops import scan_cuda
from pindel_tpu_torch.ops.scan import dead_level, key_shift

SOURCE = os.path.join(os.path.dirname(scan_cuda.SOURCE), "fused_search.cu")
LIBRARY = os.path.join(scan_cuda.BUILD_DIR, "libpt_fused.so")
MAX_ROUNDS = 16          # far rounds a launch takes (kMaxRounds)
CLOSE_WORDS = 3          # meta words of a close payload row (CM_WORDS)
FAR_WORDS = 4            # meta words of a far payload row (FM_WORDS)
FAR_WIN_WORDS = 4        # meta words of a far_win payload row (FW_WORDS)

LAUNCHES = 0        # kernel launches since import (or the last reset)
LAUNCHES_BY_DEVICE = collections.Counter()   # the same, per card index
LAUNCHES_BY_KERNEL = collections.Counter()   # close, far, far_win

_LOCK = threading.Lock()
_LIB = None
_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile the fused kernels (``scan_cuda.compile_library``)."""
    return scan_cuda.compile_library(SOURCE, LIBRARY, force, ptxas_info)


def load(path: str) -> ctypes.CDLL:
    """A built fused library with its entry points' signatures bound."""
    lib = ctypes.CDLL(path)
    lib.pt_close.argtypes = ([_PTR, _INT, _PTR, _PTR, _PTR] + [_INT] * 12
                             + [_PTR])
    lib.pt_close.restype = _INT
    lib.pt_far.argtypes = ([_PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT]
                           + [_PTR] * 3 + [_INT] * 6 + [_PTR])
    lib.pt_far.restype = _INT
    lib.pt_far_win.argtypes = ([_PTR, _INT, _PTR, _PTR, _PTR] + [_INT] * 9
                               + [_PTR])
    lib.pt_far_win.restype = _INT
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            _LIB = load(LIBRARY)
        return _LIB


def _common(chromcat, payload, maxmm, row_bytes: int, lmax: int,
            lsteps: int, device):
    """Check the inputs both kernels take; returns (reads, lsteps)."""
    lsteps = lsteps or lmax
    if lmax <= 0 or lmax % 32:
        raise ValueError(f"lmax {lmax} is not a positive multiple of 32")
    if not 1 <= lsteps <= lmax:
        raise ValueError(f"lsteps {lsteps} outside [1, {lmax}]")
    if chromcat.dim() != 2 or chromcat.shape[0] % 2 or not chromcat.shape[0]:
        raise ValueError(f"chromcat must be [2 * NR, 128], got "
                         f"{tuple(chromcat.shape)}")
    scan_cuda.check_tensor("chromcat", chromcat, torch.int8,
                           (chromcat.shape[0], 128), device)
    if chromcat.data_ptr() % 16:
        raise ValueError("chromcat is not 16-byte aligned")
    reads = payload.shape[0] if payload.dim() == 2 else -1
    scan_cuda.check_tensor("payload", payload, torch.int8,
                           (reads, row_bytes), device)
    if payload.data_ptr() % 4:
        raise ValueError("payload is not 4-byte aligned")
    if maxmm.dim() != 1 or maxmm.numel() <= min(lmax, MAX_READ_LENGTH - 1):
        raise ValueError(f"maxmm must be 1-D with more than "
                         f"{min(lmax, MAX_READ_LENGTH - 1)} entries, got "
                         f"{tuple(maxmm.shape)}")
    scan_cuda.check_tensor("maxmm", maxmm, torch.int32, (maxmm.numel(),),
                           device)
    return reads, lsteps


def _shift(w: int, lmax: int) -> int:
    """The packed key's shift at window bucket w; raises where the key
    would overflow int32 (as ``scan_rows_cuda`` does)."""
    shift = key_shift(w)
    if ((dead_level(lmax) + lmax) << shift) + (1 << shift) >= 2 ** 31:
        raise ValueError(f"packed key overflows int32 at w={w} lmax={lmax}")
    return shift


def close_args(chromcat, payload, maxmm, device, *, w0: int, w1: int,
               lmax: int, mpm: int, bp_start: int, lsteps: int = 0,
               with_r1: bool = True):
    """The output tensor and the C arguments of ``pt_close`` (all but the
    stream), after the checks."""
    reads, lsteps = _common(chromcat, payload, maxmm,
                            lmax + 4 * CLOSE_WORDS, lmax, lsteps, device)
    out = torch.empty((reads, lmax // 32 + 2), dtype=torch.int32,
                      device=device)
    args = (chromcat.data_ptr(), chromcat.shape[0], payload.data_ptr(),
            maxmm.data_ptr(), out.data_ptr(), reads, w0, w1,
            _shift(w0, lmax), _shift(w1, lmax) if with_r1 else 0,
            int(bool(with_r1)), lmax, lsteps, mpm, bp_start,
            dead_level(lmax), MAX_READ_LENGTH - 1)
    return out, args


def far_args(chromcat, payload, maxmm, device, *, spans, ws, lmax: int,
             mpm: int, bp_start: int, lsteps: int = 0):
    """The output tensor and the C arguments of ``pt_far`` (all but the
    stream; the round arrays as ctypes arrays), after the checks."""
    reads, lsteps = _common(chromcat, payload, maxmm,
                            lmax // 2 + 4 * FAR_WORDS, lmax, lsteps, device)
    if len(spans) != len(ws) or len(spans) > MAX_ROUNDS:
        raise ValueError(f"{len(spans)} spans and {len(ws)} windows: "
                         f"equal counts of at most {MAX_ROUNDS} needed")
    rounds = len(spans)
    arr = _INT * max(rounds, 1)
    out = torch.empty((reads, lmax // 32 + 2), dtype=torch.int32,
                      device=device)
    args = (chromcat.data_ptr(), chromcat.shape[0], payload.data_ptr(),
            maxmm.data_ptr(), out.data_ptr(), reads, rounds,
            arr(*spans), arr(*ws), arr(*(_shift(w, lmax) for w in ws)),
            lmax, lsteps, mpm, bp_start, dead_level(lmax),
            MAX_READ_LENGTH - 1)
    return out, args


def far_win_args(chromcat, payload, maxmm, device, *, w: int, lmax: int,
                 mpm: int, bp_start: int, lsteps: int = 0):
    """The output tensor and the C arguments of ``pt_far_win`` (all but the
    stream), after the checks; a tile of ``w + lmax`` must fit in the
    spacer, as the backend sends it."""
    reads, lsteps = _common(chromcat, payload, maxmm,
                            lmax // 2 + 4 * FAR_WIN_WORDS, lmax, lsteps,
                            device)
    if w <= 0 or w + lmax > SPACER:
        raise ValueError(f"window bucket {w} with lmax {lmax} outgrows the "
                         f"spacer ({SPACER})")
    out = torch.empty((reads, lmax // 32 + 2), dtype=torch.int32,
                      device=device)
    args = (chromcat.data_ptr(), chromcat.shape[0], payload.data_ptr(),
            maxmm.data_ptr(), out.data_ptr(), reads, w, _shift(w, lmax),
            lmax, lsteps, mpm, bp_start, dead_level(lmax),
            MAX_READ_LENGTH - 1)
    return out, args


def _card(payload) -> torch.device:
    device = payload.device
    if device.type != "cuda":
        raise ValueError(f"the fused kernels need CUDA tensors, got {device}")
    return device


def _launch(entry: str, device, out, args):
    global LAUNCHES
    if out.shape[0] == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"(reads={out.shape[0]})")
    LAUNCHES += 1
    LAUNCHES_BY_DEVICE[device.index] += 1
    LAUNCHES_BY_KERNEL[entry[len("pt_"):]] += 1
    return out


def pt_close(chromcat, payload, maxmm, *, w0: int, w1: int, lmax: int,
             mpm: int, bp_start: int, lsteps: int = 0,
             with_r1: bool = True):
    """K2 on the card: the contract of ``_close_kernel_ref``."""
    device = _card(payload)
    out, args = close_args(chromcat, payload, maxmm, device, w0=w0, w1=w1,
                           lmax=lmax, mpm=mpm, bp_start=bp_start,
                           lsteps=lsteps, with_r1=with_r1)
    return _launch("pt_close", device, out, args)


def pt_far(chromcat, payload, maxmm, *, spans, ws, lmax: int, mpm: int,
           bp_start: int, lsteps: int = 0):
    """K3 on the card: the contract of ``_far_kernel_ref``."""
    device = _card(payload)
    out, args = far_args(chromcat, payload, maxmm, device, spans=spans,
                         ws=ws, lmax=lmax, mpm=mpm, bp_start=bp_start,
                         lsteps=lsteps)
    return _launch("pt_far", device, out, args)


def pt_far_win(chromcat, payload, maxmm, *, w: int, lmax: int, mpm: int,
               bp_start: int, lsteps: int = 0):
    """K4 on the card: the contract of ``_far_win_kernel_ref``."""
    device = _card(payload)
    out, args = far_win_args(chromcat, payload, maxmm, device, w=w,
                             lmax=lmax, mpm=mpm, bp_start=bp_start,
                             lsteps=lsteps)
    return _launch("pt_far_win", device, out, args)


def search_launches() -> int:
    """Launches of the fused path's kernels: the scan's and these."""
    return scan_cuda.LAUNCHES + LAUNCHES


def search_launches_by_device() -> collections.Counter:
    """The same per card index."""
    return scan_cuda.LAUNCHES_BY_DEVICE + LAUNCHES_BY_DEVICE


def reset_launches() -> None:
    """Set the scan's and these kernels' counts to 0."""
    global LAUNCHES
    scan_cuda.LAUNCHES = 0
    scan_cuda.LAUNCHES_BY_DEVICE.clear()
    LAUNCHES = 0
    LAUNCHES_BY_DEVICE.clear()
    LAUNCHES_BY_KERNEL.clear()
