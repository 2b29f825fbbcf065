"""Multi-GPU fused search: data-parallel over a list of torch devices (port
of pindel_tpu/parallel/mesh_fused.py).

The JAX backend wraps ``_close_kernel``, ``_far_kernel`` and
``_far_win_kernel`` in ``shard_map`` over the ``dp`` axis of a mesh: the
payload rows are sharded, the chromosome and the mismatch table
replicated, and nothing crosses devices, because every read is searched on
its own (the reductions of the pipeline run on the host after the packed
per-read download).  Here the three dispatch points of
``TorchFusedBackend`` split the host payload into one contiguous slice of
rows per device, upload each slice straight to its device, launch the
kernel on every slice (each reaching the scan on that device, on its
current stream) before any download, and merge the outputs in row order on
the host.  A device listed twice holds one replica and runs its slices one
after the other, which is how the split and merge run on one card; on CPU
devices each slice takes the plain scan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from pindel_tpu_torch.ops import engine_fused as ef


def make_device_list(n: Optional[int] = None) -> List[torch.device]:
    """The first ``n`` visible CUDA cards (all of them by default), as
    ``make_dp_mesh`` takes the first n JAX devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh backend over CUDA cards needs "
                           "torch.cuda.is_available()")
    count = torch.cuda.device_count()
    n = n or count
    if not 1 <= n <= count:
        raise ValueError(f"{n} cards requested, {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def normalize(device) -> torch.device:
    """``device`` as a torch device, bare ``cuda`` as the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Merged:
    """The shards' outputs on their way to host memory; ``get`` waits for
    each and concatenates them in row order."""

    def __init__(self, parts: Sequence[ef._Download]):
        self._parts = parts

    def get(self) -> np.ndarray:
        return np.concatenate([p.get() for p in self._parts])


class TorchMeshBackend(ef.TorchFusedBackend):
    """TorchFusedBackend whose kernels run data-parallel over ``devices``.

    The legacy per-lane path (``run`` on lanes the explicit-window kernel
    does not take) stays on the first device, as the JAX backend's stays on
    the default device."""

    def __init__(self, settings, maxmm, chrom_codes, devices: Sequence,
                 chrom_name: str = None):
        devices = [normalize(d) for d in devices]
        if not devices:
            raise ValueError("the mesh backend needs at least one device")
        super().__init__(settings, maxmm, chrom_codes,
                         chrom_name=chrom_name, device=devices[0])
        self.devices = devices
        self.dp = len(devices)
        # chromosome, its tile layout and maxmm: one replica per distinct
        # device
        self.states = {self.device: self.state}
        for dev in devices:
            if dev not in self.states:
                self.states[dev] = ef.device_state_from_numpy(
                    self.chrom_codes, self.maxmm, dev)

    def _launch(self, kernel, payload: np.ndarray, static) -> _Merged:
        if payload.shape[0] % self.dp:
            raise ValueError(f"{payload.shape[0]} payload rows do not "
                             f"split over {self.dp} devices")
        rows = payload.shape[0] // self.dp
        ef.fused_cuda.count_upload(payload.nbytes)
        with torch.inference_mode():
            shards = [torch.from_numpy(payload[k * rows:(k + 1) * rows])
                      .to(dev) for k, dev in enumerate(self.devices)]
            outs = [kernel(self.states[dev].chromcat, shard,
                           self.states[dev].maxmm, **static)
                    for dev, shard in zip(self.devices, shards)]
            return _Merged([ef._Download(out) for out in outs])
