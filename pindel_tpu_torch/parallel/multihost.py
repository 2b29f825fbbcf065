"""Multi-process execution: windows sharded across processes, each rank
searching on its own devices (port of pindel_tpu/parallel/multihost.py).

``run_files_multihost`` runs in the calling process as rank 0, the
coordinator, and spawns ranks 1..N-1 as fresh interpreters (``python -m
pindel_tpu_torch.parallel.multihost cfg``), never as forks of a process
whose CUDA may be up.  Every rank runs the whole window loop of
``Pipeline.run`` over the same input:

* window w belongs to rank ``w % N``; only its owner searches it (close
  and far ends, on the devices ``rank_devices`` gives the rank) and, with
  BAM input, runs its read-pair discovery and RP->BD evidence update;
* a worker ships each window it owns to the coordinator: the searched
  reads with their anchor sets, plus the window's BD evidence delta and
  _RP text (parallel/payload.py), through a spool directory (``files``)
  or a TCPStore the coordinator serves (``store``, parallel/distspool.py).
  It does nothing for its peers' windows: BD evidence state is per window
  (``BDData.update_bd`` starts each window from the external events);
* the coordinator loads each worker window in window order, applies its
  evidence delta and writes its _RP text, and runs detection and
  reporting for every window, so the sequential report state never leaves
  one process and the reports are byte-identical to a one-process run.

The coordinator builds the search kernels and the native libraries before it
spawns, so N processes do not compile at once.  While it waits for a
window it watches its workers, and it raises as soon as one exits
non-zero, or exits without shipping the window; at the end it checks every
worker's exit code.  -S (report only close-mapped reads) is refused: it is
itself the two-phase checkpoint flow, and a worker would report.  Each
rank's record (devices, windows owned, search kernel launches by card and
by kernel, times) lands in ``LAST_RANKS`` after a run.
"""
from __future__ import annotations

import collections
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from pindel_tpu_torch.ops import fused_cuda, scan_cuda
from pindel_tpu_torch.profiling import g_timer

# one record per rank of the last run_files_multihost, rank 0 first
LAST_RANKS: List[dict] = []

DISTS = {"files": "files", "store": "store", "jax": "store"}
POLL_S = 0.02           # the coordinator's wait between looks at a window
WAIT_S = 120.0          # a worker's time to exit after the coordinator ends
# the coordinator's wait for worker windows (inside "Matching close ends")
WAIT_PHASE = "multihost: wait for worker windows"

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class WorkerFailed(RuntimeError):
    """A worker process exited non-zero, or without shipping a window."""

    def __init__(self, rank: int, code: Optional[int], what: str = ""):
        super().__init__(f"worker rank {rank} "
                         + (what or f"exited with code {code}"))
        self.rank = rank
        self.code = code


class Spool:
    """Window ownership (``w % num_hosts == rank``), the windows this rank
    saw and shipped, and, on the coordinator, the watch over its workers
    while it waits for their windows.  Transports subclass it with
    ``dump`` and ``load``."""

    TIMEOUT = 900.0

    def __init__(self, rank: int, num_hosts: int,
                 procs: Optional[Dict[int, subprocess.Popen]] = None):
        self.rank = rank
        self.num_hosts = num_hosts
        self.worker = rank != 0
        self.procs = procs or {}
        self.windows = 0            # windows Pipeline.run has reached
        self.first_dump = None      # time.time() of the first shipped window

    def mine(self, widx: int) -> bool:
        """Whether this rank searches window ``widx``; Pipeline.run asks
        once per window, in order."""
        self.windows = max(self.windows, widx + 1)
        return widx % self.num_hosts == self.rank

    def owned(self) -> List[int]:
        return [w for w in range(self.windows)
                if w % self.num_hosts == self.rank]

    def _shipped(self) -> None:
        if self.first_dump is None:
            self.first_dump = time.time()

    def _wait(self, widx: int, arrived) -> None:
        """Poll ``arrived()`` for worker window ``widx``; raise WorkerFailed
        when a worker has exited non-zero or the window's owner exited
        without shipping it, TimeoutError after TIMEOUT seconds.  The time
        spent goes to the timer phase WAIT_PHASE."""
        owner = widx % self.num_hosts
        t0 = time.monotonic()
        deadline = t0 + self.TIMEOUT
        while not arrived():
            for rank, proc in sorted(self.procs.items()):
                code = proc.poll()
                if code not in (None, 0):
                    raise WorkerFailed(rank, code)
                if code == 0 and rank == owner and not arrived():
                    raise WorkerFailed(rank, code, "exited with code 0 "
                                       f"without shipping window {widx}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"window {widx} never arrived from "
                                   f"worker {owner}")
            time.sleep(POLL_S)
        g_timer.add(WAIT_PHASE, time.monotonic() - t0)


class WindowSpool(Spool):
    """File exchange of searched windows through a shared directory.

    The payload is the packed anchor-table dict (parallel/payload.py)
    written with ``np.savez``: pure arrays, no pickled objects; ``np.load``
    runs with ``allow_pickle=False``."""

    def __init__(self, root: str, rank: int, num_hosts: int,
                 procs: Optional[Dict[int, subprocess.Popen]] = None):
        super().__init__(rank, num_hosts, procs)
        self.root = root

    def _path(self, widx: int) -> str:
        return os.path.join(self.root, f"w{widx:06d}.npz")

    def dump(self, widx: int, kept: List, bd_delta=None,
             rp_text: str = "") -> None:
        import numpy as np

        from pindel_tpu_torch.parallel import payload
        path = self._path(widx)
        tmp = path + f".tmp{self.rank}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload.pack(kept, bd_delta, rp_text))
        os.replace(tmp, path)
        self._shipped()

    def load(self, widx: int):
        """-> (reads, bd event delta, _RP text) for a worker window."""
        import numpy as np

        from pindel_tpu_torch.parallel import payload
        path = self._path(widx)
        self._wait(widx, lambda: os.path.exists(path))
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        os.remove(path)
        return payload.unpack(d), *payload.unpack_bd(d)


def rank_devices(device, backend: str, rank: int,
                 num_hosts: int) -> List[str]:
    """The devices rank ``rank`` of ``num_hosts`` searches on: the first is
    its one-device backend's device, a ``mesh`` backend takes them all.

    ``cpu`` and an indexed card (``cuda:K``) serve every rank, and the
    ``numpy`` backend searches on the host (``cpu``).  Bare ``cuda``
    spreads the ranks over the visible cards: rank r takes card ``r %
    count``, and with ``mesh`` a block of its own of ``n = count //
    num_hosts`` cards (cards ``[r * n, (r + 1) * n)``); with fewer cards
    than ranks it takes its one card ``r % count``.  No visible card
    raises."""
    dev = torch.device(device)
    if backend == "numpy":
        return ["cpu"]
    if dev.type != "cuda" or dev.index is not None:
        return [str(dev)]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"device {device!r} requested but no CUDA card "
                           "is visible")
    if backend == "mesh" and count >= num_hosts:
        n = count // num_hosts
        return [f"cuda:{c}" for c in range(rank * n, (rank + 1) * n)]
    return [f"cuda:{rank % count}"]


def build_libraries(devices) -> None:
    """Build (or load the built) fused search kernels, when a rank runs on a
    card, and the native libraries the window loop loads, so that workers
    only load them.  The standalone scan (``scan_cuda``) is not built: no
    CLI path launches it, K1's walk runs inside the fused kernels."""
    from pindel_tpu_torch import bam, bddata, textindex
    from pindel_tpu_torch.events.detect import _native_detect
    from pindel_tpu_torch.ops import engine_fused
    if any(torch.device(d).type == "cuda" for d in devices):
        fused_cuda._lib()
    textindex._lib()
    bam._lib()
    bddata._native_rp()
    engine_fused._packer()
    if _native_detect() is None:
        raise RuntimeError("native/detect.cpp failed to build or load")


def _kernel_launches() -> collections.Counter:
    """Launches per search kernel (``scan``, ``close``, ``far``,
    ``far_win``)."""
    return collections.Counter(scan=scan_cuda.LAUNCHES,
                               **fused_cuda.LAUNCHES_BY_KERNEL)


def _launches_by_card(before: collections.Counter) -> Dict[str, int]:
    """Search kernel launches (the scan's and the fused kernels') per card
    index since ``before``."""
    now = fused_cuda.search_launches_by_device() - before
    return {str(k): v for k, v in sorted(now.items())}


def _memory(devices) -> Dict[str, Optional[float]]:
    """After a rank's run (its device work synchronized): the peak of its
    allocator on its first device, and the memory used on that card by
    every process at this moment, in MiB; None on the CPU."""
    dev = torch.device(devices[0])
    if dev.type != "cuda":
        return dict(peak_alloc_mib=None, card_used_mib=None)
    torch.cuda.synchronize(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return dict(peak_alloc_mib=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                card_used_mib=(total - free) / 2 ** 20)


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def _build_pipeline(cfg):
    from pindel_tpu_torch.genome import Genome
    from pindel_tpu_torch.pipeline import Pipeline, make_backend_factory
    settings = cfg["settings"]
    devices = cfg["devices"]
    factory = make_backend_factory(settings, devices[0], cfg["backend"],
                                   devices)
    first = torch.device(devices[0])
    if first.type == "cuda":
        torch.cuda.set_device(first)
    genome = Genome.from_fasta(settings.reference_filename)
    pipe = Pipeline(settings, genome, backend_factory=factory)
    pipe.create_output_files()
    if settings.bam_config_filename:
        pipe.load_bam_config(settings.bam_config_filename)
    elif settings.pindel_config_filename:
        pipe.load_pindel_config(settings.pindel_config_filename)
    else:
        pipe.load_pindel_input(settings.pindel_filename)
    return pipe


def worker_main(cfg_path: str) -> int:
    started = time.time()
    if os.environ.get("PINDEL_TPU_WORKER_TRACE"):
        import faulthandler
        faulthandler.dump_traceback_later(
            int(os.environ["PINDEL_TPU_WORKER_TRACE"]), exit=True)
    with open(cfg_path, "rb") as fh:
        cfg = pickle.load(fh)
    if cfg.get("cpus"):
        os.sched_setaffinity(0, cfg["cpus"])
    rank, num_hosts = cfg["rank"], cfg["num_hosts"]
    if cfg["dist"] == "store":
        from pindel_tpu_torch.parallel.distspool import StoreSpool, connect
        spool = StoreSpool(connect(cfg["store_port"]), rank, num_hosts)
    else:
        spool = WindowSpool(cfg["spool"], rank, num_hosts)
    pipe = _build_pipeline(cfg)
    pipe.spool = spool
    ready = time.time()
    try:
        pipe.run()
    finally:
        pipe.close()
    spawned = cfg["spawned"]
    record = dict(rank=rank, devices=cfg["devices"], windows=spool.owned(),
                  launches_by_card=_launches_by_card(collections.Counter()),
                  launches_by_kernel=dict(_kernel_launches()),
                  started_s=started - spawned, ready_s=ready - spawned,
                  first_window_s=(None if spool.first_dump is None
                                  else spool.first_dump - spawned),
                  **_memory(cfg["devices"]), phases=g_timer.items())
    record["wall_s"] = time.time() - spawned
    _write_json(os.path.join(cfg["spool"], f"rank{rank}.json"), record)
    return 0


def _cpu_shards(num_hosts: int):
    """PINDEL_TPU_CPU_SHARD=1: a disjoint CPU set per rank (round-robin
    single cores when there are more ranks than cores), else None."""
    if not os.environ.get("PINDEL_TPU_CPU_SHARD"):
        return None
    cpus = sorted(os.sched_getaffinity(0))
    per = max(len(cpus) // num_hosts, 1)
    if num_hosts <= len(cpus):
        return [cpus[r * per:(r + 1) * per] for r in range(num_hosts)]
    return [[cpus[r % len(cpus)]] for r in range(num_hosts)]


def run_files_multihost(reference_fa: str, pindel_file: Optional[str],
                        output_prefix: str, settings, backend: str = "fused",
                        num_hosts: int = 1,
                        pindel_config: Optional[str] = None,
                        bam_config: Optional[str] = None,
                        dist: str = "files", device="cuda"):
    """Coordinator entry: spawn ranks 1..N-1, search rank 0's windows here,
    report every window in order.  ``dist`` is ``files`` or ``store``
    (``jax``, the reference's name, means ``store``).  Raises WorkerFailed
    when a worker exits non-zero.  One rank is ``pipeline.run_files``."""
    import copy

    from pindel_tpu_torch.pipeline import check_supported, run_files
    LAST_RANKS.clear()
    if num_hosts < 1:
        raise ValueError(f"--hosts must be at least 1, got {num_hosts}")
    if dist not in DISTS:
        raise ValueError(f"unknown --dist {dist!r}; one of "
                         f"{', '.join(DISTS)}")
    devices = [rank_devices(device, backend, r, num_hosts)
               for r in range(num_hosts)]
    mesh = backend == "mesh"
    if num_hosts == 1:
        return run_files(reference_fa, pindel_file, output_prefix,
                         settings=settings, device=devices[0][0],
                         bam_config=bam_config, pindel_config=pindel_config,
                         backend=backend,
                         devices=devices[0] if mesh else None)
    dist = DISTS[dist]
    s = copy.deepcopy(settings)
    check_supported(s, backend)
    if s.report_only_close_mapped_reads:
        raise ValueError("-S is single-process (it is itself the two-phase "
                         "checkpoint)")
    s.reference_filename = reference_fa
    s.pindel_filename = pindel_file or ""
    s.pindel_config_filename = pindel_config or ""
    s.bam_config_filename = bam_config or ""
    build_libraries([d for devs in devices for d in devs])

    t0 = time.time()
    before = fused_cuda.search_launches_by_device()
    before_kernel = _kernel_launches()
    cpu_shards = _cpu_shards(num_hosts)
    affinity = os.sched_getaffinity(0)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs: Dict[int, subprocess.Popen] = {}
    spool_dir = None
    store = None
    try:
        spool_dir = tempfile.mkdtemp(prefix="pindel_tpu_torch_spool_")
        if dist == "store":
            from pindel_tpu_torch.parallel.distspool import StoreSpool, serve
            store = serve()
        if cpu_shards:
            os.sched_setaffinity(0, cpu_shards[0])
        for rank in range(1, num_hosts):
            ws = copy.deepcopy(s)
            ws.output_prefix = os.path.join(spool_dir, f"worker{rank}_out")
            cfg = dict(settings=ws, backend=backend, devices=devices[rank],
                       spool=spool_dir, rank=rank, num_hosts=num_hosts,
                       dist=dist, store_port=store.port if store else None,
                       cpus=cpu_shards[rank] if cpu_shards else None,
                       spawned=time.time())
            cfg_path = os.path.join(spool_dir, f"cfg{rank}.pkl")
            with open(cfg_path, "wb") as fh:
                pickle.dump(cfg, fh, protocol=pickle.HIGHEST_PROTOCOL)
            procs[rank] = subprocess.Popen(
                [sys.executable, "-m", "pindel_tpu_torch.parallel.multihost",
                 cfg_path], env=env)
        if store is not None:
            spool = StoreSpool(store, 0, num_hosts, procs)
        else:
            spool = WindowSpool(spool_dir, 0, num_hosts, procs)
        run_files(reference_fa, pindel_file, output_prefix, settings=s,
                  device=devices[0][0], bam_config=bam_config,
                  pindel_config=pindel_config, backend=backend,
                  devices=devices[0] if mesh else None, spool=spool)
        memory = _memory(devices[0])
        wall = time.time() - t0
        phases = g_timer.items()
        for rank, proc in procs.items():
            try:
                code = proc.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                raise WorkerFailed(rank, None, f"was still running "
                                   f"{WAIT_S:.0f} s after the coordinator "
                                   "ended") from None
            if code != 0:
                raise WorkerFailed(rank, code)
        records = [dict(rank=0, devices=devices[0], windows=spool.owned(),
                        launches_by_card=_launches_by_card(before),
                        launches_by_kernel=dict(_kernel_launches()
                                                - before_kernel),
                        started_s=0.0, ready_s=0.0, first_window_s=None,
                        **memory, phases=phases, wall_s=wall)]
        for rank in procs:
            with open(os.path.join(spool_dir, f"rank{rank}.json")) as fh:
                records.append(json.load(fh))
        LAST_RANKS[:] = records
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if cpu_shards:
            os.sched_setaffinity(0, affinity)
        if spool_dir is not None:
            shutil.rmtree(spool_dir, ignore_errors=True)
    return s


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
