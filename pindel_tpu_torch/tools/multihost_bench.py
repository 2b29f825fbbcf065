"""Multi-process scaling: the same scene at ``--hosts N`` against one
process, on the card.

    python -m pindel_tpu_torch.tools.multihost_bench [--hosts 2]
        [--events 60] [--chrom-len 1200000] [--noise 3000]
        [--dist files|store] [--bam] [--device cuda|cpu]

The counterpart of ``tools/multihost_bench.py``, with its scene (seed 99,
``--events`` planted events of six kinds, 10 split reads each, ``--noise``
reference reads, 100 kb windows; with ``--bam`` the reads as anchored BAM
pairs and a BreakDancer line per DEL/DI/INV/TD event) and its simulated
hosts: the one-process run has one share of the machine's cores, and each
of the N ranks has its own share (``PINDEL_TPU_CPU_SHARD=1``).  Every rank
searches on the card ``parallel.multihost.rank_devices`` gives it.  The
one-process run takes one untimed run first (its first use); then ``t1``
(one process) and ``tN`` (``python -m pindel_tpu_torch --hosts N``) are
timed, each after ``torch.cuda.synchronize()``.  ``--dist jax`` means
``store``, as in the port's CLI.  The reports at ``--hosts N`` must be
byte-identical to the one-process run's, and on a card every rank that
owned a window must have launched the search kernels (``correct``).

The last line of standard output is one JSON object: ``t1``, ``tN``,
``hosts``, ``speedup``, ``efficiency``, each rank's devices, windows,
search kernel launches by card and its spawn-to-imports, spawn-to-ready and
spawn-to-first-window times (``parallel/multihost.py`` ``LAST_RANKS``),
``correct``, ``device`` (the card's name and power limit), ``build_s`` and
``first_use_s``.  It writes no file of the repository.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.ops import fused_cuda
from pindel_tpu_torch.parallel import multihost
from pindel_tpu_torch.pipeline import resolve_device
from pindel_tpu_torch.testing.bamwriter import make_fai
from pindel_tpu_torch.testing.scenes import reports, text_to_bam
from pindel_tpu_torch.testing.simulate import standard_scene, write_fasta
from pindel_tpu_torch.tools import measure


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_scene(d: str, events: int, chrom_len: int, noise: int,
                bam: bool):
    """The scene's files under ``d``: (CLI arguments without -o, reads)."""
    kinds = ["DEL", "SI", "DI", "INV", "TD", "LI"] * (events // 6)
    ref, planted, reads = standard_scene(
        seed=99, chrom_len=chrom_len, kinds=kinds, reads_per_event=10,
        n_noise=noise, chrom="chrM")
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrM", ref)])
    make_fai(fa)
    txt = os.path.join(d, "reads.txt")
    reads.write(txt)
    if not bam:
        return ["-f", fa, "-p", txt, "-w", "0.1", "-l", "-s",
                "--backend", "fused"], len(reads.names)
    # every rank runs the whole RP -> BD evidence chain
    bam_path = os.path.join(d, "reads.bam")
    text_to_bam(ref, "chrM", txt, bam_path)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam_path}\t500\tS1\n")
    bd = os.path.join(d, "bd.txt")
    with open(bd, "w") as fh:
        fh.write("#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore\n")
        for ev in planted:
            if ev.kind in ("DEL", "DI", "INV", "TD"):
                fh.write(f"chrM\t{ev.pos}\t20+20-\tchrM\t{ev.pos + ev.size}"
                         f"\t18+19-\t{ev.kind}\t{ev.size}\t99\n")
    return ["-f", fa, "-i", cfg, "-b", bd, "-w", "0.1", "-s",
            "--backend", "fused"], len(reads.names)


def timed_cli(argv, dev) -> float:
    t0 = time.monotonic()
    rc = port_main(argv)
    measure.sync(dev)
    wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}: {argv}")
    return wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pindel_tpu_torch.tools.multihost_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--events", type=int, default=60)
    ap.add_argument("--chrom-len", type=int, default=1_200_000)
    ap.add_argument("--noise", type=int, default=3000)
    ap.add_argument("--dist", choices=sorted(multihost.DISTS),
                    default="files")
    ap.add_argument("--bam", action="store_true",
                    help="BAM input + BreakDancer evidence scene (the "
                         "sharded RP -> BD chain under --hosts)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.hosts < 2:
        ap.error("--hosts must be at least 2")
    dev = resolve_device(args.device)
    card = measure.device_line(dev)
    t0 = time.monotonic()
    multihost.build_libraries([str(dev)])
    build_s = time.monotonic() - t0
    log(f"device: {card}; kernel and native library builds (or loads) "
        f"{build_s:.3f} s")

    all_cpus = sorted(os.sched_getaffinity(0))
    per = max(len(all_cpus) // args.hosts, 1)
    with tempfile.TemporaryDirectory(prefix="pindel_tpu_torch_mh_") as d:
        base, n_reads = build_scene(d, args.events, args.chrom_len,
                                    args.noise, args.bam)
        base += ["--device", str(dev)]
        log(f"scene: {n_reads} reads over {args.chrom_len // 1000} kb, "
            f"window 100 kb; host share: {per} of {len(all_cpus)} cpus")
        # a simulated host is one disjoint share of the cores: the
        # one-process run on one share, each rank on its own
        os.sched_setaffinity(0, all_cpus[:per])
        try:
            first_use_s = timed_cli([*base, "-o", os.path.join(d, "first")],
                                    dev)
            fused_cuda.reset_launches()
            t1 = timed_cli([*base, "-o", os.path.join(d, "single")], dev)
            single_launches = fused_cuda.search_launches()
        finally:
            os.sched_setaffinity(0, all_cpus)
        log(f"one process: first use {first_use_s:.3f} s, then "
            f"{t1:.3f} s  [{card}]")
        saved = os.environ.get("PINDEL_TPU_CPU_SHARD")
        os.environ["PINDEL_TPU_CPU_SHARD"] = "1"
        try:
            tn = timed_cli([*base, "-o", os.path.join(d, "multi"),
                            "--hosts", str(args.hosts), "--dist",
                            args.dist], dev)
        finally:
            if saved is None:
                os.environ.pop("PINDEL_TPU_CPU_SHARD")
            else:
                os.environ["PINDEL_TPU_CPU_SHARD"] = saved
            os.sched_setaffinity(0, all_cpus)
        log(f"--hosts {args.hosts}: {tn:.3f} s  [{card}]")
        single = reports(os.path.join(d, "single"))
        multi = reports(os.path.join(d, "multi"))

    bad = []
    if multi != single:
        diff = sorted(k for k in set(single) | set(multi)
                      if single.get(k) != multi.get(k))
        bad.append(f"reports at --hosts {args.hosts} differ from one "
                   f"process's: {diff}")
    ranks = []
    for r in multihost.LAST_RANKS:
        ranks.append(dict(
            rank=r["rank"], devices=r["devices"], windows=r["windows"],
            launches_by_card=r["launches_by_card"], wall_s=r.get("wall_s"),
            spawn_to_imports_s=r["started_s"], spawn_to_ready_s=r["ready_s"],
            spawn_to_first_window_s=r["first_window_s"]))
        if (dev.type == "cuda" and r["windows"]
                and not sum(r["launches_by_card"].values())):
            bad.append(f"rank {r['rank']} owned windows {r['windows']} but "
                       "never launched the search kernels")
        log(f"rank {r['rank']}: devices {r['devices']}, windows "
            f"{r['windows']}, search kernel launches by card "
            f"{r['launches_by_card']}, spawn to imports "
            f"{r['started_s']:.3f} s, to ready {r['ready_s']:.3f} s, to "
            f"first window {r['first_window_s']}  [{card}]")
    for line in bad:
        log(f"GATE FAILED: {line}")
    speedup = t1 / tn
    print(json.dumps(dict(
        tool="multihost_bench", t1=t1, tN=tn, hosts=args.hosts,
        reads=n_reads, dist=args.dist, scene="bam+bd" if args.bam else "text",
        cpu_share=per, physical_cpus=len(all_cpus), speedup=speedup,
        efficiency=speedup / args.hosts, ranks=ranks,
        launches=dict(single=single_launches,
                      hosts=sum(sum(r["launches_by_card"].values())
                                for r in ranks)),
        correct=not bad, device=card, build_s=build_s,
        first_use_s=first_use_s)), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
