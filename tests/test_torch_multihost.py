"""Multi-process window sharding of the port (pindel_tpu_torch/parallel/
multihost.py, distspool.py, payload.py) on the CPU.

The scene of tests/test_multihost.py, cut to 140 kb and 12 events, spans
three 50 kb windows, so every rank of a 2- or 3-rank run searches one.
Workers are real subprocesses; their reports must be byte-identical to the
port's one-process run and to ``pindel_tpu --backend numpy``.
"""
import io
import os
import time

import numpy as np
import pytest
import torch

from pindel_tpu.__main__ import main as reference_main
from pindel_tpu.parallel import payload as reference_payload
from pindel_tpu_torch.__main__ import build_parser, main as port_main
from pindel_tpu_torch.bddata import BDCoord
from pindel_tpu_torch.config import Settings
from pindel_tpu_torch.parallel import distspool, multihost, payload
from pindel_tpu_torch.parallel.mesh_fused import TorchMeshBackend
from pindel_tpu_torch.search import Searcher
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, bam_argv,
                                             load_golden, reports)
from test_multihost import _scene
from test_search_semantics import make_genome, sample_reads, ups_key
from test_torch_engine import to_port, to_reference

torch.set_num_threads(1)

TEXT_FLAGS = ["-w", "0.05", "-l", "-k", "-s"]


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Workers inherit the environment: one torch thread each, as here."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _out(d, name):
    os.makedirs(os.path.join(d, name))
    return os.path.join(d, name, "out")


@pytest.fixture(scope="module")
def text_scene(tmp_path_factory):
    """The scene, the reference's NumPy reports and the port's one-process
    reports (which must agree)."""
    d = str(tmp_path_factory.mktemp("multihost"))
    _d, fa, txt = _scene(tmp_path_factory.mktemp("scene"), chrom_len=140_000,
                         n_events=12)
    base = ["-f", fa, "-p", txt, *TEXT_FLAGS]
    numpy_out = _out(d, "numpy")
    assert reference_main([*base, "--backend", "numpy", "-o", numpy_out]) == 0
    single = _out(d, "single")
    assert port_main([*base, "--device", "cpu", "-o", single]) == 0
    want = reports(single)
    assert want == reports(numpy_out)
    assert want["D"] and want["CloseEndMapped"]      # the scene calls events
    return d, base, want


class RecordingStoreSpool(distspool.StoreSpool):
    """StoreSpool that keeps every instance and the windows it loaded."""

    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.loaded = []
        RecordingStoreSpool.made.append(self)

    def load(self, widx):
        self.loaded.append(widx)
        return super().load(widx)


@pytest.mark.parametrize("dist,hosts,cpu_shard", [
    ("files", 2, False), ("files", 3, True), ("store", 2, False),
    ("store", 4, False)])
def test_multihost_byte_identical(text_scene, monkeypatch, dist, hosts,
                                  cpu_shard):
    d, base, want = text_scene
    RecordingStoreSpool.made = []
    monkeypatch.setattr(distspool, "StoreSpool", RecordingStoreSpool)
    if cpu_shard:       # each rank pinned to its own CPUs
        monkeypatch.setenv("PINDEL_TPU_CPU_SHARD", "1")
    affinity = os.sched_getaffinity(0)
    out = _out(d, f"{dist}{hosts}")
    assert port_main([*base, "--device", "cpu", "--hosts", str(hosts),
                      "--dist", dist, "-o", out]) == 0
    assert reports(out) == want
    ranks = multihost.LAST_RANKS
    assert [r["rank"] for r in ranks] == list(range(hosts))
    windows = max(max(r["windows"], default=-1) for r in ranks) + 1
    assert windows == 3
    for r in ranks:
        assert r["devices"] == ["cpu"]
        assert r["windows"] == [w for w in range(windows)
                                if w % hosts == r["rank"]]
        assert r["launches_by_card"] == {}      # the plain scan on the CPU
        assert 0 <= r["started_s"] <= r["ready_s"] < r["wall_s"]
    # the coordinator's waits for worker windows are timed apart
    assert multihost.WAIT_PHASE in ranks[0]["phases"]
    assert os.sched_getaffinity(0) == affinity
    if dist == "store":
        (spool,) = RecordingStoreSpool.made
        # every worker window loaded once, in window order; no key left
        assert spool.loaded == [w for w in range(windows) if w % hosts]
        assert not any(spool.store.check([key])
                       for w in range(windows) for key in spool.keys(w))


def test_multihost_bam_rp_evidence(tmp_path):
    """BAM input with RP discovery over 20 kb windows: the owner ships each
    window's evidence delta and _RP text; reports (including _RP) equal the
    reference's (which the port's one-process run matches,
    tests/test_torch_bam.py)."""
    scene = BAM_SCENES["bam_rp_bigdel_w002"]
    paths = scene.build(str(tmp_path))
    multi = _out(str(tmp_path), "multi")
    assert port_main(bam_argv(scene, paths, multi)
                     + ["--device", "cpu", "--hosts", "2"]) == 0
    got = reports(multi)
    assert got == load_golden()["bam_rp_bigdel_w002"]
    assert got["RP"] and b"D 6000" in got["D"]
    assert all(r["windows"] for r in multihost.LAST_RANKS)


def _searched_reads():
    """Searched reads of the port (close and far anchors), from a scene
    built with the reference's classes."""
    rng = np.random.default_rng(55)
    g = make_genome(rng)
    reads = sample_reads(rng, g.chromosomes[0], n_reads=40)
    chrom, reads = to_port((g.chromosomes[0], reads))
    searcher = Searcher(Settings())
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    assert kept and any(r.up_far for r in kept)
    return kept


def test_payload_roundtrip_without_pickle():
    """pack -> np.savez -> np.load(allow_pickle=False) -> unpack keeps every
    field the report stage reads, and the port's arrays equal the
    reference's on the same reads."""
    kept = _searched_reads()
    delta = [(BDCoord("chrT", 100, 200), BDCoord("chrX", 5000, 5100))]
    arrs = payload.pack(kept, delta, "rp text\n")
    want = reference_payload.pack(to_reference(kept), to_reference(delta),
                                  "rp text\n")
    assert list(arrs) == list(want)
    for k, v in arrs.items():
        assert isinstance(v, np.ndarray) and v.dtype.kind in "iub", k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    buf.seek(0)
    with np.load(buf, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    back = payload.unpack(d)
    assert len(back) == len(kept)
    for a, b in zip(kept, back):
        for col in payload._STR_COLS + payload._INT_COLS + payload._BOOL_COLS:
            assert getattr(a, col) == getattr(b, col), col
        assert ups_key(a.up_close) == ups_key(b.up_close)
        assert ups_key(a.up_far) == ups_key(b.up_far)
        assert b.sample_name_to_number == {a.tag: 1}
    (a, b), = payload.unpack_bd(d)[0]
    assert (a.chr_name, a.pos, a.pos2, b.chr_name, b.pos, b.pos2) == \
        ("chrT", 100, 200, "chrX", 5000, 5100)
    assert payload.unpack_bd(d)[1] == "rp text\n"


@pytest.mark.parametrize("make", [
    lambda rank, n: multihost.WindowSpool("/nonexistent", rank, n),
    lambda rank, n: distspool.StoreSpool(None, rank, n)],
    ids=["files", "store"])
def test_spool_assignment(make):
    spools = [make(rank, 3) for rank in range(3)]
    assert [[w for w in range(9) if sp.mine(w)] for sp in spools] == \
        [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    assert [sp.owned() for sp in spools] == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    assert [sp.worker for sp in spools] == [False, True, True]


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 6, 8])
def test_rank_devices(monkeypatch, count):
    """Every rank's mesh devices are a block of its own of count // n
    cards, and, with at least as many cards as ranks, no card serves two
    ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)

    def spread(device, backend, n):
        return [multihost.rank_devices(device, backend, r, n)
                for r in range(n)]

    for backend in ("fused", "jax", "mesh"):
        assert spread("cpu", backend, 3) == [["cpu"]] * 3
        assert spread("cuda:1", backend, 3) == [["cuda:1"]] * 3
    assert spread("cuda", "numpy", 2) == [["cpu"]] * 2
    for backend in ("fused", "jax"):
        assert spread("cuda", backend, 3) == [[f"cuda:{r % count}"]
                                              for r in range(3)]
    for n in (1, 2, 3):
        ranks = spread("cuda", "mesh", n)
        for devs in ranks:
            assert len(set(devs)) == len(devs)
        cards = [d for devs in ranks for d in devs]
        if count >= n:
            assert len(set(cards)) == len(cards), ranks
            per = len(ranks[0])
            assert per == count // n
            assert ranks == [[f"cuda:{c}" for c in range(r * per,
                                                          (r + 1) * per)]
                             for r in range(n)]
        else:
            assert ranks == [[f"cuda:{r % count}"] for r in range(n)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.rank_devices("cuda", "fused", 0, 2)


def test_rank_devices_refuses_indivisible(monkeypatch):
    """A mesh of any count of cards is taken (launches round their rows up
    to it), and a payload whose rows do not split over the devices raises
    ValueError naming the count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1024)
    assert multihost.rank_devices("cuda", "mesh", 1, 3) == [
        f"cuda:{c}" for c in range(341, 682)]
    mesh = TorchMeshBackend(Settings(), Settings().max_mismatch(),
                            np.zeros(1000, np.int8), ["cpu"] * 6)
    assert mesh.dp == 6 and mesh._rows(7) == 12
    with pytest.raises(ValueError, match="6 devices"):
        mesh._launch(None, np.zeros((8, 4), np.int8), {})


def test_spool_removed_when_store_fails(text_scene, monkeypatch):
    """A store that fails to start leaves no spool directory behind."""
    d, base, _want = text_scene
    made = []
    real = multihost.tempfile.mkdtemp

    def mkdtemp(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    def serve():
        raise OSError("store refused to start")

    monkeypatch.setattr(multihost.tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(distspool, "serve", serve)
    with pytest.raises(OSError, match="store refused"):
        port_main([*base, "--device", "cpu", "--hosts", "2", "--dist",
                   "store", "-o", _out(d, "nostore")])
    assert made and not any(os.path.exists(p) for p in made)


def test_failed_worker_fails_the_run(text_scene, monkeypatch):
    """A worker that exits non-zero (here: handed a device the port does
    not run on) makes the run raise, naming its rank, as soon as the
    coordinator waits for one of its windows."""
    d, base, _want = text_scene
    real = multihost.rank_devices

    def bad_rank1(device, backend, rank, n):
        return ["meta"] if rank == 1 else real(device, backend, rank, n)

    monkeypatch.setattr(multihost, "rank_devices", bad_rank1)
    t0 = time.monotonic()
    with pytest.raises(multihost.WorkerFailed, match="worker rank 1 exited "
                       "with code 1") as exc:
        port_main([*base, "--device", "cpu", "--hosts", "2",
                   "-o", _out(d, "failed")])
    assert exc.value.rank == 1
    assert time.monotonic() - t0 < 60
    assert multihost.LAST_RANKS == []


def test_cli_dist_names():
    parse = build_parser().parse_args
    base = ["-f", "r.fa", "-p", "r.txt", "-o", "x"]
    assert parse(base).dist == "files"
    assert [multihost.DISTS[parse([*base, "--dist", n]).dist]
            for n in ("files", "store", "jax")] == ["files", "store", "store"]
    with pytest.raises(ValueError, match="two-phase"):
        multihost.run_files_multihost("r.fa", "r.txt", "x", Settings(
            report_only_close_mapped_reads=True), "fused", 2,
            device="cpu")
