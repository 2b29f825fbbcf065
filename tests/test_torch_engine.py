"""The port's fused engine against the JAX package's, on the CPU.

Device-half functions and the close/far/explicit-window launches are
compared on the same numpy-built inputs; the backend is compared at the
Searcher level, and its per-lane ``run`` on BreakDancer-style windows, with
the NumPy oracle and with FusedJaxBackend (as tests/test_engine_fused.py
and tests/test_engine_jax.py do for the JAX engine).  Each side runs on its
own host layer: the scenes are built with the JAX package's classes, and
``to_port`` copies them into the port's (the two packages hold the same
classes under the same relative module paths).  All comparisons are exact:
the search is integer-only.
"""
import copy
import io
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu import dna
from pindel_tpu.config import Settings
from pindel_tpu.genome import SPACER, Genome
from pindel_tpu.ops import engine_fused as jx
from pindel_tpu.reads import SplitRead
from pindel_tpu.search import NumpyBackend, Searcher, far_end_lanes
from pindel_tpu_torch import search as port_search
from pindel_tpu_torch.ops import engine_fused as tx
from pindel_tpu_torch.ops import engine_jax as tj
from test_search_semantics import make_genome, sample_reads, ups_key

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)


class _Remap(pickle.Unpickler):
    """Unpickles objects of package ``src`` as the same classes of
    ``dst``."""

    def __init__(self, data: bytes, src: str, dst: str):
        super().__init__(io.BytesIO(data))
        self.src, self.dst = src, dst

    def find_class(self, module, name):
        if module == self.src or module.startswith(self.src + "."):
            module = self.dst + module[len(self.src):]
        return super().find_class(module, name)


def to_port(obj):
    """A deep copy of JAX-package host objects (settings, chromosomes,
    reads, lanes) as the port's classes."""
    return _Remap(pickle.dumps(obj), "pindel_tpu", "pindel_tpu_torch").load()


def to_reference(obj):
    """The inverse of ``to_port``."""
    return _Remap(pickle.dumps(obj), "pindel_tpu_torch", "pindel_tpu").load()


def run_search(settings, chrom, reads, backend=None):
    searcher = Searcher(settings, backend=backend)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    return kept


def run_port_search(settings, chrom, reads, backend):
    """``run_search`` on the port's host layer: the inputs are copied into
    the port's classes and searched by its Searcher."""
    settings, chrom, reads = to_port((settings, chrom, reads))
    searcher = port_search.Searcher(settings, backend=backend)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    return kept


def torch_backend(settings, chrom):
    settings = to_port(settings)
    return tx.TorchFusedBackend(settings, settings.max_mismatch(), chrom.seq,
                                chrom_name=chrom.name, device="cpu")


def budgets(settings, qlen):
    ms = settings.max_mismatch()[qlen].astype(np.int32)
    tm = ms + settings.additional_mismatch
    thr = np.ceil(np.float32(qlen.astype(np.float64)
                             * np.float64(settings.max_allowed_mismatch_rate))
                  ).astype(np.int32)
    return ms, tm, thr


def read_codes(reads, lmax):
    codes = np.full((len(reads), lmax), dna.N, np.int8)
    for i, r in enumerate(reads):
        codes[i, :len(r.seq)] = dna.encode(r.seq)
    qlen = np.array([len(r.seq) for r in reads], np.int32)
    return codes, qlen


def assert_same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ device half
def test_chrom_cat_matches_jax():
    rng = np.random.default_rng(0)
    chrom = rng.integers(0, 5, 1000).astype(np.int8)   # not a 128 multiple
    assert_same(tx._chrom_cat(torch.from_numpy(chrom)),
                jx._chrom_cat(jnp.asarray(chrom)))


def test_pack_words_matches_jax():
    rng = np.random.default_rng(1)
    emit = rng.random((3, 2, 256)) < 0.5
    emit[0, 0, 31] = emit[0, 0, 63] = True          # sign bit of a word
    assert_same(tx._pack_words(torch.from_numpy(emit)),
                jx._pack_words(jnp.asarray(emit)))


def test_complement_matches_jax():
    codes = np.arange(5, dtype=np.int8).repeat(3).reshape(3, 5)
    assert_same(tx._complement(torch.from_numpy(codes)),
                jx._complement(jnp.asarray(codes)))


@pytest.mark.parametrize("lmax,nmeta", [(128, jx.FM_WORDS),
                                        (256, jx.CM_WORDS)])
def test_unpack_payload_matches_jax(lmax, nmeta):
    rng = np.random.default_rng(lmax)
    codes = rng.integers(0, 5, (9, lmax)).astype(np.int8)
    meta = rng.integers(-2 ** 31, 2 ** 31 - 1, (9, nmeta)).astype(np.int32)
    payload = jx._pack_payload(codes, meta)
    got = tx._unpack_payload(torch.from_numpy(payload), lmax, nmeta)
    want = jx._unpack_payload(jnp.asarray(payload), lmax, nmeta)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert_same(got[0], codes)
    assert_same(got[1], meta)


def test_pack_payload_matches_jax():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, (7, 256)).astype(np.int8)
    meta = rng.integers(-2 ** 31, 2 ** 31 - 1, (7, tx.FW_WORDS)) \
        .astype(np.int32)
    np.testing.assert_array_equal(tx._pack_payload(codes, meta),
                                  jx._pack_payload(codes, meta))


def test_device_state_matches_jax_backend():
    rng = np.random.default_rng(2)
    settings = Settings()
    chrom = make_genome(rng, length=3000).chromosomes[0]
    fb = jx.FusedJaxBackend(settings, settings.max_mismatch(), chrom.seq,
                            chrom_name=chrom.name)
    st = tx.device_state_from_numpy(chrom.seq, settings.max_mismatch(),
                                    "cpu")
    assert_same(st.chrom, fb.chrom_dev)
    assert_same(st.chromcat, fb.chromcat_dev)
    assert_same(st.maxmm, fb.maxmm_dev)
    assert st.chrom.dtype == torch.int8 and st.maxmm.dtype == torch.int32


# ------------------------------------------------------ close/far launches
@pytest.mark.parametrize("with_r1", [True, False])
def test_close_kernel_matches_jax(with_r1):
    rng = np.random.default_rng(3)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    lmax = 128
    codes, qlen = read_codes(reads, lmax)
    minus = np.array([r.matched_d == "-" for r in reads])
    pos = np.array([r.matched_rel_pos for r in reads], np.int64)
    isz = np.array([r.insert_size for r in reads], np.int64)
    ms, tm, thr = budgets(settings, qlen)
    meta = jx._close_meta(pos, isz, qlen, ms, tm, thr, minus)
    payload = jx._pack_payload(
        np.concatenate([codes, tx._reverse_codes_np(codes, qlen)], axis=1),
        meta)
    maxmm = settings.max_mismatch().copy()   # writable for from_numpy
    static = dict(w0=tx.TorchFusedBackend._w_bucket(int(isz.max())),
                  w1=tx.TorchFusedBackend._w_bucket(3 * int(isz.max())),
                  lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=settings.min_close, lsteps=64, with_r1=with_r1)
    got = tx._close_kernel(tx._chrom_cat(torch.from_numpy(chrom.seq)),
                           torch.from_numpy(payload),
                           torch.from_numpy(maxmm), **static)
    want = jx._close_kernel_jit(jx._chrom_cat(jnp.asarray(chrom.seq)),
                                jnp.asarray(payload), jnp.asarray(maxmm),
                                **static)
    assert got.dtype == torch.int32
    assert_same(got, want)
    winner = got[:, lmax // 32 + 1].numpy() & 255
    assert (winner < 255).sum() > len(reads) // 2


@pytest.mark.parametrize("max_range_index", [0, 2, 4])
def test_far_kernel_matches_jax(max_range_index):
    rng = np.random.default_rng(4)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=36)
    searcher = Searcher(settings)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    assert len(kept) > 10
    lmax = 128
    codes, qlen = read_codes(kept, lmax)
    ms, tm, thr = budgets(settings, qlen)
    meta = jx._far_meta(
        np.array([r.last_abs_loc_close_end() for r in kept], np.int64),
        qlen, np.array([r.max_len_close() for r in kept], np.int32),
        np.array([r.max_len_far() for r in kept], np.int32),
        ms, tm, thr, chrom.comp_size)
    payload = jx._pack_payload(codes, meta)
    spans = tuple(64 * 4 ** k for k in range(max_range_index + 1))
    maxmm = settings.max_mismatch().copy()   # writable for from_numpy
    static = dict(spans=spans,
                  ws=tuple(tx.TorchFusedBackend._w_bucket(2 * s)
                           for s in spans),
                  lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=10, lsteps=64)
    got = tx._far_kernel(tx._chrom_cat(torch.from_numpy(chrom.seq)),
                         torch.from_numpy(payload),
                         torch.from_numpy(maxmm), **static)
    want = jx._far_kernel_jit(jx._chrom_cat(jnp.asarray(chrom.seq)),
                              jnp.asarray(payload), jnp.asarray(maxmm),
                              **static)
    assert got.dtype == torch.int32
    assert_same(got, want)
    replaced = (got[:, lmax // 32 + 1].numpy() >> 8) & 1
    assert replaced.sum() > 0


def far_win_payload(rng, settings, chrom, w, lmax, n=24):
    """``_far_win_kernel`` inputs: reads copied from the chromosome (every
    other one reverse-complemented, so both lanes hit) with up to two
    substitutions, in windows narrower than, equal to and wider than ``w``;
    the first and last rows' windows reach the spacers."""
    qlen = rng.integers(30, min(lmax, 200) - 4, n).astype(np.int32)
    codes = np.full((n, lmax), dna.N, np.int8)
    start = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    for i in range(n):
        ql = int(qlen[i])
        pos = SPACER + int(rng.integers(0, chrom.biol_size - ql))
        q = chrom.seq[pos:pos + ql].copy()
        q[rng.integers(0, ql, int(rng.integers(0, 3)))] = rng.integers(0, 4)
        codes[i, :ql] = dna.revcomp(q) if i % 2 else q
        width = (w // 3, w, w + w // 2)[i % 3]
        start[i] = pos - int(rng.integers(0, width))
        end[i] = start[i] + width
    start[0] = SPACER - 7
    end[-1] = chrom.comp_size - SPACER + 5
    ms = settings.max_mismatch()[qlen].astype(np.int32)
    tm = ms + settings.additional_mismatch
    thr = np.ceil(np.float32(qlen.astype(np.float64) * np.float64(
        settings.max_allowed_mismatch_rate))).astype(np.int32)
    meta = np.zeros((n, tx.FW_WORDS), np.int32)
    meta[:, 0] = start
    meta[:, 1] = end
    meta[:, 2] = qlen
    meta[:, 3] = ms | (tm.astype(np.int64) << 8) | (thr.astype(np.int64) << 16)
    return tx._pack_payload(codes, meta), int(qlen.max())


@pytest.mark.parametrize("w,lmax", [(128, 128), (512, 128), (2048, 128),
                                    (8192, 128), (512, 256), (2048, 256)])
def test_far_win_kernel_matches_jax(w, lmax):
    rng = np.random.default_rng(w + lmax)
    settings = Settings()
    chrom = make_genome(rng, length=20_000).chromosomes[0]
    payload, qmax = far_win_payload(rng, settings, chrom, w, lmax)
    maxmm = settings.max_mismatch().copy()   # writable for from_numpy
    static = dict(w=w, lmax=lmax, mpm=settings.min_perfect_match_around_bp,
                  bp_start=10, lsteps=tx._round_up(qmax, 16))
    got = tx._far_win_kernel(tx._chrom_cat(torch.from_numpy(chrom.seq)),
                             torch.from_numpy(payload),
                             torch.from_numpy(maxmm), **static)
    want = jx._far_win_kernel_jit(jx._chrom_cat(jnp.asarray(chrom.seq)),
                                  jnp.asarray(payload), jnp.asarray(maxmm),
                                  **static)
    assert got.dtype == torch.int32
    assert_same(got, want)
    any_emit = got[:, lmax // 32 + 1].numpy() & 1
    assert any_emit.sum() > 0


# ------------------------------------------------------- Searcher level
def assert_kept_equal(kept_a, kept_b):
    assert len(kept_a) == len(kept_b)
    for a, b in zip(kept_a, kept_b):
        assert a.name == b.name
        assert a.seq == b.seq, a.name
        assert ups_key(a.up_close) == ups_key(b.up_close), a.name
        assert ups_key(a.up_far) == ups_key(b.up_far), a.name
        assert a.close_end_mismatch == b.close_end_mismatch, a.name
        assert a.far_end_mismatch == b.far_end_mismatch, a.name
        assert a.max_snp_error == b.max_snp_error


def three_way(settings, chrom, reads, port_backend=None):
    """(NumPy oracle, FusedJaxBackend, TorchFusedBackend) kept reads; the
    last on the port's host layer, through ``port_backend`` when given."""
    reads_fx = copy.deepcopy(reads)
    kept_tt = run_port_search(settings, chrom, reads,
                              port_backend or torch_backend(settings, chrom))
    kept_np = run_search(settings, chrom, reads)
    fb = jx.FusedJaxBackend(settings, settings.max_mismatch(), chrom.seq,
                            chrom_name=chrom.name)
    kept_fx = run_search(settings, chrom, reads_fx, backend=fb)
    return kept_np, kept_fx, kept_tt


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_torch_backend_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed + 100)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=60)
    kept_np, kept_fx, kept_tt = three_way(settings, chrom, reads)
    assert_kept_equal(kept_tt, kept_np)
    assert_kept_equal(kept_tt, kept_fx)
    assert sum(bool(r.up_far) for r in kept_tt) > 0


@pytest.mark.parametrize("max_range_index", [0, 1, 3])
def test_torch_backend_range_index(max_range_index):
    """-x changes the escalation round count; the port must track it."""
    rng = np.random.default_rng(7)
    settings = Settings()
    settings.max_range_index = max_range_index
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    kept_np, kept_fx, kept_tt = three_way(settings, chrom, reads)
    assert_kept_equal(kept_tt, kept_np)
    assert_kept_equal(kept_tt, kept_fx)


def test_torch_backend_edge_positions():
    """Reads anchored at chromosome edges (window clamping paths)."""
    rng = np.random.default_rng(11)
    settings = Settings()
    chrom = make_genome(rng, length=3000).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=20)
    for i, r in enumerate(reads):
        if i % 3 == 0:
            r.matched_rel_pos = i
        elif i % 3 == 1:
            r.matched_rel_pos = chrom.biol_size - 1 - i
    kept_np, kept_fx, kept_tt = three_way(settings, chrom, reads)
    assert_kept_equal(kept_tt, kept_np)
    assert_kept_equal(kept_tt, kept_fx)


# ------------------------------------------------- per-lane run (BD windows)
OTHER = {"A": "C", "C": "G", "G": "T", "T": "A"}


def two_copy_lanes(rng, n_reads=8, qlen=60):
    """Reads whose far-end window holds two near-copies of the read: copy
    A matches the first 40 bases and then diverges, copy B carries two
    early substitutions and matches to the end.  The unique representative
    moves from A to B as the length grows: a non-uniform chain, which
    ``run`` hands to the legacy per-lane backend."""
    g = list(rng.choice(list("ACGT"), size=4000 + n_reads * 1500))
    reads, regions = [], []
    for i in range(n_reads):
        q = list(rng.choice(list("ACGT"), size=qlen))
        pa = 500 + i * 1500
        pb = pa + int(rng.integers(200, 900))
        g[pa:pa + 40] = q[:40]
        g[pa + 40:pa + qlen] = [OTHER[c] for c in q[40:]]
        b = list(q)
        b[15], b[25] = OTHER[b[15]], OTHER[b[25]]
        g[pb:pb + qlen] = b
        r = SplitRead(name=f"@n{i}", matched_d="+", tag="S")
        r.set_seq("".join(q))
        reads.append(r)
        regions.append((SPACER + pa - int(rng.integers(0, 100)),
                        SPACER + pb + qlen + int(rng.integers(0, 100))))
    genome = Genome()
    genome.add("chrT", "".join(g))
    chrom = genome.chromosomes[0]
    lanes = [far_end_lanes(r, [(chrom, s, e)])
             for r, (s, e) in zip(reads, regions)]
    settings = Settings()
    ms = int(settings.max_mismatch()[qlen])
    return chrom, lanes, [(ms, ms + settings.additional_mismatch)] * n_reads


def close_mapped_lanes(seed, regions_of):
    """Close-mapped reads of tests/test_engine_jax.py's scenes with far-end
    windows ``regions_of(chrom, center)`` around each close anchor."""
    rng = np.random.default_rng(seed + 500)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=40)
    searcher = Searcher(settings)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    lanes = [far_end_lanes(r, regions_of(chrom, r.last_abs_loc_close_end()))
             for r in kept]
    return chrom, lanes, [searcher.budget(r) for r in kept]


RUN_CASES = {
    # one region per read: the canonical shape, _far_win_kernel
    "canonical": lambda: close_mapped_lanes(
        7, lambda ch, c: [(ch, c - 211, c + 187)]),
    # two regions per read (tests/test_engine_jax.py:67-80): legacy backend
    "two_regions": lambda: close_mapped_lanes(
        8, lambda ch, c: [(ch, c - 211, c + 187), (ch, c + 301, c + 1007)]),
    "non_uniform": lambda: two_copy_lanes(np.random.default_rng(5)),
}


def run_three_ways(chrom, lanes, budgets, tb=None):
    settings = Settings()
    tb = tb or torch_backend(settings, chrom)
    args = (10, [b[0] for b in budgets], [b[1] for b in budgets])
    got = tb.run(to_port(lanes), *args)
    fused = jx.FusedJaxBackend(settings, settings.max_mismatch(), chrom.seq,
                               chrom_name=chrom.name).run(lanes, *args)
    exp = NumpyBackend(settings, settings.max_mismatch()).run(lanes, *args)
    for (ups_g, mm_g), (ups_f, mm_f), (ups_e, mm_e) in zip(got, fused, exp):
        assert ups_key(ups_g) == ups_key(ups_f) == ups_key(ups_e)
        assert mm_g == mm_f
        if ups_e:
            assert mm_g == mm_e
    assert sum(bool(ups) for ups, _ in got) > 0
    return got


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_torch_backend_run_matches_reference(case):
    chrom, lanes, budgets = RUN_CASES[case]()
    win0, legacy0 = tx.FAR_WIN_ROWS, tj.LEGACY_ROWS
    run_three_ways(chrom, lanes, budgets)
    win, legacy = tx.FAR_WIN_ROWS - win0, tj.LEGACY_ROWS - legacy0
    assert win == (len(lanes) if case != "two_regions" else 0)
    assert legacy == (len(lanes) if case != "canonical" else 0)


def test_torch_backend_run_chunked():
    """A batch split by a lowered CHUNK gives the results of one launch."""
    chrom, lanes, budgets = RUN_CASES["canonical"]()
    whole = run_three_ways(chrom, lanes, budgets)
    tb = torch_backend(Settings(), chrom)
    tb.CHUNK = 5
    win0 = tx.FAR_WIN_ROWS
    split = run_three_ways(chrom, lanes, budgets, tb)
    assert tx.FAR_WIN_ROWS - win0 == len(lanes)
    for (ups_a, mm_a), (ups_b, mm_b) in zip(whole, split):
        assert ups_key(ups_a) == ups_key(ups_b) and mm_a == mm_b


def test_torch_backend_run_is_not_ported():
    """What ``run`` still cannot do, like the reference's device backends:
    a window whose bucket outgrows the spacer (the geometric rounds of
    -x 5 and up) goes to the legacy backend, which refuses it; the JAX
    engine fails its assert there (engine_jax.py:273-275) and only the
    NumPy oracle answers."""
    rng = np.random.default_rng(12)
    settings = Settings()
    chrom = make_genome(rng, length=3000).chromosomes[0]
    assert torch_backend(settings, chrom).run([], 10, [], []) == []
    reads = sample_reads(rng, chrom, n_reads=3)
    wide = [far_end_lanes(r, [(chrom, SPACER - 60_000, SPACER + 40_000)])
            for r in reads]
    budgets = ([3] * len(wide), [4] * len(wide))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_backend(settings, chrom).run(to_port(wide), 10, *budgets)
    with pytest.raises(AssertionError, match="spacer"):
        jx.FusedJaxBackend(settings, settings.max_mismatch(), chrom.seq,
                           chrom_name=chrom.name).run(wide, 10, *budgets)
    assert len(NumpyBackend(settings, settings.max_mismatch())
               .run(wide, 10, *budgets)) == len(wide)
