"""The port's fused engine against the JAX package's, on the CPU.

Device-half functions and the close/far launches are compared on the same
numpy-built inputs; the backend is compared at the Searcher level with the
NumPy oracle and with FusedJaxBackend (as tests/test_engine_fused.py does
for the JAX engine).  All comparisons are exact: the search is integer-only.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu import dna
from pindel_tpu.config import Settings
from pindel_tpu.ops import engine_fused as jx
from pindel_tpu.search import Searcher
from pindel_tpu_torch.ops import engine_fused as tx
from test_search_semantics import make_genome, sample_reads, ups_key

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)


def run_search(settings, chrom, reads, backend=None):
    searcher = Searcher(settings, backend=backend)
    searcher.map_close_ends(chrom, reads)
    kept = searcher.finalize_close_ends(reads)
    searcher.search_far_ends(chrom, kept)
    return kept


def torch_backend(settings, chrom):
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


def three_way(settings, chrom, reads):
    """(NumPy oracle, FusedJaxBackend, TorchFusedBackend) kept reads."""
    reads_fx = copy.deepcopy(reads)
    reads_tt = copy.deepcopy(reads)
    kept_np = run_search(settings, chrom, reads)
    fb = jx.FusedJaxBackend(settings, settings.max_mismatch(), chrom.seq,
                            chrom_name=chrom.name)
    kept_fx = run_search(settings, chrom, reads_fx, backend=fb)
    kept_tt = run_search(settings, chrom, reads_tt,
                         backend=torch_backend(settings, chrom))
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


def test_torch_backend_run_is_not_ported():
    rng = np.random.default_rng(12)
    settings = Settings()
    chrom = make_genome(rng, length=3000).chromosomes[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_backend(settings, chrom).run([], 10, [], [])
