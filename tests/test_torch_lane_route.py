"""The per-lane search (K8) through the window-parallel search's shard
kernel, against the JAX package, on the CPU.

On a card ``TorchLaneBackend`` runs ``_route_kernel``: the shard kernel at
one shard over the whole window, the merge of its partials, the recount and
the emission rules, packed into ``_search_kernel``'s [B, 5*lmax + 2] int8
buffer.  Here the route runs the kernel's plain twin
(``ops/sharded_search.py:shard_partials_ref``) and must give the JAX
``_search_kernel``'s buffer byte for byte, int16 ``rep_w`` wrap included.
The backend through the route must equal the plain backend and JAX
``JaxBackend.run``.  A property test holds what the kernel's split of a row
over several blocks relies on: partials over two column ranges of one tile,
merged by a sum and a min, equal the partials over both.  Tolerance 0
everywhere: the search is integer-only, and the one float compare gets the
same host-made float32 threshold.
"""
import copy

import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings as hsettings

from pindel_tpu import dna
from pindel_tpu.config import Settings
from pindel_tpu.ops import engine_jax as jj
from pindel_tpu.search import close_end_lane
from pindel_tpu_torch.ops import engine_jax as tj
from pindel_tpu_torch.ops import sharded_search as ss
from pindel_tpu_torch.ops.engine_fused import device_state_from_numpy
from pindel_tpu_torch.testing.lane_cases import dead_level_case, lane_case
from pindel_tpu_torch.testing.scenes import two_region_lanes
from pindel_tpu_torch.testing.shard_cases import shard_case
from test_search_semantics import make_genome, sample_reads, ups_key
from test_torch_engine import run_port_search, to_port, to_reference
from test_torch_engine_jax import assert_kept_equal, run_search

torch.set_num_threads(1)

LMAX = 128
CLOSE_MIN = Settings().min_close          # the close-end bp_start (-H)


def packed_both(args, **static):
    want = np.asarray(jj._search_kernel(*[jnp.asarray(a) for a in args],
                                        **static))
    got = tj._route_kernel(
        *[torch.from_numpy(np.array(a)) for a in args], **static)
    assert got.dtype == torch.int8
    return got.numpy(), want


@pytest.mark.parametrize("mpm,bp_start", [(3, CLOSE_MIN), (5, 10)])
@pytest.mark.parametrize("w", [512, 2048, 65536])
@pytest.mark.parametrize("nl", [1, 2, 4])
def test_route_matches_jax_search_kernel(nl, w, mpm, bp_start):
    """testing/lane_cases.py's rows (N bases in reads and reference,
    budgets of 0, rows with no seed, ``valid_w < w``, a copy past 32768 at
    w = 65536)."""
    rows = 6 if w == 65536 else 16
    args = list(lane_case(nl * 1000 + w + mpm, w=w, nl=nl, rows=rows))
    got, want = packed_both(args, w=w, lmax=LMAX, nl=nl, mpm=mpm,
                            bp_start=bp_start)
    np.testing.assert_array_equal(got, want)
    emit, _mm, _lane, rep_w, _full = tj.unpack_kernel_output(got, LMAX)
    assert emit.any(), "no chain emitted"
    # the rows built to have no seed emit nothing
    assert not emit[:2].any()
    if w == 65536:
        # offsets at or past 32768 come back negative, as in JAX
        assert (rep_w[emit] < 0).any()


def test_route_matches_jax_where_no_candidate_is_at_the_min():
    """Every candidate alive above ``max_snp`` and none DEAD: the JAX
    kernel's argmax over no match names candidate 0, and so does the
    route (the window-parallel search names the key 2^30 there)."""
    arrays, static = shard_case("bigkey")
    chrom, slice_start, reverse, qq, valid_w, qlen, ms, tm, maxmm, ma = \
        arrays
    w, lmax, nl = static["w_total"], static["lmax"], static["nl"]
    args = [chrom, slice_start, reverse, qq, valid_w, qlen, ms, tm, maxmm,
            ma]
    got, want = packed_both(args, w=w, lmax=lmax, nl=nl, mpm=static["mpm"],
                            bp_start=static["bp_start"])
    np.testing.assert_array_equal(got, want)
    _emit, min_mm, rep_lane, rep_w, _full = tj.unpack_kernel_output(got,
                                                                    lmax)
    at_dead = min_mm == ss.DEAD
    assert at_dead.any()
    assert (rep_lane[at_dead] == 0).all() and (rep_w[at_dead] == 0).all()


def route_backend(settings, chrom, monkeypatch):
    """``TorchLaneBackend`` on the CPU taking the route, as it does on a
    card."""
    monkeypatch.setattr(tj, "_search_kernel", tj._route_kernel)
    settings = to_port(settings)
    return tj.TorchLaneBackend(
        settings, device_state_from_numpy(chrom.seq, settings.max_mismatch(),
                                          "cpu"))


def plain_backend(settings, chrom):
    settings = to_port(settings)
    return tj.TorchLaneBackend(
        settings, device_state_from_numpy(chrom.seq, settings.max_mismatch(),
                                          "cpu"))


def anchors(results):
    return [(ups_key(ups), full) for ups, full in results]


def test_backend_route_on_two_region_lanes(monkeypatch):
    """chip_smoke.py's BreakDancer-style batch (two regions, four lanes a
    read): the route equals the plain backend and ``JaxBackend.run``."""
    settings = Settings()
    batch = two_region_lanes(3, 12, 1)
    chrom_p, lanes_p, ms, tm = batch
    chrom, lanes, _ms, _tm = to_reference(batch)
    routed = route_backend(settings, chrom, monkeypatch).run(lanes_p, 10, ms,
                                                            tm)
    monkeypatch.undo()
    plain = plain_backend(settings, chrom).run(lanes_p, 10, ms, tm)
    want = jj.JaxBackend(settings, settings.max_mismatch(), chrom.seq).run(
        lanes, 10, ms, tm)
    assert anchors(routed) == anchors(plain) == anchors(want)
    assert all(ups for ups, _ in routed)


def test_backend_route_on_close_end_lanes(monkeypatch):
    """One lane a read, as the close-end rounds send them (both read
    orientations, both strands, the first two range indices), at the
    close-end minimum length."""
    rng = np.random.default_rng(7)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=30)
    # each read as sampled and flipped, as the close-end schedule tries it
    flipped = copy.deepcopy(reads)
    for r in flipped:
        r.seq = dna.flip_rc(r.seq)
    reads = reads + flipped
    lanes = [[close_end_lane(chrom, r, i % 2)] for i, r in enumerate(reads)]
    maxmm = settings.max_mismatch()
    ms = [int(maxmm[len(r.seq)]) for r in reads]
    tm = [m + settings.additional_mismatch for m in ms]
    want = jj.JaxBackend(settings, maxmm, chrom.seq).run(lanes, CLOSE_MIN,
                                                        ms, tm)
    lanes_p = to_port(lanes)
    plain = plain_backend(settings, chrom).run(lanes_p, CLOSE_MIN, ms, tm)
    routed = route_backend(settings, chrom, monkeypatch).run(
        lanes_p, CLOSE_MIN, ms, tm)
    assert anchors(routed) == anchors(plain) == anchors(want)
    assert sum(bool(ups) for ups, _ in routed) > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_searcher_through_route_matches_jax(seed, monkeypatch):
    """tests/test_torch_engine_jax.py's Searcher scenes, every close attempt
    and far round through the route."""
    rng = np.random.default_rng(seed + 100)
    settings = Settings()
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=50)
    reads_jx = copy.deepcopy(reads)
    kept = run_port_search(settings, chrom, reads,
                           route_backend(settings, chrom, monkeypatch))
    kept_jx = run_search(settings, chrom, reads_jx, backend=jj.JaxBackend(
        settings, settings.max_mismatch(), chrom.seq))
    assert_kept_equal(kept, kept_jx)
    assert sum(bool(r.up_far) for r in kept) > 0


def test_backend_picks_by_device_type(monkeypatch):
    """On CPU tensors the backend runs the plain loop and never the
    route (on a card it is the other way round)."""
    calls = []

    def refuse(*a, **kw):
        raise AssertionError("the route ran on the CPU")

    def plain(*a, **kw):
        calls.append(a[0].device.type)
        return real(*a, **kw)

    real = tj._search_kernel
    monkeypatch.setattr(tj, "_route_kernel", refuse)
    monkeypatch.setattr(tj, "_search_kernel", plain)
    chrom, lanes, ms, tm = two_region_lanes(3, 4, 1)
    backend = plain_backend(Settings(), to_reference(chrom))
    backend.run(lanes, 10, ms, tm)
    assert calls and set(calls) == {"cpu"}


@pytest.mark.parametrize("ms,tm", [(130, 131), (3, 131), (131, 131)])
def test_route_matches_jax_at_the_dead_level(ms, tm):
    """Budgets at and past DEAD (-a or the budget table at 127 and above):
    the JAX kernel gives dead candidates the level value 127, so a live
    candidate there counts with them, a level above max_snp counts as 127,
    and a dead representative's strict ring decides its emission; the
    route gives the same bytes."""
    args, static = dead_level_case(ms, tm)
    got, want = packed_both(args, **static)
    np.testing.assert_array_equal(got, want)
    emit, min_mm, rep_lane, rep_w, _full = tj.unpack_kernel_output(
        got, static["lmax"])
    if ms == 130:
        assert not emit[0].any() and emit[1, 132]    # L = 133
        assert min_mm[1, 132] == ss.DEAD and rep_w[1, 132] == 7
    if ms == 3:
        # step 127: every seeded candidate alive at 127, with the dead
        assert min_mm[0, 127] == ss.DEAD and rep_w[0, 127] == 0
    if ms == 131:
        assert min_mm[3, 128] == -128                # 128 as int8


@pytest.mark.parametrize("ms,tm", [(3, 130), (130, 140)])
def test_route_matches_jax_on_lane_cases_past_dead(ms, tm):
    """testing/lane_cases.py's rows at lmax 256 under budgets past DEAD."""
    args = list(lane_case(ms + tm, w=512, nl=2, rows=8, lmax=256))
    args[6] = np.full(8, ms, np.int32)
    args[7] = np.full(8, tm, np.int32)
    got, want = packed_both(args, w=512, lmax=256, nl=2, mpm=3,
                            bp_start=CLOSE_MIN)
    np.testing.assert_array_equal(got, want)


def test_backend_route_at_a_budget_past_dead(monkeypatch):
    """-a 130: every close-end search's tsec_minus passes DEAD; the route
    takes it and equals the plain backend and ``JaxBackend.run``."""
    rng = np.random.default_rng(11)
    settings = Settings(additional_mismatch=130)
    chrom = make_genome(rng).chromosomes[0]
    reads = sample_reads(rng, chrom, n_reads=20)
    lanes = [[close_end_lane(chrom, r, 0)] for r in reads]
    maxmm = settings.max_mismatch()
    ms = [int(maxmm[len(r.seq)]) for r in reads]
    tm = [m + settings.additional_mismatch for m in ms]
    want = jj.JaxBackend(settings, maxmm, chrom.seq).run(lanes, CLOSE_MIN,
                                                        ms, tm)
    lanes_p = to_port(lanes)
    plain = plain_backend(settings, chrom).run(lanes_p, CLOSE_MIN, ms, tm)
    routed = route_backend(settings, chrom, monkeypatch).run(
        lanes_p, CLOSE_MIN, ms, tm)
    assert anchors(routed) == anchors(plain) == anchors(want)


@hsettings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), split=st.integers(1, 63),
       nl=st.integers(1, 3), tm=st.integers(0, 4), lead=st.integers(0, 64))
def test_partials_over_a_split_merge_to_the_whole(seed, split, nl, tm, lead):
    """``shard_partials_ref`` over columns [off, off + a) and [off + a,
    off + w) of one tile, merged by sum (counts) and min (keys), equals the
    partials over [off, off + w), the DEAD slots included; tiles lie inside
    the chromosome, so each range reads the same bases (the kernel splits a
    row's columns over blocks of one clamped tile)."""
    rng = np.random.default_rng(seed)
    w_total, lmax, rows = 128, 24, 3
    off, w = lead, 64
    chrom = rng.integers(0, 5, 2000).astype(np.int8)
    chrom[rng.random(2000) < 0.5] = rng.integers(0, 4)
    slice_start = rng.integers(0, 2000 - 2 * (w_total + lmax),
                               (rows, nl)).astype(np.int32)
    reverse = rng.random((rows, nl)) < 0.5
    qq = rng.integers(0, 5, (rows, nl, lmax)).astype(np.int8)
    for i in range(rows):
        for j in range(nl):
            if rng.random() < 0.7:           # a copy of the tile: long walks
                s = int(slice_start[i, j]) + int(rng.integers(0, w_total))
                qq[i, j] = chrom[s:s + lmax][::-1 if reverse[i, j] else 1]
    valid_w = rng.integers(0, w_total + 1, (rows, nl)).astype(np.int32)
    ms = rng.integers(0, tm + 1, rows).astype(np.int32)
    tsec = np.full(rows, tm, np.int32)
    t = [torch.from_numpy(a) for a in (chrom, slice_start, reverse, qq,
                                       valid_w, ms, tsec)]
    kw = dict(w_total=w_total, lmax=lmax, nl=nl, mpm=3, t_levels=tm,
              s_levels=int(ms.max()))

    def part(lo, width):
        return ss.shard_partials_ref(*t, off=lo, w_local=width, **kw)

    cnt_w, key_w = part(off, w)
    (cnt_a, key_a), (cnt_b, key_b) = part(off, split), \
        part(off + split, w - split)
    assert torch.equal(cnt_a + cnt_b, cnt_w)
    assert torch.equal(torch.minimum(key_a, key_b), key_w)
    assert cnt_w[:, :, -1].sum() > 0         # DEAD slots took part


def test_guards_take_every_searcher_shape():
    """Every per-lane call the Searcher makes at -x <= 4 passes the shard
    kernel's guards, so the route never refuses one: close ends (one lane,
    windows of one or three insert sizes in K8's buckets), far ends (two
    lanes, spans up to 64 * 4^4 either side: w = 32768), BreakDancer
    clusters (two lanes a region, windows in any bucket up to the spacer's;
    at the widest, 98,304, clusters of up to 5,461 regions before the keys
    reach 2^30), reads up to MAX_READ_LENGTH (lmax 512) under the budget
    table's largest level.  Shared memory sets no limit any more."""
    from pindel_tpu_torch.config import MAX_READ_LENGTH
    from pindel_tpu_torch.config import Settings as PortSettings
    from pindel_tpu_torch.genome import SPACER
    from pindel_tpu_torch.ops.sharded_search_cuda import check_shape
    settings = PortSettings()
    top = int(settings.max_mismatch().max())
    levels = dict(t_levels=top + settings.additional_mismatch, s_levels=top)
    backend = plain_backend(Settings(), make_genome(
        np.random.default_rng(0)).chromosomes[0])
    chrom_len = 2 * SPACER + 1                 # the shortest padded one
    lmaxes = range(128, tj._round_up(MAX_READ_LENGTH, 128) + 1, 128)
    widths = (64, 200, 500, 2048, 2049, 9000, 32768, 32769, 70000,
              SPACER - 128)
    shapes = [(1, backend._bucket(x)) for x in widths]          # close
    shapes += [(2, backend._bucket(2 * 64 * 4 ** k)) for k in range(5)]
    shapes += [(2 * regions, backend._bucket(x)) for x in widths
               for regions in (1, 2, 5, 40)]                    # BD
    taken = 0
    for nl, w in shapes:
        for lmax in lmaxes:
            if w + lmax > SPACER:
                continue                  # K8 refuses it before the route
            check_shape(chrom_len, nl=nl, w_total=w, w_local=w, lmax=lmax,
                        **levels)
            taken += 1
    assert taken > 100
    check_shape(chrom_len, nl=2 * 5461, w_total=98304, w_local=98304,
                lmax=128, **levels)
    with pytest.raises(ValueError, match="2\\^30"):
        check_shape(chrom_len, nl=2 * 5462, w_total=98304, w_local=98304,
                    lmax=128, **levels)
    with pytest.raises(ValueError, match="multiple of 4"):
        check_shape(chrom_len, nl=1, w_total=512, w_local=512, lmax=126,
                    **levels)
    # budgets at and past DEAD (-a 130, a budget table reaching 127 at
    # -e 0.3 for reads of 500) are taken, sized as the route sizes them
    for ms_top, tm_top in ((top, top + 130), (127, 128), (140, 400)):
        for lmax in lmaxes:
            t_levels, s_levels = ss.levels(ms_top, tm_top, lmax)
            check_shape(chrom_len, nl=2, w_total=32768, w_local=32768,
                        lmax=lmax, t_levels=t_levels, s_levels=s_levels)
            assert t_levels == min(tm_top, lmax - 1)
            assert s_levels >= min(ms_top, t_levels)
    assert int(PortSettings(seq_error_rate=0.3).max_mismatch().max()) >= 127
    with pytest.raises(ValueError, match="below 0"):
        check_shape(chrom_len, nl=1, w_total=512, w_local=512, lmax=128,
                    t_levels=-1, s_levels=3)


@pytest.mark.parametrize("rows,w_local,splits", [
    (8192, 32768, 1), (2112, 512, 1), (12, 2048, 1), (12, 32768, 16),
    (1, 98304, 32), (3, 128, 1), (300, 4096, 2)])
def test_row_splits(rows, w_local, splits):
    """A call of few rows splits each row over blocks (a power of two, at
    least 2,048 columns each) until it has 2,112 blocks."""
    from pindel_tpu_torch.ops.sharded_search_cuda import row_splits
    assert row_splits(rows, w_local) == splits
