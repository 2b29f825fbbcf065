"""The port's window-parallel search (K9: pindel_tpu_torch/parallel/mesh.py,
ops/sharded_search.py) against the JAX package's, on the CPU.

``sharded_search`` over ``["cpu"] * 8`` runs the plain twin of the CUDA
shard kernel on every shard; it must equal JAX ``build_sharded_search`` on
the eight virtual CPU devices bit for bit, on all five outputs, at the
grids (dp, wp) = (2, 4), (1, 8) and (4, 2), on ``__graft_entry__``'s
example arrays, on each edge case of
``pindel_tpu_torch/testing/shard_cases.py`` and on
``testing/lane_cases.py:dead_level_case``'s budgets at and past the DEAD
level.  ``TorchShardedBackend`` must
match the NumPy oracle on tests/test_mesh_sharded.py's scene.  Tolerance
is 0 everywhere: the search is integer-only, and the one float compare
gets the same host-made float32 threshold.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_arrays
from pindel_tpu.config import Settings
from pindel_tpu.parallel.mesh import Mesh, build_sharded_search
from pindel_tpu_torch.ops import engine_jax as tj
from pindel_tpu_torch.ops import sharded_search as ss
from pindel_tpu_torch.ops.sharded_search_cuda import shard_partials_cuda
from pindel_tpu_torch.parallel import mesh as tmesh
from pindel_tpu_torch.search import Searcher as PortSearcher
from pindel_tpu_torch.testing.lane_cases import dead_level_case
from pindel_tpu_torch.testing.shard_cases import CASES, shard_case
from test_search_semantics import make_genome, sample_reads, ups_key
from test_torch_engine import to_port

torch.set_num_threads(1)

GRIDS = [(2, 4), (1, 8), (4, 2)]
OUTPUTS = ("emit", "min_mm", "rep_lane", "rep_w", "full_mm")
EXAMPLE = dict(w_total=512, lmax=128, nl=2, mpm=3, bp_start=8)


@functools.lru_cache(maxsize=None)
def jax_search(dp, wp, static):
    """The JAX function at one grid, compiled once per static shape."""
    mesh = Mesh(np.array(jax.devices()[:dp * wp]).reshape(dp, wp),
                ("dp", "wp"))
    return build_sharded_search(mesh, **dict(static))


def both(arrays, static, dp, wp):
    want = jax_search(dp, wp, tuple(sorted(static.items())))(
        *[jnp.asarray(a) for a in arrays])
    got = tmesh.sharded_search(*arrays, grid=tmesh.make_grid(["cpu"] * 8, dp),
                               **static)
    return got, [np.asarray(x) for x in want]


def assert_equal(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("dp,wp", GRIDS)
def test_sharded_search_matches_jax(dp, wp):
    got, want = both(_example_arrays(), EXAMPLE, dp, wp)
    assert_equal(got, want)
    assert want[0].any()                        # the example emits


@pytest.mark.parametrize("dp,wp", GRIDS)
@pytest.mark.parametrize("case", CASES)
def test_edge_case_matches_jax(case, dp, wp):
    arrays, static = shard_case(case)
    got, want = both(arrays, static, dp, wp)
    assert_equal(got, want)


def test_edge_cases_reach_their_edge():
    """Each edge case holds what it was built for (at wp = 8)."""
    got = {}
    for case in CASES:
        arrays, static = shard_case(case)
        got[case] = (arrays, static, tmesh.sharded_search(
            *arrays, grid=tmesh.make_grid(["cpu"] * 8, 1), **static))
    # DEAD: the representative is a DEAD key, and full_mm its recount
    _a, _s, (emit, min_mm, _lane, _w, full) = got["dead"]
    dead = min_mm == ss.DEAD
    assert dead.any() and not emit.any() and (full[dead] > 0).any()
    # BIGKEY: no DEAD candidate, every live one above max_snp
    _a, st, (emit, min_mm, lane, rep_w, full) = got["bigkey"]
    big = lane == ss.BIGKEY // st["w_total"]
    assert big.any() and (rep_w[big] == ss.BIGKEY % st["w_total"]).all()
    assert (full[big] == 0).all() and (min_mm[big] == ss.DEAD).all()
    # a shard's tile clamped (or wrapped) away from the unsharded tile
    arrays, st, _out = got["clamped"]
    chrom, slice_start, reverse = arrays[:3]
    wl = st["w_total"] // 8
    starts = [ss.tile_starts(torch.from_numpy(slice_start),
                             torch.from_numpy(reverse), len(chrom), off=k * wl,
                             w_total=st["w_total"], w_local=wl,
                             lmax=st["lmax"]).numpy() for k in range(8)]
    steps = np.diff(np.stack(starts), axis=0)
    assert (steps != np.where(reverse, -wl, wl)).any()
    # every lane backward
    assert got["backward"][0][2].all() and got["backward"][2][0].any()
    # N at steps 1 and 2 of every query: strict mismatches that match
    arrays, _s, (emit, *_rest) = got["strict_step0"]
    assert (arrays[3][:, :, 1:3] == 4).all() and emit.any()
    # representatives at columns >= 32768, in int32
    _a, st, (emit, _mm, _lane, rep_w, _full) = got["wide"]
    assert st["w_total"] == 40960 and (rep_w[emit] >= 32768).all()
    assert emit.any(axis=1).all()


def test_wide_keeps_int32_where_k8_wraps():
    """At w = 40960 K8's packed int16 offset wraps (as XLA's convert does);
    K9 returns the column itself.  At wp = 1 the two searches agree."""
    arrays, st = shard_case("wide")
    got = tmesh.sharded_search(*arrays, grid=tmesh.make_grid(["cpu"], 1),
                               **st)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    packed = tj._search_kernel(*t, w=st["w_total"], lmax=st["lmax"],
                               nl=st["nl"], mpm=st["mpm"],
                               bp_start=st["bp_start"]).numpy()
    emit8, mm8, lane8, w8, _full = tj.unpack_kernel_output(packed, st["lmax"])
    emit, min_mm, lane, rep_w, _ = got
    np.testing.assert_array_equal(emit8, emit)
    np.testing.assert_array_equal(mm8, min_mm)
    e = emit
    assert (rep_w[e] >= 32768).all()
    np.testing.assert_array_equal(w8[e].astype(np.int32), rep_w[e] - 65536)
    np.testing.assert_array_equal(lane8[e], lane[e])


def _scene(dp):
    rng = np.random.default_rng(2024 + dp)
    settings = Settings()
    g = make_genome(rng)
    chrom = g.chromosomes[0]
    return settings, chrom, sample_reads(rng, chrom, n_reads=40)


@pytest.mark.parametrize("dp,wp", GRIDS)
def test_backend_matches_numpy(dp, wp):
    """tests/test_mesh_sharded.py's scene through the port's Searcher with
    TorchShardedBackend, against the port's NumPy oracle."""
    settings, chrom, reads = to_port(_scene(dp))
    backend = tmesh.TorchShardedBackend(settings, settings.max_mismatch(),
                                        chrom.seq, ["cpu"] * (dp * wp), dp)
    assert (backend.dp, backend.wp) == (dp, wp)

    def run(reads, backend=None):
        sr = PortSearcher(settings, backend=backend)
        sr.map_close_ends(chrom, reads)
        kept = sr.finalize_close_ends(reads)
        sr.search_far_ends(chrom, kept)
        return kept

    kept_np = run(copy.deepcopy(reads))
    kept_sh = run(copy.deepcopy(reads), backend)
    assert len(kept_np) == len(kept_sh)
    n_far = 0
    for a, b in zip(kept_np, kept_sh):
        assert (a.name, a.seq) == (b.name, b.seq)
        assert ups_key(a.up_close) == ups_key(b.up_close), a.name
        assert ups_key(a.up_far) == ups_key(b.up_far), a.name
        n_far += bool(a.up_far)
    assert n_far > 0


def test_bucket_and_limits():
    """The window bucket is ShardedJaxBackend's; a window past the spacer
    raises ValueError (the JAX backend asserts); the grid's defaults are
    make_mesh's."""
    from pindel_tpu.parallel.mesh import ShardedJaxBackend
    settings = to_port(Settings())
    for wp in (1, 3, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:wp]).reshape(1, wp),
                    ("dp", "wp"))
        ref = ShardedJaxBackend(Settings(), Settings().max_mismatch(),
                                np.zeros(100, np.int8), mesh)
        port = tmesh.TorchShardedBackend(settings, settings.max_mismatch(),
                                         np.zeros(100, np.int8),
                                         ["cpu"] * wp, 1)
        for width in (1, 100, 128, 129, 2048, 9000, 32768, 32769, 40000,
                      70001):
            assert port._bucket(width) == ref._bucket(width), (wp, width)
    grid = tmesh.make_grid(["cpu"] * 8)
    assert (grid.dp, grid.wp) == (2, 4)
    assert (tmesh.make_grid(["cpu"] * 3).dp, tmesh.make_grid(["cpu"] * 3).wp) \
        == (1, 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_grid(["cpu"] * 6, 4)
    from pindel_tpu_torch.genome import SPACER
    from pindel_tpu_torch.ops.search_np import Lane
    lane = Lane(chrom=np.zeros(100, np.int8), chr_name="c", start=0,
                end=SPACER, forward=True,
                query=np.zeros(50, np.int8), direction="+", strand="+")
    with pytest.raises(ValueError, match="spacer"):
        port.run([[lane]], 8, [2], [3])


def test_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher takes the twin; the CUDA wrapper itself
    refuses CPU tensors rather than run anything else."""
    arrays, st = shard_case("random")
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    kw = dict(off=0, w_total=st["w_total"], w_local=st["w_total"],
              lmax=st["lmax"], nl=st["nl"], mpm=3, t_levels=4, s_levels=3)
    args = (t[0], t[1], t[2], t[3], t[4], t[6], t[7])
    a = ss.shard_partials(*args, **kw)
    b = ss.shard_partials_ref(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shard_partials_cuda(*args, **kw)


@pytest.mark.parametrize("dp,wp", GRIDS + [(1, 1)])
@pytest.mark.parametrize("ms,tm", [(130, 131), (3, 131), (131, 131)])
def test_dead_level_budgets_match_jax(ms, tm, dp, wp):
    """Budgets at and past the DEAD level (127): the JAX function counts a
    live candidate at 127 with the dead ones and keeps levels past 127 up
    to max_snp; the port takes such budgets (``ss.levels``, the DEAD
    representative's strict bit recounted) and gives the same five outputs
    at every grid."""
    arrays, st = dead_level_case(ms, tm)
    static = dict(w_total=st["w"], lmax=st["lmax"], nl=st["nl"],
                  mpm=st["mpm"], bp_start=st["bp_start"])
    got, want = both(arrays, static, dp, wp)
    assert_equal(got, want)
    min_mm = want[1]
    # the rows reach the DEAD level, and with ms past it levels above it
    assert (min_mm == ss.DEAD).any()
    assert (min_mm > ss.DEAD).any() == (ms > ss.DEAD)
