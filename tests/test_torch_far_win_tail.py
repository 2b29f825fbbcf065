"""K4's critical-path figures and the skewed K4 cases, on the CPU.

``measure.far_win_tail`` splits a K4 call's operations by read, as
``measure.fused_bound`` counts them, and names the widest read and the
widest 1% of reads; ``kernel_bench --far-win-tail`` times (a) the whole
call, (b) its widest read and (c) the call without its widest 1%.  Here:

* the figures add up to the bound's operations, the widths are the
  payload's own windows clamped to the bucket, and the widest read is the
  one with the most operations;
* ``fused_cases.far_win_case`` scales the skewed cases as the card times
  them (a hundredth of the reads at the bucket's width);
* the subsets ``kernel_bench.tail_row`` times give the plain version's
  rows, the widest read alone also the JAX package's ``_far_win_kernel``;
* the tool's ``--far-win-tail`` line, on small calls.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pindel_tpu.ops import engine_fused as jx
from pindel_tpu_torch.ops import engine_fused as tx
from pindel_tpu_torch.testing.fused_cases import (FAR_WIN_CASES, SKEWED,
                                                  fused_case)
from pindel_tpu_torch.tools import kernel_bench, measure

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)
CPU = torch.device("cpu")


def torch_inputs(case, **kw):
    _name, chrom, maxmm, payload, static = fused_case(case, **kw)
    return (tx._chrom_cat(torch.from_numpy(chrom)),
            torch.from_numpy(payload.copy()),
            torch.from_numpy(maxmm.copy()), static, chrom, maxmm, payload)


def windows(payload, lmax):
    """(start, end) of each row of a K4 payload."""
    _codes, meta = tx._unpack_payload(torch.from_numpy(payload), lmax,
                                      tx.FW_WORDS)
    return meta[:, 0].numpy(), meta[:, 1].numpy()


@pytest.mark.parametrize("case", FAR_WIN_CASES)
def test_far_win_tail_adds_up_to_the_bound(case):
    cat, pay, mm, static, _c, _m, payload = torch_inputs(case)
    with torch.inference_mode():
        tail = measure.far_win_tail(cat, pay, mm, static)
        bound = measure.fused_bound("_far_win_kernel", cat, pay, mm, static)
    b = payload.shape[0]
    ops_ms = tail["total_ops"] / measure.PEAK_INT32_OPS * 1e3
    if bound["bound_by"] == "operations":
        assert ops_ms == pytest.approx(bound["bound_ms"], rel=1e-12)
    else:
        assert ops_ms <= bound["bound_ms"]
    start, end = windows(payload, static["lmax"])
    width = np.sort(np.clip(end - start, 0, static["w"]))
    assert tail["width"] == dict(
        min=width[0], median=width[(b - 1) // 2],
        p99=width[int(0.99 * (b - 1))], max=width[-1])
    assert (tail["reads"], tail["rows"], tail["w"]) == (b, 2 * b,
                                                        static["w"])
    assert tail["top_reads"] == -(-b // 100)
    assert tail["widest"] == tail["top_idx"][0]
    assert 0 < tail["widest_share"] <= tail["top_share"] <= 1
    assert tail["widest_ops"] == pytest.approx(
        tail["widest_share"] * tail["total_ops"], rel=1e-12)
    # the widest read's busier lane is at least its mean lane, and that at
    # least the mean read's
    assert tail["floor_ms"] >= (tail["widest_ops"] / 2
                                / measure.WARP_INT32_OPS * 1e3) * (1 - 1e-12)
    assert tail["floor_ms"] >= tail["mean_read_ms"] * (1 - 1e-12)


@pytest.mark.parametrize("reads", [0, 400, 4000])
@pytest.mark.parametrize("case", sorted(SKEWED))
def test_skewed_case_scales_its_narrow_reads(case, reads):
    w, narrow, wide = SKEWED[case]
    _name, chrom, _maxmm, payload, static = fused_case(case, reads=reads)
    narrow = reads or narrow
    wide = max(wide, narrow // 100)
    assert payload.shape[0] == narrow + wide
    assert static["w"] == w and chrom.shape[0] >= 2 * w
    start, end = windows(payload, static["lmax"])
    width = end - start
    assert int((width == w).sum()) == wide
    rest = width[width != w]
    assert rest.size == narrow and rest.min() >= 128 and rest.max() <= 512


@pytest.mark.parametrize("case", ["far_win", "far_win_skewed"])
def test_tail_row_subsets_equal_the_plain_version_and_jax(case):
    cat, pay, mm, static, chrom, maxmm, payload = torch_inputs(case)
    with torch.inference_mode():
        row = kernel_bench.tail_row(cat, pay, mm, static, CPU)
    b = payload.shape[0]
    assert row["equal_to_plain"] is True
    assert (row["whole_rows"], row["widest_rows"], row["rest_rows"]) == (
        b, 1, b - row["top_reads"])
    assert all(row[f"{sub}_ms"] > 0 for sub in ("whole", "widest", "rest"))
    assert "whole_device_ms" not in row
    assert row["bound_share"] == pytest.approx(
        row["bound_ms"] / row["whole_ms"])
    # the widest read alone, a call of one row, as the JAX package's K4
    one = payload[row["widest"]:row["widest"] + 1]
    with torch.inference_mode():
        got = tx._far_win_kernel(cat, torch.from_numpy(one.copy()), mm,
                                 **static)
    want = jx._far_win_kernel(jx._chrom_cat(jnp.asarray(chrom)),
                              jnp.asarray(one), jnp.asarray(maxmm), **static)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_bench_far_win_tail_line(monkeypatch, capsys):
    """The tool's ``--far-win-tail`` JSON line, with the scenes' calls
    replaced by a small case and the skewed cases at 20 narrow reads."""
    cat, pay, mm, static, *_ = torch_inputs("far_win_edges")
    monkeypatch.setattr(kernel_bench, "largest_far_win_calls",
                        lambda dev: {"scene3_largest": (cat, pay, mm,
                                                        static)})
    monkeypatch.setattr(kernel_bench, "TAIL_SKEWED_READS", 20)
    assert kernel_bench.main(["32", "--device", "cpu", "--far-win-tail"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "far_win_tail" and line["correct"] is True
    assert list(line["calls"]) == ["scene3_largest", "far_window",
                                   "far_win_skewed", "far_win_skewed32768"]
    assert line["calls"]["far_window"]["reads"] == 32
    assert line["calls"]["far_win_skewed"]["reads"] == 20 + 4
    for call in line["calls"].values():
        assert call["equal_to_plain"] is True and call["bound_ms"] > 0
        assert call["whole_ms"] > 0 and call["floor_ms"] > 0


def test_quartiles_take_the_lower_rank():
    q = measure._quartiles(torch.arange(1, 101))
    assert q == dict(min=1.0, median=50.0, p99=99.0, max=100.0)
    assert measure._quartiles(torch.tensor([7])) == dict(
        min=7.0, median=7.0, p99=7.0, max=7.0)
