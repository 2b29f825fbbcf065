"""The port's measurement code on the CPU: the recorded scene run and its
gate (``testing/scenes.py:run_scene`` and ``problems``) and the tools
(``pindel_tpu_torch.tools.{kernel_bench,multihost_bench,span_report}``).
On small scenes they run through the same code as on the card, write the
same reports as the repository's ``bench.py`` (the JAX package on the
CPU), print their JSON line, fail the gate when a report changes or a rule
is broken, and raise without a card unless asked for the CPU.  Scene 1's
reference digests (``testing/scene1_digests.json``) are checked by a slow
test and rewritten with ``PYTHONPATH=. python tests/test_torch_bench.py
--write-scene1-digests`` (``python -m pindel_tpu --backend numpy``)."""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as reference_bench  # noqa: E402
from pindel_tpu.__main__ import main as reference_main  # noqa: E402
from pindel_tpu.ops import engine_fused as reference_fused  # noqa: E402
from pindel_tpu_torch.testing import scenes  # noqa: E402
from pindel_tpu_torch.testing.scan_cases import (BUCKET_LMAXES,  # noqa: E402
                                                 BUCKET_ROWS, W_BUCKETS,
                                                 KINDS, branch_case,
                                                 bucket_case)
from pindel_tpu_torch.profiling import g_fallback  # noqa: E402
from pindel_tpu_torch.tools import (kernel_bench, measure,  # noqa: E402
                                    multihost_bench, span_report)
from test_pallas_onchip import _case as onchip_case  # noqa: E402

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

SCENE1_COMMAND = ("PYTHONPATH=. python tests/test_torch_bench.py "
                  "--write-scene1-digests")
# the span sums of span_report's JSON line
SPAN_SUMS = ("root_s", "root_self_s", "coverage_s", "entry_s",
             "device_wait_s", "oracle_read_pct", "upload_mb", "xchrom_s",
             "interchrom_s")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small pindel-text scene and a small BAM + BreakDancer scene, each
    with the reports of the repository's bench.py (``run_ours`` and
    ``run_ours_bam``: the JAX package's fused backend on the CPU), as
    ``scenes.Scene`` objects with those reports' digests."""
    d = str(tmp_path_factory.mktemp("bench_small"))
    text_dir, bam_dir = os.path.join(d, "text"), os.path.join(d, "bam")
    os.makedirs(text_dir)
    os.makedirs(bam_dir)
    fa, reads_txt, n = scenes.write_scene(text_dir, seed=0)
    ref_text = os.path.join(text_dir, "reference")
    reference_bench.run_ours(fa, reads_txt, ref_text)
    paths = scenes.build_bigdel(bam_dir)
    ref_bam = os.path.join(bam_dir, "reference")
    reference_bench.run_ours_bam(paths["fa"], paths["cfg"], paths["bd"],
                                 ref_bam)
    want_text = scenes.reports(ref_text)
    want_bam = scenes.reports(ref_bam)
    assert want_text["D"] and want_bam["D"]
    return dict(
        scene1=scenes.text_scene("scene1", fa, reads_txt, n,
                                 scenes.digests(want_text)),
        scene2=scenes.bam_scene("scene2", paths, int(paths["pairs"]),
                                scenes.digests(want_bam)),
        text_argv=["-f", fa, "-p", reads_txt, "-s"],
        reports=dict(scene1=want_text, scene2=want_bam))


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# ------------------------------------------------- the recorded run, the gate
@pytest.mark.parametrize("key", ["scene1", "scene2"])
def test_bench_run_matches_reference_bench(small, key, tmp_path):
    """(a) ``scenes.run_scene`` writes the reports bench.py's run_ours /
    run_ours_bam write on the same files, and the gate passes."""
    prefix = str(tmp_path / "port")
    result = scenes.run_scene(small[key], prefix, CPU)
    assert scenes.reports(prefix) == small["reports"][key]
    assert result["digests"] == small[key].want
    assert result["wall"] > 0 and result["launches"] == 0     # no card
    assert result["counters"]["windows"] == 1
    assert not scenes.problems(small[key], [result], kernel=False)


@pytest.mark.parametrize("fault", ["report", "fallback"])
def test_bench_gate_fails(small, monkeypatch, fault, tmp_path):
    """(c) A changed report, or a fallback ratio above 1%, in a recorded
    run fails the gate on that rule alone."""
    if fault == "report":
        real = scenes.reports

        def changed(prefix):
            got = real(prefix)
            got["D"] += b"changed\n"
            return got
        monkeypatch.setattr(scenes, "reports", changed)
    else:
        monkeypatch.setattr(g_fallback, "ratio", lambda: 0.02)
    scene = small["scene1"]
    result = scenes.run_scene(scene, str(tmp_path / "port"), CPU)
    bad = scenes.problems(scene, [result], kernel=False)
    want = ("reports differ from the reference's: ['D']"
            if fault == "report" else "fallback ratio 0.02 above 0.01")
    assert len(bad) == 1 and want in bad[0], bad


def test_bench_gate_rules(small):
    """An empty _D, launches that differ between runs and a card run that
    never launched the kernel each fail the gate."""
    scene = small["scene1"]
    ok = dict(digests=scene.want, d_empty=False, fallback=0.0, launches=3)
    assert not scenes.problems(scene, [ok, ok], kernel=True)
    assert scenes.problems(scene, [dict(ok, d_empty=True)], kernel=False)
    assert scenes.problems(scene, [ok, dict(ok, launches=4)], kernel=True)
    assert scenes.problems(scene, [dict(ok, launches=0)], kernel=True)
    assert not scenes.problems(scene, [dict(ok, launches=0)], kernel=False)


# a run of a BreakDancer scene that passes every rule (three windows, K4
# rows through pt_far_win, five reads across chromosomes of at most eight),
# and per rule the counters that break it alone and the words of its line
GOOD_COUNTERS = dict(windows=3, far_win_rows=12, far_win_launches=2,
                     oracle_reads=5)
BROKEN = {
    "windows": (dict(windows=2), "2 windows, not 3"),
    "far_win_never_launched": (dict(far_win_launches=0),
                               "K4 rows 12 but pt_far_win never launched"),
    "no_k4_rows": (dict(far_win_rows=0, far_win_launches=0),
                   "_far_win_kernel searched no row"),
    "route_reads_above": (dict(oracle_reads=9),
                          "9 reads taken across chromosomes, not 1 to 8"),
    "route_reads_none": (dict(oracle_reads=0),
                         "0 reads taken across chromosomes, not 1 to 8"),
}


@pytest.mark.parametrize("rule", list(BROKEN))
def test_gate_rule_trips_alone(small, rule):
    """Each rule of ``scenes.problems`` that a scene's shape sets (its
    windows, K4 on a BreakDancer scene's kernel run, ``pt_far_win`` for K4
    rows, the cross-chromosome route's reads) fails a kernel run that
    breaks it, and only that rule."""
    scene = dataclasses.replace(small["scene2"], windows=3, oracle_reads=8)
    ok = dict(digests=scene.want, d_empty=False, fallback=0.0, launches=7,
              counters=GOOD_COUNTERS)
    assert not scenes.problems(scene, [ok, ok], kernel=True)
    counters, words = BROKEN[rule]
    bad = scenes.problems(
        scene, [ok, dict(ok, counters=dict(GOOD_COUNTERS, **counters))],
        kernel=True)
    assert bad == [f"scene2 run 1: {words}"]


# ------------------------------------------------------------ kernel bench
@pytest.mark.parametrize("name", ["close_both_ranges", "close_range0",
                                  "far_3_rounds", "far_window"])
def test_kernel_bench_calls_match_jax(name):
    """(d) K2 with both ranges and range 0, K3 and K4, on the tool's own
    inputs at b = 64, equal the JAX package's ``_close_kernel_jit``,
    ``_far_kernel_jit`` and ``_far_win_kernel_jit`` bit for bit."""
    host = kernel_bench.inputs(64)
    chrom, maxmm, payload, fpayload, wpayload = host
    with torch.inference_mode():
        got = kernel_bench.calls(*host, CPU)[name]()
    args = (reference_fused._chrom_cat(jnp.asarray(chrom)),)
    if name == "far_3_rounds":
        want = reference_fused._far_kernel_jit(
            *args, jnp.asarray(fpayload), jnp.asarray(maxmm),
            **kernel_bench.FAR)
    elif name == "far_window":
        want = reference_fused._far_win_kernel_jit(
            *args, jnp.asarray(wpayload), jnp.asarray(maxmm),
            **kernel_bench.FAR_WIN)
    else:
        want = reference_fused._close_kernel_jit(
            *args, jnp.asarray(payload), jnp.asarray(maxmm),
            with_r1=name == "close_both_ranges", **kernel_bench.CLOSE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the calls find something: emission words are not all zero
    assert np.asarray(want)[:, :-2].any()


def test_kernel_bench_json(capsys):
    assert kernel_bench.main(["64", "--device", "cpu"]) == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] is True and line["b"] == 64
    calls = ("close_both_ranges", "close_range0", "far_3_rounds",
             "far_window")
    assert set(line["calls"]) == set(calls)
    for call in line["calls"].values():
        assert call["ms"] > 0 and call["bound_ms"] > 0
        assert call["equal_to_plain"] is True
    assert [line["calls"][k]["k1_calls"] for k in calls] == [2, 1, 3, 1]


def test_scan_bound_unchanged():
    """``measure.scan_bound`` gives the value chip_smoke.py's own copy gave
    before it moved, on one branch-case batch."""
    case = [torch.from_numpy(a) for a in branch_case(20, 512, 128, KINDS * 4)]
    kw = dict(w=512, lmax=128, mpm=3, lsteps=112)
    seeds, sparse = measure.row_classes(case, kw)
    assert measure.scan_bound(case, kw, seeds, sparse) == (
        0.0010958698507462688, "operations", 0.0008157875820895522)


def test_bucket_cases_are_the_onchip_sweeps():
    """The bucket sweep chip_smoke.py runs on the card draws the inputs of
    tests/test_pallas_onchip.py: every (w, lmax) of its buckets, 192
    rows."""
    assert len(W_BUCKETS) * len(BUCKET_LMAXES) == 18
    for w in W_BUCKETS:
        for lmax in BUCKET_LMAXES:
            rng = np.random.default_rng(w * 1000 + lmax)
            want = onchip_case(rng, BUCKET_ROWS, w, lmax, min(112, lmax))
            got = bucket_case(w, lmax)
            assert len(got) == len(want)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x)


# --------------------------------------------------------- multihost bench
def test_multihost_bench(capsys):
    """(e) --hosts 2 on the CPU at a small scene: equal reports, the speedup
    and each rank's start-up times."""
    assert multihost_bench.main(["--hosts", "2", "--device", "cpu",
                                 "--chrom-len", "200000", "--events", "12",
                                 "--noise", "300"]) == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] is True and line["hosts"] == 2
    assert line["speedup"] > 0 and line["t1"] > 0 and line["tN"] > 0
    assert line["efficiency"] == pytest.approx(line["speedup"] / 2)
    assert [r["rank"] for r in line["ranks"]] == [0, 1]
    worker = line["ranks"][1]
    assert worker["windows"]
    assert 0 < worker["spawn_to_ready_s"] <= worker["spawn_to_first_window_s"]


# ------------------------------------------------------------ span report
def test_span_report_cli_args(small, capsys, tmp_path):
    """(f) ``span_report --rounds 1 --device cpu -- <a small text scene's
    CLI args>``: every pass's wall by mode, the span sums the benchmark's
    readers take, and a non-empty span tree under the root span, also
    written under ``--out``."""
    assert span_report.main(["--rounds", "1", "--device", "cpu", "--out",
                             str(tmp_path), "--", *small["text_argv"]]) == 0
    line = last_json(capsys.readouterr().out)
    assert line["tool"] == "span_report" and line["cell"] is None
    assert {m: len(w) for m, w in line["walls"].items()} == {
        "off": 2, "on": 2, "profiled": 2}
    assert set(SPAN_SUMS) <= set(line)
    assert line["root_s"] > 0 and line["entry_s"] > 0
    assert line["upload_mb"] > 0 and line["device"] == "cpu (no card)"
    assert line["tree"] and line["tree"][0][:2] == [0, "run: pass"]
    assert all(row[2] >= 0 for row in line["tree"])
    assert (tmp_path / "span_tree_cli_1.txt").read_text().strip()


# ---------------------------------------------------------- without a card
@pytest.mark.parametrize("tool", [kernel_bench, multihost_bench])
def test_tool_needs_a_card(tool):
    """Without --device cpu a tool raises where no card is visible; it
    does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


def test_tools_load_no_reference():
    """In a fresh interpreter the three tools and the scene module load no
    module of the JAX package and no jax."""
    import subprocess
    code = ("import sys\n"
            "import pindel_tpu_torch.testing.scenes\n"
            "import pindel_tpu_torch.tools.kernel_bench\n"
            "import pindel_tpu_torch.tools.multihost_bench\n"
            "import pindel_tpu_torch.tools.span_report\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pindel_tpu', 'jax', 'jaxlib')))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


# ------------------------------------------------------------- scene 1
def scene1_reports(d: str, backend: str):
    fa, reads_txt, _n = scenes.write_scene(d, **scenes.SCENE1)
    prefix = os.path.join(d, backend)
    assert reference_main(["-f", fa, "-p", reads_txt, *scenes.SCENE1_FLAGS,
                           "-o", prefix, "--backend", backend]) == 0
    return scenes.reports(prefix)


@pytest.mark.slow
def test_scene1_reference_digests(tmp_path):
    """The committed digests are those of the reference's reports (the
    JAX package's fused backend on the CPU here, which writes the same
    reports as its NumPy backend on scene 1 in a tenth of the time)."""
    assert scenes.digests(scene1_reports(str(tmp_path), "fused")) == \
        scenes.load_digests(scenes.SCENE1_DIGESTS)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-scene1-digests"]:
        sys.exit(f"usage: {SCENE1_COMMAND}")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        scenes.save_digests(scenes.SCENE1_DIGESTS,
                            scene1_reports(d, "numpy"), SCENE1_COMMAND)
