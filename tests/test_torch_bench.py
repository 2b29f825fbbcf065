"""The port's measurement tools on the CPU (``pindel_tpu_torch.bench`` and
``pindel_tpu_torch.tools.{kernel,profile,multihost}_bench``): on small
scenes they run through the same code as on the card, write the same
reports as the repository's ``bench.py`` (the JAX package on the CPU),
print their JSON line, fail their gate when a report changes, and raise
without a card unless asked for the CPU.  Scene 1's reference digests
(``testing/scene1_digests.json``) are checked by a slow test and rewritten
with ``PYTHONPATH=. python tests/test_torch_bench.py
--write-scene1-digests`` (``python -m pindel_tpu --backend numpy``)."""
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
from pindel_tpu_torch import bench  # noqa: E402
from pindel_tpu_torch.testing import scenes  # noqa: E402
from pindel_tpu_torch.testing.scan_cases import (BUCKET_LMAXES,  # noqa: E402
                                                 BUCKET_ROWS, W_BUCKETS,
                                                 KINDS, branch_case,
                                                 bucket_case)
from pindel_tpu_torch.tools import (kernel_bench, measure,  # noqa: E402
                                    multihost_bench, profile_bench)
from test_pallas_onchip import _case as onchip_case  # noqa: E402

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

SCENE1_COMMAND = ("PYTHONPATH=. python tests/test_torch_bench.py "
                  "--write-scene1-digests")
# the keys of the bench's JSON line
BENCH_KEYS = {"metric", "value", "unit", "runs", "best", "spread",
              "fallback_ratio", "scene2_value", "scene2_runs",
              "scene2_fallback_ratio", "correct", "layers", "launches",
              "device"}
COARSE = ("Reading in reads", "Matching close ends", "Searching far ends",
          "Searching and reporting variations")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small pindel-text scene and a small BAM + BreakDancer scene, each
    with the reports of the repository's bench.py (``run_ours`` and
    ``run_ours_bam``: the JAX package's fused backend on the CPU), as the
    port's bench scenes with those reports' digests."""
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
        scene1=bench.text_scene("scene1", fa, reads_txt, n,
                                scenes.digests(want_text)),
        scene2=bench.bam_scene("scene2", paths, int(paths["pairs"]),
                               scenes.digests(want_bam)),
        reports=dict(scene1=want_text, scene2=want_bam))


@pytest.fixture
def small_scenes(small, monkeypatch):
    """The bench's scenes replaced by the small ones."""
    monkeypatch.setattr(bench, "SCENES", {
        key: (lambda d, key=key: small[key]) for key in ("scene1", "scene2")})
    return small


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# ------------------------------------------------------------------ bench
@pytest.mark.parametrize("key", ["scene1", "scene2"])
def test_bench_run_matches_reference_bench(small, key, tmp_path):
    """(a) The port's bench run writes the reports bench.py's run_ours /
    run_ours_bam write on the same files."""
    prefix = str(tmp_path / "port")
    result = bench.run(small[key], prefix, CPU)
    assert scenes.reports(prefix) == small["reports"][key]
    assert result["digests"] == small[key].want
    assert not bench.problems(small[key], [result], kernel=False)


def test_bench_json_line(small_scenes, capsys):
    """(b) The JSON line parses and has every key."""
    assert bench.main(["--device", "cpu", "--runs", "2"]) == 0
    line = last_json(capsys.readouterr().out)
    assert BENCH_KEYS <= set(line)
    assert line["correct"] is True
    assert line["metric"] == "split-reads/s"
    assert len(line["runs"]) == len(line["scene2_runs"]) == 2
    assert line["value"] > 0 and line["scene2_value"] > 0
    assert line["best"] >= line["value"] and line["spread"] >= 0
    assert line["launches"] == {"scene1": 0, "scene2": 0}   # no card
    for key in ("scene1", "scene2"):
        assert set(COARSE) <= set(line["layers"][key])
    assert line["device"] == "cpu (no card)"


@pytest.mark.parametrize("fault", ["report", "fallback"])
def test_bench_gate_fails(small_scenes, capsys, monkeypatch, fault):
    """(c) A changed report, or a fallback ratio above 1%, makes the bench
    exit 1 with ``"correct": false`` and a void value."""
    if fault == "report":
        def changed(prefix):
            got = scenes.reports(prefix)
            got["D"] += b"changed\n"
            return got
        monkeypatch.setattr(bench, "reports", changed)
    else:
        monkeypatch.setattr(bench.g_fallback, "ratio", lambda: 0.02)
    assert bench.main(["--device", "cpu", "--runs", "1"]) == 1
    out = capsys.readouterr()
    line = last_json(out.out)
    assert line["correct"] is False
    assert line["value"] == 0.0 and line["scene2_value"] == 0.0
    assert "GATE FAILED" in out.err


def test_bench_gate_rules(small):
    """An empty _D, launches that differ between runs and a card run that
    never launched the kernel each fail the gate."""
    scene = small["scene1"]
    ok = dict(digests=scene.want, d_empty=False, fallback=0.0, launches=3)
    assert not bench.problems(scene, [ok, ok], kernel=True)
    assert bench.problems(scene, [dict(ok, d_empty=True)], kernel=False)
    assert bench.problems(scene, [ok, dict(ok, launches=4)], kernel=True)
    assert bench.problems(scene, [dict(ok, launches=0)], kernel=True)
    assert not bench.problems(scene, [dict(ok, launches=0)], kernel=False)


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


# ---------------------------------------------------------- profile bench
def test_profile_bench(small_scenes, capsys, tmp_path):
    """(f) On the CPU: the coarse timer phases, the trace, no device share."""
    assert profile_bench.main(["--device", "cpu", "--scene", "1", "--runs",
                               "2", "--trace", str(tmp_path)]) == 0
    out = capsys.readouterr()
    for phase in COARSE:
        assert phase in out.err
    line = last_json(out.out)
    assert line["correct"] is True and len(line["runs"]) == 2
    assert set(COARSE) <= set(line["layers"])
    assert line["busy_share"] is None        # no device: not measured
    assert os.path.exists(tmp_path / "trace_scene1.json")


# ---------------------------------------------------------- without a card
@pytest.mark.parametrize("tool", [bench, kernel_bench, profile_bench,
                                    multihost_bench])
def test_tool_needs_a_card(tool):
    """Without --device cpu a tool raises where no card is visible; it
    does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


def test_tools_load_no_reference():
    """In a fresh interpreter the four tools load no module of the JAX
    package and no jax."""
    import subprocess
    code = ("import sys\n"
            "import pindel_tpu_torch.bench\n"
            "import pindel_tpu_torch.tools.kernel_bench\n"
            "import pindel_tpu_torch.tools.multihost_bench\n"
            "import pindel_tpu_torch.tools.profile_bench\n"
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
