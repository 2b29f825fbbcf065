"""The port end to end on the CPU: its reports must be byte-identical to
the JAX package's ``fused`` and ``numpy`` backends on simulated scenes, and
its runtime must not import jax.  The NumPy backend's reports are also the
golden files that chip_smoke.py holds the port to on the GPU machine, which
has no jax; ``PYTHONPATH=. python tests/test_torch_pipeline.py
--write-golden`` rewrites them, for these pindel-text scenes and for the
BAM scenes of tests/test_torch_bam.py."""
import os
import subprocess
import sys

import pytest
import torch

from pindel_tpu.config import Settings
from pindel_tpu.pipeline import run_files as run_files_reference
from pindel_tpu.testing import simulate as reference_simulate
from pindel_tpu_torch import config as port_config
from pindel_tpu_torch.__main__ import main
from pindel_tpu_torch.pipeline import run_files
from pindel_tpu_torch.profiling import g_fallback
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, SCENE1,
                                             SMALL_SCENES, bam_argv,
                                             build_bigdel, load_golden,
                                             reports, save_golden,
                                             write_scene)

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORTS = ("D", "SI", "TD", "INV", "LI", "BP", "INT", "INT_final", "RP",
           "CloseEndMapped")


def settings_s(settings_cls=Settings, **fields):
    """Settings of the JAX package, or of the port with
    ``settings_cls=port_config.Settings``, with -s set."""
    s = settings_cls(**fields)
    s.report_close_mapped_reads = True       # -s
    return s


def run_numpy_reference(d: str, scene: str):
    """The scene through pindel_tpu's NumPy backend: (paths, reports)."""
    scene_kw, _flags, fields = SMALL_SCENES[scene]
    fa, reads_txt, _n = write_scene(d, **scene_kw)
    prefix = os.path.join(d, "numpy")
    run_files_reference(fa, reads_txt, prefix, settings=settings_s(**fields),
                        backend="numpy")
    return (fa, reads_txt), reports(prefix)


@pytest.mark.parametrize("scene", list(SMALL_SCENES))
def test_reports_match_reference_backends(tmp_path, scene):
    _scene_kw, _flags, fields = SMALL_SCENES[scene]
    (fa, reads_txt), numpy_reports = run_numpy_reference(str(tmp_path),
                                                         scene)
    assert load_golden()[scene] == numpy_reports, (
        "golden_reports.json is stale: rewrite it with PYTHONPATH=. "
        "python tests/test_torch_pipeline.py --write-golden")
    run_files(fa, reads_txt, str(tmp_path / "port"),
              settings=settings_s(port_config.Settings, **fields),
              device="cpu")
    assert g_fallback.total > 0
    assert g_fallback.ratio() <= 0.01, (
        f"fallback ratio {g_fallback.ratio():.2%} "
        f"({g_fallback.fallback}/{g_fallback.total})")
    port = reports(str(tmp_path / "port"))
    assert set(port) >= {"D", "SI", "TD", "INV", "CloseEndMapped"}
    assert set(port) <= set(REPORTS)
    assert port["CloseEndMapped"]
    if not fields.get("report_only_close_mapped_reads"):
        assert b"ChrID" in port["D"] + port["INV"] + port["TD"]
    if fields.get("analyze_li"):
        assert b"\tLI\t" in port["LI"]
    prefix = str(tmp_path / "fused")
    run_files_reference(fa, reads_txt, prefix, settings=settings_s(**fields),
                        backend="fused")
    for backend, ref in (("fused", reports(prefix)),
                         ("numpy", numpy_reports)):
        assert set(ref) == set(port), backend
        for suffix, data in ref.items():
            assert port[suffix] == data, f"_{suffix} differs from {backend}"


@pytest.mark.parametrize("scene", [*SMALL_SCENES, "scene1_cut"])
def test_simulator_copy_matches_reference(tmp_path, scene):
    """The port's copy of the simulator writes the JAX package's scenes
    byte for byte (scene 1 cut to 300 kb and 4 reads per event)."""
    if scene == "scene1_cut":
        scene_kw = dict(SCENE1, chrom_len=300_000, reads_per_event=4,
                        n_noise=200)
    else:
        scene_kw = dict(SMALL_SCENES[scene][0])
    chrom = scene_kw.pop("chrom", "chrT")
    port_files = write_scene(str(tmp_path), chrom=chrom, **scene_kw)[:2]
    ref, _events, reads = reference_simulate.standard_scene(chrom=chrom,
                                                             **scene_kw)
    reference_simulate.write_fasta(str(tmp_path / "ref_want.fa"),
                                   [(chrom, ref)])
    reads.write(str(tmp_path / "reads_want.txt"))
    for got, want in zip(port_files, ("ref_want.fa", "reads_want.txt")):
        with open(got, "rb") as a, open(tmp_path / want, "rb") as b:
            assert a.read() == b.read(), want


def test_cli_runs_without_jax(tmp_path):
    """The port's CLI on --device cpu, in a fresh interpreter, on BAM input
    with a BreakDancer calls file: it writes the reports, finds the
    deletion only the BreakDancer windows reach, and never imports jax."""
    paths = build_bigdel(str(tmp_path))
    prefix = str(tmp_path / "cli")
    argv = bam_argv(BAM_SCENES["bam_bd_bigdel"], paths, prefix) + [
        "--device", "cpu"]
    code = (
        "import sys\n"
        "from pindel_tpu_torch.__main__ import main\n"
        "from pindel_tpu_torch.ops import engine_fused\n"
        f"rc = main({argv!r})\n"
        "assert rc == 0, rc\n"
        "assert engine_fused.FAR_WIN_ROWS > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    assert b"D 6000" in reports(prefix)["D"]


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fa, reads_txt, _n = write_scene(str(tmp_path), seed=4, chrom_len=20_000,
                                reads_per_event=2, kinds=["DEL"], n_noise=2)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-f", fa, "-p", reads_txt, "-o", str(tmp_path / "x"),
              "--device", "cuda"])


@pytest.mark.parametrize("flags,why", [
    (["--hosts", "2", "-S"], "-S is single-process"),
    (["-x", "5"], "ROADMAP")])
def test_cli_refuses_unported_modes(tmp_path, capsys, flags, why):
    with pytest.raises(SystemExit) as exc:
        main(["-f", "ref.fa", "-p", "reads.txt", "-o", str(tmp_path / "x"),
              "--device", "cpu", *flags])
    assert exc.value.code == 2
    assert why in capsys.readouterr().err


def write_golden() -> None:
    """Rewrites golden_reports.json from pindel_tpu's NumPy backend."""
    import tempfile

    from test_torch_bam import run_reference
    golden = {}
    for scene in SMALL_SCENES:
        with tempfile.TemporaryDirectory() as d:
            golden[scene] = run_numpy_reference(d, scene)[1]
    for name, scene in BAM_SCENES.items():
        with tempfile.TemporaryDirectory() as d:
            golden[name] = run_reference(scene, scene.build(d),
                                         os.path.join(d, "numpy"), "numpy")
    save_golden(golden)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_pipeline.py "
                 "--write-golden")
    write_golden()
