"""The port on BAM input, on the CPU: BAM + BreakDancer discovery, -q, -z
and -g scenes through the port's entry points must write report files
byte-identical to the JAX package's ``fused`` and ``numpy`` backends, and
to the golden files chip_smoke.py holds the card to.  Scene 2 of bench.py
is too large for the JSON: its reference reports are pinned by sha256 in
``scene2_digests.json``, checked by a slow test and rewritten with
``PYTHONPATH=. python tests/test_torch_bam.py --write-scene2-digests``."""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bamwriter as tools_bamwriter  # noqa: E402
from make_fai import make_fai  # noqa: E402

from pindel_tpu.__main__ import main as reference_main  # noqa: E402
from pindel_tpu_torch.__main__ import build_parser  # noqa: E402
from pindel_tpu_torch.__main__ import main as port_main  # noqa: E402
from pindel_tpu_torch.__main__ import settings_from_args  # noqa: E402
from pindel_tpu_torch.ops import engine_fused  # noqa: E402
from pindel_tpu_torch.pipeline import (run_assembly_files,  # noqa: E402
                                       run_dd_files, run_files)
from pindel_tpu_torch.profiling import g_fallback  # noqa: E402
from pindel_tpu_torch.testing import scenes  # noqa: E402
from pindel_tpu_torch.testing.scenes import (BAM_SCENES, SCENE2,  # noqa: E402
                                             bam_argv, load_golden,
                                             load_digests, reports)

# one intra-op thread: the test workers share the machine's cores, and
# torch's per-op thread pool oversubscribes them (the scan is many small ops)
torch.set_num_threads(1)

SCENE2_COMMAND = ("PYTHONPATH=. python tests/test_torch_bam.py "
                  "--write-scene2-digests")


def run_reference(scene, paths, prefix: str, backend: str):
    """``python -m pindel_tpu ... --backend <backend>`` on a built scene."""
    assert reference_main(bam_argv(scene, paths, prefix)
                          + ["--backend", backend]) == 0
    return reports(prefix)


def run_port(scene, paths, prefix: str):
    """The scene through the port's entry points on the CPU."""
    args = build_parser().parse_args(bam_argv(scene, paths, prefix))
    s = settings_from_args(args)
    if args.assembly:
        run_assembly_files(args.fasta, args.config, args.assembly, prefix,
                           settings=s, device="cpu")
    elif args.genotyping:
        assert port_main(bam_argv(scene, paths, prefix)) == 0
    elif args.detect_DD:
        run_dd_files(args.fasta, args.config, prefix, settings=s,
                     device="cpu")
    else:
        run_files(args.fasta, None, prefix, settings=s, device="cpu",
                  bam_config=args.config)
    return reports(prefix)


# ---------------------------------------------------- the BAM writer copy
def _cfg_bam(paths) -> str:
    with open(paths["cfg"]) as fh:
        return fh.read().split("\t")[0]


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", ["seed3", "bigdel", "rp_bigdel", "dd",
                                  "assembly"])
def test_scene_bams_match_tools(tmp_path, monkeypatch, name):
    """The port's copies of the BAM writer, of make_fai and of the anchored
    pair helper write the BAM and .fai bytes that the repository's tools
    write for the same scene."""
    from test_bam_channel import _pair
    builder = getattr(scenes, f"build_{name}")
    port_dir, tools_dir = tmp_path / "port", tmp_path / "tools"
    port_dir.mkdir()
    tools_dir.mkdir()
    port = builder(str(port_dir))
    monkeypatch.setattr(scenes, "write_bam", tools_bamwriter.write_bam)
    monkeypatch.setattr(scenes, "BamRecord", tools_bamwriter.BamRecord)
    monkeypatch.setattr(scenes, "pair", _pair)
    monkeypatch.setattr(scenes, "make_fai", make_fai)
    tools = builder(str(tools_dir))
    assert _read(_cfg_bam(port)) == _read(_cfg_bam(tools))
    assert _read(port["fa"] + ".fai") == _read(tools["fa"] + ".fai")


def _seed3_from_tests(d):
    from test_bam_channel import _scene_bam_and_text
    return _scene_bam_and_text(d, seed=3)[2]


def _dd_from_tests(d):
    from test_dd import _dd_scene
    return os.path.join(_dd_scene(d)[0], "dd.bam")


@pytest.mark.parametrize("builder,tests_build", [
    (scenes.build_seed3, _seed3_from_tests), (scenes.build_dd, _dd_from_tests),
])
def test_scene_bams_match_reference_tests(tmp_path, builder, tests_build):
    """The scenes copied from tests/test_bam_channel.py and tests/test_dd.py
    write the BAM those tests build."""
    port_dir, tests_dir = tmp_path / "port", tmp_path / "tests"
    port_dir.mkdir()
    tests_dir.mkdir()
    assert _read(_cfg_bam(builder(str(port_dir)))) == \
        _read(tests_build(tests_dir))


# ------------------------------------------------------- reports vs reference
# the -q, -z and -g scenes run in tests/test_torch_bam_modes.py, so that
# neither file holds up a test run split by file
MODE_SCENES = ("dd_q", "assembly_z", "genotype_g")


def check_scene_reports(tmp_path, name):
    """The scene through the port on the CPU writes the report files of
    pindel_tpu's fused and numpy backends, and the numpy ones are the
    golden files."""
    scene = BAM_SCENES[name]
    paths = scene.build(str(tmp_path))
    numpy_reports = run_reference(scene, paths, str(tmp_path / "numpy"),
                                  "numpy")
    assert load_golden()[name] == numpy_reports, (
        "golden_reports.json is stale: rewrite it with PYTHONPATH=. "
        "python tests/test_torch_pipeline.py --write-golden")
    win0 = engine_fused.FAR_WIN_ROWS
    port = run_port(scene, paths, str(tmp_path / "port"))
    if "-g" not in scene.flags:
        assert g_fallback.total > 0
        assert g_fallback.ratio() <= 0.01, (
            f"fallback ratio {g_fallback.ratio():.2%} "
            f"({g_fallback.fallback}/{g_fallback.total})")
    if scene.far_win:
        assert engine_fused.FAR_WIN_ROWS > win0
    fused_reports = run_reference(scene, paths, str(tmp_path / "fused"),
                                  "fused")
    for backend, ref in (("fused", fused_reports), ("numpy", numpy_reports)):
        assert set(ref) == set(port), backend
        for suffix, data in ref.items():
            assert port[suffix] == data, f"_{suffix} differs from {backend}"
    assert any(port.values())


@pytest.mark.parametrize("name", [n for n in BAM_SCENES
                                  if n not in MODE_SCENES])
def test_bam_scene_reports_match_reference(tmp_path, name):
    check_scene_reports(tmp_path, name)


def test_rp_library_failure_raises(tmp_path, monkeypatch):
    """A read-pair library that fails to build stops a BAM run, where
    bddata.modify_rp alone would run its Python re-statement silently."""
    import pindel_tpu_torch.bddata

    def broken():
        raise OSError("libptrp.so: build failed")

    monkeypatch.setattr(pindel_tpu_torch.bddata, "_native_rp", broken)
    paths = scenes.build_seed3(str(tmp_path))
    with pytest.raises(OSError, match="libptrp"):
        run_files(paths["fa"], None, str(tmp_path / "port"), device="cpu",
                  bam_config=paths["cfg"])


def test_bd_windows_find_the_big_deletion():
    """The 6 kb deletion lies beyond the -x 2 geometric ladder: it is found
    through the BreakDancer windows and not without them, as
    tests/test_breakdancer.py shows for the reference; the golden files
    hold what the port must write."""
    golden = load_golden()
    assert "D 6000" in golden["bam_bd_bigdel"]["D"].decode()
    assert "D 6000" not in golden["bam_bd_bigdel_nobd"]["D"].decode()
    # and through the window RP discovery makes of discordant pairs
    assert "D 6000" in golden["bam_rp_bigdel_w002"]["D"].decode()
    assert golden["bam_rp_bigdel_w002"]["RP"].count(b"\n") >= 2
    assert b"\tDD\t" in golden["dd_q"]["DD"]
    assert golden["assembly_z"]["ASM"]
    assert golden["genotype_g"]["GT"]


# ------------------------------------------------------------------ scene 2
def scene2_reports(d: str):
    paths = SCENE2.build(d)
    return run_reference(SCENE2, paths, os.path.join(d, "numpy"), "numpy")


@pytest.mark.slow
def test_scene2_reference_digests(tmp_path):
    """The committed digests are those of the reference's reports."""
    assert scenes.digests(scene2_reports(str(tmp_path))) == \
        load_digests(scenes.SCENE2_DIGESTS)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-scene2-digests"]:
        sys.exit(f"usage: {SCENE2_COMMAND}")
    import tempfile
    sys.path.insert(0, os.path.join(REPO, "tests"))
    with tempfile.TemporaryDirectory() as d:
        scenes.save_digests(scenes.SCENE2_DIGESTS, scene2_reports(d),
                            SCENE2_COMMAND)
