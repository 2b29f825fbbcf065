"""The port stands on its own: no file of ``pindel_tpu_torch`` (nor
``chip_smoke.py``) imports the JAX package or jax, a
CLI run loads neither and takes its native libraries from ``pindel_tpu_torch/build/``, and the
host modules the port copied from the JAX package are the reference's
source with only the imports rewritten."""
import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pindel_tpu_torch")
REFERENCE = os.path.join(REPO, "pindel_tpu")

PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    if os.sep + "build" + os.sep not in p) + ["chip_smoke.py"]

# host modules copied unchanged apart from their imports, and the native
# sources, copied byte for byte
COPIED = ["config.py", "dna.py", "genome.py", "reads.py",
          "textindex.py", "cxxsort.py", "regions.py", "depth.py",
          "ops/search_np.py", "events/canonical.py",
          "events/detect.py", "report/reporter.py", "bddata.py",
          "genotyping.py", "parallel/payload.py", "pindel2vcf.py",
          "pindel2vcf4tcga.py", "sam2pindel.py", "bam2pindel.py",
          "somatic.py", "native/bamio.cpp",
          "native/detect.cpp", "native/packer.cpp", "native/rp.cpp",
          "native/seqmatch.cpp", "native/textscan.cpp"]
# copied modules that differ: module -> (its top-level names, or a class's
# ``Class.method`` names, that differ, why); the class's other methods are
# still held to the reference's
DIFFERS = {
    "pipeline.py": (
        ("make_backend_factory", "run_files", "Pipeline.run",
         "Pipeline._search_stage", "Pipeline._process_window",
         "Pipeline._window_reads_bam", "Pipeline._update_ref_coverage",
         "Pipeline.create_output_files", "Pipeline._window_rp_discovery"),
        "the port's entry points build torch backends; the reference's "
        "switch over its own backend names stays with it; the port's pass "
        "runs under a root span with spans for set-up, the reference-read "
        "coverage, the bookkeeping of a window, and update_bd and "
        "apply_bd_delta apart; reference reads as arrays, coverage by a "
        "difference array; a fused backend makes partner backends for "
        "the cross-chromosome route; an earlier run's _INT is removed at "
        "start, so a rerun under one prefix reports its calls once; RP "
        "discovery takes the window's discordant pairs collected at "
        "read-in"),
    "search.py": (
        ("Searcher._far_round",),
        "reads whose far-end lanes lie on another chromosome take the "
        "cross-chromosome route under its own span and counter: K4 on the "
        "partner backend of that chromosome where the device backend has "
        "one, the NumPy oracle for the rest"),
    "profiling.py": (
        ("Timer",),
        "the port's Timer records spans with parents and threads, opens "
        "each as a profiler range while recording, and sums under a lock"),
    "bam.py": (
        ("BamReader.__init__", "BamReader.collect_sr",
         "BamReader.collect_rp", "BamReader.collect_rp_gt",
         "BamReader.collect_dd", "BamReader.depth_sum"),
        "the port times the native decode and the building of the read "
        "objects as two spans (the objects in BamReader._sr_objects, "
        "which the reference lacks); reference reads as arrays, coverage "
        "by a difference array; collect_rp is the native walk "
        "(rp_pairs), which the window's read-in runs while the window is "
        "resident, and the objects built from it (rp_reads); every window "
        "query goes through BamReader._query, which counts the loads of "
        "the native window cache (profiling.g_bam)"),
    "dd.py": (("run_dd_files",),
              "-q's entry is pipeline.run_dd_files, on the port's factory"),
    "assembly.py": (("run_assembly_files",),
                    "-z's entry is pipeline.run_assembly_files, on the "
                    "port's factory"),
    "native/__init__.py": (
        ("_build",),
        "the libraries are built into pindel_tpu_torch/build/native/, "
        "not next to the sources"),
}


def _imported(node):
    """Module names an import statement names."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_reference_or_jax_imports(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    bad = [name for node in ast.walk(tree) for name in _imported(node)
           if name.split(".")[0] in ("pindel_tpu", "jax", "jaxlib")]
    assert not bad, f"{path} imports {bad}"


def test_cli_run_is_standalone(tmp_path):
    """The port's CLI on --device cpu over a pindel-text scene and a BAM
    scene with a BreakDancer file, in a fresh interpreter: it loads no
    module of the JAX package and no jax, and every native library it
    loaded lies under pindel_tpu_torch/build/."""
    from pindel_tpu_torch.testing.scenes import (BAM_SCENES, bam_argv,
                                                 build_bigdel, load_golden,
                                                 reports, write_scene)
    text_dir, bam_dir = tmp_path / "text", tmp_path / "bam"
    text_dir.mkdir()
    bam_dir.mkdir()
    fa, reads_txt, _n = write_scene(str(text_dir), seed=0)
    text_argv = ["-f", fa, "-p", reads_txt, "-o", str(text_dir / "cli"),
                 "-s", "--device", "cpu"]
    bam_argv_ = bam_argv(BAM_SCENES["bam_bd_bigdel"],
                         build_bigdel(str(bam_dir)),
                         str(bam_dir / "cli")) + ["--device", "cpu"]
    code = (
        "import sys\n"
        "from pindel_tpu_torch.__main__ import main\n"
        f"assert main({text_argv!r}) == 0\n"
        f"assert main({bam_argv_!r}) == 0\n"
        "from pindel_tpu_torch import native\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pindel_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print('LIBS', sorted(native._LIBS))\n"
        "for lib in native._LIBS.values():\n"
        "    print('LIB', lib._name)\n"
        "with open('/proc/self/maps') as fh:\n"
        "    for line in fh:\n"
        "        if line.rstrip().endswith('.so'):\n"
        "            print('MAP', line.split()[-1])\n")
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    libs = [line[4:] for line in out if line.startswith("LIB ")]
    assert "LIBS ['ptbam', 'ptdetect', 'ptpack', 'ptrp', 'pttext']" in out
    build = os.path.join(PORT, "build", "native") + os.sep
    assert libs and all(lib.startswith(build) for lib in libs), libs
    mapped = [line[4:] for line in out if line.startswith("MAP ")]
    assert not [m for m in mapped if m.startswith(REFERENCE + os.sep)]
    golden = load_golden()
    assert reports(str(text_dir / "cli")) == golden["seed0"]
    assert reports(str(bam_dir / "cli")) == golden["bam_bd_bigdel"]


def _canonical_imports(src: str, package: str) -> str:
    """``src`` with every import statement rewritten to one canonical line,
    ``package`` mapped to ``pindel_tpu`` in the modules it names."""
    lines = src.splitlines()
    nodes = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in sorted(nodes, key=lambda n: -n.lineno):
        if isinstance(node, ast.ImportFrom) and node.module:
            head = node.module.split(".")[0]
            if head == package:
                node.module = "pindel_tpu" + node.module[len(package):]
        for alias in getattr(node, "names", []):
            if alias.name.split(".")[0] == package:
                alias.name = "pindel_tpu" + alias.name[len(package):]
        lines[node.lineno - 1:node.end_lineno] = [
            " " * node.col_offset + ast.unparse(node)]
    return "\n".join(lines)


def _definitions(body, src: str, prefix: str = ""):
    """name -> source of each definition or assignment in ``body``; a
    class's methods and assignments also as ``Class.name``, and its
    docstring as ``Class.__doc__``."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[prefix + node.name] = ast.get_source_segment(src, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                out[prefix + ast.unparse(t)] = ast.get_source_segment(
                    src, node)
        if isinstance(node, ast.ClassDef) and not prefix:
            out[node.name + ".__doc__"] = ast.get_docstring(node)
            out.update(_definitions(node.body, src, node.name + "."))
    return out


def _top_level(src: str):
    """name -> source of each top-level definition or assignment, and of
    each class's members (``_definitions``)."""
    return _definitions(ast.parse(src).body, src)


@pytest.mark.parametrize("module", COPIED + sorted(DIFFERS))
def test_host_copy_matches_reference(module):
    with open(os.path.join(PORT, module)) as fh:
        port = fh.read()
    with open(os.path.join(REFERENCE, module)) as fh:
        reference = fh.read()
    if not module.endswith(".py"):
        assert port == reference, f"{module} differs from the reference"
        return
    port = _canonical_imports(port, "pindel_tpu_torch")
    reference = _canonical_imports(reference, "pindel_tpu")
    if module not in DIFFERS:
        assert port == reference, (
            f"{module} differs from the reference beyond its imports")
        return
    names, _why = DIFFERS[module]
    ours, theirs = _top_level(port), _top_level(reference)
    # a class with a differing method is held member by member
    opened = {n.split(".")[0] for n in names if "." in n}
    kept = [n for n in theirs if n not in names and n not in opened
            and not (n.split(".")[0] in names and "." in n)]
    assert kept and all(n in theirs for n in names)
    for name in kept:
        assert ours.get(name) == theirs[name], (
            f"{module}: {name} differs from the reference")
