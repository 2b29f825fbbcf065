"""Nothing the harness runs imports JAX or the JAX package, and the plain
reference imports nothing of the port: compared by the whole top-level
name of each module (the part before the first dot), since the port's
name begins with the JAX package's."""
import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pindel_tpu"}


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(*parts):
    base = os.path.join(BENCH, *parts)
    for d, _subdirs, files in os.walk(base):
        if os.sep + "tests" in d[len(BENCH):] or "build" in d[len(BENCH):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def loaded(code):
    """The top-level names of the modules loaded after running ``code`` in
    a fresh interpreter started as ``benchmark/run.py`` starts."""
    prog = ("import sys; sys.path.insert(0, %r); sys.path.append(%r); "
            "%s; import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % (BENCH, ROOT, code))
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(res.stdout.splitlines()[-1]))


def test_no_source_of_the_benchmark_names_jax():
    for path in sources():
        bad = set(top_names(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_sources_name_nothing_of_the_port():
    for path in [*sources("refpindel"), os.path.join(BENCH, "bounds.py"),
                 os.path.join(BENCH, "judge.py")]:
        names = set(top_names(path))
        assert "pindel_tpu_torch" not in names, path
        assert not names & FORBIDDEN, path


def test_harness_loads_no_jax():
    got = loaded("import harness, control; "
                 "spec = harness.load_spec(); "
                 "[harness.cell_of(spec, w['name']) "
                 "for w in spec['workloads']]; "
                 "import pindel_tpu_torch.__main__")
    assert not got & FORBIDDEN, got & FORBIDDEN
    assert "pindel_tpu_torch" in got


def test_reference_loads_nothing_of_the_port():
    got = loaded("import refpindel.cli, refpindel.pipeline, bounds, judge")
    assert "pindel_tpu_torch" not in got
    assert not got & FORBIDDEN, got & FORBIDDEN
