"""BENCHMARK.json holds to the benchmark's contract, every cell's files
load and name only files that exist, and a cell, a configuration, a traffic
mix and a per-layer metric are added by adding files and entries alone."""
import json
import os
import re
import shutil
import time

import pytest

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {"setup_s", "pairs_per_s"} <= {m["name"]
                                          for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_file_declares_its_entry(metric):
    reader = harness.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.LAYER == metric["layer"] and one_line(metric["layer"])
    assert reader.SOURCE == metric["source"]
    assert reader.MOVES == metric["moves"] == "pairs_per_s"
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("workload", SPEC["workloads"],
                         ids=[w["name"] for w in SPEC["workloads"]])
def test_cell_files_load(workload):
    cell = harness.cell_of(SPEC, workload["name"])
    cfg = {c["name"]: c for c in SPEC["configs"]}[workload["config"]]
    assert cfg["file"].startswith("benchmark/configs/")
    assert cell.config["name"] == cfg["name"]
    assert set(cell.config["reduced"]) == set(cfg["reduced"])
    assert os.path.isfile(os.path.join(
        BENCH, "gen", cell.config["generator"]["kind"] + ".py"))
    assert set(cell.traffic) == harness.TRAFFIC_KEYS
    assert cell.traffic["warmup_passes"] >= 1
    assert cell.per_layer, "every cell reports a per-layer metric"


def test_every_config_is_used_and_every_file_exists():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in SPEC["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("traffic", [
    {"warmup_passes": 1, "clients": 4}, {"warmup_passes": 0},
    {"warmup_passes": 1.5}, {}])
def test_a_traffic_file_with_another_key_or_value_is_refused(traffic):
    with pytest.raises(ValueError, match="traffic"):
        harness.check_traffic("t", traffic)


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A throwaway layout, configuration, traffic mix and metric, in a copy
    of the benchmark, make a cell that the harness loads and runs (on the
    CPU, traced, so the new metric is read); no file that was there is
    edited, only BENCHMARK.json gains entries."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "build", "__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "colo15_text.json")))
    cfg["name"] = "tiny_text"
    cfg["generator"] = dict(kind="one_chrom", chrom="chrT",
                            chrom_len=60_000, events=2)
    (bench / "configs" / "tiny_text.json").write_text(json.dumps(cfg))
    (bench / "gen" / "one_chrom.py").write_text(
        'from gen import text\n\nPARAMS = ("chrom", "chrom_len", "events")'
        '\n\n\ndef build(g, seed, d):\n'
        '    return text.build(dict(chrom=g["chrom"], chrom_len=g['
        '"chrom_len"], kinds=["DEL", "INV"], events_per_kind=g["events"], '
        'reads_per_event=10, n_noise=10, insert_size=500), seed, d)\n')
    (bench / "traffic" / "twice.json").write_text(json.dumps(
        {"warmup_passes": 2}))
    (bench / "metrics" / "passes_seen.py").write_text(
        'UNIT = "passes"\nLAYER = "harness"\nSOURCE = "program_counter"\n'
        'MOVES = "pairs_per_s"\n\n\ndef read(run):\n'
        '    return len(run.passes)\n')
    spec["configs"].append(dict(name="tiny_text", source="a test",
                                file="benchmark/configs/tiny_text.json",
                                reduced=[], why="a test"))
    spec["workloads"].append(dict(name="tiny_text.twice", config="tiny_text",
                                  traffic="twice", chips=1, why="a test"))
    spec["per_layer"].append(dict(name="passes_seen", unit="passes",
                                  better="higher", source="program_counter",
                                  layer="harness", moves="pairs_per_s",
                                  workloads=["tiny_text.twice"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.cell_of(harness.load_spec(str(root)), "tiny_text.twice",
                           root=str(root), bench_dir=str(bench))
    assert cell.traffic["warmup_passes"] == 2
    assert cell.config["generator"]["chrom_len"] == 60_000
    assert cell.generator.__file__ == str(bench / "gen" / "one_chrom.py")
    names = [m["name"] for m, _reader in cell.per_layer]
    assert "passes_seen" in names
    assert "roofline_pct.far_win" not in names
    cell.config["flags"] = cell.config["flags"] + ["-w", "0.02"]
    out = harness.run(cell, 5, 0.1, True, time.monotonic(), device="cpu")
    assert out["correct"]
    assert out["per_layer"]["passes_seen"] == (out["attempted"], "passes")
