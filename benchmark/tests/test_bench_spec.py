"""BENCHMARK.json and the files it names: every cell, configuration and
metric file parses and holds what the harness reads, and a cell or a metric
added as files only is found by its name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.held_out import HELD_OUT_CELLS, SPEC as ALL

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_files_parse(cell):
    c = harness.find_cell(cell, spec=ALL)
    assert c.entry["chips"] == 1 and len(c.entry["why"]) <= 200
    assert {"traffic", "check_steps", "calibration_steps", "trace_steps", "limits"} <= set(c.workload)
    assert set(c.workload["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    conf = [x for x in ALL["configs"] if x["name"] == c.entry["config"]][0]
    assert set(conf["reduced"]) <= set(c.config["changed"]) | {"train.number_of_iterations"}
    assert {"preset", "overrides", "init", "work", "reference", "problem", "settings"} <= set(c.config)
    assert conf["source"] == c.config["source"]
    assert callable(c.module("inits").initial_params) and callable(c.module("work").cell_work)
    assert callable(c.module("reference").follow_cell)


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_files_parse(metric):
    m = [x for x in ALL["per_layer"] if x["name"] == metric][0]
    assert callable(harness.load_metric(metric).read)
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert set(m["workloads"]) <= {w["name"] for w in ALL["workloads"]}
    assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_held_out_cells_stay_out():
    names = {w["name"] for w in SPEC["workloads"]}
    assert HELD_OUT_CELLS and not names & set(HELD_OUT_CELLS)
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= names


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    old = spec["workloads"][0]
    new = {**old, "name": old["name"] + "-half", "traffic": old["traffic"] + "-half"}
    spec["workloads"].append(new)
    spec["per_layer"].append({**spec["per_layer"][0], "name": "steps_traced"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    wl = json.loads((root / "benchmark" / "workloads" / f"{old['name']}.json").read_text())
    (root / "benchmark" / "workloads" / f"{new['name']}.json").write_text(json.dumps(wl))
    (root / "benchmark" / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    cell = harness.find_cell(new["name"], spec=spec, bench_dir=root / "benchmark")
    assert cell.workload == wl and cell.config["preset"]
    assert harness.load_metric("steps_traced", root / "benchmark").read(type("C", (), {"steps": 7})) == 7.0


def test_a_configuration_added_as_files_is_found(tmp_path):
    """A configuration whose initialiser, work counter and reference are new
    modules, with a cell of its own, is run from files alone: the harness
    finds each by the name in the configuration's file."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH, bench)
    spec = json.loads(json.dumps(SPEC))
    old = spec["workloads"][0]
    conf = [c for c in spec["configs"] if c["name"] == old["config"]][0]
    new_conf = {**conf, "name": "added", "file": "benchmark/configs/added.json"}
    spec["configs"].append(new_conf)
    spec["workloads"].append({**old, "name": "added.cell", "config": "added", "traffic": "cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    body = json.loads((harness.ROOT / conf["file"]).read_text())
    for kind, key in (("inits", "init"), ("work", "work"), ("reference", "reference")):
        shutil.copy(bench / kind / f"{body[key]}.py", bench / kind / f"added_{key}.py")
        body[key] = f"added_{key}"
    (bench / "configs" / "added.json").write_text(json.dumps(body))
    shutil.copy(bench / "workloads" / f"{old['name']}.json", bench / "workloads" / "added.cell.json")
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "cell = harness.find_cell('added.cell')\n"
        "files = [cell.module(k).__file__ for k in ('inits', 'work', 'reference')]\n"
        "flops = cell.module('work').cell_work(cell.settings, cell.config['problem'])['step']['flops']\n"
        "print(json.dumps({'files': files, 'flops': flops}))\n"
    ) % str(root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert [f.rsplit("/", 2)[-2:] for f in got["files"]] == [
        ["inits", "added_init.py"], ["work", "added_work.py"], ["reference", "added_reference.py"]]
    assert all(f.startswith(str(root)) for f in got["files"]) and got["flops"] > 0
