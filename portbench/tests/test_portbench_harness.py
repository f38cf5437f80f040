"""The harness resolves every name in BENCHMARK.json to its files, keeps
to the benchmark's contract on its own terms, and runs each cell end to
end on the CPU at a tiny size."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

import run
from yardstick import histories as H

from conftest import BENCH, ROOT, TINY, tiny

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_benchmark_names_resolve_to_files():
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert callable(H.generator(data["generator"]))
    for w in BENCHMARK["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = BENCH / "traffic" / f"{w['traffic']}.json"
        drv = run.driver(json.loads(traffic.read_text())["driver"])
        for part in ("program", "make_inputs", "step", "window", "to_host",
                     "work"):
            assert callable(getattr(drv, part)), (w["traffic"], part)
        assert drv.SPANS
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == set(configs)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert callable(run.reader(m["name"])), m["name"]


def test_benchmark_entries_keep_the_contract_shapes():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert {"histories_per_s", "batch_p95_ms", "setup_s"} <= set(e2e)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS)
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    for w in BENCHMARK["workloads"]:
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    depth, max_events = TINY[cell]
    c = tiny(cell, depth=depth, max_events=max_events)
    res = run.run_cell(cell, 2**31 + 101, 0.2, False, device="cpu", cell=c)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 8
    traced = run.run_cell(cell, 2**31 + 101, 0.2, True, device="cpu", cell=c)
    assert traced["correct"] is True
    # the CPU has no device trace: only the host clock's metric reads
    assert set(traced["metrics"]) == {"host_enqueue_ms"}
    assert traced["device"]["busy_s"] == 0.0


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_cli_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    stops before any result: the program is not there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "sys.path.insert(0, 'portbench/tests'); import run; "
            "from conftest import tiny; "
            "print(run.run_cell('retry_deep.storm_resident', 1, 0.1, False,"
            " device='cpu', cell=tiny('retry_deep.storm_resident')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "cadence_tpu_torch" in res.stderr
