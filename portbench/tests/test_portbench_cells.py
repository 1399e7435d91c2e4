"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the shape the harness reads."""

import json
import re
from pathlib import Path

import pytest

from portbench.check import NUMBERS, limits_for
from portbench.run import HERE, ROOT, reader, resolve

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    cell = resolve(workload)
    cfg = cell.config
    assert cfg["name"] == cell.config_name
    assert {"columns", "levels", "dtype", "dt_s", "world"} <= set(cfg)
    assert set(cfg["reduced"]) <= set(cfg["published"])
    for key in cfg["reduced"]:
        assert cfg[key] != cfg["published"][key]
    for key in set(cfg["published"]) - set(cfg["reduced"]):
        assert cfg[key] == cfg["published"][key]
    assert {"records", "hold_steps", "env_cache", "warmup_steps",
            "trace_steps", "perturb"} <= set(cell.mix)
    # every metric the cell reports has its reader, and it is callable
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names and len(cell.per_layer) >= 1
    for name in names:
        assert callable(reader(name))
    lim = limits_for(workload)
    assert set(lim["limits"]) == set(NUMBERS)


def test_benchmark_file_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        resolve("no-such-cell")


def test_checkout_without_the_program_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result line."""
    import shutil
    import subprocess
    import sys
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
