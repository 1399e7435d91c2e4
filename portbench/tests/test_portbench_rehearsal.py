"""A run of each cell on the CPU at a tiny size, end to end: set-up, the
window, the reference and the check.  There is no card here, so the
command line gives no result and a traced run refuses to fall back."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from portbench.reference.params import load_namelist
from portbench.run import ROOT, main, resolve, run_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = dict(device="cpu", columns=24, levels=8)


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_rehearsal_runs_end_to_end(workload):
    result, lines = run_cell(resolve(workload), 2**31 + 101, 0.3, False,
                             **TINY)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    # a CPU run reports no device number
    assert "device" not in result
    assert set(result["metrics"]) == {"columns_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    n = len(result["checks"])
    assert [line.split()[0] for line in lines[-n:]] == list(result["checks"])


def test_traced_run_needs_the_card():
    with pytest.raises(RuntimeError, match="no card"):
        run_cell(resolve(CELLS[0]), 7, 0.1, True, **TINY)


def test_command_line_without_a_card_exits_without_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1",
                 "--trace", "0"])
    assert code == 2
    assert capsys.readouterr().out == ""


def test_namelist_is_the_ports_default_parameter_set():
    from ocean_bgc_tpu_torch.params import ModelParams
    assert json.loads(json.dumps(dataclasses.asdict(ModelParams()))) == (
        load_namelist())


def test_the_run_never_loads_jax():
    code = ("import sys; from portbench.run import resolve, run_cell;"
            "run_cell(resolve(%r), 5, 0.1, False, device='cpu', columns=8,"
            " levels=6);"
            "from portbench.run import forbidden_modules;"
            "print(forbidden_modules())" % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
