"""On the card: a short run of each cell prints a correct result, and the
control at the cells' own sizes fails a limit the program keeps.

    python -m pytest -m cuda h100_bench/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from h100_bench import control, spec

WORKLOADS = ["sp_lightglue.pairs", "sp_superglue.pairs"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_is_correct(workload):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_passes(workload):
    _card()
    lines = control.readings(workload, 2 ** 31 + 9, 1, torch.device("cuda"))
    prog = next(x for x in lines if x["side"] == "program")
    ctl = next(x for x in lines if x["side"] == "control")
    assert prog["correct"] is True, prog
    assert ctl["correct"] is False, ctl
