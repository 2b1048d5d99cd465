"""Each cell run on the card for a short window, through the command
that the benchmark's checks run. Skipped where torch sees no card."""
import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, str(run.PB / "run.py"), "--workload", cell,
         "--seed", str(2 ** 33 + 7 + trace), "--seconds", "5", "--trace",
         str(trace)], capture_output=True, text=True, timeout=1200,
        cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
