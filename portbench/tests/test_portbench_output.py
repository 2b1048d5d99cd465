"""The run's output follows the benchmark's contract."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

from _small import GROTH16, run_small
from portbench import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_is_the_result_object():
    res = run_small(GROTH16, seed=2 ** 35 + 17)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert run.report(res) == 0
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last)[:5] == KEYS and list(last)[-1] == "checks"
    assert set(last["metrics"]) == {"proofs_per_s", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(last["device"])
    lines = err.getvalue().splitlines()
    assert [ln.split()[1] for ln in lines[-3:]] == list(last["checks"])


def test_traced_result_holds_the_per_layer_metrics():
    res = run_small(GROTH16, trace=True)
    # on the CPU the device's metric has nothing to read and is left out
    assert set(res["metrics"]) == {"host_ms.groth16",
                                   "witness_map_ms.groth16",
                                   "msm_ms.groth16", "msm_roofline.groth16"}
    assert 0 < res["metrics"]["msm_roofline.groth16"]["value"] < 100


def test_no_card_no_result(tmp_path):
    """Without a card the run exits with another code than 0 and prints
    nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(run.PB / "run.py"), "--workload", GROTH16,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness, the
    run exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", GROTH16, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
