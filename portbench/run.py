"""Run one cell of the benchmark of libsnark_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json. It names a
configuration (``configs/<config>.json``: the system, the curve, the
sizes) and a traffic mix (``traffic/<mix>.json``: the parameters of
``generate.py``); ``systems/<system>.py`` drives the program and knows
its reference; each metric is read by ``metrics/<metric>.py``. Adding a
configuration, a mix, a metric or a cell adds files and entries only.

A run makes every input from ``--seed`` and builds the program's keys
(set-up), warms up on the cell's own shapes, then serves a closed loop
for ``--seconds``: each request is sent when the last returns, every
request started before the deadline runs to its end, and the window ends
with the last. After the window it reads the device's peak memory,
frees the program's state and holds a sample of the answers, drawn from
the seed and with the last request in it, against the plain reference.
With ``--trace 1`` the window runs under the program's spans and
``torch.profiler`` and the result holds the per-layer metrics; with
``--trace 0`` the end-to-end ones. The last line of standard output is
one JSON object; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# the run imports the harness as the package ``portbench`` and the program
# from the checkout's root, never the harness's files as top-level modules
if sys.path and Path(sys.path[0] or ".").resolve() == PB:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import devtrace, readers  # noqa: E402
from portbench.generate import load_module, rng  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "libsnark_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) that a run may
    not hold, compared whole: ``libsnark_tpu_torch`` is not
    ``libsnark_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT) -> tuple:
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, config, traffic


def metric_entries(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list the cell, or that list no cells and move (or
    are) a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def set_cache_dirs(root: Path = ROOT):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own build is libsnark_tpu_torch/build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = root / ".portbench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _sync(device: str):
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, serve: str = "program") -> dict:
    """One run of a cell; returns the result object. ``serve`` is
    ``"program"``, or ``"control"``: the reference at a lower precision
    in the program's place (``control.py``)."""
    import torch
    t_start = T_START if t_start is None else t_start
    cuda = device.startswith("cuda")
    system = load_module(PB / "systems" / f"{config['system']}.py",
                         f"portbench_system_{config['system']}").System(
        config, traffic, seed, device)
    stages = {"inputs": time.perf_counter() - t_start}
    if serve == "program":
        t = time.perf_counter()
        system.prepare()
        stages["program"] = time.perf_counter() - t
        t = time.perf_counter()
        system.warm_up()
        stages["warm_up"] = time.perf_counter() - t
        call, to_ints = system.request, system.as_ints
    else:
        call, to_ints = system.control_request, (lambda out: out)
    _sync(device)
    # the inputs are the harness's: keep them out of the collector's
    # full scans, which a prover holding one witness would not pay for
    gc.collect()
    gc.freeze()

    recorder = devtrace.SpanRecorder() if trace else None
    dtrace = devtrace.DeviceTrace(torch.device(device)) if (
        trace and cuda) else None
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    outs, requests = {}, []
    with contextlib.ExitStack() as stack:
        if recorder is not None:
            stack.enter_context(devtrace.installed_span_recorder(recorder))
        if dtrace is not None:
            stack.enter_context(dtrace)
        t0 = time.perf_counter()
        cpu0 = time.process_time()
        setup_s = t0 - t_start
        deadline = t0 + seconds
        i = 0
        while not requests or time.perf_counter() < deadline:
            laps = devtrace.Laps() if trace else None
            start = time.perf_counter()
            failed = False
            try:
                outs[i] = call(i, laps)
            except Exception:            # a request that fails is counted
                traceback.print_exc(file=sys.stderr)
                failed = True
            _sync(device)
            end = time.perf_counter()
            requests.append(readers.Request(
                i, start, end, failed,
                [] if laps is None else list(laps.spans)))
            i += 1
        t1 = requests[-1].end
        cpu_s = time.process_time() - cpu0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    run = readers.Run(setup_s=setup_s, t0=t0, t1=t1, requests=requests)
    if recorder is not None:
        for q in requests:
            q.spans += [s for s in recorder.spans
                        if q.start <= s[1] and s[2] <= q.end]
    if dtrace is not None:
        run.intervals = dtrace.intervals
        print(f"trace: {len(run.intervals)} device operations from "
              f"{run.intervals[0][1] - t0:+.6f} s to "
              f"{max(iv[2] for iv in run.intervals) - t1:+.6f} s of the "
              f"window's ends", file=sys.stderr)
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
          file=sys.stderr)
    took = [q.end - q.start for q in requests]
    print(f"requests: {len(took)} in {t1 - t0:.3f} s; seconds each: first "
          f"{took[0]:.3f}, median {statistics.median(took):.3f}, least "
          f"{min(took):.3f}, most {max(took):.3f}; the process's CPU "
          f"{cpu_s:.3f} s; in turn " + " ".join(f"{x:.3f}" for x in took),
          file=sys.stderr)
    if trace and serve == "program":
        run.msm_seconds = [system.msm_seconds(q.i) for q in requests]
    metrics = {}
    for m in metric_entries(bench, cell, trace):
        value = load_module(PB / "metrics" / f"{m['name']}.py",
                            f"portbench_metric_{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": False, "attempted": len(requests),
              "failed": sum(q.failed for q in requests),
              "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = devtrace.busy_seconds(run.intervals, t0, t1)
        dev["window_s"] = run.window_s
        spans = [s for q in requests for s in q.spans]
        result["breakdown"] = devtrace.breakdown(run.intervals, spans, t0, t1)

    # the reference, once the program's state is freed
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    done = [q.i for q in requests if not q.failed]
    pick = rng(seed, "check").sample(
        done[:-1], min(traffic["check_sample"] - 1, max(0, len(done) - 1)))
    sample = sorted(set(pick) | set(done[-1:]))
    wrong = sum(system.wrong_elements(j, to_ints(outs[j])) for j in sample)
    checks = {"wrong_elements": {"value": wrong, "max": 0},
              "failed_requests": {"value": result["failed"], "max": 0},
              "checked_requests": {"value": len(sample), "min": 1}}
    result["correct"] = all(
        c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
        for c in checks.values())
    result["checks"] = checks
    return result


def report(result: dict) -> int:
    """Print the numbers compared and the result; the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        limit = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} ({limit})", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, serve: str = "program") -> int:
    args = parse(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), serve=serve)
    return report(result)


if __name__ == "__main__":
    sys.exit(main())
