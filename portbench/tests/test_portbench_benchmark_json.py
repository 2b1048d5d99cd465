"""BENCHMARK.json holds to the benchmark's contract, and every file it
names is found by name, as a later PR's added files would be."""
import json
import re

import pytest

from portbench import generate, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for key, lo, hi in (("configs", 1, 24), ("workloads", 1, 24),
                        ("end_to_end", 1, 16), ("per_layer", 1, 128)):
        assert lo <= len(BENCH[key]) <= hi


def test_names_units_and_text():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names), key
        assert all(NAME.match(n) for n in names), key
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine = run.metric_entries(BENCH, w, False)
        assert "setup_s" in {m["name"] for m in mine}
        assert len(mine) >= 2
        assert run.metric_entries(BENCH, w, True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            w = {x["name"]: x for x in BENCH["workloads"]}[cell]
            assert m["moves"] in {x["name"]
                                  for x in run.metric_entries(BENCH, w, False)}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_are_found_by_name(w):
    """The cell's configuration, mix, system, circuit family and every
    metric reader load from their files by name."""
    bench, cell, config, traffic = run.load_cell(w["name"])
    entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    assert config["reduced"] == entry["reduced"]
    system = generate.load_module(run.PB / "systems" /
                                  f"{config['system']}.py", "s")
    assert hasattr(system, "System")
    if "circuit" in traffic:
        assert (run.PB / "circuits" / f"{traffic['circuit']}.py").is_file()
    for trace in (False, True):
        for m in run.metric_entries(bench, cell, trace):
            mod = generate.load_module(run.PB / "metrics" /
                                       f"{m['name']}.py", "m")
            assert callable(mod.read)


def test_an_added_metric_without_workloads_reaches_its_cells():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "x_ms.groth16", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "host path",
                               "moves": "proofs_per_s"})
    cells = {w["name"]: w for w in bench["workloads"]}
    g = run.metric_entries(bench, cells["groth16_bls12_377_2e20.dense"],
                           True)
    k = run.metric_entries(bench, cells["kzg10_bls12_377_2e22.commit_open"],
                           True)
    assert "x_ms.groth16" in {m["name"] for m in g}
    assert "x_ms.groth16" not in {m["name"] for m in k}


def test_budget_fits():
    """A full check with 24 cells fits its 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
