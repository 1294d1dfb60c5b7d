"""Every configuration, traffic mix, generator, reference and metric of
BENCHMARK.json is found by its name, and the file keeps the contract's
shape."""

import importlib
import json
import re

import pytest

from skbench.harness import HERE, ROOT, cell_of, load_file, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, want in keys.items():
        for e in BENCH[section]:
            assert set(e) == want, e
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[s]]
    assert len(names) == len(set(names))
    assert any(e["name"] == "setup_s" and e["bound"] <= 0.25 for e in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = cell_of(cell)
    assert c.chips == 1
    assert (HERE / "traffic" / f"{BENCH['workloads'][CELLS.index(cell)]['traffic']}.json").exists()
    corpus = importlib.import_module(f"skbench.corpora.{c.config['corpus']['generator']}")
    assert callable(corpus.make)
    ref = importlib.import_module(f"skbench.reference.{c.config['reference']}")
    assert callable(ref.check)
    assert c.traffic["flow"] in c.config["limits"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(load_file(HERE / "metrics" / f"{m['name']}.py").read)
    for m in c.per_layer:  # each per-layer metric's end-to-end metric is reported here
        assert m["moves"] in e2e


def test_configs_hold_their_reduced_keys():
    for e in BENCH["configs"]:
        cfg = json.loads((ROOT / e["file"]).read_text())
        assert cfg["name"] == e["name"]
        assert cfg["reduced"] == e["reduced"]
        for key in e["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank"))
    files = [e["file"] for e in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (HERE / "metrics").glob("*.py") if p.name != "__init__.py"}
    assert files == named
