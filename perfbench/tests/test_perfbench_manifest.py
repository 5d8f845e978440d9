"""The manifest and the files it names: every cell loads by its name,
with its configuration, traffic, limits and metric readers, and the
manifest keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c.mode in ("forecast", "train")
    assert harness.mode_module(c.mode).run
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gb"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    moved = {m["moves"] for m in c.per_layer}
    assert moved <= {m["name"] for m in c.end_to_end}


def test_names_units_and_entries():
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for entry in MANIFEST[group]:
            assert set(entry) <= keys, (group, entry)
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in entry:
                    assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    assert len(names) == len(set(names))


def test_bounds_and_chips():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


def test_config_files_state_their_cuts():
    for c in MANIFEST["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_embed", "hidden"))
        assert cfg["model"]["nlat"] == 721 and cfg["model"]["n_blocks"] == 10
        assert cfg["model"]["mlp_hidden"] == 1282
