"""BENCHMARK.json and the benchmark's files: every configuration, cell,
traffic mix and metric file loads, the names cross-reference, and names
and units keep to the allowed characters."""

import json
import re

import pytest

from perfbench import harness
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae

ROOT = harness.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", []):
            assert w in CELLS
    for cell in CELLS:
        reported = [m for m in e2e.values()
                    if cell in m.get("workloads", CELLS)]
        assert len(reported) >= 2, cell


def test_per_layer_metrics_move_and_cover_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"])
        moved = e2e[m["moves"]]
        # exactly the cells that report the metric it moves
        assert sorted(m["workloads"]) == sorted(moved.get("workloads",
                                                          CELLS))
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = harness.Cell(cell)
    assert {k: c.spec[k] for k in entry} == entry
    assert (harness.BENCH_DIR / "traffic" / f"{c.kind}.py").exists()
    assert c.spec["limits"] and all(v > 0 for v in c.spec["limits"].values())
    assert c.config["name"] == entry["config"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    path = ROOT / entry["file"]
    assert path.parent == harness.BENCH_DIR / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == config for w in BENCH["workloads"])
    ref_unet.param_shapes(cfg["model_config"])
    if cfg.get("vae_config"):
        ref_vae.param_shapes(cfg["vae_config"])
    # no checkpoint and no sample dump inside a window
    assert cfg["checkpointing_steps"] >= 10 ** 6
    assert "sample_every_steps" not in cfg


def test_files_are_named_from_names():
    for path in harness.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
