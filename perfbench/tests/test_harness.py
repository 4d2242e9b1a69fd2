"""Whole runs of the harness on the CPU at a tiny size, in a temporary copy
of the benchmark with cells, configurations, mixes and a metric added as
new files: the sound program comes out correct, and with each fault that
a cell can have planted in the program, `correct` comes out false (the
limits are those of the benchmark's cells)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def run(bench, cell, trace=False):
    return harness.run(cell, SEED, 0.3, trace, device="cpu", root=bench)


@pytest.mark.parametrize("cell", [c for c, *_ in tiny.CELLS])
def test_sound_program_is_correct(bench, cell):
    out = run(bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


# -- faults planted in the program -------------------------------------

def _unchanged_ddim(self, model_out, t, t_prev, x, eta=0.0, noise=None):
    return x


def _unchanged_dpmpp(self, model_out, t, t_prev, x, prev_x0, h_prev,
                     use_first_order):
    return x, x, 1.0


def _half_batch_sampling(original):
    """Half the batch computed, the rest the mean of it."""
    def call(self, batch_size=1, **kw):
        half = original(self, batch_size=batch_size - batch_size // 2, **kw)
        rest = np.repeat(half.mean(axis=0, keepdims=True), batch_size // 2,
                         axis=0)
        return np.concatenate([half, rest])
    return call


def _one_scan_altered(original):
    def call(self, *a, **kw):
        out = original(self, *a, **kw)
        out[-1] = out[-1] * 0.9
        return out
    return call


@pytest.mark.parametrize("cell", ["tiny_sample_ddim", "tiny_sample_dpmpp"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_sampling_faults_are_caught(bench, cell, fault, monkeypatch):
    from rangeldm_tpu_torch.diffusion.schedule import Schedule
    from rangeldm_tpu_torch.pipelines.api import RangePipeline
    if fault == "unchanged":
        monkeypatch.setattr(Schedule, "ddim_step", _unchanged_ddim)
        monkeypatch.setattr(Schedule, "dpmpp_2m_step", _unchanged_dpmpp)
    elif fault == "half_batch":
        monkeypatch.setattr(RangePipeline, "__call__", _half_batch_sampling(
            RangePipeline.__call__))
    else:
        monkeypatch.setattr(RangePipeline, "__call__", _one_scan_altered(
            RangePipeline.__call__))
    out = run(bench, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny_train_ldm", "tiny_train_dm"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(bench, cell, fault, monkeypatch):
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    from rangeldm_tpu_torch.training.train_state import (
        TrainState, global_norm,
    )
    if fault == "unchanged":
        def no_update(self):
            return global_norm([p.grad for p in self.model.parameters()])
        monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    else:
        to_device = LdmTrainer._to_device

        def half(self, batch):
            out = to_device(self, batch)
            return {k: v[:len(v) // 2] for k, v in out.items()}
        monkeypatch.setattr(LdmTrainer, "_to_device", half)
    out = run(bench, cell)
    assert not out["correct"], out["checks"]


# -- the benchmark grows by new files only -------------------------------

def digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(p.relative_to(root).as_posix().encode() + p.read_bytes())
    return h.hexdigest()


def test_a_cell_and_a_metric_are_added_as_new_files(tmp_path):
    before = digest(harness.BENCH_DIR)
    bench = tiny.make_copy(tmp_path)
    (bench / "metrics" / "calls_profiled.sampling.py").write_text(
        "def read(record, work):\n"
        "    return float(record['units'])\n")
    bpath = bench.parent / "BENCHMARK.json"
    benchmark = json.loads(bpath.read_text())
    benchmark["per_layer"].append({
        "name": "calls_profiled.sampling", "unit": "calls",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": "sampling_scans_per_s", "workloads": ["tiny_sample_dpmpp"]})
    bpath.write_text(json.dumps(benchmark))
    out = harness.run("tiny_sample_dpmpp", 5, 0.2, True, device="cpu",
                      root=bench)
    assert out["metrics"]["calls_profiled.sampling"]["value"] == 1.0
    assert "breakdown" in out and "busy_s" in out["device"]
    assert digest(harness.BENCH_DIR) == before
