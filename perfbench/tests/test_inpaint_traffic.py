"""The inpainting cell's files on the CPU: whole runs of the harness at a
tiny size in a temporary copy of the benchmark (a tiny inpainting
configuration, mix and cell added as new files beside those of
perfbench/tests/tiny.py), the sound program correct and each planted
fault not (a zeroed condition, half the batch, the state left unchanged),
and perfbench/calibrate.py on the new kind. On the card (marker `cuda`):
the float8 control at the cell's own size fails a limit that the
program passes."""

import json

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests import tiny

CELL = "inpaint_train_b32"
TINY = "tiny_inpaint"
SEED = 2 ** 31 + 93


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """tiny.make_copy's benchmark with a tiny inpainting cell: the tiny
    UNet at 4 + 5 input channels and no position channel, the tiny VAE,
    4 scans of 8x32x2 with the published share of the azimuth masked, the
    cell's own limits."""
    torch.set_num_threads(4)
    bench = tiny.make_copy(tmp_path_factory.mktemp("inpaint"))
    cell = harness.Cell(CELL)
    cfg = dict(cell.config, name=TINY, image_size=[8, 32], log_every=2,
               mixed_precision="no", vae_config=tiny.TINY_VAE,
               model_config=dict(tiny.TINY_UNET, in_channels=9))
    (bench / "configs" / f"{TINY}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{TINY}.json").write_text(json.dumps(dict(
        cell.mix, batch=4, pool=4, trace_steps=2, chunk=2)))
    (bench / "workloads" / f"{TINY}.json").write_text(json.dumps(dict(
        cell.spec, name=TINY, config=TINY, traffic=TINY)))
    path = bench.parent / "BENCHMARK.json"
    benchmark = json.loads(path.read_text())
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    path.write_text(json.dumps(benchmark))
    return bench


def run(bench, trace=False):
    return harness.run(TINY, SEED, 0.3, trace, device="cpu", root=bench)


def test_sound_program_is_correct(bench):
    out = run(bench)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s",
                                   "train_step_p95_ms"}
    assert set(out["checks"]) == set(harness.Cell(CELL).spec["limits"])
    assert out["checks"]["cond_gap"]["value"] < 1e-5


def test_traced_run_reads_its_per_layer_metrics(bench):
    out = run(bench, trace=True)
    assert out["correct"], out["checks"]
    # no device operation and no graph on the CPU: the device readers and
    # the graph's phases read nothing, and every step ran eager
    assert set(out["metrics"]) == {"mfu.train", "trainer_init_s.train",
                                   "host_sync_ms_per_step.train",
                                   "train_graph_replay_share.train"}
    assert 0 < out["metrics"]["mfu.train"]["value"] < 100
    assert out["metrics"]["train_graph_replay_share.train"]["value"] == 0


def _zero_condition(*args, **kw):
    z = ORIGINAL(*args, **kw)
    return torch.zeros_like(z)


ORIGINAL = None


@pytest.mark.parametrize("fault", ["zero_condition", "half_batch",
                                   "unchanged"])
def test_faults_are_caught(bench, fault, monkeypatch):
    global ORIGINAL
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    from rangeldm_tpu_torch.training import conditions
    from rangeldm_tpu_torch.training.train_state import (
        TrainState, global_norm,
    )
    if fault == "zero_condition":
        ORIGINAL = conditions._masked_image_cond
        monkeypatch.setattr(conditions, "_masked_image_cond",
                            _zero_condition)
    elif fault == "half_batch":
        to_device = LdmTrainer._to_device

        def half(self, batch):
            out = to_device(self, batch)
            return {k: v[:len(v) // 2] for k, v in out.items()}
        monkeypatch.setattr(LdmTrainer, "_to_device", half)
    else:
        def no_update(self):
            return global_norm([p.grad for p in self.model.parameters()])
        monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    out = run(bench)
    assert not out["correct"], out["checks"]


def test_calibrate_reads_the_new_kind(bench):
    row = calibrate.readings(harness.Cell(TINY, bench), 5,
                             torch.device("cpu"), control=True,
                             fault="half_batch")
    limits = harness.Cell(CELL).spec["limits"]
    # every gap is read; a run compares those the limits name
    assert set(row["program"]) == set(limits) | {"loss_gap"}
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["fault"][k] > v for k, v in limits.items()), row


def test_calibrate_inpaint_reads_the_program_controls_and_faults(bench):
    """perfbench/calibrate_inpaint.py on the CPU: the program inside every
    limit, the zeroed condition and the half batch outside one; no graph
    and no device operation here, so the phases read nothing."""
    from perfbench import calibrate_inpaint
    row = calibrate_inpaint.readings(harness.Cell(TINY, bench), 7,
                                     torch.device("cpu"), phase_steps=1)
    limits = harness.Cell(CELL).spec["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    for key in ("zero_condition", "half_batch"):
        assert any(row[key][k] > v for k, v in limits.items()), (key, row)
    assert row["zero_condition"]["cond_gap"] == 1.0
    assert row["phases"] == {"replay_ms": None, "eager_ms": {},
                             "device_ops": None, "ops_per_launch": []}


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = harness.Cell(CELL)
    row = calibrate.readings(cell, 2 ** 31 + 105, torch.device("cuda"),
                             control=True)
    limits = cell.spec["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["control"][k] > v for k, v in limits.items()), row
