"""The VAE-GAN cell's files on the CPU: whole runs of the harness at a tiny
size in a temporary copy of the benchmark (a tiny configuration, mix and
cell added as new files beside those of perfbench/tests/tiny.py), the
sound program correct and each planted fault not, perfbench/calibrate.py
on the new kind, and the work count of a step at the published size. On
the card (marker `cuda`): perfbench/calibrate_vae_gan.py's readings for
one seed at the cell's own size, the program inside every limit and each
control and fault outside one."""

import json

import pytest
import torch

from perfbench import calibrate, harness, work_vae_gan
from perfbench.tests import tiny

CELL = "vae_gan_train_b16"
TINY = "tiny_vae_gan"
SEED = 2 ** 31 + 91


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """tiny.make_copy's benchmark with a tiny VAE-GAN cell: VAE ch 32,
    ch_mult (1, 2), the published 3-layer discriminator, 2 scans of
    2x64x32, the cell's own limits."""
    torch.set_num_threads(4)
    bench = tiny.make_copy(tmp_path_factory.mktemp("vae_gan"))
    cell = harness.Cell(CELL)
    cfg = json.loads(json.dumps(cell.config))
    cfg["vae"].update(ch=32, ch_mult=[1, 2])
    cfg.update(name=TINY, image_size=[64, 32], log_every=2)
    cfg["data"]["width"] = 32
    (bench / "configs" / f"{TINY}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{TINY}.json").write_text(json.dumps({
        "kind": "vae_gan_train", "batch": 2, "pool": 3, "check_steps": 3,
        "trace_steps": 2}))
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


def test_traced_run_reads_its_per_layer_metrics(bench):
    out = run(bench, trace=True)
    assert out["correct"], out["checks"]
    # no device operation on the CPU: the device readers read nothing
    assert set(out["metrics"]) == {"mfu.train", "trainer_init_s.train",
                                   "host_sync_ms_per_step.train"}
    assert 0 < out["metrics"]["mfu.train"]["value"] < 100


def _skip_disc_update(self, x):
    before = [p.detach().clone() for p in self.state.disc.parameters()]
    out = STEP(self, x)
    with torch.no_grad():
        for p, b in zip(self.state.disc.parameters(), before):
            p.copy_(b)
    return out


def _half_batch(self, batch):
    x = TO_DEVICE(self, batch)
    return x[:len(x) // 2]


STEP = TO_DEVICE = None


@pytest.mark.parametrize("fault", ["half_batch", "disc_skipped"])
def test_faults_are_caught(bench, fault, monkeypatch):
    global STEP, TO_DEVICE
    from rangeldm_tpu_torch.train_vae import VaeTrainer
    STEP, TO_DEVICE = VaeTrainer.train_step, VaeTrainer._to_device
    if fault == "half_batch":
        monkeypatch.setattr(VaeTrainer, "_to_device", _half_batch)
    else:
        monkeypatch.setattr(VaeTrainer, "train_step", _skip_disc_update)
    out = run(bench)
    assert not out["correct"], out["checks"]


def test_calibrate_reads_the_new_kind(bench):
    row = calibrate.readings(harness.Cell(TINY, bench), 5,
                             torch.device("cpu"), control=True,
                             fault="half_batch")
    limits = harness.Cell(CELL).spec["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["control"][k] > v for k, v in limits.items()), row
    assert any(row["fault"][k] > v for k, v in limits.items()), row


def test_work_of_a_step_at_the_published_size():
    """Counted on the reference on the meta device: the VAE's forward,
    backward and second forward and the discriminator's three passes and
    their backward, 1.0689 TFLOP a scan; a discriminator forward 15.34
    GFLOP a scan (0.245 TFLOP at 16)."""
    cfg = harness.Cell(CELL).config
    one = work_vae_gan.vae_gan_counts(cfg, 1)
    assert one["step"] / 1e9 == pytest.approx(1068.89, abs=0.005)
    assert one["disc_forward"] / 1e9 == pytest.approx(15.34, abs=0.005)
    assert one["step"] == one["gen_step"] + one["disc_step"]
    assert work_vae_gan.step_flops(cfg, 16) == pytest.approx(
        16 * one["step"])


@pytest.mark.cuda
def test_readings_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    from perfbench import calibrate_vae_gan
    cell = harness.Cell(CELL)
    row = calibrate_vae_gan.readings(cell, 2 ** 31 + 103,
                                     torch.device("cuda"))
    limits = cell.spec["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    for key in ("fp8", "bf16_ref", "bf16_run", "half_batch",
                "disc_skipped"):
        assert any(row[key][k] > v for k, v in limits.items()), (key, row)
