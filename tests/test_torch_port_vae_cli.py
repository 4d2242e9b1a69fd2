"""The port's VAE training and evaluation command lines
(rangeldm_tpu_torch/train_vae.py, eval_vae.py), the VAE loader of the
second stage (train_ldm.load_vae), `RangeLoader.seek` and `save_bev_png`,
on the CPU at toy sizes, held to the JAX package where it has a
counterpart.

* `train_vae.main` on a synthetic KITTI-360 root (64x32 images, batch 2,
  two batches an epoch): a run stopped at step 2 and resumed to step 3,
  in the next epoch, equals an uninterrupted run to step 3 bit for bit:
  the logged metrics, every tensor of the train state, and the final
  weights.
* `save_final`'s vae_sgm.safetensors loads in the JAX package's
  `load_sgm_vae`, decoding within 5e-4 of the port's decode.
* `eval_vae.evaluate` equals the JAX package's on the same weights, scans
  and posterior draws: MAE and PSNR within 1e-5 relative, chamfer within
  1e-4 relative (float32 sums over 2048 points).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax

from PIL import Image
from rangeldm_tpu.convert.sgm_vae import load_sgm_vae as jax_load_sgm_vae
from rangeldm_tpu.eval_vae import evaluate as jax_evaluate
from rangeldm_tpu.geometry import get_spec as jax_get_spec
from rangeldm_tpu.models.vae import AutoencoderKL as JaxVae
from rangeldm_tpu.models.vae import VaeConfig as JaxVaeConfig
from rangeldm_tpu.training.image_logger import save_bev_png as jax_bev_png

from conftest import synthetic_scan
from rangeldm_tpu_torch import eval_vae, train_vae
from rangeldm_tpu_torch.data.datasets import (
    DatasetConfig, RangeImageDataset, RangeLoader,
)
from rangeldm_tpu_torch.geometry import get_spec
from rangeldm_tpu_torch.train_ldm import load_vae
from rangeldm_tpu_torch.training.checkpoint import TrainCheckpointer
from rangeldm_tpu_torch.training.image_logger import save_bev_png
from test_torch_port_common import nhwc_to_torch, torch_to_nhwc

TRAIN_SCANS, HELD_OUT = 4, 4
WIDTH = 32
CFG = {
    "data": {"width": WIDTH}, "batch_size": 2, "log_every": 1,
    "checkpoint_every_steps": 2, "tensorboard": False,
    "vae": {"ch": 32, "ch_mult": [1]},
    "loss": {"disc_start": 2, "disc_num_layers": 2},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def write_yaml(path, cfg: dict) -> str:
    """A config in the block-YAML subset (nested mappings, flow lists,
    double-quoted strings)."""
    def lines(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                yield f"{indent}{k}:"
                yield from lines(v, indent + "  ")
            else:
                yield f"{indent}{k}: {json.dumps(v)}"
    with open(path, "w") as f:
        f.write("\n".join(lines(cfg, "")) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Synthetic scans in KITTI-360's raw layout: a train drive and the
    held-out drive 0000."""
    root = tmp_path_factory.mktemp("kitti360")
    rng = np.random.default_rng(8)
    for drive, n in (("2013_05_28_drive_0003_sync", TRAIN_SCANS),
                     ("2013_05_28_drive_0000_sync", HELD_OUT)):
        d = root / "data_3d_raw" / drive / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            synthetic_scan(rng).tofile(d / f"{i:010d}.bin")
    return str(root)


def _main(tmp, root, name, max_steps):
    out = str(tmp / name)
    cfg = dict(CFG, output_dir=out, data=dict(CFG["data"], root=root))
    path = write_yaml(tmp / f"{name}.yaml", cfg)
    trainer = train_vae.main(["--cfg", path, "--max_steps", str(max_steps),
                              "--device", "cpu"])
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return trainer, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory, kitti_root):
    """An uninterrupted run to step 3, and one stopped at 2 and resumed
    (one thread: a module fixture is set up before the autouse one)."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("vae_runs")
    whole, log = _main(tmp, kitti_root, "whole", 3)
    _main(tmp, kitti_root, "split", 2)
    resumed, log_b = _main(tmp, kitti_root, "split", 3)
    return whole, log, resumed, log_b


def test_resumed_run_equals_the_uninterrupted_one(runs):
    whole, log, resumed, log_b = runs
    assert [r["step"] for r in log] == [1, 2, 3]
    assert [r["step"] for r in log_b] == [1, 2, 3]
    drop = ("sps", "data_wait_frac")
    for a, b in zip(log, log_b):
        assert {k: v for k, v in a.items() if k not in drop} == {
            k: v for k, v in b.items() if k not in drop}, a["step"]
    # the GAN terms switch on at disc_start 2: the third batch on
    assert [r["disc_factor"] for r in log] == [0, 0, 1]
    assert all(np.isfinite(r["d_weight"]) and r["d_weight"] > 0
               for r in log[2:])
    a, b = whole.state.state_dict(), resumed.state.state_dict()
    assert a.keys() == b.keys()
    assert [k for k in a if not (torch.equal(a[k], b[k]) if torch.is_tensor(
        a[k]) else a[k] == b[k])] == []
    assert a["step"] == 3 and a["ema_updates"] == 3
    for name in ("vae_sgm.safetensors", "vae_sgm_ema.safetensors",
                 "val_metrics.json"):
        with open(os.path.join(whole.out_dir, name), "rb") as f1, \
                open(os.path.join(resumed.out_dir, name), "rb") as f2:
            assert f1.read() == f2.read(), name
    ckpt = TrainCheckpointer(os.path.join(whole.out_dir, "checkpoints"))
    assert ckpt.steps() == [2]
    with open(os.path.join(whole.out_dir, "val_metrics.json")) as f:
        val = json.load(f)
    assert val["step"] == 3 and np.isfinite(val["val/rec_loss_ema"])


def test_loader_seek_continues_the_epoch(kitti_root):
    ds = RangeImageDataset(DatasetConfig(root=kitti_root, width=WIDTH))
    a, b = RangeLoader(ds, batch_size=2), RangeLoader(ds, batch_size=2)
    first = [x["jpg"] for _ in range(2) for x in a]         # two epochs
    b.seek(3)
    rest = [x["jpg"] for x in b]
    assert len(rest) == 1
    assert all(np.array_equal(x, y) for x, y in zip(first[3:], rest))


def test_save_final_loads_in_jax_and_in_the_second_stage(runs, tmp_path):
    """vae_sgm.safetensors: JAX's load_sgm_vae decodes as the port does;
    train_ldm.load_vae reads it (and an sgm .ckpt) with the trained
    shapes; an orbax directory is refused by name."""
    whole = runs[0]
    path = os.path.join(whole.out_dir, "vae_sgm.safetensors")
    vae = load_vae(path).eval()
    assert vae.cfg == whole.vae_cfg
    assert all(torch.equal(v, whole.state.vae.state_dict()[k])
               for k, v in vae.state_dict().items())
    torch.save({"state_dict": vae.state_dict()}, tmp_path / "vae.ckpt")
    assert load_vae(str(tmp_path / "vae.ckpt")).cfg == whole.vae_cfg
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        load_vae(str(tmp_path / "orbax"))

    z = np.random.default_rng(9).standard_normal(
        (2, 64, WIDTH, 4)).astype(np.float32)
    jcfg = JaxVaeConfig(ch=32, ch_mult=(1,))
    want = jax.jit(lambda p: JaxVae(jcfg).apply(p, z, method="decode"))(
        jax_load_sgm_vae(path))
    with torch.no_grad():
        got = torch_to_nhwc(vae.decode(nhwc_to_torch(z)))
    assert float(np.abs(got - np.asarray(want)).max()) <= 5e-4


def test_evaluate_matches_jax(runs, kitti_root):
    """eval_vae.evaluate against the JAX package's on the trained weights
    and the held-out scans, with the JAX side's posterior draws (one split
    of its key per batch, eval_vae.py:51-56); count 3 at batch 2 takes one
    scan of the second batch."""
    whole = runs[0]
    vae = load_vae(os.path.join(whole.out_dir, "vae_sgm.safetensors"))
    params = jax_load_sgm_vae(os.path.join(whole.out_dir,
                                           "vae_sgm.safetensors"))
    ds = RangeImageDataset(DatasetConfig(root=kitti_root, width=WIDTH),
                           train=False)
    batches = [b for b in RangeLoader(ds, batch_size=2, shuffle=False,
                                      drop_last=False)]
    rng, noise = jax.random.PRNGKey(0), []
    for _ in batches:
        rng, sub = jax.random.split(rng)
        noise.append(nhwc_to_torch(jax.random.normal(sub, (2, 64, WIDTH, 4))))
    jspec, tspec = jax_get_spec("kitti360", width=WIDTH), get_spec(
        "kitti360", width=WIDTH)
    want = jax_evaluate(JaxVae(JaxVaeConfig(ch=32, ch_mult=(1,))), params,
                        batches, jspec, count=3)
    got = eval_vae.evaluate(vae, batches, tspec, count=3, noise=noise)
    assert got["count"] == want["count"] == 3
    for k, rtol in (("mae", 1e-5), ("psnr", 1e-5), ("chamfer", 1e-4)):
        assert got[k] == pytest.approx(want[k], rel=rtol), k


def test_eval_cli(runs, kitti_root, capsys, monkeypatch):
    """`python -m rangeldm_tpu_torch.eval_vae` prints the scores of the
    EMA weights; without --device it asks for the card. The CLI reads the
    sensor's own width; the test narrows the dataset to WIDTH."""
    monkeypatch.setattr(eval_vae, "DatasetConfig",
                        functools.partial(DatasetConfig, width=WIDTH))
    path = os.path.join(runs[0].out_dir, "vae_sgm_ema.safetensors")
    args = ["--vae", path, "--data", kitti_root, "--count", "2",
            "--batch_size", "2"]
    out = eval_vae.main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["count"] == 2 and all(np.isfinite(v) for v in out.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_vae.main(args)


def test_trainer_refuses_what_the_jax_package_refuses(tmp_path):
    base = dict(CFG, output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="disc_bev requires"):
        train_vae.VaeTrainer(dict(base, loss={"disc_bev": True}), "cpu")
    with pytest.raises(ValueError, match="needs loss.bev_perceptual"):
        train_vae.VaeTrainer(dict(base, loss={
            "perceptual_weight": 0.1, "perceptual_kind": "vgg"}), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_vae.VaeTrainer(base)
    trainer = train_vae.VaeTrainer(dict(base, batch_size=4, loss={
        "metakernel": False, "disc_ndf": 8, "disc_bev": True,
        "bev_rec_weight": 0.5}), "cpu")
    assert trainer.lr == pytest.approx(4 * 4.5e-6)
    assert type(trainer.state.disc).__name__ == "NLayerDiscriminator"


def test_save_bev_png_matches_jax(tmp_path):
    bev = np.random.default_rng(10).uniform(-0.2, 1.2, (24, 40))
    save_bev_png(bev, str(tmp_path / "port.png"))
    jax_bev_png(bev, str(tmp_path / "jax.png"))
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          np.asarray(Image.open(tmp_path / "jax.png")))
