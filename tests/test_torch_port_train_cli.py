"""The port's training command line (rangeldm_tpu_torch/train_ldm.py
`main`, `resume`, `save_final`, the sample dumps) and the modules under it
(utils/config.py, training/checkpoint.py, training/latent_cache.py,
training/image_logger.py, training/loggers.py) against the JAX package, on
the CPU at toy sizes.

* The config reader equals PyYAML on every shipped config; merging and
  `${ENV}` equal the JAX package's `load_config` + `expand_env`.
* `resume_from_checkpoint` follows the JAX package's grammar
  (tests/test_resume_grammar.py holds the JAX side to the same table).
* A resumed run equals an uninterrupted one bit for bit, because the
  checkpoint carries the generator's state.
* The run record in model_index.json equals the JAX package's, and
  `RangePipeline` takes its sensor and normalization from it.
* The latent cache's moments within 5e-4 of the JAX package's (f32, the
  same weights and images); the sample grid PNG decodes to the JAX
  package's pixels.
"""

import json
import os
import signal
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
import jax

from PIL import Image
from rangeldm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rangeldm_tpu.train_ldm import LdmTrainer as JaxLdmTrainer
from rangeldm_tpu.train_ldm import expand_env as jax_expand_env
from rangeldm_tpu.training import image_logger as jax_image_logger
from rangeldm_tpu.training import latent_cache as jax_latent_cache
from rangeldm_tpu.utils.config import Cfg as JaxCfg
from rangeldm_tpu.utils.config import load_config as jax_load_config

import chip_smoke
from conftest import synthetic_scan
from rangeldm_tpu_torch import train_ldm
from rangeldm_tpu_torch.data import datasets
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.pipelines import RangePipeline
from rangeldm_tpu_torch.training import image_logger, latent_cache
from rangeldm_tpu_torch.training.checkpoint import TrainCheckpointer
from rangeldm_tpu_torch.training.loggers import emergency_checkpoint
from rangeldm_tpu_torch.utils.config import expand_env, load_config
from test_torch_port_common import (
    assert_tb_equals_jsonl, jax_vae_params, port_vae,
)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "rangeldm_tpu" / "configs").glob("*.yaml"))
# a pixel-space model on (8, 32) images: DownBlock2D only, so no attention
# and a trainer builds in well under a second
PIXEL = {
    "model_config": {"sample_size": [32, 8], "in_channels": 3,
                     "out_channels": 2, "block_out_channels": [32, 32],
                     "down_block_types": ["DownBlock2D", "DownBlock2D"],
                     "up_block_types": ["UpBlock2D", "UpBlock2D"]},
    "with_vae": False, "lr_warmup_steps": 1, "tensorboard": False,
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- the config reader --------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reader_equals_pyyaml(path):
    assert len(CONFIGS) == 7
    assert load_config(str(path)) == yaml.safe_load(path.read_text())


def test_merge_and_env_expansion_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("KITTI360_DATASET", "/data/kitti")
    monkeypatch.delenv("NO_SUCH_VARIABLE", raising=False)
    override = tmp_path / "override.yaml"
    override.write_text(
        "# overrides\n"
        "output_dir: runs/${NO_SUCH_VARIABLE}x  # comment\n"
        "data:\n"
        "  width: 512\n"
        "  extra: [1, 2.5, 'a b', [true, null]]\n"
        "learning_rate: 2.0e-4\n"
        "resume_from_checkpoint: latest\n")
    paths = [str(ROOT / "rangeldm_tpu" / "configs" / "rangeldm_kitti360.yaml"),
             str(override)]
    got = expand_env(load_config(*paths, overrides={"seed": 3}))
    want = jax_expand_env(jax_load_config(*paths, overrides={"seed": 3}))
    assert got == want
    assert got["data"]["root"] == "/data/kitti"
    assert got["output_dir"] == "runs/x"
    assert got.data.width == 512 and got.data.used_feature == 2


REFUSED = {
    "anchor": "a: 1\nb: &anchor 2\n",
    "alias": "a: 1\nb: *anchor\n",
    "tag": "a: 1\nb: !!str 2\n",
    "block_scalar": "a: 1\nb: |\n  text\n",
    "flow_mapping": "a: 1\nb: {c: 1}\n",
    "second_document": "a: 1\n---\nb: 2\n",
    "block_sequence": "a: 1\nb:\n  - 2\n",
    "octal": "a: 1\nb: 017\n",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_config_reader_refuses_what_it_does_not_read(case, tmp_path):
    """Outside the subset the reader raises, naming the file and the line
    of the construct, instead of guessing."""
    path = tmp_path / "bad.yaml"
    path.write_text(REFUSED[case])
    with pytest.raises(ValueError, match=f"{path}:[23]: "):
        load_config(str(path))


# -- checkpoints and resume ---------------------------------------------

def _trainer(out_dir, **cfg):
    return train_ldm.LdmTrainer(dict(PIXEL, output_dir=str(out_dir), **cfg),
                                device="cpu")


def test_checkpoint_round_trip_and_rotation(tmp_path):
    tr = _trainer(tmp_path / "run")
    ckpt = TrainCheckpointer(tmp_path / "ckpts", total_limit=2)
    assert ckpt.latest_step() is None and ckpt.restore() is None
    rng = np.random.default_rng(0)
    saved = {}
    for step in (1, 2, 3):
        tr.fit([{"jpg": rng.standard_normal((2, 8, 32, 2))
                 .astype(np.float32)}], max_steps=step)
        assert tr.state.step == step
        ckpt.save(step, tr.state)
        saved[step] = tr.state.state_dict()
    assert ckpt.steps() == [2, 3]              # the oldest went
    assert sorted(os.listdir(ckpt.directory)) == ["checkpoint_2",
                                                  "checkpoint_3"]
    for step in (2, 3):
        got = ckpt.restore(step)
        assert got.keys() == saved[step].keys()
        for k, v in saved[step].items():
            assert (torch.equal(got[k], v) if torch.is_tensor(v)
                    else got[k] == v), k
    assert ckpt.restore()["step"] == 3 and ckpt.restore(1) is None
    # a second save of a step replaces it whole
    ckpt.save(3, tr.state)
    assert ckpt.steps() == [2, 3]
    # the JAX package's orbax layout is refused by name
    (tmp_path / "orbax" / "checkpoint_5" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        TrainCheckpointer(tmp_path / "orbax").restore()


@pytest.fixture(scope="module")
def run_with_checkpoints(tmp_path_factory):
    """A run directory with checkpoints at steps 1 and 3, and an empty
    one."""
    base = tmp_path_factory.mktemp("resume")
    tr = _trainer(base / "run")
    for step in (1, 3):
        tr.state.step = step
        tr.ckpt.save(step, tr.state)
    return base


# (resume_from_checkpoint, the run directory the trainer writes to) -> the
# restored step, or the error; the JAX side is tests/test_resume_grammar.py
RESUME = {
    "none": (None, "run", 0), "false": (False, "run", 0),
    "empty": ("", "run", 0), "true": (True, "run", 3),
    "latest": ("latest", "run", 3), "int_1_is_not_true": (1, "run", 1),
    "digits": ("1", "run", 1), "int": (3, "run", 3),
    "latest_fresh": ("latest", "fresh", 0), "true_fresh": (True, "fresh", 0),
    "root_path": ("<base>/run/checkpoints", "other", 3),
    "step_dir": ("<base>/run/checkpoints/checkpoint_1", "other", 1),
    "missing_step": (7, "run", FileNotFoundError),
    "zero_is_a_step": (0, "run", FileNotFoundError),
    "missing_path": ("<base>/nope", "other", FileNotFoundError),
    "missing_step_dir": ("<base>/run/checkpoints/checkpoint_2", "other",
                         FileNotFoundError),
}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resume_follows_the_jax_grammar(case, run_with_checkpoints):
    value, run, want = RESUME[case]
    base = run_with_checkpoints
    if isinstance(value, str):
        value = value.replace("<base>", str(base))
    tr = _trainer(base / run, resume_from_checkpoint=value)
    if want is FileNotFoundError:
        with pytest.raises(FileNotFoundError, match="resume_from_checkpoint"):
            tr.resume()
    else:
        assert tr.resume() == want and tr.state.step == want


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """Four steps straight against two steps, a checkpoint, a fresh
    trainer's resume and two more steps: every tensor of the train state
    (parameters, EMA, AdamW moments) and every scalar, the generator's
    state among them, bit for bit. Without the generator in the checkpoint
    the resumed run draws other noise and timesteps."""
    cfg = dict(PIXEL, scaling_factor=0.5, shifting_factor=0.1,
               checkpointing_steps=2)
    rng = np.random.default_rng(1)
    batches = [{"jpg": rng.standard_normal((2, 8, 32, 2)).astype(np.float32)}
               for _ in range(4)]
    straight = _trainer(tmp_path / "a", **cfg)
    straight.fit(batches, max_steps=4)
    first = _trainer(tmp_path / "b", **cfg)
    first.fit(batches[:2], max_steps=2)
    assert first.ckpt.steps() == [2]
    resumed = _trainer(tmp_path / "b", resume_from_checkpoint="latest", **cfg)
    assert resumed.resume() == 2
    resumed.fit(batches[2:], max_steps=4)
    want, got = straight.state.state_dict(), resumed.state.state_dict()
    assert got.keys() == want.keys()
    assert "generator" in got and got["adam_count"] == 4
    for k, v in want.items():
        assert (torch.equal(got[k], v) if torch.is_tensor(v)
                else got[k] == v), k


def test_emergency_checkpoint_saves_on_signal_and_on_error():
    saves = []
    main = threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGUSR1)
    with emergency_checkpoint(lambda: saves.append(1)) as poll:
        assert not poll() and saves == []
        if main:
            signal.raise_signal(signal.SIGUSR1)      # only sets the flag
            assert saves == []
            assert poll() and saves == [1]
    assert signal.getsignal(signal.SIGUSR1) == before
    saves.clear()
    with pytest.raises(RuntimeError, match="boom"):
        with emergency_checkpoint(lambda: saves.append(1)):
            raise RuntimeError("boom")
    assert saves == [1]


# -- the run record -----------------------------------------------------

def test_run_record_matches_jax_and_the_pipeline_honours_it(tmp_path):
    """A model trained with `data: {sensor: nuscenes}` and its own mean,
    std and log encoding: the port's model_index.json equals the JAX
    package's, and the loaded pipeline back-projects with that sensor and
    normalization instead of KITTI-360's defaults."""
    data = {"sensor": "nuscenes", "mean": 30.0, "std": 25.0, "log": True}
    cfg = dict(PIXEL, data=data, use_ema=True)
    jax_tr = JaxLdmTrainer(JaxCfg.wrap(dict(cfg,
                                            output_dir=str(tmp_path / "j"))))
    with open(os.path.join(jax_tr.save_final(), "model_index.json")) as f:
        want = json.load(f)
    port = _trainer(tmp_path / "p", data=data, use_ema=True)
    path = port.save_final()
    with open(os.path.join(path, "model_index.json")) as f:
        got = json.load(f)
    assert got == want
    assert got["sensor"] == "nuscenes" and got["normalization"] == {
        "mean": 30.0, "std": 25.0, "log": True, "inverse": False}

    pipe = RangePipeline.from_pretrained(path, device="cpu",
                                         dtype=torch.float32)
    assert pipe.sensor == "nuscenes"
    assert (pipe.spec.name, pipe.spec.mean, pipe.spec.std, pipe.spec.log,
            pipe.spec.inverse) == ("nuscenes", 30.0, 25.0, True, False)
    assert RangePipeline.from_pretrained(path, sensor="kitti360",
                                         device="cpu").sensor == "kitti360"


# -- the command line, the latent cache, the grids ----------------------

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """8 synthetic train scans in KITTI-360's raw layout."""
    root = tmp_path_factory.mktemp("kitti360")
    d = root / "data_3d_raw" / "2013_05_28_drive_0003_sync" / \
        "velodyne_points" / "data"
    d.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(8):
        synthetic_scan(rng).tofile(d / f"{i:010d}.bin")
    return root


MAIN_CASES = {
    # pixel space on (64, 64) images, checkpoint and dump at step 2
    "pixel": {"model_config": {
        "sample_size": [64, 64], "in_channels": 3, "out_channels": 2,
        "block_out_channels": [32, 32],
        "down_block_types": ["DownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "UpBlock2D"]},
        "with_vae": False},
    # a latent model trained from the cached moments of a tiny VAE
    "cache_latents": {"model_config": {
        "sample_size": [32, 32], "in_channels": 5, "out_channels": 4,
        "block_out_channels": [32, 32],
        "down_block_types": ["DownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "UpBlock2D"]},
        "vae_config": {"ch": 32, "ch_mult": [1, 2], "z_channels": 4,
                       "num_res_blocks": 1},
        "with_vae": True, "cache_latents": True},
}


@pytest.mark.parametrize("case", sorted(MAIN_CASES))
def test_main_trains_from_yaml_on_the_cpu(case, kitti_root, tmp_path,
                                         caplog):
    """`main(["--cfg", shipped, override, "--max_steps", "2", "--device",
    "cpu"])` on 8 scans at width 64: the log of both steps, the default
    TensorBoard event file equal to it with no warning, the rotated
    checkpoint, the sample grid, and a pipeline with its run record."""
    out = tmp_path / "run"
    override = dict(MAIN_CASES[case], output_dir=str(out),
                    data={"root": str(kitti_root), "width": 64},
                    train_batch_size=4, lr_warmup_steps=1,
                    checkpointing_steps=1, checkpoints_total_limit=1,
                    sample_every_steps=2, ddpm_num_inference_steps=2,
                    log_every=1, mixed_precision="no")
    path = chip_smoke.write_yaml(str(tmp_path / "override.yaml"), override)
    shipped = ROOT / "rangeldm_tpu" / "configs" / "rangedm_kitti360.yaml"
    launches = dict(kernels.LAUNCHES)
    tr = train_ldm.main(["--cfg", str(shipped), path, "--max_steps",
                         "2", "--device", "cpu"])
    assert kernels.LAUNCHES == launches       # the CPU runs no kernel
    assert tr.device.type == "cpu" and tr.state.step == 2
    log = [json.loads(r) for r in (out / "train_log.jsonl").read_text()
           .splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert_tb_equals_jsonl(out)
    assert "tensorboard" not in caplog.text.lower()
    assert os.listdir(out / "checkpoints") == ["checkpoint_2"]
    grid = np.asarray(Image.open(out / "samples" / "samples_step00000002.png"))
    assert grid.shape == (2 * 8 * 64, 64)      # 8 range rows, 8 intensity
    pipe = out / "pipeline"
    record = json.loads((pipe / "model_index.json").read_text())
    assert record["sensor"] == "kitti360" and record["image_size"] == [64, 64]
    assert (pipe / "vae").is_dir() == (case == "cache_latents")
    if case == "cache_latents":
        meta = json.loads((out / "latent_moments.npy.json").read_text())
        assert meta["n"] == 8 and meta["shape"] == [8, 32, 32, 8]
        assert meta["tag"].endswith(":float32")
    # the config was read as the shipped file with the override on top
    assert tr.cfg.model_config["sample_size"] == \
        MAIN_CASES[case]["model_config"]["sample_size"]
    assert tr.cfg.num_epochs == 100 and tr.cfg.data.sensor == "kitti360"


def test_precompute_moments_matches_jax_and_reuses_its_cache(kitti_root,
                                                             tmp_path):
    vcfg, vparams = jax_vae_params(seed=60)
    ds = datasets.RangeImageDataset(datasets.DatasetConfig(
        root=str(kitti_root), width=64))
    out = str(tmp_path / "moments.npy")
    logs = []
    got = np.array(latent_cache.precompute_moments(
        port_vae(vcfg, vparams), ds, batch_size=3, out_path=out, tag="a",
        log=logs.append))
    want = jax_latent_cache.precompute_moments(
        JaxAutoencoderKL(vcfg), {"params": vparams}, ds, batch_size=3)
    assert got.shape == (8, 32, 32, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    meta = json.loads(Path(out + ".json").read_text())
    assert meta == {"n": 8, "tag": "a",
                    "data_tag": latent_cache.dataset_fingerprint(ds),
                    "shape": [8, 32, 32, 8]}

    class NoEncode(torch.nn.Module):
        """A VAE that must not be called."""
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def encode_moments(self, x):
            raise AssertionError("the cache was not reused")

    logs.clear()
    again = latent_cache.precompute_moments(NoEncode(), ds, batch_size=3,
                                            out_path=out, tag="a",
                                            log=logs.append)
    assert logs == [f"[latent-cache] reusing {out}"]
    np.testing.assert_array_equal(again, got)
    with pytest.raises(AssertionError, match="not reused"):
        latent_cache.precompute_moments(NoEncode(), ds, batch_size=3,
                                        out_path=out, tag="b")
    # a changed tag recomputes and rewrites the sidecar
    vae2 = port_vae(vcfg, jax.tree.map(lambda p: p * 1.01, vparams))
    changed = latent_cache.precompute_moments(vae2, ds, batch_size=3,
                                              out_path=out, tag="b")
    assert json.loads(Path(out + ".json").read_text())["tag"] == "b"
    assert not np.array_equal(np.asarray(changed), got)
    assert (latent_cache.params_fingerprint(vae2)
            != latent_cache.params_fingerprint(port_vae(vcfg, vparams)))


def test_range_image_grid_png_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    images = rng.standard_normal((10, 8, 32, 2)).astype(np.float32)
    for kw in ({}, {"mean": 50.0, "std": 50.0, "max_images": 3}):
        image_logger.save_range_image_grid(images, str(tmp_path / "p.png"),
                                           **kw)
        jax_image_logger.save_range_image_grid(images,
                                               str(tmp_path / "j.png"), **kw)
        got = np.asarray(Image.open(tmp_path / "p.png"))
        want = np.asarray(Image.open(tmp_path / "j.png"))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    log = image_logger.ImageLogger(str(tmp_path / "logs"), every=8)
    jlog = jax_image_logger.ImageLogger(str(tmp_path / "jlogs"), every=8)
    assert [s for s in range(20) if log.should_log(s)] == \
        [s for s in range(20) if jlog.should_log(s)]
    log.log(4, samples=images)
    assert (tmp_path / "logs" / "samples_step00000004.png").exists()
