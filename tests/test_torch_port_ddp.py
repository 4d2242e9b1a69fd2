"""Data parallelism in the port (rangeldm_tpu_torch/parallel/mesh.py), on the
CPU: two gloo ranks, each a process started through `subprocess` with
torchrun's environment on a free port and its own timeout, against one
process on the global batch; and the local sampling mesh, a tuple of
devices, against the unsplit call (the JAX package's
tests/test_mesh.py and tests/test_sharded_sampling.py).

Bounds: two ranks take the step one process takes on the global batch up
to the summation order, so losses and gradients agree within 1e-5 of the
largest entry, and parameters within what one Adam step explains
(`chip_smoke.adam_update_mismatches`: Adam moves a parameter whose
gradient is rounding noise by up to lr either way). The ranks apply one
averaged gradient, so they agree bit for bit. Sampling on a mesh of
(cpu, cpu) draws what the unsplit call draws, within 1e-5 as in the JAX
package's tests; a split over processes writes the files one process
writes, byte for byte."""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_ddp_worker as worker
from conftest import synthetic_scan
from rangeldm_tpu_torch import sample_ldm
from rangeldm_tpu_torch.convert import save_diffusers_pipeline
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.parallel import mesh
from rangeldm_tpu_torch.pipelines import RangePipeline, pipeline
from rangeldm_tpu_torch.pipelines.pipeline import build_conditional_sampler
from rangeldm_tpu_torch.training.checkpoint import TrainCheckpointer
from rangeldm_tpu_torch.training.loggers import ScalarLogger

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_port_ddp_worker.py")
RANK_TIMEOUT = 180          # seconds a rank may take before the test fails
TOL = 1e-5
MESH_TOL = dict(rtol=1e-5, atol=1e-5)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, world: int = 2):
    """Run `python <args>` as `world` ranks with torchrun's environment on a
    free local port; every rank must exit 0 within RANK_TIMEOUT."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_VARS and k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, *map(str, args)], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def state_diff(a: dict, b: dict) -> list:
    """Keys on which two flat state dicts are not bit-equal."""
    assert a.keys() == b.keys()
    return [k for k in a if not (torch.equal(a[k], b[k])
                                 if torch.is_tensor(a[k]) else a[k] == b[k])]


def _ranks(out_dir, world=2):
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=True)
            for r in range(world)]


# -- two ranks against one process -------------------------------------

def test_ldm_step_on_two_ranks_equals_one_process(tmp_path):
    """Two flagship-shaped LdmTrainer steps on two gloo ranks of half the
    global batch each, against one process on the global batch."""
    ref = worker.run_ldm(str(tmp_path / "ref"))
    spawn([WORKER, "ldm_step", tmp_path])
    r0, r1 = _ranks(tmp_path)
    for step in range(worker.LDM_STEPS):
        assert state_diff(r0["states"][step], r1["states"][step]) == []
        assert r0["grads"][step].keys() == r1["grads"][step].keys()
        assert all(torch.equal(g, r1["grads"][step][n])
                   for n, g in r0["grads"][step].items())
    assert r0["loss"] == r1["loss"]
    # the first step starts from one state on both sides
    assert abs(r0["loss"][0] - ref["loss"][0]) <= TOL * abs(ref["loss"][0])
    grads, want = r0["grads"][0], ref["grads"][0]
    assert grads.keys() == want.keys() and len(want) > 50
    scale = max(float(g.abs().max()) for g in want.values())
    gaps = {n: float((grads[n] - g).abs().max()) for n, g in want.items()}
    assert max(gaps.values()) <= TOL * scale, max(gaps.items(),
                                                  key=lambda kv: kv[1])
    assert chip_smoke.adam_update_mismatches(
        r0["states"][0], ref["states"][0], ("model/", "ema/"),
        worker.LDM_CFG["learning_rate"], optimizer="adam",
        betas=(0.95, 0.999)) == []
    # every rank drew the global batch's numbers: the generators agree
    assert r0["states"][1]["generator"] == ref["states"][1]["generator"]


def _vae_reference(tmp_path):
    """The single process's steps on the global batch; its state after the
    generator step goes to the ranks' discriminator step."""
    from rangeldm_tpu_torch.models.vae import gaussian_sample
    from rangeldm_tpu_torch.train_vae import GEN, step_generator
    _, state, _, x = worker.vae_gan_setup()
    with torch.no_grad():
        moments = state.vae.encode_moments(x)
        b, c, *rest = moments.shape
        noise = torch.randn((b, c // 2, *rest),
                            generator=step_generator(worker.SEED, 0, GEN,
                                                     "cpu"))
        xrec = state.vae.decode(gaussian_sample(moments, noise=noise))
    # no pixel within rounding of the L1 kink, where two summation orders
    # would take opposite signs
    assert float((x - xrec).abs().min()) > 2e-5
    ref = worker.run_vae_gan()
    path = tmp_path / "ref_after_gen.pt"
    torch.save(ref["after_gen"], path)
    return ref, path


def test_vae_gan_steps_on_two_ranks_equal_one_process(tmp_path):
    """A generator and a discriminator step (MetaKernel discriminator with
    BatchNorm, past disc_start) on two gloo ranks against one process:
    the adaptive weight, every metric, the BatchNorm statistics of the
    global batch, and the parameters."""
    ref, ref_path = _vae_reference(tmp_path)
    spawn([WORKER, "vae_gan", tmp_path, ref_path])
    r0, r1 = _ranks(tmp_path)
    for key in ("after_gen", "after_disc"):
        assert state_diff(r0[key], r1[key]) == []
    for step in ("gen", "disc"):
        assert all(torch.equal(v, r1[step][k]) for k, v in r0[step].items())
        for k, v in ref[step].items():
            assert abs(float(r0[step][k]) - float(v)) <= TOL * max(
                abs(float(v)), 1e-3), (step, k)
    d_weight = float(ref["gen"]["d_weight"])
    assert float(ref["gen"]["disc_factor"]) == 1.0
    assert 0 < d_weight < 1e4 * 0.5, "d_weight at its clip"
    for key, prefixes in (("after_gen", ("vae/", "ema/", "logvar")),
                          ("after_disc", ("disc/",))):
        assert chip_smoke.adam_update_mismatches(
            r0[key], ref[key], prefixes, worker.VAE_LR) == [], key
        stats = [k for k in ref[key] if "running" in k]
        assert len(stats) == 4          # two BatchNorms, mean and variance
        for k in stats:
            gap = float((r0[key][k] - ref[key][k]).abs().max())
            assert gap <= TOL * float(ref[key][k].abs().max()), (key, k)
    # the global batch's statistics, not a rank's own half
    _, state, (gen_step, _), x = worker.vae_gan_setup()
    from rangeldm_tpu_torch.train_vae import GEN, step_generator
    gen_step(state, x[:2], generator=step_generator(worker.SEED, 0, GEN,
                                                    "cpu"))
    half, want = state.state_dict(), ref["after_gen"]
    assert max(float((half[k] - want[k]).abs().max())
               / float(want[k].abs().max()) for k in stats) > 10 * TOL


def test_a_signal_to_one_rank_saves_on_every_rank(tmp_path):
    """SIGUSR1 that reaches rank 1 alone: the ranks agree on it at the
    next poll and both run the (collective) save at the same step, where
    rank 0 alone would run on into the next step's all-reduce."""
    spawn([WORKER, "melk", tmp_path])
    assert [r["saved"] for r in _ranks(tmp_path)] == [[1], [1]]


def _kitti_root(path, train=8, held_out=2):
    rng = np.random.default_rng(8)
    for drive, n in (("2013_05_28_drive_0003_sync", train),
                     ("2013_05_28_drive_0000_sync", held_out)):
        d = path / "data_3d_raw" / drive / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            synthetic_scan(rng, n=6000).tofile(d / f"{i:010d}.bin")
    return str(path)


def _write_yaml(path, cfg: dict) -> str:
    def lines(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                yield f"{indent}{k}:"
                yield from lines(v, indent + "  ")
            else:
                yield f"{indent}{k}: {json.dumps(v)}"
    path.write_text("\n".join(lines(cfg, "")) + "\n")
    return str(path)


def test_two_rank_vae_cli_resumes_as_it_runs(tmp_path):
    """`train_vae` on two gloo ranks: rank 0 alone writes each checkpoint,
    the log, the validation and the final weights, each rank its own image
    grids; a run resumed from step 2 ends on the uninterrupted run's
    checkpoint_4, bit for bit."""
    root = _kitti_root(tmp_path / "kitti")
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cfg = {"data": {"root": root, "width": 32}, "batch_size": 2,
           "log_every": 1, "checkpoint_every_steps": 2,
           "log_images_every": 4, "tensorboard": False,
           "vae": {"ch": 32, "ch_mult": [1]},
           "loss": {"disc_start": 2, "disc_num_layers": 2}}
    cli = ["-m", "rangeldm_tpu_torch.train_vae", "--max_steps", "4",
           "--device", "cpu", "--cfg"]
    spawn(cli + [_write_yaml(tmp_path / "a.yaml",
                             dict(cfg, output_dir=str(out_a)))])
    ckpts = out_a / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["checkpoint_2", "checkpoint_4"]
    log = [json.loads(line) for line in
           (out_a / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert [r["disc_factor"] for r in log] == [0, 0, 1, 1]
    assert sorted(os.listdir(out_a / "images")) == sorted(
        f"{kind}_step{s:08d}_p{r}.png" for kind in ("inputs",
                                                    "reconstructions")
        for s in (1, 2, 4) for r in (0, 1))
    assert {"vae_sgm.safetensors", "vae_sgm_ema.safetensors",
            "val_metrics.json"} <= set(os.listdir(out_a))

    shutil.copytree(ckpts, out_b / "checkpoints")
    shutil.rmtree(out_b / "checkpoints" / "checkpoint_4")
    outs = spawn(cli + [_write_yaml(tmp_path / "b.yaml",
                                    dict(cfg, output_dir=str(out_b)))])
    assert all("[resume] restored step 2" in out for out in outs)
    a = TrainCheckpointer(str(ckpts)).restore(4)
    b = TrainCheckpointer(str(out_b / "checkpoints")).restore(4)
    assert state_diff(a, b) == []


def test_vae_learning_rate_is_the_config_batch_times_the_base_rate(
        tmp_path, monkeypatch):
    """The JAX package's rule at any world size: base_learning_rate x
    batch_size, the batch one rank loads. The reference's Lightning run
    also multiplies by the number of GPUs (a known divergence,
    ROADMAP.md)."""
    from rangeldm_tpu_torch.train_vae import VaeTrainer
    cfg = {"batch_size": 4, "base_learning_rate": 1e-5,
           "vae": {"ch": 32, "ch_mult": [1]}, "loss": {"disc_num_layers": 2},
           "data": {"width": 32}, "output_dir": str(tmp_path),
           "tensorboard": False}
    one = VaeTrainer(cfg, device="cpu").lr
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    assert VaeTrainer(cfg, device="cpu").lr == one == pytest.approx(4e-5)


def _tiny_pipe(cond_channels=0, pos_encoding=True, with_vae=True):
    """A pipe dict of seeded toy models in float32 on the CPU."""
    in_ch = 4 + cond_channels + int(pos_encoding)
    ucfg = UNetConfig(sample_size=(4, 32), in_channels=in_ch,
                      out_channels=4, block_out_channels=(32, 32),
                      down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                      up_block_types=("AttnUpBlock2D", "UpBlock2D"))
    vcfg = VaeConfig(ch=32, ch_mult=(1, 2), z_channels=4,
                     num_res_blocks=1) if with_vae else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = UNet2D(ucfg).eval().requires_grad_(False)
        vae = (AutoencoderKL(vcfg).eval().requires_grad_(False)
               if with_vae else None)
    return dict(meta={"pos_encoding": pos_encoding}, unet=unet,
                unet_cfg=ucfg, vae=vae, vae_cfg=vcfg,
                schedule=Schedule(ScheduleConfig()),
                device=torch.device("cpu"), dtype=torch.float32)


def test_two_rank_sampling_writes_the_files_of_one_process(tmp_path):
    """`sample_ldm` split over two processes (ranks 0 and 1 take batches
    0, 2 and 1) writes the files one process writes."""
    pipe = _tiny_pipe()
    path = str(tmp_path / "pipeline")
    save_diffusers_pipeline(path, pipe["unet"], pipe["vae"],
                            {"num_train_timesteps": 1000},
                            record={"pos_encoding": True})
    args = ["--pipeline", path, "--samples", "5", "--batch_size", "2",
            "--steps", "2", "--device", "cpu"]
    one, two = tmp_path / "one", tmp_path / "two"
    assert sample_ldm.main(args + ["--out", str(one)]) == 5
    outs = spawn(["-m", "rangeldm_tpu_torch.sample_ldm", *args,
                  "--out", two])
    assert "process 0/2" in outs[0] and "wrote 3 samples" in outs[0]
    assert "process 1/2" in outs[1] and "wrote 2 samples" in outs[1]
    files = sorted(os.listdir(one))
    assert files == sorted(os.listdir(two)) and len(files) == 15
    for f in files:
        assert (one / f).read_bytes() == (two / f).read_bytes(), f


# -- the local mesh ----------------------------------------------------

def test_largest_divisible_prefix():
    """The 'auto' policy: the largest k <= n dividing the batch, floor 1."""
    f = mesh.largest_divisible_prefix
    assert f(8, 16) == 8
    assert f(8, 6) == 6
    assert f(4, 9) == 3
    assert f(8, 7) == 7
    assert f(8, 1) == 1
    assert f(1, 5) == 1
    with pytest.raises(ValueError, match="must be positive"):
        f(8, 0)


@pytest.fixture
def eight_cards(monkeypatch):
    """Eight visible cards, for the policies that only count them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    return torch.device("cuda", 0)


def test_resolve_sampling_mesh_policy(eight_cards, monkeypatch):
    def size(*args):
        m = pipeline.resolve_sampling_mesh(*args, eight_cards)
        return len(m)

    assert size("auto", 16) == 8
    assert size("auto", 6) == 6
    assert size("1", 16) == 1
    assert size("4", 16) == 4
    assert size("auto", 7) == 7
    with pytest.raises(ValueError, match="local devices"):
        size("64", 64)
    assert pipeline.resolve_sampling_mesh("auto", 16, torch.device(
        "cuda", 3))[:2] == (torch.device("cuda", 3), torch.device("cuda", 0))
    # RangePipeline(mesh="auto") takes the same prefix for each call
    auto = RangePipeline(dict(_tiny_pipe(), device=eight_cards), mesh="auto")
    for batch in (16, 6, 3):
        assert auto._mesh_for_batch(batch) == pipeline.resolve_sampling_mesh(
            "auto", batch, eight_cards)
    with pytest.raises(ValueError, match="'auto'"):
        RangePipeline(_tiny_pipe(), mesh="all")
    # under torchrun each rank owns its card only
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert size("auto", 16) == 1
    assert pipeline.resolve_sampling_mesh("auto", 4, "cpu") == (
        torch.device("cpu"),)


def test_default_device_is_the_local_rank_card(eight_cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mesh.resolve_device(None) == torch.device("cuda", 0)
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert mesh.resolve_device(None) == torch.device("cuda", 5)
    assert mesh.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "8")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 8 has no card"):
        mesh.resolve_device(None)


def test_single_process_helpers_are_no_ops(tmp_path, monkeypatch):
    assert mesh.process_shard() == (0, 1) and mesh.is_primary()
    t = torch.arange(4.0)
    mesh.all_reduce_mean_([t])
    mesh.broadcast_([t])
    mesh.barrier("nothing")
    assert torch.equal(t, torch.arange(4.0))
    assert mesh.all_reduce_sum(t) is t
    g = torch.Generator().manual_seed(1)
    assert torch.equal(mesh.global_draw(lambda s: torch.randn(
        s, generator=g), (3, 2)), torch.randn((3, 2), generator=torch.
                                              Generator().manual_seed(1)))
    # rank 1 of 2 (torchrun's variables, no group) writes no shared file
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert mesh.process_shard() == (1, 2) and not mesh.is_primary()
    path = TrainCheckpointer(str(tmp_path / "ckpt")).write(3, None)
    assert path.endswith("checkpoint_3") and not os.path.exists(path)
    ScalarLogger(str(tmp_path / "log")).log(1, {"loss": 1.0})
    assert not (tmp_path / "log").exists()


CPU2 = (torch.device("cpu"),) * 2


def _spy_batches(pipe):
    """The batch sizes the UNet sees, recorded by a forward hook."""
    seen = []
    pipe["unet"].register_forward_hook(
        lambda m, args, out: seen.append(args[0].shape[0]))
    return seen


@pytest.mark.parametrize("with_vae,method", [
    (True, "ddim"), (False, "ddim"), (False, "ddpm"), (True, "dpmpp")])
def test_build_sampler_on_a_mesh_equals_one_device(with_vae, method):
    pipe = _tiny_pipe(with_vae=with_vae)
    seen = _spy_batches(pipe)
    ref = pipeline.build_sampler(pipe, 4, 3, method)(
        torch.Generator().manual_seed(7))
    assert set(seen) == {4}
    seen.clear()
    got = pipeline.build_sampler(pipe, 4, 3, method, mesh=CPU2)(
        torch.Generator().manual_seed(7))
    assert seen == [2] * 6          # two chunks a step
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **MESH_TOL)


@pytest.mark.parametrize("mode", ["upsample", "inpainting"])
def test_conditional_sampler_on_a_mesh_equals_one_device(mode):
    rng = np.random.default_rng(0)
    if mode == "upsample":
        # beams / 2 unshuffled by the VAE's factor 2 onto the 4x32 latent
        pipe = _tiny_pipe(cond_channels=4, pos_encoding=False)
        inputs = {"down": rng.standard_normal((4, 4, 64, 2))}
    else:
        pipe = _tiny_pipe(cond_channels=5, pos_encoding=False)
        inputs = {"masked_image": rng.standard_normal((4, 8, 64, 2)),
                  "inpainting_mask": np.sign(rng.standard_normal(
                      (4, 8, 64, 1)))}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    seen = _spy_batches(pipe)
    ref = build_conditional_sampler(pipe, 4, mode, 3, factor=2)(
        torch.Generator().manual_seed(11), inputs)
    seen.clear()
    got = build_conditional_sampler(pipe, 4, mode, 3, factor=2, mesh=CPU2)(
        torch.Generator().manual_seed(11), inputs)
    assert seen == [2] * 6
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **MESH_TOL)


def test_range_pipeline_on_a_mesh_equals_one_device():
    base = RangePipeline(_tiny_pipe())
    split = RangePipeline(_tiny_pipe(), mesh=CPU2)
    a = base(batch_size=4, num_inference_steps=3, seed=5)
    b = split(batch_size=4, num_inference_steps=3, seed=5)
    np.testing.assert_allclose(b, a, **MESH_TOL)
    # the pipeline's own modules serve its own device: nothing copied
    for p in (base, split):
        assert p._p["replicas"] == {"cpu": (p._p["unet"], p._p["vae"])}
    img, traj = split(batch_size=4, num_inference_steps=3, seed=5,
                      final_only=False)
    np.testing.assert_allclose(img, a, **MESH_TOL)
    assert traj.shape == (3, 4, 8, 64, 2)
    _, traj_ref = base(batch_size=4, num_inference_steps=3, seed=5,
                       final_only=False)
    np.testing.assert_allclose(traj, traj_ref, **MESH_TOL)


def test_mesh_batch_divisibility_error():
    pipe = _tiny_pipe(with_vae=False)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.build_sampler(pipe, 6, 2, mesh=(torch.device("cpu"),) * 4)
    with pytest.raises(ValueError, match="starts at the pipeline's device"):
        pipeline.build_sampler(pipe, 4, 2, mesh=(torch.device("meta"),
                                                   torch.device("cpu")))
