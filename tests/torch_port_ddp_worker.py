"""One rank of the port's data-parallel CPU tests (tests/test_torch_port_ddp.py),
and the single-process runs they are held against. A rank is started with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) and joins a gloo group:

    python tests/torch_port_ddp_worker.py <case> <out_dir> [<ref_state>]

`case` is "ldm_step" (two flagship-shaped LDM train steps), "vae_gan"
(one generator and one discriminator step) or "melk" (a SIGUSR1 that
reaches rank 1 alone); the rank writes what the test
compares to <out_dir>/rank{r}.pt. With WORLD_SIZE unset the same functions
run as one process on the global batch."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rangeldm_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, process_shard,
)

SEED = 0
GLOBAL_BATCH = 4
# the flagship's grammar (a frozen VAE, the pos channel, attention blocks)
# at narrow widths: 16x64 images, a 4x16 latent
LDM_CFG = {
    "model_config": {"sample_size": [16, 4], "in_channels": 5,
                     "out_channels": 4, "block_out_channels": [32, 32],
                     "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
                     "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]},
    "vae_config": {"ch": 32, "ch_mult": [1, 2, 2], "z_channels": 4,
                   "num_res_blocks": 1},
    "with_vae": True, "pos_encoding": True, "lr_warmup_steps": 0,
    "learning_rate": 1e-3, "mixed_precision": "no", "tensorboard": False,
    "seed": SEED,
}
LDM_STEPS = 2
VAE_LR = 1e-3
MELK_STEPS = 4


def rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch."""
    rank, world = process_shard()
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def ldm_batches() -> list:
    """The global batches, (B, H, W, C) images, one per step."""
    rng = np.random.default_rng(SEED)
    return [rng.uniform(-1, 1, (GLOBAL_BATCH, 16, 64, 2)).astype(np.float32)
            for _ in range(LDM_STEPS)]


def run_ldm(out_dir: str) -> dict:
    """LDM_STEPS train steps of LdmTrainer on this rank's rows: each
    step's loss, gradients before the clip (averaged over the ranks) and
    the train state after it."""
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    trainer = LdmTrainer(dict(LDM_CFG, output_dir=out_dir), device="cpu")
    state = trainer.state
    out = {"loss": [], "grads": [], "states": []}
    apply = state.apply_gradients

    def capture():
        out["grads"].append({n: p.grad.clone() for n, p in
                             state.model.named_parameters()
                             if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    for images in ldm_batches():
        batch = trainer._to_device({"jpg": rows(torch.from_numpy(images))})
        metrics = trainer.train_step(state, batch, state.generator)
        out["loss"].append(float(metrics["loss"]))
        out["states"].append(state.state_dict())
    return out


def vae_gan_setup():
    """(loss config, state, steps, global batch) of the small VAE-GAN
    steps; the channel weights keep d_weight below its clip."""
    from rangeldm_tpu_torch.models.discriminator import (
        NLayerDiscriminatorMetaKernel,
    )
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    from rangeldm_tpu_torch.training import vae_trainer
    cfg = vae_trainer.VaeLossConfig(disc_start=0, range_weight=1.0,
                                    intensity_weight=0.25)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2),
                                      num_res_blocks=1))
        disc = NLayerDiscriminatorMetaKernel(2, ndf=8, n_layers=2)
    state = vae_trainer.VaeGanState.create(vae, disc, VAE_LR, cfg)
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.rand(GLOBAL_BATCH, 2, 64, 16, generator=g) * 0.8 + 0.1
    return cfg, state, vae_trainer.make_vae_gan_steps(cfg), x


def run_vae_gan(ref_state: str = None) -> dict:
    """The generator step, then the discriminator step from `ref_state`
    (the single process's state after its generator step, when given: the
    discriminator sees the reconstruction of weights that Adam moved by up
    to lr on rounding-noise gradients), on this rank's rows."""
    from rangeldm_tpu_torch.train_vae import DISC, GEN, step_generator
    _, state, (gen_step, disc_step), x = vae_gan_setup()
    x = rows(x)
    out = {"gen": gen_step(state, x, generator=step_generator(
        SEED, 0, GEN, "cpu"))}
    out["after_gen"] = state.state_dict()
    if ref_state is not None:
        state.load_state_dict(torch.load(ref_state, weights_only=True))
    out["disc"] = disc_step(state, x, generator=step_generator(
        SEED, 1, DISC, "cpu"))
    out["after_disc"] = state.state_dict()
    return out


def run_melk() -> dict:
    """MELK_STEPS steps, each with an all-reduce as a gradient's, under
    `emergency_checkpoint` with a save that waits at a barrier; SIGUSR1
    reaches rank 1 alone during step 1. The steps at which this rank
    saved."""
    import signal

    from rangeldm_tpu_torch.parallel.mesh import all_reduce_mean_, barrier
    from rangeldm_tpu_torch.training.loggers import emergency_checkpoint
    rank, _ = process_shard()
    saved, step = [], 0

    def save():
        barrier(f"save_{step}")
        saved.append(step)

    with emergency_checkpoint(save) as melk:
        for step in range(MELK_STEPS):
            all_reduce_mean_([torch.ones(3)])
            if rank == 1 and step == 1:
                signal.raise_signal(signal.SIGUSR1)
            melk()
    return {"saved": saved}


def main():
    torch.set_num_threads(1)
    case, out_dir = sys.argv[1], sys.argv[2]
    init_distributed(torch.device("cpu"))
    rank, _ = process_shard()
    if case == "ldm_step":
        out = run_ldm(os.path.join(out_dir, f"run{rank}"))
    elif case == "vae_gan":
        out = run_vae_gan(sys.argv[3] if len(sys.argv) > 3 else None)
    elif case == "melk":
        out = run_melk()
    else:
        raise ValueError(case)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
