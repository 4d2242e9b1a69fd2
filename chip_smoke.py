#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`rangeldm_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device    - require CUDA; the card's name and power limit; TF32 off
  2. build     - compile every CUDA kernel from rangeldm_tpu_torch/csrc/;
                 ptxas must report no spill stores for the bf16 kernels
  3. kernels   - each kernel against its plain PyTorch version at the
                 flagship shapes (batch 4, the conditional CLI's batch 8
                 and the training batch 32) and RangeDM's (training and
                 dump batch 8), f32
                 and bf16, two calls bit-identical, with times, the bound,
                 the floor of the exponentials alone and one PyTorch
                 library call as a yardstick
  3b. group_norm - the GroupNorm -> activation -> wrap kernel pair against
                 its plain versions at the main paths' GroupNorm sites
                 (flagship UNet and VAE at batch 32, RangeDM at 8, the
                 VAE-GAN's float32 at 16), forward and backward, two calls
                 bit-identical, with times, the bytes bound and PyTorch's
                 unfused chain (autocast's float32 norm, SiLU, cast, pad)
  4. unet      - one flagship-width UNet forward (f32) through the kernels
                 against the same UNet on the plain einsum path; 16
                 attention and 61 GroupNorm launches (both sides run the
                 GroupNorm pair: 4 and 4b hold the attention kernels)
  4b. unet_grad - one flagship-width UNet forward and backward (f32)
                 through both kernels against the plain path: every
                 parameter's gradient
  4c. norm_models - whole models with the GroupNorm pair against the same
                 models on PyTorch's unfused chain, on the card at the
                 cells' batches and precisions (flagship UNet trained under
                 bf16 autocast and sampled in bf16, its VAE's encoder and
                 decoder, RangeDM's UNet, the VAE-GAN's VAE in f32 with
                 TF32 convolutions) against the unfused chain in float32:
                 output and gradients within 1.5 times the unfused chain's
                 own distance in that precision; the pair's calls a pass
  5. main      - a flagship pipeline directory with seeded random weights at
                 full width, loaded with RangePipeline.from_pretrained and
                 sampled with DDIM-50 and DPM-Solver++-20 in bf16, then
                 to_point_clouds and the sampling CLI
  6. train     - LdmTrainer on the shipped flagship config (batch 32, bf16)
                 for 10 fit steps on seeded synthetic range images, then
                 save_final, RangePipeline.from_pretrained and a sample
  7. conditional - a synthetic KITTI-360 root (8 held-out and 160 train
                 scans of 120,000 points, made from SEED) read by the
                 port's loader, cold and warm; for each of the full-width
                 upsample and inpainting models with seeded random weights:
                 RangePipeline.upsample / .inpaint at batch 4 with DDIM-50
                 on conditions from the dataset, then sample_conditional.main
                 on the held-out scans and the MAE metrics of its triplets
  8. cond_train - LdmTrainer on the shipped upsample config (batch 32, bf16)
                 for 5 steps, one epoch of the port's RangeLoader over the
                 train drive, then save_final, reload and a 2-step upsample
  9. train_cli - the training command line (`train_ldm.main`) on the shipped
                 pixel-space RangeDM config (rangedm_kitti360.yaml, full
                 width, batch 8, bf16) plus an override file, over the
                 synthetic root: 4 steps with rolling checkpoints and a
                 sample dump, a checkpoint round trip, a resumed run to
                 step 6, the final pipeline reloaded through its run record
                 and sampled with DDIM-50; then the flagship config with
                 cache_latents for 3 steps, and the moments cache reused
  9b. vae_train - VAE-GAN training through `train_vae.main` on the shipped
                 vae_kitti360.yaml at full width (batch 16, the 3-layer
                 MetaKernel discriminator) over the synthetic root: 6 steps
                 in f32 (the trainer's own TF32 setting: cuDNN's on, as in
                 the published runs) past disc_start 2, a resume from step 3
                 bit-equal to them, validation, the sgm weights through
                 convert.load_vae, eval_vae on the held-out scans, 4
                 steps in bf16, a profile of a step, and small steps on the
                 card against the CPU; no attention kernel on this path
  9c. ddp      - data parallelism over torch.distributed, in worker
                 processes of this script (`chip_smoke.py worker ...`):
                 (a) the flagship step (TRAIN_CFG, bf16) on two ranks
                 sharing the card over gloo, 16 a rank, 3 steps, against
                 one process on the global batch of 32 (gradients, losses,
                 the state after step 2 within one Adam step's bound, the
                 ranks bit-equal, launches, steps/s); (b) `train_ldm.main`
                 under torchrun, a world of one over NCCL, on the flagship
                 YAML over the synthetic root; (c) the small VAE-GAN steps
                 on two ranks against one process (d_weight, BatchNorm
                 statistics of the global batch, parameters); (d)
                 `sample_ldm.main` on two ranks and in one process, equal
                 files; (e) the C++ projection core against numpy on
                 120,000-point scans, alone and from 8 threads
  10. eval     - sample, score and gate: `parity_gate.main` on a seeded
                 full-width flagship pipeline (DDIM-50, 32 samples at batch
                 32, bf16) and a seeded darknet53 checkpoint in the released
                 format, against a synthetic held-out drive of 32 scans:
                 exit code 1, finite MMD, JSD and FRD, 16 x (1 + 50) forward
                 kernel launches; `python -m rangeldm_tpu_torch.evaluate`
                 on the gate's dumps (MMD, JSD; a process of its own)
                 and `evaluate.main` on phase 7's densification triplets
                 (IoU, accuracy, MAE); RangeNet++ on the card against the
                 CPU and its rate at batch 8 with TF32 off and on, and how
                 far TF32 moves the FRD activations; the float32
                 MMD on the card against the float64 host value; chamfer
                 on two 120,000-point scans against a float64 k-d tree
  11. t64      - the bf16 flagship UNet forward and a DDIM-50 chain with the
                 six T=64 attention layers on the kernel against the same
                 model with them on the plain version (a known divergence by
                 design: the number, no bound)
  12. spatial  - the flagship VAE azimuth-sharded over a local mesh of 4
                 shards of cuda:0 (and over every card where there are
                 several): decode of a batch of 4 latents and encode back,
                 and the Waymo-scale decode to 64 x 2656, against the
                 unsharded VAE (f32, TF32 off, SPATIAL_TOL), with the bf16
                 gap, ms and peak memory; the sliced encoder and decoder and
                 an EdgeConvResnetBlock card against CPU; maybe_trace and
                 step_annotation around one flagship DDIM step, read back by
                 trace_op_breakdown, and device_memory_stats
  13. projection - the tensor projection (`geometry.range_image`) on the
                 card: batches of 8 synthetic 120,000-point scans padded to
                 131,072 for the kitti, ring (nuScenes, with points under
                 its 2 m min_depth) and uniform row modes, against the numpy
                 path and the C++ core scan by scan (tests/test_geometry.py's
                 per-image bounds), the batch bit-equal to the scans one at
                 a time and to a second call; ms per scan at batch 8 by CUDA
                 events, the host-to-card copy apart, peak memory, beside
                 the C++ core's and numpy's ms per scan; no attention kernel
                 on this path. Phase 9 also reads its runs' TensorBoard
                 event files back (the port's reader) against their jsonl
Every phase that runs a main path (5-9c) requires the GroupNorm pair's
calls there: the GroupNorm layers of each model times its passes. Then the
kernel summary line, the card line, and the result line. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# backward: rtol 2e-4 / atol 2e-5 in f32 (tests/test_flash_attention.py);
# 3e-2 of the largest entry in bf16 (tests/test_torch_port_attention_bwd.py)
BWD_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: 3e-2}
UNET_TOL = 5e-4
GRAD_TOL = (1e-3, 1e-6)     # per tensor: 1e-3 * max|ref| + 1e-6
BATCH = 4
GATE_STAGE_BATCH = 1           # the parity gate's unet_stage_report
TRAIN_BATCH = 32
TRAIN_STEPS = 10
SEED = 0
SCAN_POINTS = 120_000          # about one HDL-64E scan
HELD_OUT_SCANS = 8             # in 2013_05_28_drive_0000_sync, the test split
TRAIN_SCANS = 160              # in a train drive: five batches of 32
CLI_BATCH = 8                  # sample_conditional's default batch
COND_TRAIN_STEPS = 5            # one epoch of the train drive
# (heads, T) of the flagship UNet's attention layers, with the number of
# such layers in one forward; N = batch * heads. One ragged case (N, 8, 200)
# lies off the main path.
FLAGSHIP_LAYERS = [(16, 1024, 5), (32, 256, 5), (32, 64, 6)]
# the same for pixel-space RangeDM (64x1024 image): 2 + 3 layers at 4x64
# and the mid block's at 2x32, 64 heads each
RANGEDM_LAYERS = [(64, 256, 5), (64, 64, 1)]
RANGEDM_BATCH = 8              # rangedm_kitti360.yaml's, and the dump's
RAGGED_SHAPE = (5, 8, 200)
# (model, site, B, C, W, H, eps, dtype, act, shift, wrap): the main paths'
# GroupNorm sites that hold the most bytes, at their cells' batches
GN_SITES = [
    ("rangeldm_kitti360", "unet level 0 norm2", 32, 128, 256, 16, 1e-5,
     torch.bfloat16, "silu", True, True),
    ("rangeldm_kitti360", "unet level 0 up norm1", 32, 256, 256, 16, 1e-5,
     torch.bfloat16, "silu", False, True),
    ("rangeldm_kitti360", "unet level 1 attention", 32, 128, 128, 8, 1e-5,
     torch.bfloat16, "identity", False, False),
    ("rangeldm_kitti360", "unet level 3 norm2", 32, 256, 32, 2, 1e-5,
     torch.bfloat16, "silu", True, True),
    ("rangeldm_kitti360", "vae level 0", 32, 64, 1024, 64, 1e-6,
     torch.bfloat16, "silu", False, True),
    ("rangedm_kitti360", "unet level 0 norm2", 8, 128, 1024, 64, 1e-5,
     torch.bfloat16, "silu", True, True),
    ("rangedm_kitti360", "unet level 0 up norm1", 8, 256, 1024, 64, 1e-5,
     torch.bfloat16, "silu", False, True),
    ("vae_gan_kitti360", "vae level 0", 16, 64, 1024, 64, 1e-6,
     torch.float32, "silu", False, True),
    ("vae_gan_kitti360", "decoder level 0 norm1", 16, 128, 1024, 64, 1e-6,
     torch.float32, "silu", False, True),
]
GN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1.6e-2, 3e-2)}
# phase norm_models: a model with the GroupNorm pair may lie this many
# times as far from float32 as with the unfused chain in the same precision
NORM_MODELS_SLACK = 1.5
# the shipped configs the training command line reads, as data files
RANGEDM_YAML = os.path.join("rangeldm_tpu", "configs", "rangedm_kitti360.yaml")
FLAGSHIP_YAML = os.path.join("rangeldm_tpu", "configs",
                             "rangeldm_kitti360.yaml")
CLI_STEPS = (4, 6)             # run A's last step, and the resumed run B's
VAE_YAML = os.path.join("rangeldm_tpu", "configs", "vae_kitti360.yaml")
VAE_BATCH = 16                 # vae_kitti360.yaml's, with its VAE and
VAE_SHAPE = dict(ch=64, ch_mult=(1, 2, 4), z_channels=4, circular=True)
VAE_DISC_LAYERS = 3            # discriminator
VAE_STEPS = (3, 6)             # the checkpoint run B resumes from; the last
VAE_DISC_START = 2             # the GAN terms from the third step on
VAE_BF16_STEPS = 4
VAE_CARD_TOL = 1e-4            # small VAE-GAN steps, card against CPU, f32:
VAE_PARAM_TOL = 1e-6           # their metrics, parameters after Adam
VAE_MOMENT_TOL = 1e-4          # (adam_update_mismatches) and the
VAE_STATS_TOL = 1e-5           # discriminator's running statistics
CACHE_STEPS = 3
EVAL_SCANS = 32                # held-out scans of the eval root, and --samples
EVAL_BATCH = 32                # the parity gate's default --batch_size
EVAL_STEPS = 50
RANGENET_BATCH = 8             # frd_pipeline's batch
RANGENET_TOL = 1e-5            # card against CPU, of the features' scale:
                               # a forward with TF32 on lies above it
CHAMFER_TOL = 1e-3             # float32 on the card against float64
DEVICE = "cuda"                # of the eval and t64 phases
DDP_RANKS = 2                  # ranks sharing cuda:0 over gloo (NCCL refuses
                               # two ranks on one card)
DDP_STEPS = 3                  # (a): flagship steps at 16 a rank, global 32
DDP_GRAD_TOL = 2e-2            # (a), bf16: two ranks' gradients, moments and
                               # losses against one process's, of the largest
                               # entry (autocast rounds each rank's weight
                               # gradients to bf16 apart: about 4e-3)
DDP_CLI_STEPS = 8              # (b): the training CLI, a world of one, NCCL
DDP_SAMPLES = 8                # (d): the sampling CLI, 2 ranks against one
DDP_SAMPLE_BATCH = 2           # process: samples, batch and DDIM steps
DDP_SAMPLE_STEPS = 5
RANK_TIMEOUT = 300             # seconds a worker process may take
SPATIAL_SHARDS = 4             # phase spatial: azimuth shards of cuda:0
SPATIAL_LATENT = (16, 256)     # (beams, azimuth) of the flagship latent
WAYMO_LATENT = (16, 664)       # decoded to 64 x 2656 (ldm/inference.py:169)
EDGE_SHAPE = (1, 64, 1024, 64)  # one EdgeConvResnetBlock's input (B, C, W, H)
PROJ_BATCH = 8                 # phase projection: scans of one batch on the
PROJ_POINTS = 131_072          # card, each SCAN_POINTS padded to this buffer
PROJ_SENSORS = ("kitti360", "nuscenes", "kitti360_vanilla")  # kitti, ring,
PROJ_NEAR = 512                # uniform rows; nuScenes scans get points at
#                                0.5 m, under its 2 m min_depth
# the card's projection against numpy's and the C++ core's, per image: a
# point whose azimuth lies within an ulp of a column edge may land in the
# next column when atan2 differs in the last ulp, which moves a pixel and
# its one-pixel fills (tests/test_geometry.py:70-75, the JAX package's own
# bounds: values, mask pixels, car-window pixels)
PROJ_BOUNDS = (16, 8, 8)
SPATIAL_TOL = 1e-4             # f32, TF32 off, of the output's scale: the
# sharded VAE against the unsharded one, and the sliced and EdgeConv modules
# on the card against the CPU. cuDNN picks other f32 algorithms at a shard's
# width, and the sharded GroupNorm takes E[x^2] - mean^2 where F.group_norm
# takes Welford's: a few 1e-6 of the scale (1e-5 expected at most); TF32
# (10 mantissa bits) would read 1e-3, a misplaced halo O(1)
# rangeldm_tpu/configs/rangeldm_kitti360.yaml, the shipped flagship training
# config, with the warm-up cut to 2 steps so that 10 steps move the weights;
# output_dir is a temporary directory set at run time
TRAIN_CFG = {
    "model": "rangeldm_kitti360",
    "output_dir": None,
    "data": {"sensor": "kitti360", "root": "${KITTI360_DATASET}",
             "width": 1024, "used_feature": 2},
    "train_batch_size": 32,
    "num_epochs": 1000,
    "gradient_accumulation_steps": 1,
    "use_ema": True,
    "learning_rate": 1.0e-4,
    "lr_warmup_steps": 2,
    "lr_scheduler": "cosine",
    "adam_beta1": 0.95,
    "adam_beta2": 0.999,
    "adam_weight_decay": 1.0e-6,
    "adam_epsilon": 1.0e-8,
    "ema_inv_gamma": 1.0,
    "ema_power": 0.75,
    "ema_max_decay": 0.9999,
    "ddim": True,
    "ddpm_num_steps": 1000,
    "ddpm_beta_schedule": "linear",
    "prediction_type": "epsilon",
    "ddpm_num_inference_steps": 50,
    "snr_gamma": None,
    "pos_encoding": True,
    "with_vae": True,
    "vae_checkpoint": None,
    "checkpointing_steps": 500,
    "checkpoints_total_limit": 10,
    "resume_from_checkpoint": None,
    "save_images_epochs": 1,
    "save_model_epochs": 10,
    "eval_batch_size": 16,
    "mixed_precision": "bf16",
}

# rangeldm_tpu/configs/upsample.yaml and inpainting.yaml, the shipped
# conditional training configs, with the same 2-step warm-up; output_dir
# and data.root are set at run time
UPSAMPLE_CFG = {
    "model": "rangeldm_upsample",
    "output_dir": None,
    "data": {"sensor": "kitti360", "root": None, "downsample": 4},
    "train_batch_size": 32,
    "num_epochs": 1000,
    "learning_rate": 1.0e-4,
    "lr_warmup_steps": 2,
    "with_vae": True,
    "vae_checkpoint": None,
    "upsample": 4,
    "inpainting": None,
    "ddim": True,
    "ddpm_num_inference_steps": 50,
    "mixed_precision": "bf16",
}
INPAINT_CFG = {
    "model": "rangeldm_inpainting",
    "output_dir": None,
    "data": {"sensor": "kitti360", "root": None, "inpainting": 0.0625},
    "train_batch_size": 32,
    "num_epochs": 1000,
    "learning_rate": 1.0e-4,
    "lr_warmup_steps": 2,
    "with_vae": True,
    "vae_checkpoint": None,
    "upsample": None,
    "inpainting": 0.0625,
    "ddim": True,
    "ddpm_num_inference_steps": 50,
    "mixed_precision": "bf16",
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# the GroupNorm pair's counters; the backward's counts calls, of two
# launches each (the backward and its reduction of dgamma, dbeta)
GN_KERNELS = ("group_norm_act_fwd", "group_norm_act_bwd")


def gn_sites(model) -> int:
    """The GroupNorm layers of a model: each calls the pair's forward once a
    forward pass and its backward once a backward pass."""
    return sum(isinstance(m, torch.nn.GroupNorm) for m in model.modules())


def require_gn(kernels, fwd: int, bwd: int, what: str) -> dict:
    """Require `fwd` forward and `bwd` backward calls of the GroupNorm pair
    since the last reset of the counters; returns them."""
    got = {k: kernels.LAUNCHES.get(k, 0) for k in GN_KERNELS}
    require(got == dict(zip(GN_KERNELS, (fwd, bwd))),
            f"{what}: the GroupNorm pair launched {got}, expected "
            f"{(fwd, bwd)}")
    return got


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(kernel, shape, dtype) -> tuple:
    """(operations, bytes) of one call. Forward: 4 T^2 D flops per head
    (two products); q, k, v read and out written once. Backward: 10 T^2 D
    flops per head (five products: l, dp, dv, dq, dk); q, k, v, g read and
    dq, dk, dv written once."""
    n, d, t = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if kernel == "attention_fwd":
        return 4.0 * t * t * d * n, 4.0 * n * d * t * itemsize
    return 10.0 * t * t * d * n, 7.0 * n * d * t * itemsize


def ex2_floor_ms(kernel, shape, clock_hz: float) -> float:
    """Least time of the call's exponentials alone: N T^2 per pass over the
    keys that forms e (one in the forward, three in the backward), at 16
    ex2 per SM per clock on every SM at the given SM clock."""
    n, _, t = shape
    count = (1 if kernel == "attention_fwd" else 3) * n * t * t
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return count / (sms * 16 * clock_hz) * 1e3


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """Least time in ms, the larger of operations over the dtype's peak and
    bytes over the memory rate, and which of the two it is."""
    flop_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return max(flop_ms, byte_ms), ("operations" if flop_ms >= byte_ms
                                   else "bytes")


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         max_sm_clock_mhz=clock_mhz, torch=torch.__version__,
         cuda=torch.version.cuda,
         tf32="off (cudnn and matmul) for the f32 phases")
    return smi, clock_mhz * 1e6


# the tensor-core kernels, which must not spill registers
MMA_KERNELS = ("attention_fwd_bf16", "attention_bwd_rows_bf16",
               "attention_bwd_cols_bf16")


def ptxas_table(report: str) -> dict:
    """{mangled kernel name: {"registers": n, "spill_stores": n}} from
    nvcc's -Xptxas -v report."""
    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            table[name] = {}
        for key, pattern in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("registers", r"Used (\d+) registers")):
            m = re.search(pattern, line)
            if m and name:
                table[name][key] = int(m.group(1))
    return table


def phase_build(kernels):
    t0 = time.perf_counter()
    reports = kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for out in reports.values():
        ptxas.update(ptxas_table(out))
    emit("build", seconds=round(seconds, 3), ptxas=ptxas)
    for kernel in MMA_KERNELS:
        found = [v for k, v in ptxas.items() if kernel in k]
        require(len(found) == 1 and found[0].get("spill_stores") == 0,
                f"ptxas: {kernel} not built or spills registers: {found}")


def _shapes(batch, model_layers=FLAGSHIP_LAYERS):
    return [((batch * heads, 8, t), layers)
            for heads, t, layers in model_layers]


def _close(kernel, got, want, dtype) -> tuple:
    """(max abs error, within tolerance) of a kernel's outputs."""
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    if kernel == "attention_fwd":
        tol = TOL[dtype]
        return err, all(torch.allclose(a.float(), b.float(), rtol=tol,
                                       atol=tol) for a, b in zip(got, want))
    if dtype == torch.float32:
        rtol, atol = BWD_TOL[dtype]
        return err, all(torch.allclose(a, b, rtol=rtol, atol=atol)
                        for a, b in zip(got, want))
    return err, all((a.float() - b.float()).abs().max().item()
                    <= BWD_TOL[dtype] * b.float().abs().max().item()
                    for a, b in zip(got, want))


def phase_kernels(attention, clock_hz: float):
    """Each kernel at the flagship shapes of the parity gate's UNet stage
    report (batch 1), a rank of the `ddp` phase's sampling (batch 2),
    sampling (batch 4), the conditional CLI (batch 8), a rank of its
    training (batch 16), and training and the gate's sampling (batch 32),
    plus a ragged T,
    against its plain version; times of the
    kernel, the plain version and one PyTorch call (SDPA forward, or the
    autograd backward of SDPA) on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(kernel, "rangeldm_kitti360", batch, shape, layers)
             for kernel in ("attention_fwd", "attention_bwd")
             for batch in (GATE_STAGE_BATCH, DDP_SAMPLE_BATCH, BATCH,
                           CLI_BATCH, TRAIN_BATCH // DDP_RANKS, TRAIN_BATCH)
             for shape, layers in _shapes(batch)]
    cases += [(kernel, "rangedm_kitti360", RANGEDM_BATCH, shape, layers)
              for kernel in ("attention_fwd", "attention_bwd")
              for shape, layers in _shapes(RANGEDM_BATCH, RANGEDM_LAYERS)]
    cases += [(kernel, None, 0, RAGGED_SHAPE, 0)
              for kernel in ("attention_fwd", "attention_bwd")]
    rows = []
    for kernel, model, batch, shape, layers in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                                      dtype=dtype) for _ in range(4))
            scale = shape[1] ** -0.5
            qs, ks, vs, gs = (u.transpose(1, 2) for u in (q, k, v, g))
            if kernel == "attention_fwd":
                def run():
                    return attention.fused_attention_t(q, k, v, scale)

                def plain():
                    return attention.attention_t_reference(q, k, v, scale)

                def library():
                    return F.scaled_dot_product_attention(qs, ks, vs,
                                                          scale=scale)
            else:
                def run():
                    return attention.fused_attention_bwd_t(q, k, v, g, scale)

                def plain():
                    return attention.attention_bwd_t_reference(q, k, v, g,
                                                               scale)
                leaves = [u.detach().requires_grad_(True)
                          for u in (qs, ks, vs)]
                out = F.scaled_dot_product_attention(*leaves, scale=scale)

                def library():
                    return torch.autograd.grad(out, leaves, gs,
                                               retain_graph=True)
            got, again = (res if isinstance(res, tuple) else (res,)
                          for res in (run(), run()))
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err, ok = _close(kernel, got, want, dtype)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del got, again, want
            ms = cuda_ms(run, 20)
            plain_ms = cuda_ms(plain, 5)
            library_ms = cuda_ms(library, 20)
            flops, nbytes = attention_work(kernel, shape, dtype)
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            row = dict(kernel=kernel, model=model, batch=batch,
                       shape=list(shape),
                       dtype=str(dtype).split(".")[1],
                       layers_per_unet_forward=layers, max_abs_err=err,
                       deterministic=same, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       ex2_floor_ms=ex2_floor_ms(kernel, shape, clock_hz),
                       flops=flops, bytes=nbytes)
            emit("kernels", **row)
            require(ok, f"{kernel} disagrees with its plain version at "
                        f"{shape} {dtype}: max abs err {err}")
            require(same, f"two calls of {kernel} at {shape} {dtype} "
                          f"differ")
            rows.append(row)
    return rows


def _gn_library(x, weight, bias, groups, eps, act, shift, wrap):
    """PyTorch's unfused chain as the modules ran it before the kernel pair:
    the shift added in x's dtype, autocast's float32 GroupNorm (bf16 x),
    the activation, the cast back and the conv's circular pad."""
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=x.dtype == torch.bfloat16):
        if shift is not None:
            x = x + shift[:, :, None, None]
        y = F.group_norm(x, groups, weight, bias, eps)
        y = F.silu(y) if act == "silu" else y
    y = y.to(x.dtype)
    return F.pad(y, (0, 0, 1, 1), mode="circular") if wrap else y


def phase_group_norm(group_norm):
    """Each GroupNorm site of GN_SITES, forward and backward: the kernel
    against its plain version in float32 (forward within one rounding of
    the dtype, backward within GN_TOL of the largest entry), two calls
    bit-identical; times of the kernel, its plain version and PyTorch's
    unfused chain (the backward: autograd through it), and the bytes bound
    (each input read once, each output written once)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (model, site, b, c, w, h, eps, dtype, act, with_shift,
         wrap) in GN_SITES:
        x = (torch.randn((b, c, w, h), generator=gen, device="cuda") * 2
             + 0.5).to(dtype)
        weight = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        shift = (torch.randn((b, c), generator=gen, device="cuda").to(dtype)
                 if with_shift else None)
        g = torch.randn((b, c, w + 2 if wrap else w, h), generator=gen,
                        device="cuda").to(dtype)
        args = (32, eps, act)
        xf, sf = x.float(), None if shift is None else shift.float()
        out, mean, rstd = group_norm._forward(x, weight, bias, shift, *args,
                                              wrap)
        again = group_norm._forward(x, weight, bias, shift, *args, wrap)[0]
        grads = group_norm._backward(x, weight, bias, shift, mean, rstd, g,
                                     *args, wrap, with_shift)
        grads2 = group_norm._backward(x, weight, bias, shift, mean, rstd, g,
                                      *args, wrap, with_shift)
        want = group_norm.group_norm_act_reference(
            xf, weight, bias, *args, sf, wrap).to(dtype)
        want_grads = group_norm.group_norm_act_bwd_reference(
            xf, weight, bias, *args, sf, g.float(), wrap)
        torch.cuda.synchronize()
        fwd_tol, bwd_tol = GN_TOL[dtype]
        fwd_err = (out.float() - want.float()).abs().max().item()
        bwd_err = max(
            (a.float() - r.float()).abs().max().item()
            / max(r.float().abs().max().item(), 1e-30)
            for a, r in zip(grads, want_grads) if a is not None)
        same = torch.equal(out, again) and all(
            torch.equal(a, a2) for a, a2 in zip(grads, grads2)
            if a is not None)
        del again, grads2, want, want_grads

        leaves = [u.detach().requires_grad_(True) if u is not None else None
                  for u in (x, weight, bias, shift)]
        lib_out = _gn_library(leaves[0], leaves[1], leaves[2], *args,
                              leaves[3], wrap)
        lib_in = [u for u in leaves if u is not None]
        itemsize = x.element_size()
        fwd_bytes = (x.numel() + out.numel()) * itemsize
        bwd_bytes = (x.numel() + g.numel() + x.numel()) * itemsize
        timed = {
            "fwd": (lambda: group_norm._forward(x, weight, bias, shift,
                                                *args, wrap),
                    lambda: group_norm.group_norm_act_reference(
                        xf, weight, bias, *args, sf, wrap),
                    lambda: _gn_library(x, weight, bias, *args, shift,
                                        wrap), fwd_bytes, fwd_err, fwd_tol),
            "bwd": (lambda: group_norm._backward(
                        x, weight, bias, shift, mean, rstd, g, *args, wrap,
                        with_shift),
                    lambda: group_norm.group_norm_act_bwd_reference(
                        x, weight, bias, *args, shift, g, wrap),
                    lambda: torch.autograd.grad(lib_out, lib_in, g,
                                                retain_graph=True),
                    bwd_bytes, bwd_err, bwd_tol)}
        for direction, (run, plain, library, nbytes, err,
                        tol) in timed.items():
            kernel = (group_norm.KERNEL if direction == "fwd"
                      else group_norm.BWD_KERNEL)
            p = group_norm.plan(b, c, 32, w, h, itemsize, wrap,
                                direction == "bwd")
            row = dict(kernel=kernel, model=model, site=site,
                       shape=[b, c, w, h], dtype=str(dtype).split(".")[1],
                       act=act, shift=with_shift, wrap=wrap,
                       plan=p.as_dict(), max_err=err, tol=tol,
                       deterministic=same, ms=cuda_ms(run, 20),
                       plain_ms=cuda_ms(plain, 5),
                       library_ms=cuda_ms(library, 10),
                       bound_ms=nbytes / PEAK_BYTES * 1e3, bytes=nbytes)
            emit("group_norm", **row)
            require(err <= tol * (1 if direction == "bwd" else
                                  max(out.float().abs().max().item(), 1)),
                    f"{kernel} disagrees with its plain version at {site} "
                    f"{dtype}: {err}")
            require(same, f"two calls of {kernel} at {site} differ")
            rows.append(row)
        del lib_out, leaves, lib_in, out, grads
    return rows


def phase_unet(kernels, models):
    cfg = models.rangeldm_kitti360().unet
    torch.manual_seed(SEED)
    fused = models.UNet2D(cfg).cuda().eval()
    plain = models.UNet2D(dataclasses.replace(
        cfg, use_fused_attention=False)).cuda().eval()
    plain.load_state_dict(fused.state_dict())
    h, w = cfg.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((BATCH, cfg.in_channels, w, h), generator=gen,
                    device="cuda")
    t = torch.tensor(500, device="cuda")
    with torch.inference_mode():
        kernels.reset_launches()
        got = fused(x, t)
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["attention_fwd"]
        gn_launches = kernels.LAUNCHES["group_norm_act_fwd"]
        want = plain(x, t)
    err = (got - want).abs().max().item()
    emit("unet", dtype="float32", batch=BATCH, latent=[h, w],
         max_abs_err=err, tol=UNET_TOL, launches=launches,
         group_norm_launches=gn_launches, out_absmax=want.abs().max().item())
    require(launches == 16, f"UNet forward launched attention_fwd "
                            f"{launches} times, expected 16")
    require(gn_launches == 61, f"UNet forward launched group_norm_act_fwd "
                               f"{gn_launches} times, expected 61")
    require(err <= UNET_TOL, f"UNet with the kernel differs from the "
                             f"einsum path by {err}")


def phase_unet_grad(kernels, models):
    """The full-width flagship UNet in f32 (TF32 off) at batch 2: one
    forward and backward through both kernels and through the plain einsum
    path, on the same weights, input and cotangent. The loss is a mean, so
    the gradients stay small against the 1e-6 floor of the tolerance except
    where they are rounding noise (to_k.bias has an exact gradient of
    zero)."""
    cfg = models.rangeldm_kitti360().unet
    torch.manual_seed(SEED)
    fused = models.UNet2D(cfg).cuda().train()
    plain = models.UNet2D(dataclasses.replace(
        cfg, use_fused_attention=False)).cuda().train()
    plain.load_state_dict(fused.state_dict())
    h, w = cfg.sample_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn((2, cfg.in_channels, w, h), generator=gen, device="cuda")
    ct = torch.randn((2, cfg.out_channels, w, h), generator=gen,
                     device="cuda")
    t = torch.tensor([10, 900], device="cuda")
    launches = {}
    for name, model in (("fused", fused), ("plain", plain)):
        kernels.reset_launches()
        (model(x, t) * ct).mean().backward()
        torch.cuda.synchronize()
        launches[name] = dict(kernels.LAUNCHES)
    want = dict(plain.named_parameters())
    absmax = max(p.grad.abs().max().item() for p in want.values())
    worst, worst_rel, attn_params, n = None, 0.0, 0, 0
    for pname, p in fused.named_parameters():
        ref = want[pname].grad
        require(p.grad is not None and ref is not None,
                f"no gradient for {pname}")
        require(bool(torch.isfinite(p.grad).all()),
                f"non-finite gradient for {pname}")
        err = (p.grad - ref).abs().max().item()
        tol = GRAD_TOL[0] * ref.abs().max().item() + GRAD_TOL[1]
        require(err <= tol, f"gradient of {pname} differs from the plain "
                            f"path by {err} (tolerance {tol})")
        if ".attentions." in pname and pname.split(".")[-2] in (
                "group_norm", "to_q", "to_k", "to_v"):
            attn_params += 1
        if worst is None or err / tol > worst[1] / worst[2]:
            worst = (pname, err, tol)
        if ref.abs().max().item() >= 1e-3 * absmax:
            worst_rel = max(worst_rel, err / ref.abs().max().item())
        n += 1
    emit("unet_grad", dtype="float32", batch=2, latent=[h, w],
         tensors=n, attention_qkv_norm_tensors=attn_params,
         worst_tensor=worst[0], worst_err=worst[1], worst_tol=worst[2],
         grad_absmax=absmax, worst_rel_err_of_tensors_above_1e_3=worst_rel,
         launches=launches)
    # 16 attention layers x (group_norm, to_q, to_k, to_v) x (weight, bias)
    require(attn_params == 16 * 8, f"{attn_params} attention q/k/v/norm "
                                   f"tensors checked, expected 128")
    for kernel in ("attention_fwd", "attention_bwd"):
        require(launches["fused"][kernel] == 16,
                f"UNet forward and backward launched {kernel} "
                f"{launches['fused'][kernel]} times, expected 16")
        require(launches["plain"][kernel] == 0,
                f"the plain path launched {kernel}")


@contextlib.contextmanager
def unfused_norms():
    """Every GroupNorm of the models inside the block on PyTorch's unfused
    chain (`group_norm_act_reference`: F.group_norm, the activation, the
    circular pad), on the card too; the kernel pair after it."""
    from rangeldm_tpu_torch.models import layers
    from rangeldm_tpu_torch.ops import group_norm

    saved = layers.group_norm_act
    layers.group_norm_act = group_norm.group_norm_act_reference
    try:
        yield
    finally:
        layers.group_norm_act = saved


def phase_norm_models(kernels, models):
    """The GroupNorm pair inside whole models, at the cells' batches and
    precisions: the flagship UNet trained under bf16 autocast and sampled
    in bf16 weights, the flagship VAE's encoder (autocast, training's
    encode) and decoder (bf16, sampling's decode), RangeDM's UNet trained
    under autocast, and the VAE-GAN's VAE trained in float32 with TF32
    convolutions. Each model runs on the card three times with the same
    weights and inputs: with the pair, with the unfused chain in the same
    precision, and with the unfused chain in float32 (TF32 off), the
    reference. In the output and in all parameter gradients together
    (relative 2-norms) the pair must lie no further from the reference
    than NORM_MODELS_SLACK times the unfused chain does: both round the
    same convolutions, so a fault of the pair shows as a distance of its
    own on top of the precision's. The pair's calls a pass must equal the
    model's GroupNorm layers."""
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig

    flagship, rangedm = models.rangeldm_kitti360(), models.rangedm_kitti360()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def unet(spec, batch):
        torch.manual_seed(SEED)
        h, w = spec.unet.sample_size
        x = randn(batch, spec.unet.in_channels, w, h)
        t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
        return (models.UNet2D(spec.unet).cuda(),
                lambda m: m(x.to(next(m.parameters()).dtype), t))

    def vae(cfg, batch, hw):
        torch.manual_seed(SEED)
        return AutoencoderKL(cfg).cuda(), randn(batch, cfg.in_channels,
                                                hw[1], hw[0])

    # the flagship cells train and sample at batch 32 (TRAIN_BATCH)
    flag_vae, image = vae(flagship.vae, TRAIN_BATCH, flagship.image_size)
    h, w = flagship.unet.sample_size
    z = randn(TRAIN_BATCH, flagship.vae.z_channels, w, h)
    gan_vae, gan_image = vae(VaeConfig(**VAE_SHAPE), VAE_BATCH,
                             flagship.image_size)

    def dtype_of(m):
        return next(m.parameters()).dtype

    # (name, model, run, train, precision); sampling's models hold bf16
    # weights, training's float32 weights under autocast
    cases = [
        ("flagship unet, training", *unet(flagship, TRAIN_BATCH), True,
         "autocast"),
        ("flagship vae encoder, training", flag_vae.encoder,
         lambda m: m(image), False, "autocast"),
        ("flagship unet, sampling", *unet(flagship, TRAIN_BATCH), False,
         "bfloat16"),
        ("flagship vae decoder, sampling", flag_vae.decoder,
         lambda m: m(z.to(dtype_of(m))), False, "bfloat16"),
        ("rangedm unet, training", *unet(rangedm, RANGEDM_BATCH), True,
         "autocast"),
        ("vae_gan vae, training", gan_vae,
         lambda m: m(gan_image, sample_posterior=False)[0], True, "tf32")]

    def run(model, fn, train, precision, cotangent=None):
        model.train(train).zero_grad(set_to_none=True)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = precision == "tf32"
        kernels.reset_launches()
        try:
            with torch.autocast("cuda", torch.bfloat16,
                                enabled=precision == "autocast"), \
                    torch.set_grad_enabled(train):
                out = fn(model).float()
                if train:
                    (out * (cotangent if cotangent is not None
                            else torch.ones_like(out))).mean().backward()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.synchronize()
        grads = (torch.cat([p.grad.float().flatten() for p in
                            model.parameters() if p.grad is not None])
                 if train else None)
        return out.detach(), grads, {k: kernels.LAUNCHES[k]
                                     for k in GN_KERNELS}

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    rows = []
    for name, model, fn, train, precision in cases:
        ct = None
        if train:
            with torch.no_grad(), torch.autocast(
                    "cuda", torch.bfloat16, enabled=precision == "autocast"):
                ct = torch.randn(fn(model).shape, generator=gen,
                                 device="cuda")
        cell = model.to(torch.bfloat16) if precision == "bfloat16" else model
        f32 = copy.deepcopy(cell).float()
        with unfused_norms():
            ref = run(f32, fn, train, "float32", ct)
            plain = run(cell, fn, train, precision, ct)
        fused = run(cell, fn, train, precision, ct)
        del f32
        sites = gn_sites(model)
        # the pair's and the unfused chain's distances from the reference,
        # and from each other
        row = dict(model=name, precision=precision, train=train,
                   out_err=rel(fused[0], ref[0]),
                   out_err_chain=rel(plain[0], ref[0]),
                   out_pair_vs_chain=rel(fused[0], plain[0]),
                   sites=sites, launches=fused[2])
        if train:
            row.update(grad_err=rel(fused[1], ref[1]),
                       grad_err_chain=rel(plain[1], ref[1]),
                       grad_pair_vs_chain=rel(fused[1], plain[1]))
        emit("norm_models", **row)
        require(not any(plain[2].values()) and not any(ref[2].values()),
                f"{name}: the unfused chain launched {plain[2]}")
        require(fused[2] == dict(zip(GN_KERNELS, (sites, sites * train))),
                f"{name}: the GroupNorm pair launched {fused[2]} in a pass "
                f"of {sites} GroupNorm layers")
        require(all(row[f"{k}_err"] <= NORM_MODELS_SLACK
                    * row[f"{k}_err_chain"] for k in ("out", "grad")
                    if f"{k}_err" in row),
                f"{name}: with the pair the model lies further from float32 "
                f"than with the unfused chain in {precision}: {row}")
        rows.append(row)
        del ref, plain, fused
    return rows


def phase_main(kernels, models, smi):
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.pipelines import RangePipeline
    from rangeldm_tpu_torch import sample_ldm

    spec = models.rangeldm_kitti360()
    torch.manual_seed(SEED)
    unet = models.UNet2D(spec.unet)
    vae = models.AutoencoderKL(spec.vae)
    sched = dataclasses.asdict(spec.schedule)
    launches = dict.fromkeys(("attention_fwd", *GN_KERNELS), 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        save_diffusers_pipeline(path, unet, vae, sched)
        pipe = RangePipeline.from_pretrained(path)
        require(pipe.device.type == "cuda", "pipeline is not on CUDA")
        require(next(pipe._p["unet"].parameters()).dtype == torch.bfloat16,
                "pipeline is not bf16 by default")
        pipe(batch_size=BATCH, num_inference_steps=2)       # warm-up
        sites = (gn_sites(pipe._p["unet"]), gn_sites(pipe._p["vae"].decoder))

        rates = {}
        for method, steps in (("ddim", 50), ("dpmpp", 20)):
            kernels.reset_launches()
            t0 = time.perf_counter()
            images = pipe(batch_size=BATCH, num_inference_steps=steps,
                          method=method, seed=SEED)
            dt = time.perf_counter() - t0
            n = kernels.LAUNCHES["attention_fwd"]
            gn = require_gn(kernels, sites[0] * steps + sites[1], 0, method)
            add(dict(attention_fwd=n, **gn))
            rates[method] = dict(steps=steps, seconds=dt,
                                 samples_per_s=BATCH / dt, launches=n,
                                 group_norm_launches=gn)
            require(images.shape == (BATCH, 64, 1024, 2),
                    f"{method}: image shape {images.shape}")
            require(bool(np.isfinite(images).all()),
                    f"{method}: non-finite samples")
            require(n == 16 * steps, f"{method}: {n} kernel launches, "
                                     f"expected {16 * steps}")
        clouds = pipe.to_point_clouds(images)
        require(len(clouds) == BATCH and all(
            c.ndim == 2 and c.shape[1] == 4 and np.isfinite(c).all()
            for c in clouds), "bad point clouds")

        out = os.path.join(tmp, "samples")
        kernels.reset_launches()
        t0 = time.perf_counter()
        sample_ldm.main(["--pipeline", path, "--out", out, "--samples",
                         str(BATCH), "--batch_size", str(BATCH)])
        cli_s = time.perf_counter() - t0
        n = kernels.LAUNCHES["attention_fwd"]
        add(dict(attention_fwd=n, **require_gn(
            kernels, sites[0] * 50 + sites[1], 0, "sample_ldm.main")))
        require(n == 16 * 50, f"sample_ldm.main: {n} kernel launches")
        files = sorted(os.listdir(out))
        want = sorted(f"{i}{s}" for i in range(BATCH)
                      for s in (".bin", "_bev.png", "_range.png"))
        require(files == want, f"sample_ldm.main wrote {files}")

        u, v = pipe._p["unet"], pipe._p["vae"]
        h, w = spec.unet.sample_size
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((BATCH, spec.unet.in_channels, w, h), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        z = torch.randn((BATCH, spec.vae.z_channels, w, h), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        t = torch.tensor(500, device="cuda")
        with torch.inference_mode():
            unet_ms = cuda_ms(lambda: u(x, t), 10)
            vae_ms = cuda_ms(lambda: v.decode(z), 5)
    emit("main", dtype="bfloat16", batch=BATCH, card=smi, **rates,
         group_norm_sites=dict(unet=sites[0], vae_decoder=sites[1]),
         cloud_points=[int(c.shape[0]) for c in clouds],
         cli_seconds=cli_s, cli_files=len(files), unet_fwd_ms=unet_ms,
         vae_decode_ms=vae_ms)
    return launches


def phase_train(kernels, smi):
    """LdmTrainer.fit on TRAIN_CFG for TRAIN_STEPS steps at batch 32 in
    bf16 on seeded synthetic range images, then save_final, reload and a
    2-step DDIM sample. Returns the launches of each kernel in the fit."""
    from rangeldm_tpu_torch.pipelines import RangePipeline
    from rangeldm_tpu_torch.train_ldm import LdmTrainer

    with tempfile.TemporaryDirectory() as tmp:
        cfg = dict(TRAIN_CFG, output_dir=os.path.join(tmp, "run"))
        trainer = LdmTrainer(cfg)
        require(trainer.device.type == "cuda", "trainer is not on CUDA")
        h, w = trainer.spec.image_size
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        images = [torch.randn((TRAIN_BATCH, h, w, 2), generator=gen,
                              device="cuda") for _ in range(TRAIN_STEPS)]
        params0 = [p.detach().clone() for p in trainer.unet.parameters()]
        ema0 = [e.clone() for e in trainer.state.ema]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        last = trainer.fit(({"jpg": x} for x in images),
                           max_steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(cfg["output_dir"], "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        require([r["step"] for r in log] == list(range(1, TRAIN_STEPS + 1)),
                f"train log steps {[r['step'] for r in log]}")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                    for r in log), f"non-finite loss or grad_norm: {log}")
        moved = sum(not torch.equal(a, b)
                    for a, b in zip(params0, trainer.unet.parameters()))
        ema_moved = sum(not torch.equal(a, b)
                        for a, b in zip(ema0, trainer.state.ema))
        require(moved == len(params0), f"{moved} of {len(params0)} "
                                       f"parameters changed")
        require(ema_moved == len(ema0), f"{ema_moved} of {len(ema0)} EMA "
                                        f"tensors changed")
        for kernel in ("attention_fwd", "attention_bwd"):
            require(launches.get(kernel) == 16 * TRAIN_STEPS,
                    f"fit launched {kernel} {launches.get(kernel)} times, "
                    f"expected {16 * TRAIN_STEPS}")
        # a step: the VAE encoder's forward, the UNet's forward and backward
        unet_sites = gn_sites(trainer.unet)
        require_gn(kernels, (unet_sites + gn_sites(trainer.vae.encoder))
                   * TRAIN_STEPS, unet_sites * TRAIN_STEPS, "fit")
        # the log's steps per second count from the start of fit; the
        # steady rate leaves out step 1 (first-call set-up)
        elapsed = [r["step"] / r["sps"] for r in log]
        steady = (TRAIN_STEPS - 1) / (elapsed[-1] - elapsed[0])

        path = trainer.save_final()
        pipe = RangePipeline.from_pretrained(path)
        images = pipe(batch_size=BATCH, num_inference_steps=2, seed=SEED)
        require(images.shape == (BATCH, h, w, 2) and
                bool(np.isfinite(images).all()),
                f"sample from the trained pipeline: {images.shape}")
        saved = sorted(os.listdir(path))
    require(saved == ["model_index.json", "scheduler", "unet", "unet_ema",
                      "vae"], f"save_final wrote {saved}")
    emit("train", dtype="bfloat16", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         card=smi, losses=[r["loss"] for r in log],
         grad_norms=[r["grad_norm"] for r in log],
         steps_per_s=steady, samples_per_s=steady * TRAIN_BATCH,
         steps_per_s_with_first=last["sps"], first_step_s=elapsed[0],
         peak_memory_gib=peak_gib, launches=launches, saved=saved)
    return launches


def synthetic_scan(rng, n: int) -> np.ndarray:
    """A KITTI-360-like (N, 4) scan: points at random azimuths and ranges,
    zeniths in the HDL-64E's field of view, random intensities."""
    azi = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.5, 80.0, n)
    zen = rng.uniform(-0.43, 0.03, n)
    return np.stack([r * np.cos(zen) * np.cos(azi),
                     r * np.cos(zen) * np.sin(azi), r * np.sin(zen),
                     rng.uniform(0.0, 1.0, n)], axis=1).astype(np.float32)


def make_kitti_root(root: str, held_out: int = HELD_OUT_SCANS,
                    train: int = TRAIN_SCANS) -> str:
    """The velodyne_points/data/*.bin layout of KITTI-360's raw scans, with
    `held_out` scans in a held-out drive and `train` in a train drive."""
    rng = np.random.default_rng(SEED)
    for drive, count in (("2013_05_28_drive_0000_sync", held_out),
                         ("2013_05_28_drive_0003_sync", train)):
        d = os.path.join(root, "data_3d_raw", drive, "velodyne_points",
                         "data")
        os.makedirs(d)
        for i in range(count):
            synthetic_scan(rng, SCAN_POINTS).tofile(
                os.path.join(d, f"{i:010d}.bin"))
    return root


def loader_rates(data, root: str) -> dict:
    """Images per second of one RangeLoader pass (batch 8, 8 threads) over
    the train drive's scans with a cold cache (projection and compressed
    cache write) and then a warm one (cache reads)."""
    ds = data.RangeImageDataset(data.DatasetConfig(root=root, downsample=4))
    rates = {}
    for name in ("cold", "warm"):
        loader = data.RangeLoader(ds, batch_size=8, seed=SEED)
        t0 = time.perf_counter()
        n = sum(len(b["jpg"]) for b in loader)
        rates[f"loader_{name}_images_per_s"] = n / (time.perf_counter() - t0)
    require(n == TRAIN_SCANS, f"loader yielded {n} images")
    return rates


def _triplets(out: str, prefix: str) -> dict:
    """The result, target and input arrays the conditional CLI wrote."""
    arrays = {}
    for sub in ("result", "target", "input"):
        d = os.path.join(out, f"{prefix}_{sub}")
        files = sorted(os.listdir(d))
        want = sorted(f"{i}.npy" for i in range(CLI_BATCH))
        require(files == want, f"sample_conditional wrote {files} in {d}")
        arrays[sub] = np.stack([np.load(os.path.join(d, f"{i}.npy"))
                                for i in range(CLI_BATCH)])
    return arrays


def phase_conditional(kernels, models, data_root: str, smi,
                      samples_root: str) -> int:
    """Both full-width conditional models, through the pipeline API and the
    conditional CLI on conditions from the port's dataset; the CLI writes
    its triplets under `samples_root`. Returns the forward kernels'
    launches."""
    from rangeldm_tpu_torch import data, sample_conditional
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.metrics import densification_mae, inpainting_mae
    from rangeldm_tpu_torch.pipelines import RangePipeline

    rates = loader_rates(data, data_root)
    emit("conditional", loader_batch=8, scan_points=SCAN_POINTS,
         scans=TRAIN_SCANS, **rates)
    launches = dict.fromkeys(("attention_fwd", *GN_KERNELS), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for spec in (models.rangeldm_upsample(),
                     models.rangeldm_inpainting()):
            mode = "upsample" if spec.cond_channels == 8 else "inpainting"
            torch.manual_seed(SEED)
            path = os.path.join(tmp, mode)
            save_diffusers_pipeline(path, models.UNet2D(spec.unet),
                                    models.AutoencoderKL(spec.vae),
                                    dataclasses.asdict(spec.schedule))
            pipe = RangePipeline.from_pretrained(path)
            require(pipe.device.type == "cuda", f"{mode}: not on CUDA")
            require(next(pipe._p["unet"].parameters()).dtype
                    == torch.bfloat16, f"{mode}: not bf16 by default")
            require(pipe.cond_channels == spec.cond_channels,
                    f"{mode}: {pipe.cond_channels} condition channels")
            ds = data.RangeImageDataset(
                sample_conditional.conditional_dataset_config(
                    pipe._p, data_root, "kitti360", mode, 4, 0.0625),
                train=False)
            batch = data.collate([ds[i] for i in range(BATCH)])

            def call(steps):
                if mode == "upsample":
                    return pipe.upsample(batch["down"], steps, seed=SEED)
                return pipe.inpaint(batch["masked_image"],
                                    batch["inpainting_mask"], steps,
                                    seed=SEED)

            call(2)                                          # warm-up
            # a call: the UNet each step, the decoder, and for inpainting
            # the encoder on the masked image
            vae = pipe._p["vae"]
            want_gn = (gn_sites(pipe._p["unet"]) * 50 + gn_sites(vae.decoder)
                       + (mode == "inpainting") * gn_sites(vae.encoder))
            kernels.reset_launches()
            t0 = time.perf_counter()
            images = call(50)
            api_s = time.perf_counter() - t0
            n_api = kernels.LAUNCHES["attention_fwd"]
            gn_api = require_gn(kernels, want_gn, 0, f"{mode} API")
            require(images.shape == (BATCH, 64, 1024, 2),
                    f"{mode}: image shape {images.shape}")
            require(bool(np.isfinite(images).all()),
                    f"{mode}: non-finite samples")
            require(n_api == 16 * 50, f"{mode}: {n_api} kernel launches, "
                                      f"expected {16 * 50}")

            out = os.path.join(samples_root, f"{mode}_samples")
            kernels.reset_launches()
            t0 = time.perf_counter()
            written = sample_conditional.main(
                ["--pipeline", path, "--mode", mode, "--data", data_root,
                 "--out", out, "--samples", str(CLI_BATCH)])
            cli_s = time.perf_counter() - t0
            n_cli = kernels.LAUNCHES["attention_fwd"]
            gn_cli = require_gn(kernels, want_gn, 0, f"{mode} CLI")
            require(written == CLI_BATCH, f"{mode}: CLI wrote {written}")
            require(n_cli == 16 * 50, f"{mode}: the CLI launched the "
                                      f"kernel {n_cli} times")
            prefix = "densification" if mode == "upsample" else "inpainting"
            arrays = _triplets(out, prefix)
            res, tgt = arrays["result"][..., 0], arrays["target"][..., 0]
            norm = dict(encoding="linear", mean=ds.spec.mean, std=ds.spec.std)
            if mode == "upsample":
                scores = densification_mae(res, tgt, factor=4, **norm)
            else:
                scores = {"mae": inpainting_mae(
                    res, tgt, masked_columns=int(0.0625 * 1024), **norm)}
            scores = {k: float(v) for k, v in scores.items()}
            require(all(np.isfinite(v) for v in scores.values()),
                    f"{mode}: MAE {scores}")
            launches["attention_fwd"] += n_api + n_cli
            for k in GN_KERNELS:
                launches[k] += gn_api[k] + gn_cli[k]
            emit("conditional", mode=mode, dtype="bfloat16", card=smi,
                 api_batch=BATCH, api_steps=50, api_seconds=api_s,
                 api_samples_per_s=BATCH / api_s, api_launches=n_api,
                 cli_batch=CLI_BATCH, cli_seconds=cli_s,
                 cli_samples_per_s=CLI_BATCH / cli_s, cli_launches=n_cli,
                 triplet_shapes={k: list(v.shape)
                                 for k, v in arrays.items()},
                 mae_m=scores)
    return launches


def phase_cond_train(kernels, data_root: str, smi) -> dict:
    """LdmTrainer.fit on UPSAMPLE_CFG for COND_TRAIN_STEPS steps at batch
    32 in bf16, fed by the port's RangeLoader over the train drive, then
    save_final, reload and a 2-step upsample. Returns the launches of each
    kernel in the fit."""
    from rangeldm_tpu_torch import data
    from rangeldm_tpu_torch.pipelines import RangePipeline
    from rangeldm_tpu_torch.train_ldm import LdmTrainer

    with tempfile.TemporaryDirectory() as tmp:
        dcfg = dict(UPSAMPLE_CFG["data"], root=data_root)
        cfg = dict(UPSAMPLE_CFG, output_dir=os.path.join(tmp, "run"),
                   data=dcfg)
        trainer = LdmTrainer(cfg)
        require(trainer.device.type == "cuda", "trainer is not on CUDA")
        require(trainer.cond_fn is not None, "no condition")
        ds = data.RangeImageDataset(data.DatasetConfig(
            root=dcfg["root"], sensor=dcfg["sensor"],
            downsample=cfg["upsample"]))
        loader = data.RangeLoader(ds, batch_size=cfg["train_batch_size"],
                                  seed=SEED)
        require(len(loader) == COND_TRAIN_STEPS,
                f"{len(loader)} batches an epoch")
        batches = iter(loader)
        params0 = [p.detach().clone() for p in trainer.unet.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        trainer.fit(batches, max_steps=COND_TRAIN_STEPS, log_every=1,
                    loader=loader)
        batches.close()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(cfg["output_dir"], "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        require([r["step"] for r in log]
                == list(range(1, COND_TRAIN_STEPS + 1)),
                f"train log steps {[r['step'] for r in log]}")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                    for r in log), f"non-finite loss or grad_norm: {log}")
        moved = sum(not torch.equal(a, b)
                    for a, b in zip(params0, trainer.unet.parameters()))
        require(moved == len(params0), f"{moved} of {len(params0)} "
                                       f"parameters changed")
        for kernel in ("attention_fwd", "attention_bwd"):
            require(launches.get(kernel) == 16 * COND_TRAIN_STEPS,
                    f"fit launched {kernel} {launches.get(kernel)} times, "
                    f"expected {16 * COND_TRAIN_STEPS}")
        # a step: the VAE encoder on the target, the UNet forward and
        # backward (the condition is the low-resolution scan, not encoded)
        unet_sites = gn_sites(trainer.unet)
        require_gn(kernels, (unet_sites + gn_sites(trainer.vae.encoder))
                   * COND_TRAIN_STEPS, unet_sites * COND_TRAIN_STEPS, "fit")
        elapsed = [r["step"] / r["sps"] for r in log]
        steady = (COND_TRAIN_STEPS - 1) / (elapsed[-1] - elapsed[0])

        pipe = RangePipeline.from_pretrained(trainer.save_final())
        require(pipe.cond_channels == 8,
                f"reloaded pipeline: {pipe.cond_channels} condition channels")
        down = data.collate([ds[i] for i in range(BATCH)])["down"]
        images = pipe.upsample(down, num_inference_steps=2, seed=SEED)
        require(images.shape == (BATCH, 64, 1024, 2) and
                bool(np.isfinite(images).all()),
                f"upsample from the trained pipeline: {images.shape}")
    emit("cond_train", config="upsample", dtype="bfloat16",
         batch=cfg["train_batch_size"], steps=COND_TRAIN_STEPS, card=smi,
         losses=[r["loss"] for r in log],
         grad_norms=[r["grad_norm"] for r in log],
         data_wait_frac=[r["data_wait_frac"] for r in log],
         steps_per_s=steady, samples_per_s=steady * TRAIN_BATCH,
         first_step_s=elapsed[0], peak_memory_gib=peak_gib,
         launches=launches)
    return launches


def write_yaml(path: str, cfg: dict) -> str:
    """A config override in the block-YAML subset the port reads: nested
    mappings, strings double-quoted."""
    def lines(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                yield f"{indent}{k}:"
                yield from lines(v, indent + "  ")
            else:
                text = ("true" if v is True else "false" if v is False
                        else json.dumps(v))
                yield f"{indent}{k}: {text}"
    with open(path, "w") as f:
        f.write("\n".join(lines(cfg, "")) + "\n")
    return path


def png_size(path: str) -> tuple:
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"))


def read_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def tb_matches_log(out_dir: str, files: int) -> dict:
    """<out_dir>/tb, read back with the port's framing and CRC checks (the
    card's machine has no tensorboard package), holds `files` event files
    whose scalars equal train_log.jsonl's rows: tags, steps and float32
    values."""
    from rangeldm_tpu_torch.training.event_file import (
        event_files, read_scalars,
    )
    tb = os.path.join(out_dir, "tb")
    paths = event_files(tb)
    require(len(paths) == files, f"{tb} holds {len(paths)} event files, "
            f"expected {files}")
    want = [(r["step"], k, float(np.float32(v))) for r in read_log(out_dir)
            for k, v in r.items() if k != "step"]
    got = read_scalars(tb)
    require(got == want and len(want) > 0,
            f"{tb}: {len(got)} scalars differ from the jsonl's {len(want)}: "
            f"{[(g, w) for g, w in zip(got, want) if g != w][:3]}")
    return dict(files=len(paths), scalars=len(got),
                bytes=sum(os.path.getsize(p) for p in paths))


def state_equal(a: dict, b: dict) -> list:
    """The keys on which two TrainState.state_dict()s differ."""
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if not (
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k])]


def adam_update_mismatches(got: dict, want: dict, prefixes: tuple,
                           lr: float, param_tol: float = VAE_PARAM_TOL,
                           moment_tol: float = VAE_MOMENT_TOL,
                           optimizer: str = None,
                           betas: tuple = (0.9, 0.999)) -> list:
    """What differs, beyond what one Adam update explains, between two
    flat `VaeGanState.state_dict()`s (or, with `optimizer="adam"` and
    AdamW's `betas`, two `TrainState.state_dict()`s) updated from one
    state (the running statistics aside). The bias-corrected first and second moments of each
    parameter under `prefixes` lie within `moment_tol` of their tensor's
    largest entry plus the optimizer's largest (a bias whose exact
    gradient is 0, ahead of a one-channel GroupNorm group or a BatchNorm,
    holds rounding noise only). A parameter moved by lr * m / (sqrt(v) +
    eps) may then differ by `param_tol` plus lr times the update's
    sensitivity to those moment differences, (|dm| + |d sqrt v|) /
    (sqrt(v) + eps), at most 2: 0 where the moments agree, a full step
    either way where a gradient is noise around 0. The EMA ('ema/'),
    (1 - decay) times the move, is held to its parameter's bound."""
    def moments(sd, name):
        opt = optimizer or ("adam_disc" if name.startswith("disc/")
                            else "adam_gen")
        key, t = name.split("/", 1)[-1], sd[f"{opt}_count"]
        m = np.asarray(sd[f"{opt}/exp_avg/{key}"], np.float64)
        v = np.asarray(sd[f"{opt}/exp_avg_sq/{key}"], np.float64)
        return m / (1 - betas[0] ** t), np.sqrt(v / (1 - betas[1] ** t))

    names = [n for n in want if n.startswith(prefixes)
             and "running" not in n and "num_batches" not in n]
    bad = []
    for i, kind in enumerate(("first", "second")):
        scale = max(float(np.abs(moments(want, n)[i]).max()) for n in names)
        for n in names:
            g, w = moments(got, n)[i], moments(want, n)[i]
            err = float(np.abs(g - w).max())
            if err > moment_tol * (float(np.abs(w).max()) + scale):
                bad.append(f"{kind} moment of {n}: {err}")
    for n in names:
        (m1, r1), (m0, r0) = moments(got, n), moments(want, n)
        sens = np.minimum(2.0, (np.abs(m1 - m0) + np.abs(r1 - r0))
                          / (r0 + 1e-8))
        err = np.abs(np.asarray(got[n], np.float64)
                     - np.asarray(want[n], np.float64))
        if not (err <= param_tol + lr * sens).all():
            bad.append(f"{n}: {float(err.max())}")
    return bad


def unet_work(name: str) -> dict:
    """A zoo UNet's parameter count and the operations of one forward pass
    of one image (each multiply-add counted as two), counted by
    torch.utils.flop_counter on the meta device, where nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from rangeldm_tpu_torch.models import UNet2D, zoo
    cfg = dataclasses.replace(zoo.get_model_spec(name).unet,
                              use_fused_attention=False)
    with torch.device("meta"):
        unet = UNet2D(cfg)
        h, w = cfg.sample_size
        x = torch.zeros((1, cfg.in_channels, w, h))
        with FlopCounterMode(display=False) as counter:
            unet(x, torch.zeros((1,), dtype=torch.long))
    return {"unet_params": sum(p.numel() for p in unet.parameters()),
            "unet_fwd_tflop_per_image": counter.get_total_flops() / 1e12}


def phase_train_cli(kernels, data_root: str, smi) -> dict:
    """`train_ldm.main` on the shipped RangeDM config with an override file:
    run A (steps 1-4, checkpoints every 2 keeping 1, a dump at step 4), a
    checkpoint round trip into a fresh trainer, run B resumed from the
    latest checkpoint to step 6, the final pipeline loaded through its run
    record and sampled; then the flagship config with cache_latents for 3
    steps and the moments cache called again. Returns each kernel's
    launches over those runs."""
    from rangeldm_tpu_torch import train_ldm
    from rangeldm_tpu_torch.pipelines import RangePipeline
    from rangeldm_tpu_torch.training import checkpoint, latent_cache
    from rangeldm_tpu_torch.utils.config import expand_env, load_config

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    fields = unet_work("rangedm_kitti360")
    total = dict.fromkeys(("attention_fwd", "attention_bwd", *GN_KERNELS),
                          0)

    def count(expect_fwd, expect_bwd, what, gn_fwd, gn_bwd):
        """Attention and GroupNorm (forward, backward) launches since the
        last reset."""
        torch.cuda.synchronize()
        got = (kernels.LAUNCHES.get("attention_fwd", 0),
               kernels.LAUNCHES.get("attention_bwd", 0))
        require(got == (expect_fwd, expect_bwd),
                f"{what}: (forward, backward) launches {got}, expected "
                f"{(expect_fwd, expect_bwd)}")
        total["attention_fwd"] += got[0]
        total["attention_bwd"] += got[1]
        for k, n in require_gn(kernels, gn_fwd, gn_bwd, what).items():
            total[k] += n

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rangedm")
        base = {"output_dir": out, "data": {"root": data_root},
                "checkpointing_steps": 2, "checkpoints_total_limit": 1,
                "sample_every_steps": 4, "log_every": 1}
        shipped = os.path.join(here, RANGEDM_YAML)

        # run A: steps 1-4
        override = write_yaml(os.path.join(tmp, "a.yaml"), base)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer = train_ldm.main(["--cfg", shipped, override, "--max_steps",
                                  str(CLI_STEPS[0])])
        torch.cuda.synchronize()
        fields["run_a_seconds"] = time.perf_counter() - t0
        fields["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = CLI_STEPS[0]
        # pixel space: the UNet alone, trained `steps` steps and sampled
        # once with DDIM-50 for the dump
        sites = gn_sites(trainer.unet)
        count(6 * steps + 6 * 50, 6 * steps, "run A",
              sites * (steps + 50), sites * steps)
        require(trainer.device.type == "cuda" and trainer.vae is None
                and trainer.spec.name == "rangedm_kitti360"
                and trainer.compute_dtype == torch.bfloat16
                and trainer.cfg.train_batch_size == RANGEDM_BATCH,
                f"run A trained {trainer.spec.name} at batch "
                f"{trainer.cfg.train_batch_size} in {trainer.compute_dtype}")
        log_a = read_log(out)
        require([r["step"] for r in log_a] == list(range(1, steps + 1)),
                f"run A logged steps {[r['step'] for r in log_a]}")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                    for r in log_a), f"non-finite loss or grad_norm: {log_a}")
        ckpt_dir = os.path.join(out, "checkpoints")
        require(sorted(os.listdir(ckpt_dir)) == [f"checkpoint_{steps}"],
                f"checkpoints after rotation: {os.listdir(ckpt_dir)}")
        grid = os.path.join(out, "samples", f"samples_step{steps:08d}.png")
        require(png_size(grid) == (1024, 2 * RANGEDM_BATCH * 64),
                f"sample grid {png_size(grid)}")

        # round trip: a fresh trainer resumes from checkpoint_4
        want = trainer.state.state_dict()
        t0 = time.perf_counter()
        timed = checkpoint.TrainCheckpointer(os.path.join(tmp, "timed"))
        saved = timed.save(steps, trainer.state)
        fields["checkpoint_save_s"] = time.perf_counter() - t0
        fields["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
        del trainer
        fresh = train_ldm.LdmTrainer(dict(
            expand_env(load_config(shipped, override)),
            resume_from_checkpoint=os.path.join(ckpt_dir,
                                                f"checkpoint_{steps}")))
        t0 = time.perf_counter()
        restored = fresh.resume()
        torch.cuda.synchronize()
        fields["resume_s"] = time.perf_counter() - t0
        got = fresh.state.state_dict()
        require(restored == steps, f"resumed at step {restored}")
        differ = state_equal(want, got)
        require(not differ, f"the round trip changed {differ[:5]}")
        fields["round_trip"] = dict(
            tensors=sum(torch.is_tensor(v) for v in got.values()),
            scalars={k: v for k, v in got.items()
                     if not torch.is_tensor(v) and k != "generator"},
            generator_state_bytes=len(got["generator"]) // 2)
        del fresh, want, got

        # run B: resumed from the latest checkpoint, to step 6
        override = write_yaml(os.path.join(tmp, "b.yaml"), dict(
            base, resume_from_checkpoint="latest"))
        kernels.reset_launches()
        trainer = train_ldm.main(["--cfg", shipped, override, "--max_steps",
                                  str(CLI_STEPS[1])])
        count(6 * (CLI_STEPS[1] - steps), 6 * (CLI_STEPS[1] - steps),
              "run B", sites * (CLI_STEPS[1] - steps),
              sites * (CLI_STEPS[1] - steps))
        log_b = read_log(out)[len(log_a):]
        require([r["step"] for r in log_b]
                == list(range(steps + 1, CLI_STEPS[1] + 1)),
                f"run B logged steps {[r['step'] for r in log_b]}")
        require(all(np.isfinite(r["loss"]) for r in log_b),
                f"non-finite loss: {log_b}")
        # the default TensorBoard sink: one event file a run, equal to the
        # jsonl rows of both runs
        fields["tensorboard"] = tb_matches_log(out, 2)
        pipe_dir = os.path.join(out, "pipeline")
        with open(os.path.join(pipe_dir, "model_index.json")) as f:
            record = json.load(f)
        require(record["model"] == "rangedm_kitti360"
                and record["sensor"] == "kitti360"
                and record["image_size"] == [64, 1024]
                and record["pos_encoding"] is True
                and record["normalization"] == {"mean": 20.0, "std": 40.0,
                                                "log": False,
                                                "inverse": False},
                f"run record {record}")
        # the steady rate: step intervals with no checkpoint or dump in
        # them (1-2 and 3-4 of run A, 5-6 of run B), from the log's
        # steps-per-second counted from the start of each fit
        ends = {r["step"]: (r["step"] - s0) / r["sps"]
                for recs, s0 in ((log_a, 0), (log_b, steps)) for r in recs}
        clean = [(1, 2), (3, 4), (5, 6)]
        seconds = sum(ends[b] - ends[a] for a, b in clean)
        fields.update(steps_per_s=len(clean) / seconds,
                      samples_per_s=len(clean) * RANGEDM_BATCH / seconds,
                      first_step_s=ends[1],
                      losses=[r["loss"] for r in log_a + log_b])
        del trainer

        # the trained pipeline: pixel space, sensor and normalization from
        # its record, DDIM-50 at batch 4
        pipe = RangePipeline.from_pretrained(pipe_dir)
        require(not pipe.is_latent and pipe.sensor == "kitti360"
                and (pipe.spec.mean, pipe.spec.std) == (20.0, 40.0),
                f"pipeline: latent {pipe.is_latent}, sensor {pipe.sensor}")
        pipe(batch_size=BATCH, num_inference_steps=2)        # warm-up
        kernels.reset_launches()
        t0 = time.perf_counter()
        images = pipe(batch_size=BATCH, num_inference_steps=50, seed=SEED)
        sample_s = time.perf_counter() - t0
        count(6 * 50, 0, "pixel DDIM-50", sites * 50, 0)
        require(images.shape == (BATCH, 64, 1024, 2)
                and bool(np.isfinite(images).all()),
                f"pixel samples {images.shape}")
        clouds = pipe.to_point_clouds(images)
        require(len(clouds) == BATCH and all(
            c.ndim == 2 and c.shape[1] == 4 and np.isfinite(c).all()
            for c in clouds), "bad point clouds")
        unet = pipe._p["unet"]
        gen = torch.Generator(device=pipe.device).manual_seed(SEED)
        x = torch.randn((BATCH, 3, 1024, 64), generator=gen,
                        device=pipe.device, dtype=torch.bfloat16)
        t = torch.tensor(500, device=pipe.device)
        kernels.reset_launches()
        with torch.inference_mode():
            fields["unet_fwd_ms"] = cuda_ms(lambda: unet(x, t), 10)
        kernels.reset_launches()      # timing launches are not the path's
        fields.update(ddim50_seconds=sample_s,
                      ddim50_samples_per_s=BATCH / sample_s,
                      cloud_points=[int(c.shape[0]) for c in clouds])
        del pipe, unet

        # the flagship config from cached moments
        out_l = os.path.join(tmp, "latent")
        override = write_yaml(os.path.join(tmp, "latent.yaml"), {
            "output_dir": out_l, "data": {"root": data_root},
            "cache_latents": True, "log_every": 1})
        kernels.reset_launches()
        trainer = train_ldm.main(["--cfg", os.path.join(here, FLAGSHIP_YAML),
                                  override, "--max_steps", str(CACHE_STEPS)])
        # the encode pass over the train drive, then steps on its moments
        unet_sites = gn_sites(trainer.unet)
        count(16 * CACHE_STEPS, 16 * CACHE_STEPS, "cache_latents run",
              unet_sites * CACHE_STEPS + gn_sites(trainer.vae.encoder)
              * -(-TRAIN_SCANS // trainer.cfg.train_batch_size),
              unet_sites * CACHE_STEPS)
        log_l = read_log(out_l)
        require([r["step"] for r in log_l] == list(range(1, CACHE_STEPS + 1))
                and all(np.isfinite(r["loss"]) for r in log_l),
                f"cache_latents run logged {log_l}")
        fields["tensorboard_cache_run"] = tb_matches_log(out_l, 1)
        npy = os.path.join(out_l, "latent_moments.npy")
        with open(npy + ".json") as f:
            meta = json.load(f)
        require(meta["n"] == TRAIN_SCANS and meta["shape"] == [
            TRAIN_SCANS, 16, 256, 8] and meta["tag"].endswith(":bfloat16"),
            f"moments cache {meta}")
        mtime = os.stat(npy).st_mtime_ns
        ds = train_ldm.build_dataset(trainer.cfg)
        msgs = []
        kw = dict(batch_size=TRAIN_BATCH, out_path=npy, log=msgs.append,
                  dtype=trainer.compute_dtype)
        t0 = time.perf_counter()
        cached = latent_cache.precompute_moments(trainer.vae, ds,
                                                 tag=meta["tag"], **kw)
        reuse_s = time.perf_counter() - t0
        require(msgs[:1] == [f"[latent-cache] reusing {npy}"]
                and os.stat(npy).st_mtime_ns == mtime,
                f"the second call did not reuse the cache: {msgs}")
        cached = np.array(cached)
        # a changed tag encodes again: the encode pass's rate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = latent_cache.precompute_moments(trainer.vae, ds,
                                                tag=meta["tag"] + ":x", **kw)
        encode_s = time.perf_counter() - t0
        require(os.stat(npy).st_mtime_ns != mtime, "a changed tag reused")
        diff = float(np.abs(np.asarray(again) - cached).max())
        require(bool(np.isfinite(cached).all()) and diff <= 3e-2 * float(
            np.abs(cached).max()), f"two encodes differ by {diff}")
        fields.update(cache_reuse_s=reuse_s,
                      cache_encode_images_per_s=TRAIN_SCANS / encode_s,
                      cache_reencode_max_abs_diff=diff,
                      cache_losses=[r["loss"] for r in log_l])
        del trainer
    emit("train_cli", config=RANGEDM_YAML, dtype="bfloat16",
         batch=RANGEDM_BATCH, card=smi, launches=total,
         seconds=time.perf_counter() - t_phase, **fields)
    return total

def vae_work() -> dict:
    """The shipped KITTI-360 VAE's and MetaKernel discriminator's parameter
    counts and the operations of one forward pass of one 64x1024 image
    (each multiply-add two), counted by torch.utils.flop_counter on the
    meta device, where nothing runs. Only matrix products and convolutions
    count: the MetaKernels' elementwise patch weighting does not."""
    from torch.utils.flop_counter import FlopCounterMode
    from rangeldm_tpu_torch.models.discriminator import (
        NLayerDiscriminatorMetaKernel,
    )
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    out = {}
    cfg = VaeConfig(**VAE_SHAPE)
    f = cfg.down_factor
    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
        disc = NLayerDiscriminatorMetaKernel(2, n_layers=VAE_DISC_LAYERS)
        x = torch.zeros((1, 2, 1024, 64))
        z = torch.zeros((1, cfg.z_channels, 1024 // f, 64 // f))
        for name, module, call in (
                ("vae", vae, lambda: vae(x, noise=z)),
                ("disc", disc, lambda: disc(x))):
            with FlopCounterMode(display=False) as counter:
                call()
            out[f"{name}_params"] = sum(p.numel()
                                        for p in module.parameters())
            out[f"{name}_fwd_gflop_per_image"] = (counter.get_total_flops()
                                                  / 1e9)
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's and cuDNN's deterministic algorithms inside the block (cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG, which `main` sets before any CUDA work);
    the previous settings after it."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]


def vae_step_ends(log: list) -> dict:
    """{step: seconds since the start of the fit} from the log's steps per
    second, counted from the start of a fit that began at step 0."""
    return {r["step"]: r["step"] / r["sps"] for r in log}


def phase_vae_train(data_root: str, smi) -> dict:
    """VAE-GAN training through `train_vae.main` on the shipped
    vae_kitti360.yaml (full width: ch 64, ch_mult (1, 2, 4), z 4, 64x1024
    images with 2 channels, batch 16, the 3-layer MetaKernel
    discriminator) plus an override file (disc_start 2, a checkpoint every
    3 steps, logs every step), over the synthetic root: run A to step 6 in
    f32 (with the trainer's TF32 setting, which `VaeTrainer` sets around
    each step whatever this process set: cuDNN's on, matrix products'
    off); the held-out validation; vae_sgm.safetensors through
    convert.load_vae; eval_vae on the held-out scans; a profile of two
    steps; run D to step 6 and run B resumed from D's checkpoint_3, both
    with deterministic algorithms, B bit-equal to D; run C in bf16; and one
    small generator and discriminator step on the card against the CPU."""
    from torch.profiler import ProfilerActivity, profile
    from rangeldm_tpu_torch import convert, eval_vae, train_vae
    from rangeldm_tpu_torch.models.discriminator import (
        NLayerDiscriminatorMetaKernel,
    )
    from rangeldm_tpu_torch.models.vae import VaeConfig
    from rangeldm_tpu_torch.ops import kernels
    from rangeldm_tpu_torch.training import checkpoint
    from rangeldm_tpu_torch.utils.profiling import device_time

    here = os.path.dirname(os.path.abspath(__file__))
    shipped = os.path.join(here, VAE_YAML)
    t_phase = time.perf_counter()
    fields = vae_work()
    last = VAE_STEPS[1]
    drop = ("sps", "data_wait_frac")
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, max_steps, **extra):
            out = os.path.join(tmp, name)
            override = write_yaml(os.path.join(tmp, f"{name}.yaml"), {
                "output_dir": out, "data": {"root": data_root},
                "loss": {"disc_start": VAE_DISC_START},
                "checkpoint_every_steps": VAE_STEPS[0], "log_every": 1,
                "tensorboard": False, **extra})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer = train_vae.main(["--cfg", shipped, override,
                                      "--max_steps", str(max_steps)])
            torch.cuda.synchronize()
            return trainer, read_log(out), time.perf_counter() - t0

        # run A: f32 with the trainer's TF32 convolutions, steps 1-6
        torch.cuda.reset_peak_memory_stats()
        trainer, log_a, fields["run_a_seconds"] = run("a", last)
        fields["peak_memory_gib"] = (torch.cuda.max_memory_allocated()
                                     / 2 ** 30)
        state, cfg = trainer.state, trainer.cfg
        require(trainer.device.type == torch.device(DEVICE).type
                and trainer.compute_dtype == torch.float32
                and int(cfg.batch_size) == VAE_BATCH
                and trainer.vae_cfg == VaeConfig(**VAE_SHAPE)
                and isinstance(state.disc, NLayerDiscriminatorMetaKernel)
                and state.disc.n_layers == VAE_DISC_LAYERS
                and sum(p.numel() for p in state.vae.parameters())
                == fields["vae_params"],
                f"run A trained {trainer.vae_cfg} with "
                f"{type(state.disc).__name__} at batch {cfg.batch_size} in "
                f"{trainer.compute_dtype} on {trainer.device}")
        require([r["step"] for r in log_a] == list(range(1, last + 1)),
                f"run A logged steps {[r['step'] for r in log_a]}")
        require(all(np.isfinite(v) for r in log_a for v in r.values()),
                f"non-finite metrics: {log_a}")
        factors = [r["disc_factor"] for r in log_a]
        require(factors == [0.0] * VAE_DISC_START
                + [1.0] * (last - VAE_DISC_START),
                f"disc_factor {factors} with disc_start {VAE_DISC_START}")
        require(all(r["d_weight"] > 0 for r in log_a[VAE_DISC_START:]),
                f"d_weight after disc_start: {log_a}")
        ends = vae_step_ends(log_a)
        # intervals that hold no checkpoint (saved after steps 3 and 6)
        clean = [(1, 2), (4, 5), (5, 6)]
        seconds = sum(ends[b] - ends[a] for a, b in clean)
        fields.update(
            tf32_steps_per_s=len(clean) / seconds,
            tf32_samples_per_s=len(clean) * VAE_BATCH / seconds,
            first_step_s=ends[1],
            d_weight=[r["d_weight"] for r in log_a],
            losses={k: [r[k] for r in log_a] for k in (
                "total_loss", "rec_loss", "kl_loss", "g_loss", "disc_loss")})
        with open(os.path.join(tmp, "a", "val_metrics.json")) as f:
            val = json.load(f)
        require(val["step"] == last and all(np.isfinite(v)
                                            for v in val.values()),
                f"val_metrics.json {val}")
        fields["val"] = val

        # the checkpoint: timed save, size
        t0 = time.perf_counter()
        saved = checkpoint.TrainCheckpointer(os.path.join(tmp, "timed")).save(
            last, state)
        fields["checkpoint_save_s"] = time.perf_counter() - t0
        fields["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))

        # save_final's weights through the second stage's loader
        sgm = os.path.join(tmp, "a", "vae_sgm.safetensors")
        loaded = convert.load_vae(sgm)
        require(loaded.cfg == trainer.vae_cfg and not state_equal(
            {k: v.cpu() for k, v in state.vae.state_dict().items()},
            loaded.state_dict()), "vae_sgm.safetensors does not load back "
                                  "through convert.load_vae")
        fields["vae_sgm_bytes"] = os.path.getsize(sgm)

        # eval_vae on the held-out scans
        t0 = time.perf_counter()
        scores = eval_vae.main(["--vae", sgm, "--data", data_root,
                                "--count", str(HELD_OUT_SCANS),
                                "--batch_size", str(HELD_OUT_SCANS // 2)])
        fields["eval_vae_seconds"] = time.perf_counter() - t0
        require(scores["count"] == HELD_OUT_SCANS and all(
            np.isfinite(v) for v in scores.values()), f"eval_vae {scores}")
        fields["eval_vae"] = scores

        # a profile of two more steps of run A's trainer (TF32 convolutions)
        batch = next(iter(train_vae.RangeLoader(
            train_vae.RangeImageDataset(train_vae.dataset_config(cfg)),
            batch_size=VAE_BATCH)))
        x = trainer._to_device(batch)
        kernels.reset_launches()
        trainer.train_step(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer.train_step(x)
            torch.cuda.synchronize()
        fields["profile_tf32"] = dict(wall_ms_per_step=wall,
                                     **device_time(prof, 2, wall))
        # five steps, each a forward of the VAE in the generator step and
        # one in the discriminator step, and the generator's backward
        sites = gn_sites(state.vae)
        fields["launches"] = require_gn(kernels, 2 * 5 * sites, 5 * sites,
                                        "five VAE-GAN steps")
        fields["group_norm_sites"] = sites
        del trainer, state, loaded

        # run D to step 6 and run B resumed from D's checkpoint_3, both with
        # deterministic algorithms: cuDNN's default ones may differ between
        # two runs in the last bits, and B must equal D bit for bit
        with deterministic_algorithms():
            trainer, log_d, _ = run("d", last)
            del trainer
            ckpt = os.path.join("checkpoints", f"checkpoint_{VAE_STEPS[0]}")
            shutil.copytree(os.path.join(tmp, "d", ckpt),
                            os.path.join(tmp, "b", ckpt))
            d_state = checkpoint.TrainCheckpointer(
                os.path.join(tmp, "d", "checkpoints")).restore(last)
            trainer, log_b, fields["resume_run_seconds"] = run("b", last)
        require([r["step"] for r in log_b]
                == list(range(VAE_STEPS[0] + 1, last + 1)),
                f"run B logged steps {[r['step'] for r in log_b]}")
        differ = [r["step"] for r, s in zip(log_d[VAE_STEPS[0]:], log_b)
                  if {k: v for k, v in r.items() if k not in drop}
                  != {k: v for k, v in s.items() if k not in drop}]
        require(not differ, f"resumed steps {differ} differ from run D's")
        got = trainer.state.state_dict()
        differ = state_equal(d_state, got)
        require(not differ, f"the resumed state differs in {differ[:5]}")
        ends = vae_step_ends(log_d)
        fields.update(
            resume_equal=dict(steps=[r["step"] for r in log_b],
                              tensors=sum(torch.is_tensor(v)
                                          for v in got.values())),
            deterministic_tf32_steps_per_s=len(clean) / sum(
                ends[b] - ends[a] for a, b in clean),
            default_vs_deterministic_max_rel=max(
                abs(r[k] - s[k]) / max(abs(s[k]), 1e-6)
                for r, s in zip(log_a, log_d) for k in r if k not in drop))
        del trainer, d_state, got

        # run C: bf16 autocast, no checkpoint inside the run
        torch.cuda.reset_peak_memory_stats()
        trainer, log_c, _ = run("c", VAE_BF16_STEPS, mixed_precision="bf16",
                                checkpoint_every_steps=1000)
        require(trainer.compute_dtype == torch.bfloat16
                and all(np.isfinite(v) for r in log_c for v in r.values()),
                f"bf16 run: {log_c}")
        ends = vae_step_ends(log_c)
        seconds = ends[VAE_BF16_STEPS] - ends[1]
        fields.update(bf16_steps_per_s=(VAE_BF16_STEPS - 1) / seconds,
                      bf16_samples_per_s=(VAE_BF16_STEPS - 1) * VAE_BATCH
                      / seconds,
                      bf16_peak_memory_gib=torch.cuda.max_memory_allocated()
                      / 2 ** 30,
                      bf16_losses=[r["total_loss"] for r in log_c])
        del trainer

    # one small generator and discriminator step on the card against the
    # CPU (f32, TF32 off): metrics, updated parameters, EMA, statistics
    small = vae_gan_card_vs_cpu(DEVICE)
    require(small["rel"] <= VAE_CARD_TOL and not small["problems"],
            f"the small VAE-GAN steps on the card differ from the CPU: "
            f"{small}")
    require(0 < small["d_weight"] < small["d_weight_clip"],
            f"the small step's adaptive weight sits at its clip: {small}")
    fields["small_step_card_vs_cpu_rel"] = small["rel"]
    fields["small_step_d_weight"] = small["d_weight"]
    emit("vae_train", config=VAE_YAML, batch=VAE_BATCH, card=smi,
         seconds=time.perf_counter() - t_phase, **fields)
    return fields


def vae_gan_card_vs_cpu(device: str, disc_start: int = 0) -> dict:
    """One small generator step and one discriminator step (a VAE of ch 32,
    ch_mult (1, 2), 64x16 images, batch 2, the MetaKernel discriminator of
    ndf 8, lr 1e-3, f32) on `device` against the same steps on the CPU.
    Returns the largest metric difference relative to its size ("rel"),
    the device's d_weight and its clip, and what differs beyond the
    bounds after each step ("problems"): `adam_update_mismatches` over the
    VAE, logvar and EMA after the generator step and over the
    discriminator after its step, and the running statistics within
    VAE_STATS_TOL. The channel weights (range 1, intensity 0.25) keep the
    adaptive weight's ratio of gradient norms below its clip at 1e4, so
    d_weight compares both norms. The device's discriminator step starts
    from the CPU's state after the generator step: Adam moves a parameter
    whose gradient is rounding noise by up to lr either way, and the
    discriminator sees the reconstruction of those weights."""
    from rangeldm_tpu_torch.models.discriminator import (
        NLayerDiscriminatorMetaKernel,
    )
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    from rangeldm_tpu_torch.training import vae_trainer

    lr = 1e-3
    cfg = vae_trainer.VaeLossConfig(disc_start=disc_start, range_weight=1.0,
                                    intensity_weight=0.25)
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand(2, 2, 64, 16, generator=g) * 0.8 + 0.1
    noise = [torch.randn(2, 4, 32, 8, generator=g) for _ in range(2)]
    states = {}
    for dev in ("cpu", device):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2),
                                          num_res_blocks=1))
            disc = NLayerDiscriminatorMetaKernel(2, ndf=8, n_layers=2)
        states[dev] = vae_trainer.VaeGanState.create(
            vae.to(dev), disc.to(dev), lr, cfg)
    gen_step, disc_step = vae_trainer.make_vae_gan_steps(cfg)
    out, problems = {}, []

    def compare(what, prefixes):
        got, want = states[device].state_dict(), states["cpu"].state_dict()
        problems.extend(f"{what}: {p}" for p in adam_update_mismatches(
            got, want, prefixes, lr))
        for k, v in want.items():
            if "running" in k:
                err = float((got[k] - v).abs().max())
                if err > VAE_STATS_TOL:
                    problems.append(f"{what}: {k} {err}")
        return want

    for dev, st in states.items():
        out[dev] = gen_step(st, x.to(dev), noise=noise[0].to(dev))
    states[device].load_state_dict(compare("generator step",
                                           ("vae/", "ema/", "logvar")))
    for dev, st in states.items():
        out[dev].update(disc_step(st, x.to(dev), noise=noise[1].to(dev)))
    compare("discriminator step", ("disc/",))
    rel = max(abs(float(out[device][k]) - float(v)) / max(abs(float(v)),
                                                          1e-3)
              for k, v in out["cpu"].items())
    return {"rel": rel, "d_weight": float(out[device]["d_weight"]),
            "d_weight_clip": 1e4 * cfg.disc_weight, "problems": problems}


def make_rangenet_ckpt(path: str) -> str:
    """A seeded darknet53 checkpoint in the released format: the state
    dicts of the backbone, decoder and head in files named `backbone`,
    `segmentation_decoder` and `segmentation_head`, with random weights,
    BatchNorm statistics and affine terms."""
    from rangeldm_tpu_torch.metrics.rangenet import RangeNet

    gen = torch.Generator().manual_seed(SEED)
    model = RangeNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.normal_(0, 0.02, generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0, 0.02, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.normal_(0.7, 0.1, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    os.makedirs(path)
    for name, module in (("backbone", model.backbone),
                         ("segmentation_decoder", model.decoder),
                         ("segmentation_head", model.head)):
        torch.save(module.state_dict(), os.path.join(path, name))
    return path


def rangenet_work(h: int = 64, w: int = 1024) -> tuple:
    """(float32 operations, parameters) of one darknet53 forward with the
    head on a 5 x h x w scan, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    from rangeldm_tpu_torch.metrics.rangenet import RangeNet

    with torch.device("meta"):
        model = RangeNet()
        x = torch.zeros(1, 5, h, w)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return (counter.get_total_flops(),
            sum(p.numel() for p in model.parameters()))


def chamfer_f64(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric squared chamfer distance in float64, by exact nearest
    neighbours from a k-d tree."""
    from scipy.spatial import cKDTree

    a, b = a.astype(np.float64), b.astype(np.float64)
    d_ab = cKDTree(b).query(a)[0]
    d_ba = cKDTree(a).query(b)[0]
    return float(np.mean(d_ab ** 2) + np.mean(d_ba ** 2))


def phase_eval(kernels, models, samples_root: str, smi) -> int:
    """Sample, score and gate at full width: the parity gate
    (`parity_gate.main`) on a seeded flagship pipeline with DDIM-50 over
    EVAL_SCANS samples in bf16, scored with MMD, JSD and FRD (RangeNet++ on
    a seeded darknet53 checkpoint) against a synthetic held-out drive; the
    evaluate CLI's MMD and JSD on the gate's dumps (`python -m
    rangeldm_tpu_torch.evaluate` in a process of its own, last, so that
    every timing of the phase is
    taken with nothing else running) and on phase 7's
    densification triplets (IoU, accuracy, MAE); RangeNet on the card
    against the CPU (with TF32 on as the control the bound must catch), its
    rate with TF32 off and on, and how far TF32 moves
    the FRD activations; the float32 MMD on the card against the
    float64 one, and chamfer on two 120,000-point scans against a float64
    k-d tree. Returns the forward kernel's launches in the gate."""
    from rangeldm_tpu_torch import evaluate, parity_gate
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.metrics import chamfer, frd_pipeline, mmd
    from rangeldm_tpu_torch.metrics.frd import frd_indices
    from rangeldm_tpu_torch.metrics.histogram import kitti_histogram
    from rangeldm_tpu_torch.utils.precision import tf32

    t_phase = time.perf_counter()
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = make_kitti_root(os.path.join(tmp, "kitti360"),
                               held_out=EVAL_SCANS, train=0)
        ckpt = make_rangenet_ckpt(os.path.join(tmp, "rangenet"))
        spec = models.rangeldm_kitti360()
        torch.manual_seed(SEED)
        weights = os.path.join(tmp, "pipeline")
        save_diffusers_pipeline(weights, models.UNet2D(spec.unet),
                                models.AutoencoderKL(spec.vae),
                                dataclasses.asdict(spec.schedule))
        out = os.path.join(tmp, "gate")

        # the gate, end to end
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        code = parity_gate.main([
            "--weights", weights, "--data", root, "--out", out,
            "--samples", str(EVAL_SCANS), "--batch_size", str(EVAL_BATCH),
            "--steps", str(EVAL_STEPS), "--rangenet", ckpt])
        torch.cuda.synchronize()
        gate_s = time.perf_counter() - t0
        launches = kernels.LAUNCHES["attention_fwd"]
        gate_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(out, "parity_report.json")) as f:
            report = json.load(f)
        scores = report["scores"]
        n_batches = -(-EVAL_SCANS // EVAL_BATCH)
        require(code == 1, f"the gate exited {code}, expected 1 (FAIL) "
                           f"on random weights: {report.get('error')}")
        require(report["pass"] is False and report["n_sampled"] == EVAL_SCANS
                and scores["n_gen"] == scores["n_ref"] == EVAL_SCANS,
                f"gate report: {report}")
        require(all(np.isfinite(scores[k]) for k in ("mmd", "jsd", "frd")),
                f"gate scores {scores}")
        require(launches == 16 * (1 + EVAL_STEPS * n_batches),
                f"the gate launched attention_fwd {launches} times, "
                f"expected {16 * (1 + EVAL_STEPS * n_batches)}")
        fields.update(gate_seconds=gate_s, gate_launches=launches,
                      gate_peak_memory_gib=gate_peak, gate_scores=scores,
                      vae_stage=report["vae_stage"],
                      unet_stage=report["unet_stage"])

        # RangeNet on the card against the CPU, and its rate (the card is
        # otherwise idle here)
        gen_files = frd_pipeline.generated_sample_files(out, EVAL_SCANS)
        ref_files = evaluate.kitti_reference_files(EVAL_SCANS, root)
        x = torch.from_numpy(np.stack([
            frd_pipeline.project_scan(evaluate.load_bin(f), 64, 1024)
            for f in ref_files[:RANGENET_BATCH]]))
        model = frd_pipeline.load_rangenet(ckpt)
        cpu_model = frd_pipeline.load_rangenet(ckpt, device="cpu")
        with torch.inference_mode():
            x2 = x[:2].to(DEVICE)
            on_card = model(x2)[0].cpu()
            with tf32(True):
                on_card_tf32 = model.decoder(*model.backbone(x2)).cpu()
            on_cpu = cpu_model(x[:2])[0]
            scale = on_cpu.abs().max().item()
            card_err = (on_card - on_cpu).abs().max().item()
            tf32_err = (on_card_tf32 - on_cpu).abs().max().item()
            xb = x.to(DEVICE)

            def features():
                return model.decoder(*model.backbone(xb))

            with tf32(True):
                tf32_ms = cuda_ms(features, 5)
            with tf32(False):
                f32_ms = cuda_ms(features, 5)
            full_ms = cuda_ms(lambda: model(xb), 5)
        require(card_err <= RANGENET_TOL * scale,
                f"RangeNet features on the card differ from the CPU by "
                f"{card_err} at scale {scale}")
        require(tf32_err > RANGENET_TOL * scale,
                f"with TF32 on, RangeNet features on the card differ from "
                f"the CPU by only {tf32_err} at scale {scale}: the bound "
                f"{RANGENET_TOL} cannot tell a forward that leaks TF32")
        flops, params = rangenet_work()
        fields.update(rangenet_card_vs_cpu_max_abs=card_err,
                      rangenet_feature_scale=scale,
                      rangenet_card_vs_cpu_rel=card_err / scale,
                      rangenet_tf32_vs_cpu_rel=tf32_err / scale,
                      rangenet_params=params,
                      rangenet_gflop_per_scan=flops / 1e9,
                      rangenet_batch=RANGENET_BATCH,
                      rangenet_features_ms=f32_ms,
                      rangenet_scans_per_s=RANGENET_BATCH / f32_ms * 1e3,
                      rangenet_scans_per_s_tf32=RANGENET_BATCH / tf32_ms
                      * 1e3,
                      rangenet_forward_with_head_ms=full_ms,
                      rangenet_f32_tflops=flops * RANGENET_BATCH
                      / full_ms / 1e9)

        # evaluate.main in this process: MMD and JSD on the gate's dumps,
        # IoU, accuracy and MAE on phase 7's densification triplets
        os.environ["KITTI360_DATASET"] = root
        try:
            t0 = time.perf_counter()
            hist = evaluate.main(["--exp", out, "--mmd", "--jsd",
                                  "--limit", str(EVAL_SCANS)])
            hist_s = time.perf_counter() - t0
        finally:
            del os.environ["KITTI360_DATASET"]
        require(hist["mmd"] == scores["mmd"] and hist["jsd"] == scores["jsd"],
                f"evaluate {hist} against the gate's {scores}")
        dens = os.path.join(samples_root, "upsample_samples")
        t0 = time.perf_counter()
        seg = evaluate.main(["--exp", dens, "--iou", "--accuracy", "--mae",
                             "--cond_prefix", "densification", "--rangenet",
                             ckpt, "--limit", str(CLI_BATCH)])
        seg_s = time.perf_counter() - t0
        require(all(np.isfinite(v) for v in seg.values())
                and 0 <= seg["iou"] <= 1 and 0 <= seg["accuracy"] <= 1,
                f"evaluate on the densification triplets: {seg}")
        fields.update(hist_mmd_jsd_seconds=hist_s,
                      segmentation_seconds=seg_s, densification=seg)

        # how far TF32 moves the gathered activations
        idx = torch.as_tensor(frd_indices(), device=DEVICE)

        def acts(files, enabled):
            def fn(batch):
                with tf32(enabled):
                    feats = model.decoder(*model.backbone(batch))
                return feats.flatten(1)[:, idx]
            return frd_pipeline.run_batched(fn, DEVICE, (
                evaluate.load_bin(f) for f in files), RANGENET_BATCH,
                64, 1024)

        t0 = time.perf_counter()
        gen_f32, ref_f32 = acts(gen_files, False), acts(ref_files, False)
        acts_s = time.perf_counter() - t0
        gen_tf32, ref_tf32 = acts(gen_files, True), acts(ref_files, True)
        act_scale = float(np.abs(gen_f32).max())
        act_err = float(max(np.abs(gen_tf32 - gen_f32).max(),
                            np.abs(ref_tf32 - ref_f32).max()))
        # the TF32 activations get no Frechet step of their own: it is a
        # 4096-dim host sqrtm for a number with no bound; the activations'
        # difference is the record
        fields.update(frd_activations_seconds=acts_s,
                      tf32_activation_max_abs=act_err,
                      tf32_activation_rel=act_err / act_scale)

        # float32 MMD on the card against the float64 host value
        gen_h = evaluate.histograms(gen_files, kitti_histogram)
        ref_h = evaluate.histograms(ref_files, kitti_histogram)
        t0 = time.perf_counter()
        mmd_card = mmd.compute_mmd(ref_h, gen_h, device=True)
        mmd_card_s = time.perf_counter() - t0
        mmd_rel = abs(mmd_card - scores["mmd"]) / abs(scores["mmd"])
        require(mmd_rel <= 1e-4, f"MMD on the card {mmd_card} against "
                                 f"the host's {scores['mmd']}")
        fields.update(mmd_card=mmd_card, mmd_card_rel=mmd_rel,
                      mmd_card_seconds=mmd_card_s)

        # chamfer on two scans of SCAN_POINTS points
        a, b = (evaluate.load_bin(f)[:, :3] for f in ref_files[:2])
        require(len(a) == len(b) == SCAN_POINTS,
                f"scan sizes {len(a)}")
        ca, cb = (torch.from_numpy(v).to(DEVICE) for v in (a, b))
        cd = float(chamfer.chamfer_distance(ca, cb))
        cd_ms = cuda_ms(lambda: chamfer.chamfer_distance(ca, cb), 3, 1)
        cd64 = chamfer_f64(a, b)
        cd_rel = abs(cd - cd64) / cd64
        require(cd_rel <= CHAMFER_TOL, f"chamfer on the card {cd} "
                                       f"against float64 {cd64}")
        fields.update(chamfer=cd, chamfer_f64=cd64, chamfer_rel=cd_rel,
                      chamfer_ms=cd_ms)

        # the evaluate CLI on the gate's dumps, as a user runs it, in its
        # own process: MMD and JSD. Its FRD left the smoke when phase
        # spatial took the script past half its time limit: its Frechet
        # step is a second host sqrtm of the 4096-dim product (190-220 s)
        # after the gate's, which stays; tests/test_torch_port_evaluate.py
        # holds the CLI's FRD against the JAX package's
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, KITTI360_DATASET=root, PYTHONPATH=os.pathsep
                   .join(filter(None, (here, os.environ.get("PYTHONPATH")))))
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "rangeldm_tpu_torch.evaluate", "--exp",
             out, "--mmd", "--jsd", "--limit", str(EVAL_SCANS), "--device",
             DEVICE], cwd=here, env=env,
            capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        require(cli.returncode == 0, f"python -m rangeldm_tpu_torch.evaluate "
                                     f"exited {cli.returncode}: "
                                     f"{cli.stderr[-2000:]}")
        res = json.loads(cli.stdout.strip().splitlines()[-1])
        require(res["mmd"] == scores["mmd"] and res["jsd"] == scores["jsd"],
                f"evaluate's {res} against the gate's {scores}")
        fields.update(evaluate_cli_seconds=cli_s, evaluate_cli=res)
    emit("eval", card=smi, samples=EVAL_SCANS, batch=EVAL_BATCH,
         steps=EVAL_STEPS, dtype="bfloat16",
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         seconds=time.perf_counter() - t_phase, **fields)
    return launches


def phase_t64(models, smi):
    """The known bf16 divergence at T=64: the flagship UNet forward and a
    DDIM-50 chain in bf16 with its six T=64 attention layers on the kernel
    (which rounds e and the denominator to bf16, as the TPU kernel does)
    against the same model with those layers on `attention_t_reference`
    (the JAX package sends T <= 64 to an f32 softmax). Reports the max-abs
    difference of each; no bound, the difference is by design."""
    from rangeldm_tpu_torch.pipelines import pipeline
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.models.unet import Attention

    spec = models.rangeldm_kitti360()
    torch.manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        save_diffusers_pipeline(path, models.UNet2D(spec.unet),
                                models.AutoencoderKL(spec.vae),
                                dataclasses.asdict(spec.schedule))
        pipe = pipeline.load_diffusers_pipeline(path)
    unet = pipe["unet"]
    tokens = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: tokens.__setitem__(mod, args[0].shape[2]
                                             * args[0].shape[3]))
        for m in unet.modules() if isinstance(m, Attention)]
    h, w = spec.unet.sample_size
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn((BATCH, spec.unet.in_channels, w, h), generator=gen,
                    device=DEVICE, dtype=torch.bfloat16)
    t = torch.tensor(500, device=DEVICE)
    sample = pipeline.build_sampler(pipe, BATCH, 50)
    out = {}
    for name in ("kernel", "reference"):
        with torch.inference_mode():
            eps = unet(x, t).float()
        if name == "kernel":
            for hook in hooks:
                hook.remove()
            t64 = [m for m, n in tokens.items() if n == 64]
            require(len(t64) == 6, f"{len(t64)} attention layers at T=64")
        images = sample(pipeline.batch_generator(pipe["device"], SEED, 0))
        out[name] = (eps, images.float())
        for m in t64:
            m.use_fused = False
    for m in t64:
        m.use_fused = None
    (eps_k, img_k), (eps_r, img_r) = out["kernel"], out["reference"]
    emit("t64", card=smi, dtype="bfloat16", batch=BATCH, layers=len(t64),
         unet_fwd_max_abs=(eps_k - eps_r).abs().max().item(),
         unet_fwd_scale=eps_r.abs().max().item(),
         ddim50_max_abs=(img_k - img_r).abs().max().item(),
         ddim50_scale=img_r.abs().max().item(),
         ddim50_mean_abs=(img_k - img_r).abs().mean().item())


# -- phase spatial: the azimuth-sharded VAE, research modules, profiling ---

def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32."""
    want = want.float()
    return ((got.float().to(want.device) - want).abs().max()
            / want.abs().max()).item()


def wall_ms(fn, iters: int, devices) -> float:
    """Host ms per call of fn() over `iters` calls after one warm-up, each
    of `devices` synchronised before and after."""
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) * 1e3 / iters


def peak_gib(fn, device) -> float:
    """max_memory_allocated of one call of fn(), GiB."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def phase_spatial(kernels, models, smi) -> int:
    """(a) the flagship VAE's decode of a batch of 4 latents (16 x 256) and
    the encode of what it decoded, azimuth-sharded over a local mesh of 4
    shards of cuda:0 (and over every card where there are several) against
    the unsharded VAE: f32 with TF32 off within SPATIAL_TOL, the bf16 gap,
    ms per call and peak memory of each; (b) the Waymo-scale decode, a
    16 x 664 latent to 64 x 2656 over 4 shards; (c) SlicedEncoder /
    SlicedDecoder at SlicedConfig's defaults on 64 x 1024 at batch 4 and
    one EdgeConvResnetBlock, card against CPU; (d) maybe_trace around one
    flagship DDIM step with step_annotation, read back by
    trace_op_breakdown: the forward kernel's group above 0 ms and its
    events equal to its launch count; device_memory_stats naming the card.
    Returns the forward kernel's launches in (d)."""
    from rangeldm_tpu_torch.pipelines import pipeline
    from rangeldm_tpu_torch.convert import save_diffusers_pipeline
    from rangeldm_tpu_torch.models import experimental, sliced
    from rangeldm_tpu_torch.parallel.sharded_vae import (
        sharded_vae_decode, sharded_vae_encode,
    )
    from rangeldm_tpu_torch.parallel.spatial import (
        gather_azimuth, shard_azimuth,
    )
    from rangeldm_tpu_torch.utils.precision import tf32
    from rangeldm_tpu_torch.utils.profiling import (
        device_memory_stats, maybe_trace, step_annotation, trace_op_breakdown,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    spec = models.rangeldm_kitti360()
    f = spec.vae.down_factor
    torch.manual_seed(SEED)
    vae = models.AutoencoderKL(spec.vae).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    meshes = {f"cuda:0 x{SPATIAL_SHARDS}": (dev,) * SPATIAL_SHARDS}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = tuple(torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count()))

    def decode(mesh, z):
        return gather_azimuth(sharded_vae_decode(
            vae, shard_azimuth(z, mesh)), dev)

    def encode(mesh, x):
        return gather_azimuth(sharded_vae_encode(
            vae, shard_azimuth(x, mesh)), dev)

    # (a) decode, then encode what was decoded, at the flagship's width
    h, w = SPATIAL_LATENT
    z = torch.randn((BATCH, spec.vae.z_channels, w, h), generator=gen,
                    device=dev)
    flagship = {}
    with torch.inference_mode(), tf32(False):
        whole_img = vae.decode(z)
        unsharded = {
            "decode_ms": wall_ms(lambda: vae.decode(z), 5, [dev]),
            "encode_ms": wall_ms(lambda: vae.encode_moments(whole_img), 5,
                                 [dev]),
            "decode_peak_gib": peak_gib(lambda: vae.decode(z), dev),
            "encode_peak_gib": peak_gib(
                lambda: vae.encode_moments(whole_img), dev)}
        for name, mesh in meshes.items():
            devices = sorted(set(mesh), key=str)
            img = decode(mesh, z)
            require(img.shape == (BATCH, spec.vae.out_ch, f * w, f * h),
                    f"{name}: decoded shape {tuple(img.shape)}")
            moments = encode(mesh, img)
            require(moments.shape == (BATCH, 2 * spec.vae.z_channels, w, h),
                    f"{name}: moments shape {tuple(moments.shape)}")
            gaps = {"decode_rel": rel_gap(img, whole_img),
                    "encode_rel": rel_gap(moments, vae.encode_moments(img))}
            for key, gap in gaps.items():
                require(gap <= SPATIAL_TOL, f"{name}: sharded {key} {gap} "
                                            f"> {SPATIAL_TOL}")
            with torch.autocast("cuda", dtype=torch.bfloat16):
                gaps["bf16_decode_rel"] = rel_gap(decode(mesh, z),
                                                  vae.decode(z))
                gaps["bf16_encode_rel"] = rel_gap(
                    encode(mesh, img), vae.encode_moments(img))
            flagship[name] = dict(
                gaps, decode_ms=wall_ms(lambda: decode(mesh, z), 5, devices),
                encode_ms=wall_ms(lambda: encode(mesh, img), 5, devices),
                decode_peak_gib=peak_gib(lambda: decode(mesh, z), dev),
                encode_peak_gib=peak_gib(lambda: encode(mesh, img), dev))
        del whole_img, img, moments

        # (b) the Waymo-scale decode at batch 1
        mesh = meshes[f"cuda:0 x{SPATIAL_SHARDS}"]
        hw, ww = WAYMO_LATENT
        zw = torch.randn((1, spec.vae.z_channels, ww, hw), generator=gen,
                         device=dev)
        img = decode(mesh, zw)
        require(img.shape == (1, spec.vae.out_ch, f * ww, f * hw),
                f"waymo: decoded shape {tuple(img.shape)}")
        waymo = {"decode_rel": rel_gap(img, vae.decode(zw)),
                 "decode_ms": wall_ms(lambda: decode(mesh, zw), 3, [dev]),
                 "unsharded_decode_ms": wall_ms(lambda: vae.decode(zw), 3,
                                                [dev]),
                 "decode_peak_gib": peak_gib(lambda: decode(mesh, zw), dev),
                 "unsharded_decode_peak_gib": peak_gib(
                     lambda: vae.decode(zw), dev)}
        require(waymo["decode_rel"] <= SPATIAL_TOL,
                f"waymo: sharded decode {waymo['decode_rel']} > "
                f"{SPATIAL_TOL}")
        del img

    # (c) the research modules, card against CPU, f32
    cfg = sliced.SlicedConfig()
    torch.manual_seed(SEED)
    research = {
        "sliced_encoder": (sliced.SlicedEncoder(cfg),
                           (torch.randn(BATCH, cfg.in_channels, 1024,
                                        cfg.resolution),)),
        "sliced_decoder": (sliced.SlicedDecoder(cfg),
                           (torch.randn(BATCH, cfg.z_channels,
                                        1024 // 2 ** (len(cfg.ch_mult) - 1),
                                        cfg.resolution
                                        // 2 ** (len(cfg.ch_mult) - 1)),)),
        "edge_conv_resnet_block": (
            experimental.EdgeConvResnetBlock(
                EDGE_SHAPE[1], EDGE_SHAPE[1], azi=2 * np.pi / EDGE_SHAPE[2],
                inc=np.radians(26.9) / EDGE_SHAPE[3]),
            (torch.randn(EDGE_SHAPE),
             torch.rand(EDGE_SHAPE[0], 1, *EDGE_SHAPE[2:]) * 78 + 2))}
    modules = {}
    for name, (module, inputs) in research.items():
        module.eval()
        with torch.inference_mode():
            t0 = time.perf_counter()
            want = module(*inputs)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            module.to(dev)
            card = tuple(x.to(dev) for x in inputs)
            with tf32(False):
                got = module(*card)
                gap = rel_gap(got, want)
                ms = cuda_ms(lambda: module(*card), 5)
        require(got.shape == want.shape, f"{name}: {tuple(got.shape)}")
        require(gap <= SPATIAL_TOL, f"{name}: card against CPU {gap} > "
                                    f"{SPATIAL_TOL}")
        modules[name] = dict(shape=list(got.shape), card_vs_cpu_rel=gap,
                             ms=ms, cpu_ms=cpu_ms)
        module.cpu()

    # (d) the profiling hooks around one flagship DDIM step, bf16
    torch.manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        save_diffusers_pipeline(path, models.UNet2D(spec.unet), vae,
                                dataclasses.asdict(spec.schedule))
        pipe = pipeline.load_diffusers_pipeline(path)
        sample = pipeline.build_sampler(pipe, BATCH, 1)
        sample(pipeline.batch_generator(dev, SEED, 0))      # warm-up
        torch.cuda.synchronize()
        trace_dir = os.path.join(tmp, "trace")
        kernels.reset_launches()
        with maybe_trace(trace_dir, enabled=True):
            with step_annotation("ddim_step"):
                images = sample(pipeline.batch_generator(dev, SEED, 0))
            torch.cuda.synchronize()
        launches = kernels.LAUNCHES["attention_fwd"]
        breakdown = trace_op_breakdown(trace_dir)
    require(bool(torch.isfinite(images).all()), "ddim step: not finite")
    require(launches == 16, f"ddim step: {launches} forward launches")
    require(breakdown["plane"].startswith("/device:cuda"),
            f"trace plane {breakdown['plane']}")
    require(breakdown["groups"]["attention_fwd"] > 0,
            "trace: no attention_fwd time")
    require(breakdown["events"]["attention_fwd"] == launches,
            f"trace: {breakdown['events']['attention_fwd']} attention_fwd "
            f"kernels, the counter {launches}")
    memory = device_memory_stats()
    require(memory.get("cuda:0", {}).get("name")
            == torch.cuda.get_device_name(0), f"memory stats {memory}")
    emit("spatial", card=smi, shards=SPATIAL_SHARDS, batch=BATCH,
         tol=SPATIAL_TOL, flagship_unsharded=unsharded, flagship=flagship,
         waymo=waymo, research=modules,
         trace={"launches": launches, **breakdown},
         memory=memory["cuda:0"], seconds=time.perf_counter() - t_phase)
    return launches


# -- phase ddp: data parallelism over torch.distributed --------------------

def tensors_digest(sd: dict) -> str:
    """sha256 of a flat state dict's names, scalars and tensor bytes."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k]
        h.update(k.encode())
        if torch.is_tensor(v):
            v = v.detach().cpu().contiguous()
            h.update(str(v.dtype).encode()
                     + v.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def ddp_snapshot(state) -> dict:
    """What the next update reads, as GPU clones (no host synchronisation)
    under TrainState.state_dict()'s names: parameters, EMA, AdamW's
    moments and update count."""
    out = {"adam_count": int(state.step)}
    moments = state.optimizer.state
    for (n, p), e in zip(state.model.named_parameters(), state.ema):
        out[f"model/{n}"] = p.detach().clone()
        out[f"ema/{n}"] = e.clone()
        out[f"adam/exp_avg/{n}"] = moments[p]["exp_avg"].clone()
        out[f"adam/exp_avg_sq/{n}"] = moments[p]["exp_avg_sq"].clone()
    return out


def ddp_batches(batch: int, h: int, w: int, device) -> list:
    """The global batches of phase ddp (a), made on the device from
    SEED + 1, equal in every process."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    return [torch.randn((batch, h, w, 2), generator=gen, device=device)
            for _ in range(DDP_STEPS)]


def ddp_fit(trainer, batches) -> dict:
    """`trainer.fit` over `batches` (log every step), keeping on the card
    the gradients of steps 1 and 2 before the clip (averaged over the
    ranks) and, where a third step runs, the state after step 2."""
    state = trainer.state
    out = {"grads": [], "snapshot": None}
    apply = state.apply_gradients

    def capture():
        if state.step < 2:
            out["grads"].append({n: p.grad.clone() for n, p in
                                 state.model.named_parameters()
                                 if p.grad is not None})
        elif state.step == 2:
            out["snapshot"] = ddp_snapshot(state)
        return apply()

    state.apply_gradients = capture
    trainer.fit(iter(batches), max_steps=len(batches), log_every=1)
    state.apply_gradients = apply
    return out


def to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree


def ddp_vae_setup(device) -> tuple:
    """(state, (gen_step, disc_step), global batch) of phase ddp (c): a VAE
    of ch 32, ch_mult (1, 2), the 2-layer MetaKernel discriminator of ndf 8
    (two BatchNorms), 64x16 images, global batch 4, past disc_start, f32;
    the channel weights keep d_weight below its clip."""
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
    state = vae_trainer.VaeGanState.create(vae.to(device), disc.to(device),
                                           1e-3, cfg)
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.rand(4, 2, 64, 16, generator=g) * 0.8 + 0.1
    return state, vae_trainer.make_vae_gan_steps(cfg), x.to(device)


def ddp_vae_steps(device, rows=slice(None), ref_state: str = None) -> dict:
    """The generator step, then the discriminator step (from `ref_state`,
    the single process's state after its generator step, when given) on
    `rows` of the global batch; metrics and states on the CPU."""
    from rangeldm_tpu_torch.train_vae import DISC, GEN, step_generator
    state, (gen_step, disc_step), x = ddp_vae_setup(device)
    x = x[rows]
    out = {"gen": gen_step(state, x, generator=step_generator(
        SEED, 0, GEN, device))}
    out["after_gen"] = state.state_dict()
    if ref_state is not None:
        state.load_state_dict(torch.load(ref_state, weights_only=True))
    out["disc"] = disc_step(state, x, generator=step_generator(
        SEED, 1, DISC, device))
    out["after_disc"] = state.state_dict()
    return to_cpu(out)


def worker(argv) -> int:
    """A process of phase ddp, started with torchrun's environment.
    `ranks <device> <dir> <cfg.json> <vae ref state> <pipeline> <out>`: a
    rank of two sharing the device over gloo, which runs (a) DDP_STEPS
    flagship steps, (d) `sample_ldm.main` into <out> and (c) the small
    VAE-GAN steps. `cli <device> <dir> <module> <args>...`: a command
    line's `main`, under torchrun for (b). Each writes its results and its
    kernel launches to <dir>/rank{r}.pt."""
    import importlib
    import torch.distributed as dist
    from rangeldm_tpu_torch.ops import kernels
    from rangeldm_tpu_torch.parallel.mesh import (
        distributed, init_distributed, process_shard,
    )
    kind, device, out_dir = argv[0], torch.device(argv[1]), argv[2]

    def launches():
        if device.type == "cuda":
            torch.cuda.synchronize()
        out = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        return out

    result = {}
    if kind == "ranks":
        from rangeldm_tpu_torch import sample_ldm
        from rangeldm_tpu_torch.train_ldm import LdmTrainer
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rank, world = init_distributed(device, backend="gloo")
        with open(argv[3]) as f:
            cfg = json.load(f)
        b = cfg["train_batch_size"] // world
        trainer = LdmTrainer(dict(cfg, train_batch_size=b,
                                  output_dir=os.path.join(out_dir, "run")),
                             device=device)
        h, w = trainer.spec.image_size
        batches = [x[rank * b:(rank + 1) * b] for x in ddp_batches(
            cfg["train_batch_size"], h, w, device)]
        kernels.reset_launches()
        fit = ddp_fit(trainer, batches)
        result["a_launches"] = launches()
        result["final"] = tensors_digest(trainer.state.state_dict())
        result["steps_1_2"] = tensors_digest(
            {f"{i}/{n}": g for i, gs in enumerate(fit["grads"])
             for n, g in gs.items()} | fit["snapshot"])
        if rank == 0:
            result.update(to_cpu(fit))
        del trainer, fit
        sample_ldm.main(ddp_sample_args(argv[5], device) + ["--out", argv[6]])
        result["d_launches"] = launches()
        b = 4 // world
        result["c"] = ddp_vae_steps(device, slice(rank * b, (rank + 1) * b),
                                    argv[4])
    elif kind == "cli":
        importlib.import_module(argv[3]).main(argv[4:])
        result["launches"] = launches()
    else:
        raise ValueError(kind)
    rank, world = process_shard()
    result.update(rank=rank, world=world,
                  backend=dist.get_backend() if distributed() else None)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if distributed():
        dist.destroy_process_group()
    return 0


def ddp_sample_args(pipeline: str, device) -> list:
    """sample_ldm's arguments in phase ddp (d)."""
    return ["--pipeline", pipeline, "--samples", str(DDP_SAMPLES),
            "--batch_size", str(DDP_SAMPLE_BATCH), "--steps",
            str(DDP_SAMPLE_STEPS), "--device", str(device)]


def start(args, env_extra=None) -> subprocess.Popen:
    """`python3 <args>` with this script's environment, torchrun's
    variables removed, then `env_extra`; output to a pipe."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def start_ranks(args, world: int = DDP_RANKS) -> list:
    """`world` ranks of `python3 <args>` with torchrun's variables on a
    free local port (explicit: nothing tells a process of a cluster)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return [start(args, {"RANK": str(r), "LOCAL_RANK": str(r),
                         "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                         "MASTER_PORT": str(port)}) for r in range(world)]


def finish(procs, what: str) -> list:
    """Wait for every process (RANK_TIMEOUT each; the rest are killed on
    failure); each must exit 0. Returns their output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{what}: process {i} exited "
                                   f"{p.returncode}:\n{out[-4000:]}")
    return outs


def grad_gap(got: dict, want: dict) -> float:
    """The largest gradient difference over the largest gradient entry."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[n] - g).abs().max()) for n, g in want.items()) / \
        scale


def phase_ddp(kernels, data_root: str, smi, device: str = "cuda:0") -> dict:
    """Data parallelism over torch.distributed and the projection core.
    Two ranks share the card over gloo and run (a) the flagship step
    (batch 16 each, global 32, bf16, DDP_STEPS steps) against one process
    on the global batch from the same state: gradients of steps 1 and 2,
    losses, the state after step 2 within what one Adam step explains, the
    ranks bit-equal, launches and steps/s; (d) `sample_ldm.main` split over
    them against one process: equal files; (c) the small VAE-GAN steps
    against one process: d_weight, metrics, the global batch's BatchNorm
    statistics, parameters. Then (b) `train_ldm.main` under torchrun, a
    world of one over NCCL, on the flagship YAML over the synthetic root,
    and (e) the C++ projection core against numpy on 120,000-point scans,
    alone and from 8 threads. Returns the attention and GroupNorm launches
    of the distributed runs."""
    from rangeldm_tpu_torch import sample_ldm
    from rangeldm_tpu_torch.geometry.projection import range_image_np
    from rangeldm_tpu_torch.geometry.sensors import get_spec
    from rangeldm_tpu_torch.models.vae import gaussian_sample
    from rangeldm_tpu_torch.native import range_image_native
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    from rangeldm_tpu_torch.train_vae import GEN, step_generator

    script = os.path.abspath(__file__)
    t_phase = time.perf_counter()
    attention = ("attention_fwd", "attention_bwd")
    launches = dict.fromkeys((*attention, *GN_KERNELS), 0)

    def count(*dicts):
        for d in dicts:
            for k in launches:
                launches[k] += d.get(k, 0)

    def load(d, n):
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=True) for r in range(n)]

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the single process's runs: (a) two steps on the global batch,
        # whose pipeline (d) samples; (c) the VAE-GAN steps
        ref_dir, a_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "a")
        os.makedirs(a_dir)
        cfg_path = os.path.join(tmp, "train_cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(TRAIN_CFG, f)
        trainer = LdmTrainer(dict(TRAIN_CFG, output_dir=ref_dir),
                             device=device)
        unet_sites = gn_sites(trainer.unet)
        enc_sites = gn_sites(trainer.vae.encoder)
        dec_sites = gn_sites(trainer.vae.decoder)
        h, w = trainer.spec.image_size
        batch = TRAIN_CFG["train_batch_size"]
        ref = to_cpu(ddp_fit(trainer, ddp_batches(batch, h, w,
                                                  device)[:2]))
        ref["snapshot"] = to_cpu(ddp_snapshot(trainer.state))
        lr = trainer.state.schedule(1)
        pipeline = trainer.save_final()
        del trainer
        vae_ref = ddp_vae_steps(device)
        state, _, x = ddp_vae_setup(device)
        with torch.no_grad():
            moments = state.vae.encode_moments(x)
            bsz, c, *rest = moments.shape
            noise = torch.randn((bsz, c // 2, *rest), device=device,
                                generator=step_generator(SEED, 0, GEN,
                                                         device))
            xrec = state.vae.decode(gaussian_sample(moments, noise=noise))
        # no pixel within rounding of the L1 kink
        kink = float((x - xrec).abs().min())
        require(kink > 2e-5, f"ddp (c): a pixel {kink} from the L1 kink")
        vae_state = os.path.join(tmp, "vae_ref.pt")
        torch.save(vae_ref["after_gen"], vae_state)
        one, two = os.path.join(tmp, "one"), os.path.join(tmp, "two")
        sample_ldm.main(ddp_sample_args(pipeline, device) + ["--out", one])

        t0 = time.perf_counter()
        finish(start_ranks([script, "worker", "ranks", device, a_dir,
                            cfg_path, vae_state, pipeline, two]),
               "ddp (a), (c), (d)")
        ranks_seconds = time.perf_counter() - t0
        r0, r1 = load(a_dir, DDP_RANKS)

        # (a)
        require(r0["final"] == r1["final"]
                and r0["steps_1_2"] == r1["steps_1_2"],
                "ddp (a): the ranks' states or gradients differ")
        require(r0["backend"] == "gloo" and r0["world"] == DDP_RANKS,
                f"ddp (a): {r0['backend']}, world {r0['world']}")
        # a step: the VAE encoder, the UNet forward and backward
        gn_want = ((unet_sites + enc_sites) * DDP_STEPS,
                   unet_sites * DDP_STEPS)
        for r in (r0, r1):
            for k in attention:
                require(r["a_launches"].get(k) == 16 * DDP_STEPS,
                        f"ddp (a): rank {r['rank']} launched {k} "
                        f"{r['a_launches'].get(k)} times, expected "
                        f"{16 * DDP_STEPS}")
            got = tuple(r["a_launches"].get(k) for k in GN_KERNELS)
            require(got == gn_want, f"ddp (a): rank {r['rank']} launched the "
                                    f"GroupNorm pair {got}, expected "
                                    f"{gn_want}")
        count(r0["a_launches"], r1["a_launches"])
        log, ref_log = read_log(os.path.join(a_dir, "run")), read_log(ref_dir)
        require([x["step"] for x in log] == list(range(1, DDP_STEPS + 1)),
                f"ddp (a): rank 0's log {log}")
        gaps = [grad_gap(g, wnt) for g, wnt in zip(r0["grads"],
                                                  ref["grads"])]
        loss_gaps = [abs(x["loss"] - y["loss"]) / abs(y["loss"])
                     for x, y in zip(log, ref_log)]
        require(max(gaps) <= DDP_GRAD_TOL and max(loss_gaps) <= DDP_GRAD_TOL,
                f"ddp (a): gradient gaps {gaps}, loss gaps {loss_gaps}")
        bad = adam_update_mismatches(r0["snapshot"], ref["snapshot"],
                                     ("model/", "ema/"), lr,
                                     moment_tol=DDP_GRAD_TOL,
                                     optimizer="adam", betas=(0.95, 0.999))
        require(not bad, f"ddp (a): after step 2, {bad[:5]}")
        ends = [x["step"] / x["sps"] for x in log]
        out["a"] = dict(
            ranks=DDP_RANKS, backend="gloo", device=device,
            batch_per_rank=batch // DDP_RANKS, steps=DDP_STEPS,
            steps_per_s=(DDP_STEPS - 1) / (ends[-1] - ends[0]),
            grad_gap=gaps, grad_bound=DDP_GRAD_TOL, loss_gap=loss_gaps,
            params_outside_adam_bound=len(bad), ranks_bit_equal=True,
            launches_per_rank=r0["a_launches"],
            losses=[x["loss"] for x in log],
            ranks_seconds=ranks_seconds)

        # (d)
        n_batches = -(-DDP_SAMPLES // DDP_SAMPLE_BATCH)
        for r in (r0, r1):
            calls = len(range(r["rank"], n_batches, DDP_RANKS))
            want = 16 * DDP_SAMPLE_STEPS * calls
            gn_want = (unet_sites * DDP_SAMPLE_STEPS + dec_sites) * calls
            require(r["d_launches"].get("attention_fwd") == want
                    and r["d_launches"].get(GN_KERNELS[0]) == gn_want
                    and r["d_launches"].get(GN_KERNELS[1]) == 0,
                    f"ddp (d): rank {r['rank']} {r['d_launches']}, expected "
                    f"{want} attention and {gn_want} GroupNorm launches")
        count(r0["d_launches"], r1["d_launches"])
        files = sorted(os.listdir(one))
        require(files == sorted(os.listdir(two))
                and len(files) == 3 * DDP_SAMPLES,
                f"ddp (d): {files} against {sorted(os.listdir(two))}")
        differ = [f for f in files if open(os.path.join(one, f), "rb").read()
                  != open(os.path.join(two, f), "rb").read()]
        require(not differ, f"ddp (d): files differ: {differ}")
        out["d"] = dict(ranks=DDP_RANKS, samples=DDP_SAMPLES,
                        batch=DDP_SAMPLE_BATCH, steps=DDP_SAMPLE_STEPS,
                        files_equal=len(files))

        # (c)
        c0, c1 = r0["c"], r1["c"]
        require(all(state_equal(c0[k], c1[k]) == []
                    for k in ("after_gen", "after_disc"))
                and all(torch.equal(v, c1[s][k]) for s in ("gen", "disc")
                        for k, v in c0[s].items()),
                "ddp (c): the ranks differ")
        rel = max(abs(float(c0[s][k]) - float(v)) / max(abs(float(v)), 1e-3)
                  for s in ("gen", "disc") for k, v in vae_ref[s].items())
        d_weight = float(c0["gen"]["d_weight"])
        problems = []
        for key, prefixes in (("after_gen", ("vae/", "ema/", "logvar")),
                              ("after_disc", ("disc/",))):
            problems += adam_update_mismatches(c0[key], vae_ref[key],
                                               prefixes, 1e-3)
            stats = [k for k in vae_ref[key] if "running" in k]
            require(len(stats) == 4, f"ddp (c): statistics {stats}")
            problems += [f"{key} {k}" for k in stats if float(
                (c0[key][k] - vae_ref[key][k]).abs().max()) > VAE_STATS_TOL]
        require(rel <= VAE_CARD_TOL and not problems
                and 0 < d_weight < 1e4 * 0.5,
                f"ddp (c): metrics {rel}, d_weight {d_weight}, "
                f"{problems[:5]}")
        out["c"] = dict(ranks=DDP_RANKS, global_batch=4, metrics_rel=rel,
                        d_weight=d_weight,
                        d_weight_ref=float(vae_ref["gen"]["d_weight"]),
                        kink_gap=kink, ranks_bit_equal=True)
        del r0, r1, ref

        # (b) the training CLI under torchrun: a world of one over NCCL
        b_dir = os.path.join(tmp, "b")
        os.makedirs(b_dir)
        override = write_yaml(os.path.join(tmp, "b.yaml"), {
            "output_dir": b_dir, "data": {"root": data_root},
            "log_every": 1})
        t0 = time.perf_counter()
        finish([start([
            "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", script, "worker", "cli", device,
            b_dir, "rangeldm_tpu_torch.train_ldm", "--cfg", FLAGSHIP_YAML,
            override, "--max_steps", str(DDP_CLI_STEPS),
            # on the card the rank's own device, cuda:{LOCAL_RANK}
            *([] if "cuda" in device else ["--device", device])])],
            "ddp (b)")
        b_seconds = time.perf_counter() - t0
        (rb,) = load(b_dir, 1)
        require(rb["backend"] == ("nccl" if "cuda" in device else "gloo")
                and rb["world"] == 1,
                f"ddp (b): {rb['backend']}, world {rb['world']}")
        for k in attention:
            require(rb["launches"].get(k) == 16 * DDP_CLI_STEPS,
                    f"ddp (b): {k} launched {rb['launches'].get(k)} times")
        gn_want = ((unet_sites + enc_sites) * DDP_CLI_STEPS,
                   unet_sites * DDP_CLI_STEPS)
        got = tuple(rb["launches"].get(k) for k in GN_KERNELS)
        require(got == gn_want, f"ddp (b): the GroupNorm pair launched {got}, "
                                f"expected {gn_want}")
        count(rb["launches"])
        log = read_log(b_dir)
        require([x["step"] for x in log] == list(range(1, DDP_CLI_STEPS + 1))
                and all(np.isfinite(x["loss"]) for x in log),
                f"ddp (b): log {log}")
        require({"unet", "unet_ema", "vae"} <= set(os.listdir(
            os.path.join(b_dir, "pipeline"))), "ddp (b): no pipeline")
        ends = [x["step"] / x["sps"] for x in log]
        out["b"] = dict(
            world=1, backend=rb["backend"], launcher="torch.distributed.run",
            batch=TRAIN_BATCH, steps=DDP_CLI_STEPS,
            steps_per_s=(DDP_CLI_STEPS - 1) / (ends[-1] - ends[0]),
            data_wait_frac=log[-1]["data_wait_frac"], seconds=b_seconds,
            launches=rb["launches"])

    # (e) the projection core against numpy, alone and in 8 loader threads
    scans = [np.fromfile(f, np.float32).reshape(-1, 4) for f in sorted(
        glob_scans(data_root))[:8]]
    spec = get_spec("kitti360")
    range_image_native(scans[0], spec)                       # build, warm
    timed = {}
    for name, fn in (("numpy", range_image_np), ("native",
                                                  range_image_native)):
        t0 = time.perf_counter()
        res = [fn(pc, spec) for pc in scans]
        timed[name] = ((time.perf_counter() - t0) / len(scans) * 1e3, res)
    gap = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(
        timed["native"][1], timed["numpy"][1]))
    pixels = sum(int((np.abs(a[0] - b[0]).max(-1) > 1e-5).sum())
                 for a, b in zip(timed["native"][1], timed["numpy"][1]))
    threads = {}
    for team in ("default", "one"):
        threads[team] = threaded_projection_ms(scans, spec, team)
    out["e"] = dict(scan_points=SCAN_POINTS, scans=len(scans),
                    numpy_ms_per_scan=timed["numpy"][0],
                    native_ms_per_scan=timed["native"][0],
                    max_abs_gap=gap, pixels_above_1e5=pixels,
                    loader_threads_ms_per_scan=threads,
                    host_cpus=os.cpu_count())
    emit("ddp", card=smi, seconds=time.perf_counter() - t_phase,
         launches=launches, **out)
    return launches


def glob_scans(root: str) -> list:
    import glob
    return glob.glob(os.path.join(root, "data_3d_raw", "*_0003_sync",
                                  "velodyne_points", "data", "*.bin"))


def threaded_projection_ms(scans, spec, team: str) -> float:
    """Wall ms per scan of the native core called from 8 threads at once,
    as the loader's pool calls it, 4 passes over the scans: with OpenMP's
    default team in every call, or one thread per call ("one", set in each
    calling thread through libgomp's omp_set_num_threads)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from rangeldm_tpu_torch.native import range_image_native
    gomp = ctypes.CDLL("libgomp.so.1")

    def call(pc):
        if team == "one":
            gomp.omp_set_num_threads(1)
        return range_image_native(pc, spec)

    work = scans * 4
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(call, scans))                          # warm
        t0 = time.perf_counter()
        list(pool.map(call, work))
        return (time.perf_counter() - t0) / len(work) * 1e3


def synthetic_ring_scan(rng, n: int, n_beams: int = 32) -> np.ndarray:
    """A nuScenes-like (N + PROJ_NEAR, 5) scan: `synthetic_scan` with a ring
    column, after PROJ_NEAR points at 0.5 m that would win their pixels
    without the 2 m min_depth."""
    pc = synthetic_scan(rng, n)
    pc = np.concatenate([pc, rng.integers(0, n_beams, (n, 1)).astype(
        np.float32)], axis=1)
    near = pc[:PROJ_NEAR].copy()
    near[:, :3] *= 0.5 / np.linalg.norm(near[:, :3], axis=1, keepdims=True)
    return np.concatenate([near, pc])


def phase_projection(smi, device: str = "cuda:0") -> dict:
    """The tensor projection on the card, for each of PROJ_SENSORS: a batch
    of PROJ_BATCH scans through `range_image` on `device`, against
    `range_image_np` and the C++ core scan by scan (mismatched values, mask
    and car-window pixels within PROJ_BOUNDS), the batch bit-equal to the
    scans one at a time and to a second call, nothing under min_depth
    winning; then its ms per scan at batch 8 (CUDA events), the host-to-card
    copy of the padded points apart, peak memory and the least time of the
    bytes it must move, beside the C++ core's and numpy's ms per scan on
    the host."""
    from rangeldm_tpu_torch.geometry import (
        get_spec, pad_points, project, range_image, range_image_np,
    )
    from rangeldm_tpu_torch.native import range_image_native

    t_phase = time.perf_counter()
    dev = torch.device(device)
    out = {}
    for k, name in enumerate(PROJ_SENSORS):
        spec = get_spec(name)
        rng = np.random.default_rng(SEED + k)
        ring = spec.row_mode == "ring"
        scans = [synthetic_ring_scan(rng, SCAN_POINTS) if ring
                 else synthetic_scan(rng, SCAN_POINTS)
                 for _ in range(PROJ_BATCH)]
        padded = [pad_points(pc, PROJ_POINTS) for pc in scans]
        pts_host = torch.from_numpy(np.stack([p for p, _ in padded]))
        valid_host = torch.from_numpy(np.stack([v for _, v in padded]))
        pts, valid = pts_host.to(dev), valid_host.to(dev)

        got = range_image(pts, valid, spec)
        again = range_image(pts, valid, spec)
        torch.cuda.synchronize()
        require(all(t.device == pts.device for t in got),
                f"{name}: the image left the card")
        require(got[0].shape == (PROJ_BATCH, spec.n_beams, spec.width, 2),
                f"{name}: image {tuple(got[0].shape)}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{name}: two calls differ")
        for i in range(PROJ_BATCH):
            one = range_image(pts[i], valid[i], spec)
            require(all(torch.equal(a[i], b) for a, b in zip(got, one)),
                    f"{name}: scan {i} of the batch differs from it alone")
        if spec.min_depth > 0:
            raw = project(pts, valid, spec)
            hit = raw[..., 0] > 0
            require(bool(hit.any()) and float(raw[..., 0][hit].min())
                    > spec.min_depth, f"{name}: a point under min_depth won")

        card = [t.cpu().numpy() for t in got]
        timed, counts = {}, {}
        for ref, fn in (("numpy", range_image_np),
                        ("native", range_image_native)):
            fn(scans[0], spec)                               # build, warm
            t0 = time.perf_counter()
            refs = [fn(pc, spec) for pc in scans]
            timed[f"{ref}_ms_per_scan"] = ((time.perf_counter() - t0)
                                           / PROJ_BATCH * 1e3)
            per_scan = []
            for i, (img, mask, cw) in enumerate(refs):
                c = (int((~np.isclose(card[0][i], img, rtol=1e-5,
                                      atol=1e-5)).sum()),
                     int((card[1][i] != mask).sum()),
                     int((card[2][i] != cw).sum()))
                require(all(x <= b for x, b in zip(c, PROJ_BOUNDS)),
                        f"{name} scan {i} against {ref}: (values, mask, "
                        f"car window) mismatches {c} above {PROJ_BOUNDS}")
                per_scan.append(c)
            counts[ref] = dict(
                max_per_scan=[max(c[j] for c in per_scan) for j in range(3)],
                total=[sum(c[j] for c in per_scan) for j in range(3)])

        iters = 20
        batch_ms = cuda_ms(lambda: range_image(pts, valid, spec), iters)
        copy_ms = cuda_ms(lambda: (pts_host.to(dev), valid_host.to(dev)),
                          iters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        range_image(pts, valid, spec)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # each input read once (points, validity), each output written once
        # (the image, the mask and the car window)
        nbytes = (pts.numel() * 4 + valid.numel()
                  + got[0].numel() * 4 + got[1].numel() + got[2].numel())
        out[name] = dict(
            row_mode=spec.row_mode, batch=PROJ_BATCH, points=SCAN_POINTS,
            padded_to=PROJ_POINTS, card_ms_per_scan=batch_ms / PROJ_BATCH,
            card_batch_ms=batch_ms, copy_ms_per_scan=copy_ms / PROJ_BATCH,
            copy_bytes=pts.numel() * 4 + valid.numel(),
            bound_ms_per_scan=nbytes / PEAK_BYTES * 1e3 / PROJ_BATCH,
            peak_memory_gib_above_inputs=peak / 2 ** 30,
            mask_pixels_per_scan=float(card[1].sum() / PROJ_BATCH),
            mismatches=counts, host_cpus=os.cpu_count(), **timed)
        del pts, valid, got, again
    emit("projection", card=smi, bounds=PROJ_BOUNDS,
         seconds=time.perf_counter() - t_phase, **out)
    return out


def summary(rows, launches, gn_rows, norm_rows):
    """One entry per kernel, over the attention layers of one flagship UNet
    in bf16 at the batch of the path that carries it most: the forward at
    sampling batch 4, the backward at training batch 32. Time, plain time
    and library time are summed over those layers; the bound is that of
    the same work; the error is the largest at those shapes. The GroupNorm
    pair's entries sum its GN_SITES rows, one call each; their launches
    are the main paths' calls (the backward's, of two launches each), and
    those of one flagship UNet pass are measured in phase norm_models."""
    entries = []
    for kernel, batch, replaces in (
            ("attention_fwd", BATCH, "rangeldm_tpu/ops/attention.py:48"),
            ("attention_bwd", TRAIN_BATCH,
             "rangeldm_tpu/ops/attention.py:115")):
        main = [r for r in rows if r["kernel"] == kernel
                and r["model"] == "rangeldm_kitti360"
                and r["batch"] == batch and r["dtype"] == "bfloat16"]

        def total(key):
            return sum(r[key] * r["layers_per_unet_forward"] for r in main)

        bound_ms, bound_by = bound(total("flops"), total("bytes"),
                                   torch.bfloat16)
        entries.append({
            "name": kernel, "route": "cuda",
            "source": f"rangeldm_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": total("library_ms")})
    (unet,) = [r for r in norm_rows
               if r["model"] == "flagship unet, training"]
    for kernel in GN_KERNELS:
        main = [r for r in gn_rows if r["kernel"] == kernel]
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "rangeldm_tpu_torch/csrc/group_norm_act.cu",
            "replaces": None, "sites": len(main),
            "launches": launches[kernel],
            "launches_per_flagship_unet": unet["launches"][kernel],
            "max_err": max(r["max_err"] for r in main),
            **{key: sum(r[key] for r in main) for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes"})
    return {"kernels": entries}


def main() -> int:
    if sys.argv[1:2] == ["worker"]:          # a process of phase ddp
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # read when cuBLAS makes its handle: deterministic GEMMs need it
    # (phase vae_train's resume check)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rangeldm_tpu_torch import models
    from rangeldm_tpu_torch.ops import attention, group_norm, kernels

    smi, clock_hz = phase_device()
    phase_build(kernels)
    rows = phase_kernels(attention, clock_hz)
    gn_rows = phase_group_norm(group_norm)
    phase_unet(kernels, models)
    phase_unet_grad(kernels, models)
    norm_rows = phase_norm_models(kernels, models)
    # the hand-written kernels' launches over the main paths
    launches = dict.fromkeys(("attention_fwd", "attention_bwd", *GN_KERNELS),
                             0)

    def add(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    add(phase_main(kernels, models, smi))
    add(phase_train(kernels, smi))
    with tempfile.TemporaryDirectory() as tmp:
        data_root = make_kitti_root(os.path.join(tmp, "kitti360"))
        samples_root = os.path.join(tmp, "samples")
        add(phase_conditional(kernels, models, data_root, smi, samples_root))
        add(phase_cond_train(kernels, data_root, smi))
        add(phase_train_cli(kernels, data_root, smi))
        kernels.reset_launches()
        vae = phase_vae_train(data_root, smi)
        torch.cuda.synchronize()
        require(not any(kernels.LAUNCHES[k] for k in ("attention_fwd",
                                                      "attention_bwd")),
                f"VAE-GAN training launched {kernels.LAUNCHES}: its path "
                f"holds no attention")
        add(vae["launches"])
        add(phase_ddp(kernels, data_root, smi))
        launches["attention_fwd"] += phase_eval(kernels, models,
                                                samples_root, smi)
    phase_t64(models, smi)
    launches["attention_fwd"] += phase_spatial(kernels, models, smi)
    kernels.reset_launches()
    phase_projection(smi)
    torch.cuda.synchronize()
    require(not any(kernels.LAUNCHES.values()),
            f"the projection launched {kernels.LAUNCHES}: its path holds no "
            f"attention")
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps(summary(rows, launches, gn_rows, norm_rows)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
