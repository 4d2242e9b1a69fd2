"""A temporary copy of the benchmark with tiny configurations and cells
added as new files, for runs of the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness import BENCH_DIR

TINY_UNET = {
    "sample_size": [16, 4], "in_channels": 5, "out_channels": 4,
    "layers_per_block": 1, "block_out_channels": [32, 32],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "attention_head_dim": 8}
TINY_VAE = {
    "in_channels": 2, "out_ch": 2, "ch": 32, "ch_mult": [1, 2],
    "num_res_blocks": 1, "z_channels": 4, "double_z": True,
    "attn_type": "none", "act": "silu", "circular": True, "coord": False,
    "use_quant_conv": False, "scaling_factor": 0.18215}
TINY_PIXEL = dict(TINY_UNET, sample_size=[32, 8], in_channels=3,
                  out_channels=2)

# (cell, config, mix, the cell of the benchmark whose limits it takes)
CELLS = [
    ("tiny_sample_ddim", "tiny_ldm", "tiny_ddim", "ldm_sample_ddim50_b32"),
    ("tiny_sample_dpmpp", "tiny_ldm", "tiny_dpmpp", "ldm_sample_ddim50_b32"),
    ("tiny_train_ldm", "tiny_ldm", "tiny_train", "ldm_train_b32"),
    ("tiny_train_dm", "tiny_dm", "tiny_train", "dm_train_b8"),
]


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_copy(tmp: Path, dtype: str = "no") -> Path:
    """Copy BENCHMARK.json and perfbench/ under `tmp` and add the tiny
    files; the configurations compute in float32 unless `dtype` is
    "bf16". Returns the copy's benchmark directory."""
    root = tmp / "checkout"
    bench = root / "perfbench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    benchmark = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    flagship = json.loads((BENCH_DIR / "configs" /
                           "rangeldm_kitti360.json").read_text())
    pixel = json.loads((BENCH_DIR / "configs" /
                        "rangedm_kitti360.json").read_text())
    _dump(bench / "configs" / "tiny_ldm.json", dict(
        flagship, name="tiny_ldm", model_config=TINY_UNET,
        vae_config=TINY_VAE, image_size=[8, 32], mixed_precision=dtype,
        log_every=2))
    _dump(bench / "configs" / "tiny_dm.json", dict(
        pixel, name="tiny_dm", model_config=TINY_PIXEL, image_size=[8, 32],
        mixed_precision=dtype, log_every=2))
    mixes = {
        "tiny_ddim": {"kind": "sampling", "batch": 3, "steps": 4,
                      "method": "ddim", "check_calls": 2, "trace_calls": 1,
                      "chunk": 2},
        "tiny_dpmpp": {"kind": "sampling", "batch": 2, "steps": 4,
                       "method": "dpmpp", "check_calls": 2,
                       "trace_calls": 1, "chunk": 2},
        "tiny_train": {"kind": "train", "batch": 4, "pool": 4,
                       "check_steps": 3, "trace_steps": 2, "chunk": 2},
    }
    for name, mix in mixes.items():
        _dump(bench / "traffic" / f"{name}.json", mix)
    for cell, config, mix, like in CELLS:
        spec = json.loads((BENCH_DIR / "workloads" /
                           f"{like}.json").read_text())
        _dump(bench / "workloads" / f"{cell}.json", dict(
            spec, name=cell, config=config, traffic=mix))
        for metric in benchmark["end_to_end"] + benchmark["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    _dump(root / "BENCHMARK.json", benchmark)
    return bench
