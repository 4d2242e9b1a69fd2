"""FRD and segmentation scores end to end (the RangeNet++ inference run
orchestrated by metrics/metric.py:15-24, 71-135).

Projects generated .bin point clouds and reference scans with the
LiDARGen-style LaserScan projection (metrics histogram.py:210-270: uniform
fov +3/-25, floor binning, descending-depth overwrite) on the host, feeds
them in batches through darknet53 on the device (the released checkpoint),
and computes the Frechet distance over decoder features, or IoU/accuracy
over the head's label maps.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from rangeldm_tpu_torch.geometry.laserscan import laserscan_project
from rangeldm_tpu_torch.metrics.frd import frd_from_activations, frd_indices
from rangeldm_tpu_torch.metrics.rangenet import RangeNet, preprocess_scan

FEATURES = 32          # channels of the decoder's last feature map


def load_rangenet(model_dir: str, device=None) -> RangeNet:
    """The released darknet53-1024 checkpoint (backbone /
    segmentation_decoder / optional segmentation_head torch files, read
    with weights_only=True) on `device` (default: the CUDA device)."""
    from rangeldm_tpu_torch.convert import load_torch_state_dict
    from rangeldm_tpu_torch.sample_ldm import resolve_device

    def find(name):
        for cand in (name, name + ".pth", name + ".pytorch"):
            p = os.path.join(model_dir, cand)
            if os.path.exists(p):
                return load_torch_state_dict(p)
        return None

    backbone = find("backbone")
    decoder = find("segmentation_decoder")
    head = find("segmentation_head")
    if backbone is None or decoder is None:
        raise FileNotFoundError(
            f"backbone/segmentation_decoder not found in {model_dir}")
    model = RangeNet.from_state_dicts(backbone, decoder, head)
    return model.to(resolve_device(device))


def project_scan(pc: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, 4) cloud -> the normalized (5, h, w) RangeNet input."""
    pr, pxyz, prem, pm = laserscan_project(pc[:, :3], pc[:, 3], h=h, w=w)
    return preprocess_scan(pr, pxyz, prem, pm).transpose(2, 0, 1)


@torch.inference_mode()
def run_batched(fn: Callable[[torch.Tensor], torch.Tensor], device,
                scans: Iterable[np.ndarray], batch_size: int, h: int,
                w: int) -> np.ndarray:
    """Project each scan on the host and run `fn` on (B, 5, h, w) batches
    on `device`, concatenating the host copies of its results. The last
    batch stays ragged: BatchNorm runs on running statistics, so each
    scan's result depends on that scan alone."""
    inputs, outs = [], []

    def flush():
        batch = torch.from_numpy(np.stack(inputs)).to(device)
        outs.append(fn(batch).cpu().numpy())
        inputs.clear()

    for pc in scans:
        inputs.append(project_scan(pc, h, w))
        if len(inputs) == batch_size:
            flush()
    if inputs:
        flush()
    return np.concatenate(outs) if outs else None


def _device(model: RangeNet) -> torch.device:
    return next(model.parameters()).device


def extract_features(model: RangeNet, scans: Iterable[np.ndarray],
                     batch_size: int = 8, h: int = 64,
                     w: int = 1024) -> np.ndarray:
    """scans: iterable of (N, 4) point clouds -> (n, 32, h, w) float32."""
    out = run_batched(lambda x: model(x)[0], _device(model), scans,
                      batch_size, h, w)
    return out if out is not None else np.zeros((0, FEATURES, h, w),
                                                np.float32)


def extract_labels(model: RangeNet, scans: Iterable[np.ndarray],
                   batch_size: int = 8, h: int = 64,
                   w: int = 1024) -> np.ndarray:
    """scans: iterable of (N, 4) point clouds -> (n, h, w) int32 label maps
    (the head's argmax: the reference's rangenetpp segmentation dump
    consumed by iou.py; no KNN)."""
    if not model.with_head:
        raise ValueError("RangeNet was loaded without a segmentation head")
    out = run_batched(
        lambda x: torch.argmax(model(x)[1], dim=1).to(torch.int32),
        _device(model), scans, batch_size, h, w)
    return out if out is not None else np.zeros((0, h, w), np.int32)


def _numeric_sorted(files: List[str]) -> List[str]:
    """{i}.npy dumps in index order (the reference pairs result/target by
    integer filename, iou.py:10-23)."""
    def key(f):
        stem = os.path.splitext(os.path.basename(f))[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)
    return sorted(files, key=key)


def generated_sample_files(sample_dir: str, limit: int) -> List[str]:
    """The sample CLI's unpadded {i}.bin dumps, truncated to `limit` in
    INTEGER index order: a lexicographic sort would select
    {0, 1, 10, 100, 1000, ...}, a different subset than the reference's
    first-N-by-index pairing."""
    files = _numeric_sorted(
        glob.glob(os.path.join(sample_dir, "*.bin")))[:limit]
    if not files:
        raise FileNotFoundError(
            f"no generated .bin samples under {sample_dir}")
    return files


def _dump_files(sample_dir: str, prefix: str, sub: str,
                limit: int) -> List[str]:
    """{prefix}_{sub}/{i}.npy dumps in index order, truncated to limit."""
    files = _numeric_sorted(glob.glob(
        os.path.join(sample_dir, f"{prefix}_{sub}", "*.npy")))[:limit]
    if not files:
        raise FileNotFoundError(
            f"no dumps under {sample_dir}/{prefix}_{sub}")
    return files


def paired_dump_files(sample_dir: str, prefix: str, limit: int):
    """(result files, target files) of a triplet dump, which must hold the
    same index set: equal counts alone can hide a missing dump on one side
    and an extra one on the other, and pairing by position would then
    score result i against target j."""
    res = _dump_files(sample_dir, prefix, "result", limit)
    tgt = _dump_files(sample_dir, prefix, "target", limit)
    rn = [os.path.basename(f) for f in res]
    tn = [os.path.basename(f) for f in tgt]
    if rn != tn:
        raise ValueError(
            f"{prefix} result/target dumps are not the same index set; "
            f"differing: {sorted(set(rn) ^ set(tn))[:8]}")
    return res, tgt


def _dump_scans(files: List[str], spec, max_depth: float = 90.0):
    """Load {i}.npy normalized range-image dumps (sample_conditional
    triplets), back-project with the training sensor spec, and yield
    depth-filtered (N, 4) point clouds."""
    from rangeldm_tpu_torch.geometry.inverse import to_point_cloud
    for f in files:
        img = np.load(f)
        if img.ndim == 2:
            img = img[..., None]
        pc = to_point_cloud(torch.from_numpy(
            np.asarray(img[None], np.float32)), spec)[0].numpy()
        depth = np.linalg.norm(pc[:, :3], axis=1)
        pc = pc[(depth > 1e-3) & (depth < max_depth)]
        if pc.shape[1] == 3:
            pc = np.concatenate(
                [pc, np.zeros((len(pc), 1), pc.dtype)], axis=1)
        yield pc.astype(np.float32)


def compute_segmentation_scores(sample_dir: str, prefix: str,
                                rangenet_dir: Optional[str],
                                sensor: str = "kitti360",
                                limit: int = 1000,
                                encoding: str = "linear",
                                device=None) -> dict:
    """IoU / accuracy over RangeNet segmentations of conditional result vs
    target dumps (metric.py:71-97: segment both dump dirs, then weighted
    jaccard + pixel accuracy over the paired label maps).

    `encoding` must match the range encoding the dumps were written with
    (the sampler dumps the training normalization verbatim): decoding
    log/inverse dumps with the linear default would back-project
    geometrically wrong clouds and score garbage silently."""
    if rangenet_dir is None:
        raise ValueError("--rangenet checkpoint dir required for IoU")
    from rangeldm_tpu_torch.geometry.sensors import get_spec
    from rangeldm_tpu_torch.metrics.mae import (
        segmentation_accuracy, segmentation_iou,
    )
    spec = get_spec(sensor, log=encoding == "log",
                    inverse=encoding == "inverse")
    if encoding == "none":
        # raw-meter dumps: identity denormalization (the --mae path's
        # 'none' decoding); remapping 'none' to linear would back-project
        # 40*v+20 instead of v, silently
        spec = spec.replace(mean=0.0, std=1.0)
    res_files, tgt_files = paired_dump_files(sample_dir, prefix, limit)
    model = load_rangenet(rangenet_dir, device)
    res = extract_labels(model, _dump_scans(res_files, spec))
    tgt = extract_labels(model, _dump_scans(tgt_files, spec))
    return {"iou": segmentation_iou(res, tgt),
            "accuracy": segmentation_accuracy(res, tgt)}


def compute_frd_for_dirs(sample_dir: str, reference_files: List[str],
                         rangenet_dir: Optional[str],
                         limit: int = 1000, batch_size: int = 8,
                         h: int = 64, w: int = 1024, device=None) -> float:
    """FRD between the generated `{i}.bin` dumps and the held-out scans
    (metrics/metric.py:99-135). Generated files pair and truncate in
    INTEGER index order. The 4096-dim subsample is gathered on the device
    inside the batched forward: full (N, 32, 64, 1024) feature stacks are
    about 8.4 GB a side at the reference's N=1000, against about 16 MB a
    side of activations."""
    if rangenet_dir is None:
        raise ValueError("--rangenet checkpoint dir required for FRD")
    gen_files = generated_sample_files(sample_dir, limit)
    ref_files = list(reference_files[:limit])
    if not ref_files:
        raise FileNotFoundError("no held-out reference scans to score "
                                "against (empty reference_files)")
    model = load_rangenet(rangenet_dir, device)
    dev = _device(model)
    idx = torch.as_tensor(frd_indices(total=h * w * FEATURES), device=dev)

    def activations(x):
        # NCHW is the reference's CHW flatten order: no transpose
        return model(x)[0].flatten(1)[:, idx]

    def acts(files):
        return run_batched(activations, dev, (
            np.fromfile(f, np.float32).reshape(-1, 4) for f in files),
            batch_size, h, w)

    return frd_from_activations(acts(gen_files), acts(ref_files))
