"""Evaluation command line (metrics/metric.py).

    python -m rangeldm_tpu_torch.evaluate --exp samples/ --mmd --jsd [--nus]
    python -m rangeldm_tpu_torch.evaluate --exp runs/up --mae
    python -m rangeldm_tpu_torch.evaluate --exp samples/ --frd \
        --rangenet /path/to/darknet53-1024
    python -m rangeldm_tpu_torch.evaluate --exp runs/up --iou --accuracy \
        --rangenet /path/to/darknet53-1024

The reference distribution for KITTI-360 is the held-out drives 0000 and
0002 under $KITTI360_DATASET, shuffled with seed 0 and truncated to the
generated-sample count (mmd.py:107-119); for nuScenes, the LIDAR_TOP
sweeps of v1.0-test under $NUSCENES_DATASET. Histograms, MMD and JSD are
computed on the host in float64, as the reference does; RangeNet++ (FRD,
IoU, accuracy) runs on the CUDA device unless `--device cpu` is given.
Prints one JSON line of plain floats.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random

import numpy as np

from rangeldm_tpu_torch.metrics.histogram import (
    kitti_histogram, nuscenes_histogram,
)
from rangeldm_tpu_torch.metrics.jsd import compute_jsd
from rangeldm_tpu_torch.metrics.mmd import compute_mmd
from rangeldm_tpu_torch.parallel.mesh import resolve_device


def load_bin(path: str, n_feats: int = 4) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, n_feats)


def kitti_reference_files(count: int, root: str | None = None):
    if root is None:
        root = os.environ.get("KITTI360_DATASET", "")
    files = glob.glob(root + "/data_3d_raw/2013_05_28_drive_0000_sync/"
                             "velodyne_points/data/*")
    files += glob.glob(root + "/data_3d_raw/2013_05_28_drive_0002_sync/"
                              "velodyne_points/data/*")
    files.sort()   # glob order is filesystem-dependent; the seeded shuffle
    # must permute a deterministic base order to be reproducible
    random.Random(0).shuffle(files)
    return files[:count]


def nuscenes_reference_files(count: int, root: str | None = None):
    if root is None:
        root = os.environ.get("NUSCENES_DATASET", "")
    with open(os.path.join(root, "v1.0-test/sample_data.json")) as f:
        sample_data = json.load(f)
    files = [os.path.join(root, x["filename"]) for x in sample_data
             if "sweeps/LIDAR_TOP" in x["filename"]]
    random.Random(0).shuffle(files)
    return files[:count]


def histograms(files, hist_fn, n_feats: int = 4):
    return [hist_fn(load_bin(f, n_feats)) for f in files]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True, help="generated sample dir")
    ap.add_argument("--mmd", action="store_true")
    ap.add_argument("--jsd", action="store_true")
    ap.add_argument("--frd", action="store_true")
    ap.add_argument("--mae", action="store_true")
    ap.add_argument("--inpainting_mae", action="store_true")
    ap.add_argument("--iou", action="store_true",
                    help="weighted-jaccard IoU over RangeNet segmentations "
                         "of conditional result vs target dumps")
    ap.add_argument("--accuracy", action="store_true",
                    help="pixel accuracy over the same segmentations")
    ap.add_argument("--cond_prefix", default=None,
                    choices=["densification", "inpainting"],
                    help="which triplet dumps --iou/--accuracy read "
                         "(default: auto-detect)")
    ap.add_argument("--sensor", default="kitti360",
                    help="sensor spec used to back-project --iou dumps")
    ap.add_argument("--nus", action="store_true")
    ap.add_argument("--rangenet", default=None,
                    help="darknet53-1024 checkpoint dir for --frd")
    ap.add_argument("--encoding", default="linear",
                    choices=["log", "linear", "none"],
                    help="range encoding of the --mae/--iou dumps")
    ap.add_argument("--limit", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device of RangeNet++ (default: the CUDA "
                         "device; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    hist_fn = nuscenes_histogram if args.nus else kitti_histogram
    ref_fn = nuscenes_reference_files if args.nus else kitti_reference_files
    ref_feats = 5 if args.nus else 4

    if args.mmd or args.jsd:
        # integer index order + --limit on BOTH datasets: a lexicographic
        # sorted(glob)[:limit] over the CLI's unpadded {i}.bin names picks
        # the {0, 1, 10, 100, ...} subset, not the reference's first-N;
        # also errors on an empty/wrong --exp instead of scoring []
        from rangeldm_tpu_torch.metrics.frd_pipeline import (
            generated_sample_files,
        )
        sample_files = generated_sample_files(args.exp, args.limit)
        gen_h = histograms(sample_files, hist_fn)
        ref_h = histograms(ref_fn(len(sample_files)), hist_fn, ref_feats)
        if args.mmd:
            results["mmd"] = compute_mmd(ref_h, gen_h)
        if args.jsd:
            results["jsd"] = compute_jsd(ref_h, gen_h)

    if args.frd:
        if args.nus:
            # the reference's FRD is KITTI-only (metric.py:37 "--fid ...
            # (KITTI only)"): the RangeNet++ checkpoint is trained on
            # semantic-KITTI 64-beam geometry and the 5-float nuScenes
            # reference stride does not fit the 4-float FRD reader
            raise SystemExit(
                "--frd is KITTI-only (as in the reference metric CLI); "
                "use --mmd/--jsd for nuScenes")
        from rangeldm_tpu_torch.metrics.frd_pipeline import (
            compute_frd_for_dirs,
        )
        results["frd"] = compute_frd_for_dirs(
            args.exp, ref_fn(args.limit), args.rangenet, limit=args.limit,
            device=device)

    if args.iou or args.accuracy:
        from rangeldm_tpu_torch.metrics.frd_pipeline import (
            compute_segmentation_scores,
        )
        prefix = args.cond_prefix
        if prefix is None:
            prefix = "inpainting" if os.path.isdir(
                os.path.join(args.exp, "inpainting_result")) \
                else "densification"
        scores = compute_segmentation_scores(
            args.exp, prefix, args.rangenet, sensor=args.sensor,
            limit=args.limit, encoding=args.encoding, device=device)
        if args.iou:
            results["iou"] = scores["iou"]
        if args.accuracy:
            results["accuracy"] = scores["accuracy"]

    if args.mae or args.inpainting_mae:
        from rangeldm_tpu_torch.metrics.frd_pipeline import paired_dump_files
        from rangeldm_tpu_torch.metrics.mae import (
            densification_mae, inpainting_mae,
        )

        def load_pair(prefix):
            """result/target stacks paired by integer filename index (the
            reference pairs by index, iou.py) with --limit honored."""
            try:
                rf, tf = paired_dump_files(args.exp, prefix, args.limit)
            except ValueError as e:
                raise SystemExit(str(e)) from e

            def stack(files):
                arr = np.stack([np.load(f) for f in files])
                return arr[..., 0] if arr.ndim == 4 else arr  # range channel
            return stack(rf), stack(tf)

        if args.mae:
            res, tgt = load_pair("densification")
            results.update(densification_mae(res, tgt,
                                             encoding=args.encoding))
        if args.inpainting_mae:
            res, tgt = load_pair("inpainting")
            results["inpainting_mae"] = inpainting_mae(
                res, tgt, encoding=args.encoding)

    # metric fns may return numpy scalars (np.float32 is not JSON
    # serializable): emit plain floats like the reference CLI prints
    results = {k: float(v) if isinstance(v, (np.floating, np.integer))
               else v for k, v in results.items()}
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
