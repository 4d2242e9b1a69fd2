"""LiDAR scans on disk -> range images and the conditions derived from them
(the JAX package's rangeldm_tpu/data/datasets.py, after the reference's
RangeDataset / RangeLoader, ldm/dataset.py:298-417, and its KITTI-360,
nuScenes and vanilla readers).

A sample is a dict of numpy arrays in the (H=beams, W=azimuth, C) layout:
jpg (H, W, C) float32, mask (H, W) bool, car_window_mask (H, W) bool, and,
when asked for, the conditions down, inpainting_mask and masked_image. The
loader yields the same dicts stacked on a batch axis; trainers and samplers
move them to the device.

Projections are cached as .npz files beside the raw scans (data_3d_range
directories) with the JAX package's paths and array names, so one root's
caches serve both packages. A scan is projected by the C++ core
(`native.range_image_native`, built with g++ at first use), as the JAX
package's dataset does where its core is built; `geometry.projection.
range_image_np` is its plain version.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from rangeldm_tpu_torch.geometry.sensors import SensorSpec, get_spec
from rangeldm_tpu_torch.native import range_image_native
from rangeldm_tpu_torch.parallel.mesh import process_shard
from rangeldm_tpu_torch.utils.profiling import record_span

HELD_OUT_DRIVES = ("0000_sync", "0002_sync")    # the KITTI-360 test split


@dataclasses.dataclass
class DatasetConfig:
    root: str
    sensor: str = "kitti360"
    width: int = 1024
    used_feature: int = 2
    # beam subsampling for the upsample condition: an int n means [1, n],
    # stride n on the beams only; a pair is [azimuth stride, beam stride]
    downsample: Optional[Sequence[int]] = None
    inpainting: Optional[float] = None           # masked azimuth fraction
    coord: bool = False
    cache: bool = True
    # compressed caches are smaller but slower to read (zlib decode)
    cache_compress: bool = True
    log: bool = False
    inverse: bool = False
    mean: Optional[float] = None
    std: Optional[float] = None


class RangeImageDataset:
    """Indexable dataset of projected range images."""

    def __init__(self, cfg: DatasetConfig, train: bool = True):
        self.cfg = cfg
        kw = {}
        if cfg.mean is not None:
            kw["mean"] = cfg.mean
        if cfg.std is not None:
            kw["std"] = cfg.std
        self.spec: SensorSpec = get_spec(
            cfg.sensor, width=cfg.width, log=cfg.log, inverse=cfg.inverse,
            **kw)
        self.train = train
        self.files = self._list_files()
        downsample = cfg.downsample
        if isinstance(downsample, int):
            # ldm/dataset.py:341-342: int n -> [1, n]
            downsample = [1, downsample]
        self.downsample = downsample
        self.inpainting = cfg.inpainting

    # -- file discovery ---------------------------------------------------
    def _list_files(self) -> List[str]:
        cfg = self.cfg
        if cfg.sensor in ("kitti360", "kitti360_vanilla"):
            files = glob(os.path.join(
                cfg.root, "data_3d_raw/*/velodyne_points/data/*.bin"))
            held_out = [f for f in files
                        if any(h in f for h in HELD_OUT_DRIVES)]
            return sorted(set(files) - set(held_out) if self.train
                          else held_out)
        if cfg.sensor == "nuscenes":
            split = "v1.0-trainval" if self.train else "v1.0-test"
            with open(os.path.join(cfg.root, split, "sample_data.json")) as f:
                sample_data = json.load(f)
            return sorted(os.path.join(cfg.root, x["filename"])
                          for x in sample_data
                          if "sweeps/LIDAR_TOP" in x["filename"])
        if cfg.sensor == "stf":
            # ImageSets split lists -> lidar_hdl64_strongest/*.bin
            # (vae/sgm/data/STF_range_image.py:70-85)
            split = "train" if self.train else "val"
            with open(os.path.join(cfg.root, "ImageSets",
                                   f"{split}.txt")) as f:
                names = [x.strip().replace(",", "_") for x in f if x.strip()]
            return [os.path.join(cfg.root, "lidar_hdl64_strongest",
                                 n + ".bin") for n in names]
        raise ValueError(cfg.sensor)

    def _load_points(self, path: str) -> np.ndarray:
        if self.cfg.sensor in ("nuscenes", "stf"):
            pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
            pts[:, 3] /= 255.0       # ldm/nuscenes_range_image.py:78
            return pts
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    @property
    def _spec_tag(self) -> str:
        """The projection settings in the cache file name: the default
        KITTI-360 settings keep the bare name; any other sensor, width,
        encoding or normalization gets a suffix, so that caches of other
        settings over the same root are never read back."""
        c = self.cfg
        if (c.sensor == "kitti360" and c.width == 1024 and not c.log
                and not c.inverse and c.mean is None and c.std is None):
            return ""
        blob = f"{c.sensor}:{c.width}:{c.log}:{c.inverse}:{c.mean}:{c.std}"
        return "." + hashlib.sha256(blob.encode()).hexdigest()[:10]

    def _cache_path(self, path: str) -> str:
        ext = self._spec_tag + ".npz"
        if self.cfg.sensor == "nuscenes":
            return path.replace("sweeps", "sweeps_range").replace(".bin", ext)
        if self.cfg.sensor == "stf":
            return path.replace("lidar_hdl64", "lidar_range_hdl64").replace(
                ".bin", ext)
        return path.replace("data_3d_raw", "data_3d_range").replace(
            ".bin", ext)

    @staticmethod
    def _cache_tmp(cache: str) -> str:
        """A tmp path unique to the writing thread: two loader threads may
        project the same scan (one epoch's producer still running as the
        next starts), and two writers of one tmp file would publish a
        corrupt zip."""
        return cache + f".tmp-{os.getpid()}-{threading.get_ident()}.npz"

    # -- sample assembly --------------------------------------------------
    def __len__(self) -> int:
        return len(self.files)

    def _base_sample(self, path: str) -> Dict[str, np.ndarray]:
        cache = self._cache_path(path)
        if self.cfg.cache and os.path.exists(cache):
            with np.load(cache) as z:
                img, mask, cw = z["jpg"], z["mask"], z["car_window_mask"]
                # cache_compress=False over caches written compressed:
                # rewrite them stored once, so later reads are fast. A
                # read-only cache root just reads slower.
                if (not self.cfg.cache_compress
                        and z.zip.infolist()[0].compress_type != 0):
                    try:
                        tmp = self._cache_tmp(cache)
                        np.savez(tmp, jpg=img, mask=mask, car_window_mask=cw)
                        os.replace(tmp, cache)
                    except OSError:
                        pass
        else:
            img, mask, cw = range_image_native(self._load_points(path),
                                               self.spec)
            if self.cfg.cache:
                Path(cache).parent.mkdir(parents=True, exist_ok=True)
                # publish atomically: a run stopped mid-write must never
                # leave a truncated zip at the cache path
                tmp = self._cache_tmp(cache)
                save = (np.savez_compressed if self.cfg.cache_compress
                        else np.savez)
                save(tmp, jpg=img, mask=mask, car_window_mask=cw)
                os.replace(tmp, cache)
        img = img[..., :self.cfg.used_feature]
        if self.cfg.coord:
            h = img.shape[0]
            coord = np.broadcast_to(
                (np.arange(h, dtype=np.float32) / h)[:, None, None],
                (h, img.shape[1], 1))
            img = np.concatenate([img, coord], axis=-1)
        return {"jpg": img.astype(np.float32), "mask": mask,
                "car_window_mask": cw}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ret = self._base_sample(self.files[idx])
        img = ret["jpg"]
        if self.downsample:
            sb, sa = self.downsample[1], self.downsample[0]
            # strides (down[0] on azimuth, down[1] on beams) from stride//2
            # (ldm/dataset.py:344-346)
            ret["down"] = img[(sb // 2)::sb, (sa // 2)::sa, :]
        if self.inpainting:
            h, w, _ = img.shape
            # a leading azimuth sector of fraction `inpainting` is masked
            # (ldm/dataset.py:347-362, start fixed at 0): +1 masked, -1 kept
            m = -np.ones((h, w, 1), np.float32)
            m[:, :int(self.inpainting * w), :] = 1.0
            masked = -np.ones_like(img)
            keep = m[..., 0] < 0
            masked[keep] = img[keep]
            ret["inpainting_mask"] = m
            ret["masked_image"] = masked
        return ret


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts (ldm/dataset.py:370-380)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class LoaderStallWarning(UserWarning):
    """The RangeLoader's producer cannot keep up with its consumer."""


class RangeLoader:
    """Epoch iterator with a seeded shuffle and a background prefetch
    thread that fills batches from a thread pool.

    It times how long the consumer blocks on an empty queue:
    `wait_fraction` is the share of this epoch's wall time spent waiting,
    and after STALL_STEPS starved batches in a row it warns once with a
    LoaderStallWarning naming the measured and the demanded rates."""

    STALL_STEPS = 10      # consecutive starved gets before the warning
    STALL_WAIT_S = 0.01   # a get that blocks longer than this is starved

    def __init__(self, dataset: RangeImageDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, num_threads: int = 8,
                 shard_by_process: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.shard_by_process = shard_by_process
        self._epoch = 0
        self._skip = 0
        self._warned_stall = False
        self.wait_fraction = 0.0          # updated live during iteration
        self.stall_report: Optional[dict] = None

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.shard_by_process:
            # each process reads a disjoint slice of the same permutation,
            # every slice cut to the common length so that all processes
            # run the same number of batches
            rank, world = process_shard()
            order = order[rank::world][:len(order) // world]
        return order

    def seek(self, batches: int) -> None:
        """Continue as if `batches` batches had been read already: the
        next iteration is that epoch's, from that batch on (a resumed
        training run reads what an uninterrupted one would)."""
        n = len(self)
        self._epoch, self._skip = divmod(int(batches), n) if n else (0, 0)

    def __len__(self):
        n = len(self.dataset)
        if self.shard_by_process:
            n //= process_shard()[1]
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _warn_stall(self, starved: int, measured: float, demanded: float,
                    wait_frac: float):
        self._warned_stall = True
        self.stall_report = {
            "measured_imgs_per_s": measured, "demanded_imgs_per_s": demanded,
            "starved_batches": starved, "wait_fraction": wait_frac,
            "num_threads": self.num_threads,
        }
        warnings.warn(LoaderStallWarning(
            f"data producer cannot keep up: measured {measured:.0f} img/s "
            f"vs the {demanded:.0f} img/s the consumer demands (blocked on "
            f"an empty queue for {starved} consecutive batches; wait "
            f"fraction {wait_frac:.0%}). Remedies: "
            f"DatasetConfig(cache_compress=False) (zlib decode is the usual "
            f"bottleneck) or a larger RangeLoader(num_threads=...) "
            f"(currently {self.num_threads})."), stacklevel=3)

    def __iter__(self):
        order = self._order()
        self._epoch += 1
        first, self._skip = self._skip, 0
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(self.num_threads)
        stop = threading.Event()
        end = object()
        # the producer's own rate: images per second of fetch and collate
        # time, with the time blocked on a full queue left out
        prod = {"imgs": 0, "busy_s": 0.0}

        def put(item) -> bool:
            """A bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # an exception is forwarded to the consumer, which would
            # otherwise wait forever for the end marker
            try:
                for b in range(first, nb):
                    if stop.is_set():
                        return
                    idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                    t0 = time.perf_counter()
                    batch = collate(list(pool.map(self.dataset.__getitem__,
                                                  idx)))
                    prod["busy_s"] += time.perf_counter() - t0
                    prod["imgs"] += len(idx)
                    if not put(batch):
                        return
                put(end)
            except BaseException as e:  # noqa: BLE001 - forwarded, re-raised
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        t_epoch = time.time_ns()
        wait_s = 0.0
        consumed = 0
        starved = 0
        try:
            while True:
                # one measurement for the wait fraction and the span
                t0 = time.time_ns()
                item = q.get()
                t1 = time.time_ns()
                record_span("loader_wait", t0, t1)
                got_wait = (t1 - t0) / 1e9
                wait_s += got_wait
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError("RangeLoader producer failed") from item
                consumed += self.batch_size
                elapsed = max((t1 - t_epoch) / 1e9, 1e-9)
                self.wait_fraction = wait_s / elapsed
                if got_wait > self.STALL_WAIT_S:
                    starved += 1
                    if starved >= self.STALL_STEPS and not self._warned_stall:
                        measured = prod["imgs"] / max(prod["busy_s"], 1e-9)
                        demanded = consumed / max(elapsed - wait_s, 1e-9)
                        self._warn_stall(starved, measured, demanded,
                                         self.wait_fraction)
                else:
                    starved = 0
                yield item
        finally:
            # a consumer may stop mid-epoch: release the producer (it may
            # be blocked on a full queue) and the pool
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False, cancel_futures=True)
