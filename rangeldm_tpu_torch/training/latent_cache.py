"""Posterior moments of a frozen VAE, computed once per dataset (the JAX
package's rangeldm_tpu/training/latent_cache.py:27-155).

The reference encodes every batch through the frozen VAE at every step
(ldm/train_unconditional.py:480-481). The posterior moments (mean, logvar)
are a function of the image under the frozen VAE, so one ordered encode
pass can serve every epoch; the train step still draws its latents from
the cached moments with its own generator, as `latent_dist.sample()` does.

The moments are kept as an .npy beside the run, (N, h, w, 2z) float32, with
a .json sidecar {n, tag, data_tag, shape}; a cache is reused only when
every field matches. In a distributed run every rank encodes the whole
pass, as the JAX package's processes do (rangeldm_tpu/training/
latent_cache.py:110-123): both files are published by rename, so the last
complete write wins and no rank reads a partial one.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from rangeldm_tpu_torch.data.datasets import RangeLoader
from rangeldm_tpu_torch.pipelines.samplers import to_bcwh, to_bhwc


class MomentsDataset:
    """A dataset of precomputed moments that RangeLoader can serve: its
    samples are {"moments": (h, w, 2z) float32}."""

    def __init__(self, moments: np.ndarray):
        self.moments = moments

    def __len__(self) -> int:
        return len(self.moments)

    def __getitem__(self, i: int):
        return {"moments": np.asarray(self.moments[i], np.float32)}


def params_fingerprint(module: torch.nn.Module) -> str:
    """Content hash of a module's state dict (names, shapes, dtypes and
    every byte), so a VAE retrained in place invalidates the cache."""
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:24]


def dataset_fingerprint(dataset) -> str:
    """Hash of the dataset's identity: its sorted file list and its
    projection config (sensor, width, encoding, mean and std all change the
    moments) when it has them, else its type and length."""
    files = getattr(dataset, "files", None)
    if files is not None:
        blob = "\n".join(sorted(str(f) for f in files))
        blob += "\n" + repr(getattr(dataset, "cfg", ""))
    else:
        blob = f"{type(dataset).__qualname__}:{len(dataset)}"
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _cached(out_path: str, n: int, tag: str,
            data_tag: str) -> Optional[np.ndarray]:
    """The cache at out_path when its sidecar matches every field."""
    try:
        with open(out_path + ".json") as f:
            meta = json.load(f)
        cached = np.load(out_path, mmap_mode="r")
    except (OSError, ValueError):
        return None
    if (meta.get("n") == n and meta.get("tag") == tag
            and meta.get("data_tag") == data_tag
            and tuple(meta.get("shape", ())) == cached.shape):
        return cached
    return None


@torch.no_grad()
def precompute_moments(vae: torch.nn.Module, dataset, batch_size: int = 32,
                       out_path: Optional[str] = None, tag: str = "",
                       log: Optional[Callable[[str], None]] = None,
                       data_tag: Optional[str] = None,
                       dtype: torch.dtype = torch.float32) -> np.ndarray:
    """One ordered encode pass over `dataset` on the VAE's device, under
    autocast to `dtype` when it is not float32 -> (N, h, w, 2z) float32.

    With `out_path` the result is an .npy written to a temporary file and
    renamed into place, with its sidecar; a matching cache there is
    returned (memory-mapped) without encoding. Pass a content fingerprint
    of the VAE (`params_fingerprint`) and the encode dtype as `tag`."""
    n = len(dataset)
    if n == 0:
        raise ValueError("precompute_moments: the dataset is empty "
                         "(check data.root)")
    if data_tag is None:
        data_tag = dataset_fingerprint(dataset)
    if out_path:
        cached = _cached(out_path, n, tag, data_tag)
        if cached is not None:
            if log:
                log(f"[latent-cache] reusing {out_path}")
            return cached

    device = next(vae.parameters()).device
    loader = RangeLoader(dataset, batch_size=batch_size, shuffle=False,
                         drop_last=False)
    tmp = f"{out_path}.tmp-{os.getpid()}.npy" if out_path else None
    moments = None
    start = 0
    for batch in loader:
        images = to_bcwh(torch.as_tensor(batch["jpg"]).to(device,
                                                          torch.float32))
        with torch.autocast(device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            m = vae.encode_moments(images)
        m = to_bhwc(m.float()).cpu().numpy()
        if moments is None:
            shape = (n,) + m.shape[1:]
            moments = (np.lib.format.open_memmap(tmp, mode="w+",
                                                 dtype=np.float32,
                                                 shape=shape)
                       if tmp else np.empty(shape, np.float32))
        moments[start:start + len(m)] = m
        start += len(m)
        if log and (start // batch_size) % 50 == 1:
            log(f"[latent-cache] encoded {start}/{n}")
    if not out_path:
        return moments
    moments.flush()
    del moments
    # a sidecar never describes an .npy it was not written for
    with contextlib.suppress(FileNotFoundError):
        os.remove(out_path + ".json")
    os.replace(tmp, out_path)
    with open(tmp + ".json", "w") as f:
        json.dump({"n": n, "tag": tag, "data_tag": data_tag,
                   "shape": list(shape)}, f)
    os.replace(tmp + ".json", out_path + ".json")
    return np.load(out_path, mmap_mode="r")
