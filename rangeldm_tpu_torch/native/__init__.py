"""The C++ range-image projection core (`csrc/projection.cpp`, the JAX
package's rangeldm_tpu/native core) and its ctypes binding.

    from rangeldm_tpu_torch.native import range_image_native
    img, mask, cw = range_image_native(pc, spec)   # == range_image_np(...)

The core is compiled with g++ at first use (or ahead of it, through
`build()`) into `rangeldm_tpu_torch/_build/`, under a name keyed on a
hash of the source and the flags, so an edited source is rebuilt. A build
holds a file lock and publishes the library by rename, so threads and
processes that start on one fresh checkout build it once and never load a
half-written file. A failed build raises with the compiler's output: there
is no fallback to the numpy path. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "projection.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]
ROW_MODES = {"kitti": 0, "ring": 1, "uniform": 2}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def target() -> Path:
    """The library's path, named after a hash of the source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"projection-{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH; the projection core is "
                           "built from csrc/projection.cpp at first use")
    return path


def build() -> Path:
    """Compile the core unless it is built; returns the library's path."""
    lib = target()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "projection.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if lib.exists():            # another process built it meanwhile
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded core, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.project_scan.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, f32p, f32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, f32p, u8p, u8p]
            lib.project_scan.restype = None
            _lib = lib
        return _lib


def range_image_native(pc: np.ndarray, spec) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
    """Projection, hole filling, car-window mask and normalization of one
    scan in C++: (image (H, W, 2) float32, mask (H, W) bool, car-window
    mask (H, W) bool), as `geometry.projection.range_image_np` returns."""
    pc = np.ascontiguousarray(pc, np.float32)
    n, stride = pc.shape
    if spec.row_mode == "ring" and stride < 5:
        # the core reads pc[i * stride + 4] as the ring id
        raise ValueError(
            f"ring-mode spec {spec.name!r} needs 5-column clouds "
            f"(x,y,z,intensity,ring); got stride {stride}")
    if stride < 4:
        # every mode reads pc[i * stride + 3] as the intensity
        raise ValueError(
            f"projection needs >=4-column clouds (x,y,z,intensity); "
            f"got stride {stride}")
    lib = library()
    h, w = spec.n_beams, spec.width
    image = np.empty((h, w, 2), np.float32)
    mask = np.empty((h, w), np.uint8)
    cw = np.empty((h, w), np.uint8)
    encoding = 1 if spec.log else (2 if spec.inverse else 0)
    height = np.ascontiguousarray(spec.height, np.float32)
    incl = np.ascontiguousarray(spec.incl, np.float32)
    lib.project_scan(
        pc, n, stride, height, incl, spec.n_beams, spec.width,
        ROW_MODES[spec.row_mode], encoding, float(spec.fov_up),
        float(spec.fov_down), float(spec.min_depth), float(spec.range_fill),
        float(spec.mean), float(spec.std), float(spec.intensity_fill),
        image, mask, cw)
    return image, mask.astype(bool), cw.astype(bool)
