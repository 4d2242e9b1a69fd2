"""Build, load and count the package's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc into a shared library with a
plain C interface and loaded with ctypes. The build happens at first use
(or ahead of it, through `build_all`) into `rangeldm_tpu_torch/_build/`,
one library per source, named after a hash of the source, the headers
and the flags, so that an edited source or header is rebuilt. Nothing here
runs at import time.

`LAUNCHES` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _target(source: Path) -> Path:
    """The library of one source, named after a hash of the source, every
    csrc/*.cuh header (any of them may be included) and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile the named sources (default: every csrc/*.cu) that are not
    built yet, one nvcc process per source, all started together. Returns
    each source's ptxas report (registers, shared memory, spills), kept
    beside its library, so a source built earlier reports too."""
    sources = sorted(CSRC.glob("*.cu")) if names is None else [
        CSRC / f"{n}.cu" for n in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources:
        target = _target(src)
        if target.exists() and target.with_suffix(".log").exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, target)
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    return {src.stem: _target(src).with_suffix(".log").read_text()
            for src in sources}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(CSRC / f"{name}.cu")
        if not target.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


