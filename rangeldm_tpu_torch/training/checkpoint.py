"""Rolling training checkpoints (the JAX package's TrainCheckpointer,
rangeldm_tpu/training/checkpoint.py:23-45, after accelerate's save_state
in ldm/train_unconditional.py:560-585).

A checkpoint is the directory `<root>/checkpoint_{step}` (orbax's
step_prefix naming, which `LdmTrainer.resume` also accepts) holding

* `tensors.safetensors`: every tensor of `TrainState.state_dict()`,
  written with `convert.write_safetensors`;
* `state.json`: its scalars, the torch generator's state among them.

No pickle is read or written. Each checkpoint is written into a sibling
temporary directory, synced and renamed into place, so a crash never
leaves a half-written `checkpoint_{step}`. The orbax checkpoints of the JAX
package are not resumed: a JAX PRNG key has no torch.Generator
counterpart (tools/export_pipeline.py exports a JAX pipeline's weights).

In a distributed run (parallel/mesh.py) rank 0 writes and `save` returns
on every rank once the checkpoint is in place, as the JAX package's save
does (rangeldm_tpu/training/checkpoint.py:60-121); every rank restores.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from rangeldm_tpu_torch.convert import read_safetensors, write_safetensors
from rangeldm_tpu_torch.parallel.mesh import barrier, is_primary

TENSORS = "tensors.safetensors"
SCALARS = "state.json"
_STEP_DIR = re.compile(r"checkpoint[-_](\d+)$")


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpointer:
    """`save(step, state)`, `latest_step()`, `restore(step=None)`; keeps
    the newest `total_limit` checkpoints under `directory`."""

    def __init__(self, directory: str, total_limit: int = 10):
        self.directory = os.path.abspath(directory)
        self.total_limit = int(total_limit)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{int(step)}")

    def _dirs(self) -> Dict[int, str]:
        """{step: directory} of the checkpoint_N (or checkpoint-N)
        directories under the root."""
        if not os.path.isdir(self.directory):
            return {}
        out = {}
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            path = os.path.join(self.directory, name)
            if m and os.path.isdir(path):
                out[int(m.group(1))] = path
        return out

    def steps(self) -> List[int]:
        """The steps of the checkpoints under the directory, ascending."""
        return sorted(self._dirs())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> str:
        """`write` on rank 0, then a barrier: every rank returns once the
        checkpoint is in place."""
        final = self.write(step, state)
        barrier(f"checkpoint_{int(step)}")
        return final

    def write(self, step: int, state) -> str:
        """On rank 0 (the only process of a run without a group): write
        `state.state_dict()` as checkpoint_{step}, replacing one of the
        same step, then remove the oldest beyond `total_limit`. Other ranks
        write nothing. Returns the checkpoint's path."""
        final = self.path(step)
        if not is_primary():
            return final
        sd = state.state_dict()
        tmp = os.path.join(self.directory,
                           f".checkpoint_{int(step)}.tmp-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        write_safetensors({k: v for k, v in sd.items()
                           if isinstance(v, torch.Tensor)},
                          os.path.join(tmp, TENSORS))
        with open(os.path.join(tmp, SCALARS), "w") as f:
            json.dump({k: v for k, v in sd.items()
                       if not isinstance(v, torch.Tensor)}, f)
        for name in (TENSORS, SCALARS):
            _fsync(os.path.join(tmp, name))
        old = None
        if os.path.exists(final):
            old = f"{tmp}.old"
            os.rename(final, old)
        os.rename(tmp, final)
        _fsync(self.directory)
        if old is not None:
            shutil.rmtree(old)
        if self.total_limit > 0:
            dirs = self._dirs()
            for old_step in sorted(dirs)[:-self.total_limit]:
                shutil.rmtree(dirs[old_step])
        return final

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state dict of checkpoint `step` (default: the newest), with
        its tensors on the CPU, for `TrainState.load_state_dict`; None when
        there is no such checkpoint."""
        dirs = self._dirs()
        step = max(dirs, default=None) if step is None else int(step)
        if step not in dirs:
            return None
        path = dirs[step]
        files = os.listdir(path)
        if TENSORS not in files or SCALARS not in files:
            raise ValueError(
                f"{path} holds {sorted(files)}, not {TENSORS} and {SCALARS}: "
                f"orbax checkpoints written by the JAX package are not "
                f"resumed by this package (a JAX PRNG key has no "
                f"torch.Generator counterpart, so the run could not equal "
                f"JAX's); tools/export_pipeline.py exports the weights of a "
                f"JAX pipeline directory")
        with open(os.path.join(path, SCALARS)) as f:
            sd: Dict[str, Any] = json.load(f)
        sd.update(read_safetensors(os.path.join(path, TENSORS)))
        return sd
