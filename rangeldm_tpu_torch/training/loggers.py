"""Scalar logging and emergency checkpointing.

`ScalarLogger` is the `accelerator.log` equivalent
(ldm/train_unconditional.py:587-591): every scalar dict goes to a jsonl
stream, by default to TensorBoard event files under <out_dir>/tb (written
with the standard library, `training/event_file.py`), and when asked to a
Lightning-CSVLogger-style metrics.csv (header = union of keys, rewritten
when new keys appear). It takes the JAX package's `wandb` switch, but that
sink is not ported: asking for it logs one warning and the run goes on with
the other sinks. In a distributed run only rank 0 writes (the JAX
package's `primary` default).

`emergency_checkpoint` is the reference's "melk" machinery
(vae/main.py:254-261, 876-895; rangeldm_tpu/training/loggers.py:129-180):
SIGUSR1, the usual preemption signal of a cluster, and an exception that
escapes the training loop both save a checkpoint before the process ends.
"""

from __future__ import annotations

import contextlib
import csv as csv_mod
import json
import logging
import os
import signal
import threading
from typing import Callable, Dict, Iterator, Optional

from rangeldm_tpu_torch.parallel.mesh import any_rank, is_primary
from rangeldm_tpu_torch.training.event_file import EventFileWriter

log = logging.getLogger(__name__)


class ScalarLogger:
    """Appends to <out_dir>/train_log.jsonl, with tensorboard=True to a new
    event file under <out_dir>/tb, and with csv=True to
    <out_dir>/metrics.csv; each write reaches its file before `log`
    returns, and `close()` closes the event file. On any rank but 0 it
    writes nothing."""

    def __init__(self, out_dir: str, csv: bool = False,
                 tensorboard: bool = True, wandb: bool = False):
        self.primary = is_primary()
        self.tb: Optional[EventFileWriter] = None
        if not self.primary:
            return
        if wandb:
            sinks = (["train_log.jsonl"] + ["tb/"] * tensorboard
                     + ["metrics.csv"] * csv)
            log.warning("the wandb sink is not available in this package; "
                        "logging to %s only", ", ".join(sinks))
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "train_log.jsonl")
        if tensorboard:
            self.tb = EventFileWriter(os.path.join(out_dir, "tb"))
        self.csv_path = os.path.join(out_dir, "metrics.csv") if csv else None
        self._csv_keys: list = []
        self._csv_rows: list = []
        if self.csv_path and os.path.exists(self.csv_path):
            # a resumed run appends to the previous rows instead of
            # truncating them at its first new key
            with open(self.csv_path, newline="") as f:
                reader = csv_mod.DictReader(f)
                self._csv_keys = list(reader.fieldnames or [])
                self._csv_rows = list(reader)

    def _write_csv(self, rec: Dict[str, float]) -> None:
        self._csv_rows.append(rec)
        new_keys = [k for k in rec if k not in self._csv_keys]
        if new_keys:
            self._csv_keys.extend(new_keys)
            with open(self.csv_path, "w", newline="") as f:
                w = csv_mod.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                w.writerows(self._csv_rows)
        else:
            with open(self.csv_path, "a", newline="") as f:
                csv_mod.DictWriter(f, fieldnames=self._csv_keys).writerow(rec)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.primary:
            return
        rec = {k: float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, rec["step"])
        if self.csv_path is not None:
            self._write_csv(rec)

    def close(self) -> None:
        """Flush and close the event file."""
        if self.tb is not None:
            self.tb.close()


@contextlib.contextmanager
def emergency_checkpoint(save_fn: Callable[[], None],
                         signum: Optional[int] = signal.SIGUSR1,
                         on_error: Optional[Callable[[], None]] = None
                         ) -> Iterator[Callable[[], bool]]:
    """Deferred "melk": the signal only sets a flag, and the yielded
    `poll()` runs `save_fn` at the caller's next step boundary, where the
    train state is consistent (a save inside the handler could run in the
    middle of an optimizer update). Callers poll after every step and after
    long work between steps, such as a sample dump; in a distributed run
    every rank polls at the same points, and one rank's signal makes all
    of them save (`save_fn` may be collective).

    An exception that escapes the block saves once before it propagates,
    with `on_error` when given (a save that waits for no other rank, which
    may never arrive), else `save_fn`.
    The handler is installed only on the main thread (Python allows no
    other); elsewhere only the save on an exception remains."""
    requested = threading.Event()

    def poll() -> bool:
        """Save if a signal arrived on any rank since the last poll: the
        ranks agree on it, so that every one saves at the same step."""
        if not any_rank(requested.is_set()):
            return False
        requested.clear()
        save_fn()
        return True

    old = None
    installed = (signum is not None and
                 threading.current_thread() is threading.main_thread())
    if installed:
        old = signal.signal(signum, lambda _sig, _frame: requested.set())
    try:
        yield poll
    except BaseException:
        try:
            (on_error or save_fn)()
        except Exception:  # noqa: BLE001 - the original error propagates
            log.exception("emergency checkpoint failed")
        raise
    finally:
        if installed:
            signal.signal(signum, old)
