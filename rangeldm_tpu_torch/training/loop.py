"""The training loop of `LdmTrainer.fit` and `VaeTrainer.fit`, and the
training CLIs' run of it over a loader's epochs (`fit_epochs`).

Spans (utils/profiling.py): each step is a `train_step` root, from the
batch pull to the end of its side job, over `batch_wait` (the loader's
`loader_wait` inside), `to_device`, the step's own spans, `log_sync`,
`checkpoint` and the side job's own span (LDM's `sample_dump`).
"""

from __future__ import annotations

import time
from contextlib import closing
from typing import Callable, Optional

from rangeldm_tpu_torch.training.loggers import (
    ScalarLogger, emergency_checkpoint,
)
from rangeldm_tpu_torch.utils.profiling import step_annotation

_END = object()     # what the loop pulls from exhausted batches


def fit_loop(trainer, batches, train_step: Callable,
             side_job: Callable[[int, object], bool], *,
             max_steps: Optional[int], log_every: int, loader,
             ckpt_every: int) -> dict:
    """Train `trainer` until `batches` run out or the step count reaches
    `max_steps`. The trainer gives the loop its `cfg` (the scalar sinks'
    keys), `out_dir`, `state` (whose `step` counts), `ckpt` (a
    `TrainCheckpointer`) and `_to_device(batch)`; `train_step(x)` runs one
    step on the moved batch and returns its metrics as tensors.

    Every `log_every` steps (and at the last) the metrics, the step and the
    steps per second since the start of this call go to
    <out_dir>/train_log.jsonl and <out_dir>/tb, with `loader`'s
    `data_wait_frac` when one is given. A checkpoint every `ckpt_every`
    steps, then `side_job(step, x)`, which returns whether it ran. A
    checkpoint at the next step boundary after SIGUSR1 (polled after each
    step and after a side job that ran), and one when an exception
    escapes, which rank 0 writes alone. Returns the last logged record."""
    cfg = trainer.cfg
    logger = ScalarLogger(trainer.out_dir,
                          csv=bool(cfg.get("csv_log", False)),
                          tensorboard=bool(cfg.get("tensorboard", True)),
                          wandb=bool(cfg.get("wandb", False)))
    last = {}
    t0 = time.perf_counter()
    step0 = step = trainer.state.step

    def save_now():
        trainer.ckpt.save(trainer.state.step, trainer.state)

    def write_now():
        trainer.ckpt.write(trainer.state.step, trainer.state)

    # the event file is closed on the crash path too
    with closing(logger), emergency_checkpoint(
            save_now, on_error=write_now) as melk:
        batches = iter(batches)
        while True:
            with step_annotation("train_step") as root:
                with step_annotation("batch_wait") as wait:
                    batch = next(batches, _END)
                    if batch is _END:
                        wait.discard()
                        root.discard()
                if batch is _END:
                    break
                with step_annotation("to_device"):
                    x = trainer._to_device(batch)
                metrics = train_step(x)
                melk()
                step += 1
                done = bool(max_steps) and step >= max_steps
                if step % log_every == 0 or done:
                    with step_annotation("log_sync"):
                        # float() waits for the device: only at log steps
                        last = {k: float(v) for k, v in metrics.items()}
                        last.update(step=step, sps=(
                            (step - step0)
                            / max(time.perf_counter() - t0, 1e-9)))
                        if loader is not None:
                            last["data_wait_frac"] = loader.wait_fraction
                        logger.log(step, last)
                if step % ckpt_every == 0:
                    with step_annotation("checkpoint"):
                        trainer.ckpt.save(step, trainer.state)
                if side_job(step, x):
                    melk()   # serve a signal that came during the side job
            if done:
                break
    return last


def fit_epochs(trainer, loader, *, max_steps: Optional[int],
               num_epochs: int,
               on_resume: Optional[Callable[[int], None]] = None) -> None:
    """A training command line's run: restore `trainer`'s checkpoint, hand
    the restored step to `on_resume`, then `trainer.fit` on `loader`'s
    epochs one after another, for `max_steps` steps or else `num_epochs`
    epochs, at the config's `log_every`. An empty loader raises first."""
    if len(loader) == 0:
        raise ValueError(f"no training batch: {len(loader.dataset)} samples "
                         f"under data.root, batch size {loader.batch_size}")
    start = trainer.resume()
    if start:
        print(f"[resume] restored step {start}")
    if on_resume is not None:
        on_resume(start)

    def epochs():
        while True:
            yield from loader

    batches = epochs()
    try:
        trainer.fit(batches, max_steps=max_steps or num_epochs * len(loader),
                    log_every=int(trainer.cfg.get("log_every", 50)),
                    loader=loader)
    finally:
        batches.close()     # stops the loader's producer thread
