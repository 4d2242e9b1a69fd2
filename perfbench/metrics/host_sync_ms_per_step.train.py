"""Host time of the log sync and the checkpoint per step in a train cell,
in ms: the mean, over the steps of the unprofiled window, of the summed
`log_sync` and `checkpoint` spans of a step (perfbench/spans.py). The
log's `float()` reads wait for the device once in `log_every` steps, so
a median would read 0; the mean spreads that wait over the steps."""

from statistics import mean

from perfbench import spans


def read(record, work):
    if record.get("kind") != "train":
        return None
    steps = spans.sums(record, "train_step", ("log_sync", "checkpoint"))
    return mean(steps) if steps else None
