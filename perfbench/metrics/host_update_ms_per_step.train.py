"""Host time of the update per step in a train cell, in ms: the median,
over the steps of the unprofiled window, of the summed `clip`, `adamw`
and `ema` spans of a step (the global norm and clip, AdamW's update and
the EMA's; perfbench/spans.py)."""

from statistics import median

from perfbench import spans


def read(record, work):
    if record.get("kind") != "train":
        return None
    steps = spans.sums(record, "train_step", ("clip", "adamw", "ema"))
    return median(steps) if steps else None
