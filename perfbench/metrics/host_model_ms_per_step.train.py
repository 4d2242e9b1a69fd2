"""Host time of the model per step in a train cell, in ms: the median,
over the steps of the unprofiled window, of the summed `encode`,
`forward` and `backward` spans of a step (the VAE encode and the
posterior draw, the draws, `add_noise`, the UNet and the loss, and the
backward; perfbench/spans.py)."""

from statistics import median

from perfbench import spans


def read(record, work):
    if record.get("kind") != "train":
        return None
    steps = spans.sums(record, "train_step", ("encode", "forward",
                                              "backward"))
    return median(steps) if steps else None
