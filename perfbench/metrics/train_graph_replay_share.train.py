"""Share of the training steps that replay a captured CUDA graph in a
train cell, in %: the median, over the steps of the unprofiled window, of
a step's `train_graph_replay` spans over its `train_graph_replay`,
`train_graph_capture` and `train_eager` spans (perfbench/spans.py). The
program leaves one of the three under each `train_step`; where a step
holds none (a program without the graphed step), it reads nothing."""

from statistics import median

from perfbench import spans

KINDS = ("train_graph_replay", "train_graph_capture", "train_eager")


def read(record, work):
    if record.get("kind") != "train":
        return None
    units = spans.window(record, "train_step")
    if not units:
        return None
    counts = [[len(u.get(name, ())) for name in KINDS] for u in units]
    if not all(sum(c) for c in counts):
        return None
    return median(100.0 * c[0] / sum(c) for c in counts)
