"""Share of the UNet evaluations that replay a captured CUDA graph in a
sampling cell, in %: the median, over the calls of the unprofiled window,
of a call's `unet_graph_replay` spans over its `unet_graph_replay`,
`unet_graph_capture` and `unet_eager` spans (perfbench/spans.py). The
program leaves one of the three under each `unet_eval`; where a call holds
none (a program without the graphed model function), it reads nothing."""

from statistics import median

from perfbench import spans

KINDS = ("unet_graph_replay", "unet_graph_capture", "unet_eager")


def read(record, work):
    if record.get("kind") != "sampling":
        return None
    units = spans.window(record, "sample_call")
    if not units:
        return None
    counts = [[len(u.get(name, ())) for name in KINDS] for u in units]
    if not all(sum(c) for c in counts):
        return None
    return median(100.0 * c[0] / sum(c) for c in counts)
