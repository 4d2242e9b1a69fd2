"""Host time per UNet evaluation in a sampling cell, in ms: the median,
over the calls of the unprofiled window, of the summed `unet_eval` spans
of a call (every device's model evaluation of one step: the host's
launches of the UNet's kernels) over their count (perfbench/spans.py).
Against the card's work per evaluation it says whether the host or the
card sets a call's pace."""

from statistics import median

from perfbench import spans


def read(record, work):
    if record.get("kind") != "sampling":
        return None
    units = spans.window(record, "sample_call")
    if not units or not all(u.get("unet_eval") for u in units):
        return None
    return median(sum(u["unet_eval"]) / len(u["unet_eval"]) for u in units)
