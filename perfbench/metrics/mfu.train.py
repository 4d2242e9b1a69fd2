"""The model's share of the card's peak in a train cell, in %: the
operations of the unprofiled stretch's calls or steps (perfbench/work.py,
counted on the reference) over its wall time, over the bf16 dense peak of
one H100 SXM (989 TFLOP/s at 700 W)."""


def read(record, work):
    un = record.get("unprofiled") or {}
    if record.get("kind") != "train" or not un.get("units") \
            or not un.get("wall_s"):
        return None
    return (100.0 * work["flops_per_unit"] * un["units"] / un["wall_s"]
            / work["peak_flops"])
