"""The attention backward kernel's share of its roofline in a training
cell, in %: the least time of every backward attention call of the
profiled stretch (perfbench/work.py on the reference's shapes) over the
device time of the events named `attention_bwd`."""


def read(record, work):
    if record.get("kind") != "train":
        return None
    spent = sum(s for n, s in record["time_by_name"].items()
                if "attention_bwd" in n)
    if spent <= 0:
        return None
    return 100.0 * work["attn_bwd_bound_s_per_unit"] * record["units"] / spent
