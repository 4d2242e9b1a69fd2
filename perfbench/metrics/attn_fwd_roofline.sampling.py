"""The attention forward kernel's share of its roofline in a sampling cell,
in %: the least time of every attention call of the profiled stretch (per
call the larger of its operations over the bf16 peak and its bytes over
the memory rate, perfbench/work.py on the reference's shapes) over the
device time of the events named `attention_fwd`."""


def read(record, work):
    if record.get("kind") != "sampling":
        return None
    spent = sum(s for n, s in record["time_by_name"].items()
                if "attention_fwd" in n)
    if spent <= 0:
        return None
    return 100.0 * work["attn_fwd_bound_s_per_unit"] * record["units"] / spent
