"""The share of the time the card was idle in a sampling cell, in %: one
less the device's busy time per call or step in the profiled stretch (the
union of its operations' intervals) over the wall time per call or step
of the unprofiled stretch (the profiler slows the host, not the
kernels)."""


def read(record, work):
    un = record.get("unprofiled") or {}
    if record.get("kind") != "sampling" or not un.get("units") \
            or not record.get("units") or not record.get("busy_s"):
        return None
    busy = record["busy_s"] / record["units"]
    wall = un["wall_s"] / un["units"]
    return 100.0 * (1.0 - busy / wall)
