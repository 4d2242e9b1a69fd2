"""The card's busy time per step in a train cell, in ms: the union of the
device operations' intervals in the profiled stretch over its steps. It
moves with the work the kernels do and not with the host's speed, so it
stays steady where the step's wall time swings with the host (0.1 % from
run to run against several % for the rate)."""


def read(record, work):
    if record.get("kind") != "train" or not record.get("units") \
            or not record.get("busy_s"):
        return None
    return 1e3 * record["busy_s"] / record["units"]
