"""Device kernels launched per UNet evaluation in the profiled stretch of a
sampling cell: the whole call's kernels (the UNet, the sampler's update,
the decoder, the copies' neighbours) over its UNet evaluations. Fewer
kernels per evaluation is fewer launches for the host to issue."""


def read(record, work):
    if record.get("kind") != "sampling" or not record.get("evals") \
            or not record.get("kernels"):
        return None
    return record["kernels"] / record["evals"]
