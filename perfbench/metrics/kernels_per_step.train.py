"""Device kernels launched per training step in the profiled stretch of a
training cell (the encode, forward, backward, clip, AdamW and EMA of
`LdmTrainer.fit`)."""


def read(record, work):
    if record.get("kind") != "train" or not record.get("units") \
            or not record.get("kernels"):
        return None
    return record["kernels"] / record["units"]
