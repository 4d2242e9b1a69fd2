"""The VAE's full-resolution forward passes per step in a VAE-GAN training
cell, in ms: the device time of the profiled stretch launched under the
`vae_forward` (the generator step's encode, draw and decode) and
`disc_recon` (the discriminator step's reconstruction without a gradient)
spans, over its steps (perfbench/span_device.py)."""

NAMES = ("vae_forward", "disc_recon")


def read(record, work):
    by_span = record.get("device_ms_by_span") or {}
    if record.get("kind") != "train" or not record.get("units") \
            or not any(n in by_span for n in NAMES):
        return None
    return sum(by_span.get(n, 0.0) for n in NAMES) / record["units"]
