"""The discriminator's own device time per step in a VAE-GAN training
cell, in ms: the device time of the profiled stretch launched under the
`disc_forward` (the generator step's pass over the reconstruction, the
discriminator step's over the real and the reconstructed batch),
`disc_backward` and `adaptive_weight` spans (the two last-layer gradients,
the second a whole discriminator backward), over its steps
(perfbench/span_device.py)."""

NAMES = ("disc_forward", "disc_backward", "adaptive_weight")


def read(record, work):
    by_span = record.get("device_ms_by_span") or {}
    if record.get("kind") != "train" or not record.get("units") \
            or not any(n in by_span for n in NAMES):
        return None
    return sum(by_span.get(n, 0.0) for n in NAMES) / record["units"]
