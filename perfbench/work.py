"""The work of a call or a step, counted on the frozen reference, and the
table of peaks the per-layer metrics divide by.

Operations come from `torch.utils.flop_counter` run over the reference
(perfbench/reference/) on the meta device, where nothing is computed:
convolutions, linear layers and the attention products, a multiply-add
counted as two; elementwise work and normalisations are not counted. The
attention shapes (N = batch x heads, D, T) are those the reference's
attention sees. Because the count comes from the reference, it reads the
same whatever later implements the model.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import layers as ref_layers
from perfbench.reference import unet as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.precision import REFERENCE

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time of a piece of work: the larger of its operations over
    the dtype's peak and its bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def attention_work(kernel: str, shape: Tuple[int, int, int],
                   itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of one attention call on (N, D, T) operands:
    forward 4 T^2 D N operations and q, k, v, o read or written once;
    backward 10 T^2 D N (the logits again, dv, dp, dq, dk) and q, k, v, g
    read and dq, dk, dv written once."""
    n, d, t = shape
    if kernel == "attention_fwd":
        return 4.0 * t * t * d * n, 4.0 * n * d * t * itemsize
    if kernel == "attention_bwd":
        return 10.0 * t * t * d * n, 7.0 * n * d * t * itemsize
    raise ValueError(kernel)


def _meta_params(shapes: Dict[str, Tuple[int, ...]],
                 grad: bool = False) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device="meta", requires_grad=grad)
            for n, s in shapes.items()}


def _unet_input(mc: dict, batch: int):
    w, h = mc["sample_size"]            # the reference's [azimuth, beams]
    x = torch.empty((batch, mc["in_channels"], w, h), device="meta")
    return x, torch.zeros((batch,), dtype=torch.long, device="meta")


@functools.lru_cache(maxsize=None)
def _unet_counts(key: str, batch: int) -> Tuple[float, float,
                                                Tuple[tuple, ...]]:
    """(forward operations, forward + backward operations, attention
    shapes) of the UNet of config `key` at `batch`."""
    mc = json.loads(key)
    p = _meta_params(ref_unet.param_shapes(mc), grad=True)
    x, t = _unet_input(mc, batch)
    ref_layers.ATTENTION_SHAPES = shapes = []
    try:
        with FlopCounterMode(display=False) as fwd:
            y = ref_unet.forward(mc, p, x, t, REFERENCE)
        with FlopCounterMode(display=False) as bwd:
            y.sum().backward()
    finally:
        ref_layers.ATTENTION_SHAPES = None
    f = fwd.get_total_flops()
    return float(f), float(f + bwd.get_total_flops()), tuple(shapes)


def _key(d: dict) -> str:
    return json.dumps(d, sort_keys=True)


def unet_flops(mc: dict, batch: int = 1) -> float:
    """Operations of one UNet forward pass at `batch`."""
    return _unet_counts(_key(mc), batch)[0]


def unet_train_flops(mc: dict, batch: int = 1) -> float:
    """Operations of one UNet forward and backward pass at `batch`
    (gradients of the weights and of the activations)."""
    return _unet_counts(_key(mc), batch)[1]


def attention_shapes(mc: dict, batch: int) -> List[Tuple[int, int, int]]:
    """(N, D, T) of every attention layer of one UNet forward pass."""
    return list(_unet_counts(_key(mc), batch)[2])


@functools.lru_cache(maxsize=None)
def _vae_counts(key: str, batch: int) -> Tuple[float, float]:
    vc = json.loads(key)["vae"]
    size = json.loads(key)["image"]
    p = _meta_params(ref_vae.param_shapes(vc))
    f = 2 ** (len(vc["ch_mult"]) - 1)
    h, w = size
    x = torch.empty((batch, vc["in_channels"], w, h), device="meta")
    z = torch.empty((batch, vc["z_channels"], w // f, h // f), device="meta")
    with FlopCounterMode(display=False) as enc:
        ref_vae.encode_moments(vc, p, x, REFERENCE)
    with FlopCounterMode(display=False) as dec:
        ref_vae.decode(vc, p, z, REFERENCE)
    return float(enc.get_total_flops()), float(dec.get_total_flops())


def vae_encode_flops(vc: dict, image_size, batch: int = 1) -> float:
    return _vae_counts(_key({"vae": vc, "image": list(image_size)}),
                       batch)[0]


def vae_decode_flops(vc: dict, image_size, batch: int = 1) -> float:
    return _vae_counts(_key({"vae": vc, "image": list(image_size)}),
                       batch)[1]


def attention_bound_s(mc: dict, batch: int, kernel: str,
                      dtype: str = "bfloat16") -> float:
    """The least time of every attention call of one UNet pass at `batch`:
    the sum over its layers of `bound_s`."""
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    return sum(bound_s(*attention_work(kernel, s, itemsize), dtype)
               for s in attention_shapes(mc, batch))
