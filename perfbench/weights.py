"""Weights made from a seed, on the device, in one draw.

Every parameter comes out of one uniform draw of a `torch.Generator`:
a weight of two or more dimensions, and its bias, uniform in
+-1/sqrt(fan_in) (PyTorch's default for convolutions and linear layers);
a normalisation's scale 1 and shift 0 (its weight is one-dimensional).
The names and shapes come from the reference, so the same dict loads into
the program (strict) and feeds the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def make(shapes: Dict[str, Tuple[int, ...]], generator: torch.Generator,
         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    device = generator.device
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator, device=device)
    flat = flat.mul_(2.0).sub_(1.0)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        base = name.rsplit(".", 1)[0]
        weight = shapes.get(base + ".weight", shape)
        if len(weight) < 2:          # a normalisation's scale and shift
            value = (torch.ones if name.endswith(".weight")
                     else torch.zeros)(shape, device=device)
        else:
            fan_in = math.prod(weight[1:])
            value = flat[offset:offset + n].view(shape) / math.sqrt(fan_in)
        out[name] = value.to(dtype)
        offset += n
    return out
