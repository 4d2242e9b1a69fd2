"""The arithmetic the reference's products run in.

`Precision` rounds the operands of every convolution, linear layer and
attention product before the product, which itself runs in float32:

* `REFERENCE`: no rounding, float32 with TF32 off;
* `FP8`: each operand scaled by 448 / its largest magnitude, rounded to
  float8 e4m3 and scaled back (per-tensor scaling, the usual fp8 recipe).
  This is the control of the correctness check: the reference computed in
  the precision one step below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

E4M3_MAX = 448.0


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, in float32. The
    gradient passes the rounding unchanged (straight through), so that the
    backward products see the rounded operands and float32 gradients."""
    x = x.float()
    with torch.no_grad():
        scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
        rounded = (x * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (rounded - x).detach()


class Precision(NamedTuple):
    """`q` rounds an operand before a product."""
    name: str
    q: Callable[[torch.Tensor], torch.Tensor]


REFERENCE = Precision("float32", _identity)
FP8 = Precision("fp8_e4m3", fp8_round)
PRECISIONS = {"float32": REFERENCE, "fp8_e4m3": FP8}


@contextlib.contextmanager
def strict_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
