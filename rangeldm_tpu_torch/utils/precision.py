"""TF32 on the card, set for a block and given back after it."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def tf32(enabled: bool, matmul: Optional[bool] = None):
    """TF32 on (or off) for cuDNN convolutions and, unless `matmul` sets
    them apart, matrix products inside the block; the caller's settings
    after it. The metrics run with TF32 off, in full float32 as the
    reference's float32 runs on the CPU: TF32 keeps 10 mantissa bits of
    each operand."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = (enabled if matmul is None
                                             else matmul)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
