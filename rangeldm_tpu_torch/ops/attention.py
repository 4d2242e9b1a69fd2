"""Fused small-head attention on the transposed (N, D, T) layout.

The UNet's attention layers have head_dim 8 and up to 1024 tokens, so the
(T, T) score matrix of every head is large and its row of 8-wide products
is small: materializing the scores in device memory costs far more than
the arithmetic. `fused_attention_t` keeps them on chip. On a CUDA tensor it
launches the hand-written kernel `csrc/attention_fwd.cu` (the port of the
Pallas kernel `rangeldm_tpu/ops/attention.py::_attn_kernel`); on a CPU
tensor it runs `attention_t_reference`, the plain version of the same
function. There is no other path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rangeldm_tpu_torch.ops import kernels

KERNEL = "attention_fwd"
HEAD_DIM = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 232448        # shared memory one block may use on sm_90
kernels.LAUNCHES.setdefault(KERNEL, 0)


def max_seq_len(dtype: torch.dtype) -> int:
    """Longest T the kernel takes: the head's K and V must fit in the
    shared memory of one block."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _SMEM_BYTES // (2 * HEAD_DIM * itemsize)


def attention_t_reference(qt: torch.Tensor, kt: torch.Tensor,
                          vt: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain attention on the transposed layout, the counterpart of
    `_plain_attention_t`: logits and softmax in f32, probabilities cast to
    the input dtype for the PV product."""
    logits = torch.einsum("ndt,nds->nts", qt.float(), kt.float()) * scale
    p = torch.softmax(logits, dim=-1).to(vt.dtype)
    return torch.einsum("nds,nts->ndt", vt, p)


def _check(qt, kt, vt):
    if not (qt.shape == kt.shape == vt.shape) or qt.dim() != 3:
        raise ValueError(f"q, k, v must share one (N, D, T) shape, got "
                         f"{tuple(qt.shape)}, {tuple(kt.shape)}, "
                         f"{tuple(vt.shape)}")
    if not (qt.dtype == kt.dtype == vt.dtype):
        raise TypeError("q, k, v must share one dtype")
    if not (qt.device == kt.device == vt.device):
        raise ValueError("q, k, v must lie on one device")


def fused_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      scale: float = None) -> torch.Tensor:
    """(N, D, T) transposed q/k/v -> (N, D, T) softmax attention output,
    `softmax(scale * q^T k) v^T` per head. Scale defaults to D^-0.5.

    CUDA tensors go to the kernel, which takes D = 8, T up to
    `max_seq_len(dtype)`, f32 or bf16, contiguous; anything else raises.
    CPU tensors go to `attention_t_reference`."""
    _check(qt, kt, vt)
    n, d, t = qt.shape
    scale = d ** -0.5 if scale is None else float(scale)
    if qt.device.type == "cpu":
        return attention_t_reference(qt, kt, vt, scale)
    if qt.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qt.device}")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if qt.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, "
                        f"got {qt.dtype}")
    if t > max_seq_len(qt.dtype):
        raise ValueError(f"sequence length {t} exceeds the CUDA kernel's "
                         f"limit of {max_seq_len(qt.dtype)} for {qt.dtype} "
                         f"(the head's K and V live in shared memory)")
    if not (qt.is_contiguous() and kt.is_contiguous() and vt.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    out = torch.empty_like(qt)
    if n == 0 or t == 0:
        return out
    fn = kernels.library(KERNEL).attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = fn(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
                 n, d, t, _DTYPES[qt.dtype], scale * math.log2(math.e),
                 stream)
    kernels.check(err, KERNEL)
    kernels.count_launch(KERNEL)
    return out
