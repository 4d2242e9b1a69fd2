"""Fused small-head attention on the transposed (N, D, T) layout, forward
and backward.

The UNet's attention layers have head_dim 8 and up to 1024 tokens, so the
(T, T) score matrix of every head is large and its row of 8-wide products
is small: materializing the scores in device memory costs far more than
the arithmetic. Both directions keep them on chip:

* `fused_attention_t` launches `csrc/attention_fwd.cu` (the port of the
  Pallas kernel `rangeldm_tpu/ops/attention.py::_attn_kernel`);
* `fused_attention_bwd_t` launches `csrc/attention_bwd.cu` (the port of
  `_attn_bwd_kernel`);
* `FusedAttention` pairs the two as one autograd function, as the JAX
  package's custom VJP `_fused_attention_ad` does, and `fused_attention_t`
  applies it, so gradients flow through the kernel.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version of the same function (`attention_t_reference`,
`attention_bwd_t_reference`). There is no other path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from rangeldm_tpu_torch.ops import kernels

KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
HEAD_DIM = 8
LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 232448        # shared memory one block may use on sm_90
kernels.LAUNCHES.setdefault(KERNEL, 0)
kernels.LAUNCHES.setdefault(BWD_KERNEL, 0)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _max_padded(bytes_per_key: int) -> int:
    """Longest T whose staged operands fit in one block's shared memory
    when the bf16 kernels pad each row to whole 16-key tiles plus 8 keys
    (`padded_stride` in csrc/attention_tile.cuh)."""
    return (_SMEM_BYTES // bytes_per_key - 8) // 16 * 16


def max_seq_len(dtype: torch.dtype) -> int:
    """Longest T the forward kernel takes: the head's K and V must fit in
    the shared memory of one block (padded rows in bf16)."""
    if dtype == torch.bfloat16:
        return _max_padded(2 * HEAD_DIM * 2)
    return _SMEM_BYTES // (2 * HEAD_DIM * _itemsize(dtype))


def max_seq_len_bwd(dtype: torch.dtype) -> int:
    """Longest T the backward kernel takes: its second launch holds the
    head's Q, G and G / rowsum in the dtype, plus three f32 row statistics,
    in the shared memory of one block (padded rows in bf16)."""
    if dtype == torch.bfloat16:
        return _max_padded(3 * HEAD_DIM * 2 + 3 * 4)
    return _SMEM_BYTES // (3 * HEAD_DIM * _itemsize(dtype) + 3 * 4)


def attention_t_reference(qt: torch.Tensor, kt: torch.Tensor,
                          vt: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain attention on the transposed layout, the counterpart of
    `_plain_attention_t`: logits and softmax in f32, probabilities cast to
    the input dtype for the PV product."""
    logits = torch.einsum("ndt,nds->nts", qt.float(), kt.float()) * scale
    p = torch.softmax(logits, dim=-1).to(vt.dtype)
    return torch.einsum("nds,nts->ndt", vt, p)


def attention_bwd_t_reference(qt: torch.Tensor, kt: torch.Tensor,
                              vt: torch.Tensor, g: torch.Tensor,
                              scale: float) -> Tuple[torch.Tensor, ...]:
    """Plain backward on the transposed layout, the math of
    `_attn_bwd_kernel` with its (N, T, T) intermediates materialized:
    `eb = exp2(l - m)`, `gp = g / rowsum(eb)` and `dl` are rounded to the
    input dtype where the TPU kernel rounds them; every sum is f32.
    Returns (dq, dk, dv) in the input dtype."""
    dtype = qt.dtype
    logits = torch.einsum("ndt,nds->nts", qt.float(), kt.float()) * (
        scale * LOG2E)
    m = logits.amax(dim=-1, keepdim=True)
    ef = torch.exp2(logits - m).to(dtype).float()                # (N, T, S)
    inv_s = 1.0 / ef.sum(dim=-1, keepdim=True)                   # (N, T, 1)
    dp = torch.einsum("ndt,nds->nts", g.float(), vt.float())
    gp = (g.float() * inv_s.transpose(1, 2)).to(dtype).float()   # (N, D, T)
    dv = torch.einsum("ndt,nts->nds", gp, ef)
    c = (dp * ef).sum(dim=-1, keepdim=True) * inv_s
    dl = ((ef * (dp - c)) * (inv_s * scale)).to(dtype).float()
    dq = torch.einsum("nds,nts->ndt", kt.float(), dl)
    dk = torch.einsum("ndt,nts->nds", qt.float(), dl)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check(*tensors: torch.Tensor) -> None:
    """q, k, v (and g) share one (N, D, T) shape, dtype and device."""
    qt = tensors[0]
    if qt.dim() != 3 or any(u.shape != qt.shape for u in tensors):
        raise ValueError(f"q, k, v, g must share one (N, D, T) shape, got "
                         f"{[tuple(u.shape) for u in tensors]}")
    if any(u.dtype != qt.dtype for u in tensors):
        raise TypeError("q, k, v, g must share one dtype")
    if any(u.device != qt.device for u in tensors):
        raise ValueError("q, k, v, g must lie on one device")


def _check_kernel_input(tensors, limit: int) -> None:
    """Raise unless a CUDA kernel takes these tensors: CUDA, D = 8, f32 or
    bf16, T up to `limit`, contiguous."""
    qt = tensors[0]
    n, d, t = qt.shape
    if qt.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qt.device}")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if qt.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, "
                        f"got {qt.dtype}")
    if t > limit:
        raise ValueError(f"sequence length {t} exceeds the CUDA kernel's "
                         f"limit of {limit} for {qt.dtype} (the head's "
                         f"operands live in shared memory)")
    if not all(u.is_contiguous() for u in tensors):
        raise ValueError("q, k, v, g must be contiguous")


def _entry(name: str, n_pointers: int, n_scales: int):
    """The C entry point of csrc/<name>.cu with its argument types set:
    the pointers, then n, d, seq and dtype, the float scales, the stream."""
    fn = getattr(kernels.library(name), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 4
                       + [ctypes.c_float] * n_scales + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _forward(qt, kt, vt, scale: float) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, its plain version on a CPU one."""
    if qt.device.type == "cpu":
        return attention_t_reference(qt, kt, vt, scale)
    _check_kernel_input((qt, kt, vt), max_seq_len(qt.dtype))
    out = torch.empty_like(qt)
    n, d, t = qt.shape
    if n == 0 or t == 0:
        return out
    fn = _entry(KERNEL, 4, 1)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = fn(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
                 n, d, t, _DTYPES[qt.dtype], scale * LOG2E, stream)
    kernels.check(err, KERNEL)
    kernels.count_launch(KERNEL)
    return out


class FusedAttention(torch.autograd.Function):
    """softmax(scale * q^T k) v^T per head with the kernel pair: the forward
    saves q, k and v, and the backward recomputes the softmax from them in
    `fused_attention_bwd_t` (the JAX package's `_fused_attention_ad`).
    Under autocast it runs in the dtype its inputs arrive in."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qt, kt, vt, scale: float):
        ctx.save_for_backward(qt, kt, vt)
        ctx.scale = scale
        return _forward(qt, kt, vt, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        qt, kt, vt = ctx.saved_tensors
        g = g.to(qt.dtype).contiguous()
        return (*fused_attention_bwd_t(qt, kt, vt, g, ctx.scale), None)


def fused_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      scale: float = None) -> torch.Tensor:
    """(N, D, T) transposed q/k/v -> (N, D, T) softmax attention output,
    `softmax(scale * q^T k) v^T` per head, differentiable through
    `FusedAttention`. Scale defaults to D^-0.5.

    CUDA tensors go to the kernel, which takes D = 8, T up to
    `max_seq_len(dtype)`, f32 or bf16, contiguous; anything else raises.
    CPU tensors go to `attention_t_reference`."""
    _check(qt, kt, vt)
    scale = qt.shape[1] ** -0.5 if scale is None else float(scale)
    return FusedAttention.apply(qt, kt, vt, scale)


def fused_attention_bwd_t(qt: torch.Tensor, kt: torch.Tensor,
                          vt: torch.Tensor, g: torch.Tensor,
                          scale: float) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of `fused_attention_t` for the output cotangent g, all
    (N, D, T) in q's dtype.

    CUDA tensors go to the kernel, which takes what the forward kernel takes
    with T up to `max_seq_len_bwd(dtype)`, and g of q's shape and dtype;
    anything else raises. CPU tensors go to `attention_bwd_t_reference`."""
    _check(qt, kt, vt, g)
    scale = float(scale)
    if qt.device.type == "cpu":
        return attention_bwd_t_reference(qt, kt, vt, g, scale)
    _check_kernel_input((qt, kt, vt, g), max_seq_len_bwd(qt.dtype))
    dq, dk, dv = (torch.empty_like(qt) for _ in range(3))
    n, d, t = qt.shape
    if n == 0 or t == 0:
        return dq, dk, dv
    stats = torch.empty((n, 3, t), dtype=torch.float32, device=qt.device)
    fn = _entry(BWD_KERNEL, 8, 2)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = fn(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), g.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats.data_ptr(), n, d, t, _DTYPES[qt.dtype],
                 scale * LOG2E, scale, stream)
    kernels.check(err, BWD_KERNEL)
    kernels.count_launch(BWD_KERNEL)
    return dq, dk, dv
