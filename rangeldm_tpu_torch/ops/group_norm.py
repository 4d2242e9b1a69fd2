"""GroupNorm -> activation -> the next conv's azimuth wrap in one pass,
forward and backward.

Every GroupNorm of the UNet and the VAE feeds an activation (SiLU, or the
identity before attention) and most feed a 3x3 `CircularConv`, which pads
its input circularly on azimuth first. Unfused, each of those is a pass over
device memory (under autocast also a cast to float32 and one back), and the
backward repeats them. `group_norm_act` does the chain in one pass:

* an optional per-(batch, channel) shift added before the statistics (the
  UNet's time-embedding projection, folded into `norm2`);
* GroupNorm with float32 statistics, the affine and the activation in
  float32, rounded once to x's dtype;
* with `wrap`, the output written as (B, C, W + 2, H) with rows 0 and W + 1
  holding rows W - 1 and 0, which `CircularConv(..., wrapped=True)`
  convolves without a pad.

On a CUDA tensor `GroupNormAct` launches `csrc/group_norm_act.cu` (forward,
and backward from x, the statistics and the shift) or raises; on a CPU (or
meta) tensor `group_norm_act_reference`, the unfused chain, runs instead,
and autograd differentiates it. `group_norm_act_bwd_reference` is the plain
version of the backward kernel's arithmetic. `plan` chooses the kernels'
split from the (batch, group) slice's size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rangeldm_tpu_torch.ops import kernels

KERNEL = "group_norm_act_fwd"
BWD_KERNEL = "group_norm_act_bwd"
ACTS = {"identity": 0, "silu": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_BYTES = 232448 - 2048  # dynamic shared memory of a block, less static
# staged bytes a block aims at, and vectors a thread handles: 16-64 KB and
# 2-8 vectors time the same at the sites that decide the step (PERF.md)
CHUNK_BYTES = 64 * 1024
VECTORS_PER_THREAD = 4
MIN_CHUNK = 2048            # values a block keeps when split to fill the card
MAX_CLUSTER = 8             # blocks a slice (portable cluster size)
MAX_THREADS = 512           # kMaxThreads and kMaxPortions of the kernels
MAX_PORTIONS = 64
SMS = 132                   # streaming multiprocessors of the H100 SXM
kernels.LAUNCHES.setdefault(KERNEL, 0)
kernels.LAUNCHES.setdefault(BWD_KERNEL, 0)


def _activation(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "identity":
        return y
    raise ValueError(f"unknown activation {act!r}; one of {sorted(ACTS)}")


def group_norm_act_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int, eps: float,
                             act: str = "identity",
                             shift: Optional[torch.Tensor] = None,
                             wrap: bool = False) -> torch.Tensor:
    """The unfused chain the kernel replaces: `x + shift[:, :, None, None]`
    in x's dtype, `F.group_norm`, the activation, and with `wrap` the
    circular pad of one azimuth row on each side."""
    if shift is not None:
        x = x + shift[:, :, None, None]
    y = _activation(F.group_norm(x, groups, weight, bias, eps), act)
    return F.pad(y, (0, 0, 1, 1), mode="circular") if wrap else y


def fold_wrapped(g: torch.Tensor) -> torch.Tensor:
    """The gradient of a wrapped (B, C, W + 2, H) tensor folded onto its
    (B, C, W, H) source: rows 0 and W + 1 added to rows W - 1 and 0."""
    w = g.shape[2] - 2
    d = g[:, :, 1:w + 1].clone()
    d[:, :, w - 1] += g[:, :, 0]
    d[:, :, 0] += g[:, :, w + 1]
    return d


def group_norm_act_bwd_reference(
        x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
        groups: int, eps: float, act: str, shift: Optional[torch.Tensor],
        g: torch.Tensor, wrap: bool = False) -> Tuple[Optional[torch.Tensor],
                                                      ...]:
    """(dx, dweight, dbias, dshift) of `group_norm_act` for the output
    gradient g, with the backward kernel's arithmetic in float32: the
    pre-activation recomputed from x and the statistics, per-(batch,
    channel) sums A = sum dz, Bs = sum dz xhat, X = sum xhat, and
    dx = rstd (gamma dz - S1 / N - xhat S2 / N) with S1, S2 the slice's
    sums of gamma A and gamma Bs. Each result in its input's dtype; dshift
    is None without a shift."""
    b, c, w, h = x.shape
    v = x.float()
    if shift is not None:
        v = v + shift.float()[:, :, None, None]
    dy = (fold_wrapped(g) if wrap else g).float()
    slices = v.reshape(b, groups, -1)
    mean = slices.mean(-1, keepdim=True)
    rstd = torch.rsqrt(slices.var(-1, unbiased=False, keepdim=True) + eps)
    xhat = ((slices - mean) * rstd).reshape(b, c, w, h)
    gamma = weight.float()[None, :, None, None]
    z = xhat * gamma + bias.float()[None, :, None, None]
    if act == "silu":
        s = torch.sigmoid(z)
        dz = dy * s * (1 + z * (1 - s))
    elif act == "relu":
        dz = dy * (z > 0)
    else:
        dz = dy
    sum_a, sum_b = dz.sum((2, 3)), (dz * xhat).sum((2, 3))
    n = (c // groups) * w * h
    s1 = (sum_a * weight.float()).reshape(b, groups, -1).sum(-1) / n
    s2 = (sum_b * weight.float()).reshape(b, groups, -1).sum(-1) / n
    per_c = functools.partial(torch.repeat_interleave, repeats=c // groups,
                              dim=1)
    r_c, s1_c, s2_c = per_c(rstd[..., 0]), per_c(s1), per_c(s2)
    dx = r_c[:, :, None, None] * (gamma * dz - s1_c[:, :, None, None]
                                  - xhat * s2_c[:, :, None, None])
    dshift = None
    if shift is not None:
        dshift = (r_c * (weight.float() * sum_a - w * h * s1_c
                         - xhat.sum((2, 3)) * s2_c)).to(shift.dtype)
    return (dx.to(x.dtype), sum_b.sum(0).to(weight.dtype),
            sum_a.sum(0).to(bias.dtype), dshift)


class Plan(ctypes.Structure):
    """How the kernels cut a (batch, group) slice: `clusters` blocks a slice
    (a thread-block cluster), each holding `portions` runs of `portion`
    values of one channel, `tpc` threads a portion, `threads` a block,
    `vec` values a load, and whether x (and the output gradient) are staged
    in shared memory. The kernels take it by pointer as their `Split`."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "clusters", "portions", "portion", "tpc", "threads", "vec",
        "stage_x", "stage_g")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=1024)
def plan(batch: int, channels: int, groups: int, w: int, h: int,
         itemsize: int, wrap: bool, backward: bool = False,
         align: int = 16) -> Plan:
    """The kernels' split of one (batch, group) slice of Cg W H values.

    A slice stays in one block while its staged bytes are within
    CHUNK_BYTES and the B G blocks fill two waves of the SMS SMs; else it
    is split into a cluster of up to MAX_CLUSTER blocks, each a whole number
    of channels or an equal part of one. A block's chunk of x is staged in
    shared memory when it fits; the backward's output gradient beside it
    only within CHUNK_BYTES, so that large slices keep several blocks on an
    SM (the gradient's second read comes mostly from L2). The
    vector width is the widest load of at most 16 bytes that the rows (with
    `wrap`) or channels and the pointers' `align` allow."""
    cg, hw = channels // groups, w * h
    n = cg * hw
    vec = 16 // itemsize
    unit = h if wrap else hw
    while vec > 1 and (unit % vec or align % (vec * itemsize)):
        vec //= 2
    per_value = itemsize * (2 if backward else 1)

    def splits(s: int) -> bool:
        if s > MAX_CLUSTER or n % s:
            return False
        return cg % s == 0 if s <= cg else s % cg == 0 and (n // s) % vec == 0

    s = 1
    while splits(2 * s) and (
            n // s * per_value > CHUNK_BYTES or cg // s > MAX_PORTIONS
            or (batch * groups * s < 2 * SMS and n // (2 * s) >= MIN_CHUNK)):
        s *= 2
    portions = cg // s if s <= cg else 1
    if portions > MAX_PORTIONS:
        raise ValueError(f"{cg} channels a group: more than {MAX_PORTIONS} "
                         f"a block even split {s} ways")
    portion = hw if s <= cg else n // s
    chunk = portions * portion
    threads = min(MAX_THREADS, max(64, _pow2_ceil(
        -(-chunk // (VECTORS_PER_THREAD * vec)))))
    return Plan(clusters=s, portions=portions, portion=portion,
                tpc=_pow2_floor(threads // portions), threads=threads,
                vec=vec, stage_x=chunk * itemsize <= SMEM_BYTES,
                stage_g=backward and 2 * chunk * itemsize <= CHUNK_BYTES)


def _align(*tensors: Optional[torch.Tensor]) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    a = 16
    for t in tensors:
        if t is not None:
            while t.data_ptr() % a:
                a //= 2
    return a


def _check_kernel_input(x, weight, bias, shift, groups: int) -> None:
    """Raise unless the kernels take these: CUDA, (B, C, W, H) float32 or
    bfloat16, C a multiple of groups, (C,) parameters of one float dtype, a
    (B, C) shift, all on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"no group_norm_act kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"x must be (B, C, W, H) with C a multiple of "
                         f"{groups}, got {tuple(x.shape)}")
    b, c = x.shape[:2]
    if weight is None or bias is None:
        raise ValueError("the CUDA kernel needs the norm's weight and bias")
    for name, t, shape in (("weight", weight, (c,)), ("bias", bias, (c,)),
                           ("shift", shift, (b, c))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be {shape} float32 or bfloat16, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}")
    if weight.dtype != bias.dtype:
        raise TypeError("weight and bias must share one dtype")


def _entry(name: str, n_pointers: int, n_ints: int):
    """The C entry point of csrc/group_norm_act.cu with its argument types:
    the pointers (the plan's last), the ints, eps, the stream."""
    fn = getattr(kernels.library("group_norm_act"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(x, weight, bias, shift, groups: int, eps: float, act: str,
             wrap: bool):
    """(out, mean, rstd) from the forward kernel."""
    b, c, w, h = x.shape
    out = x.new_empty((b, c, w + 2 if wrap else w, h))
    mean = x.new_empty((b * groups,), dtype=torch.float32)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return out, mean, rstd
    p = plan(b, c, groups, w, h, x.element_size(), wrap, False,
             _align(x, out))
    fn = _entry(KERNEL, 8, 10)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), _ptr(shift), mean.data_ptr(),
                 rstd.data_ptr(), ctypes.addressof(p), b, c, groups, w, h,
                 _DTYPES[x.dtype],
                 int(weight.dtype == torch.bfloat16),
                 int(shift is not None and shift.dtype == torch.bfloat16),
                 ACTS[act], int(wrap), eps, stream)
    kernels.check(err, KERNEL)
    kernels.count_launch(KERNEL)
    return out, mean, rstd


def _backward(x, weight, bias, shift, mean, rstd, g, groups: int,
              eps: float, act: str, wrap: bool, need_shift: bool):
    """(dx, dweight, dbias, dshift) from the backward kernel and its
    reduction over the batch: two launches, counted as one call of
    BWD_KERNEL in `kernels.LAUNCHES`."""
    b, c, w, h = x.shape
    dx = torch.empty_like(x)
    dweight, dbias = torch.empty_like(weight), torch.empty_like(bias)
    dshift = torch.empty_like(shift) if need_shift else None
    if x.numel() == 0:
        return dx, dweight.zero_(), dbias.zero_(), dshift
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    p = plan(b, c, groups, w, h, x.element_size(), wrap, True,
             _align(x, g, dx))
    fn = _entry(BWD_KERNEL, 13, 10)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), _ptr(shift), mean.data_ptr(),
                 rstd.data_ptr(), sums.data_ptr(), dweight.data_ptr(),
                 dbias.data_ptr(), _ptr(dshift), ctypes.addressof(p), b, c,
                 groups, w, h, _DTYPES[x.dtype], int(weight.dtype == torch.bfloat16),
                 int(shift is not None and shift.dtype == torch.bfloat16),
                 ACTS[act], int(wrap), eps, stream)
    kernels.check(err, BWD_KERNEL)
    kernels.count_launch(BWD_KERNEL)
    return dx, dweight, dbias, dshift


class GroupNormAct(torch.autograd.Function):
    """`group_norm_act` on the kernel pair: the forward saves x, the
    parameters, the shift and the slices' float32 mean and rstd (no float32
    copy of x, no output), and the backward recomputes the pre-activation
    from them. Under autocast it runs in the dtype x arrives in."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, shift, groups: int, eps: float,
                act: str, wrap: bool):
        x = x.contiguous()
        shift = None if shift is None else shift.contiguous()
        out, mean, rstd = _forward(x, weight, bias, shift, groups, eps, act,
                                   wrap)
        ctx.save_for_backward(x, weight, bias, shift, mean, rstd)
        ctx.args = (groups, eps, act, wrap)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, weight, bias, shift, mean, rstd = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx, dweight, dbias, dshift = _backward(
            x, weight, bias, shift, mean, rstd, g, *ctx.args,
            need_shift=shift is not None and ctx.needs_input_grad[3])
        return dx, dweight, dbias, dshift, None, None, None, None


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: str = "identity",
                   shift: Optional[torch.Tensor] = None,
                   wrap: bool = False) -> torch.Tensor:
    """act(GroupNorm(x + shift[:, :, None, None])) with the norm's weight and
    bias, x (B, C, W, H); with `wrap` as (B, C, W + 2, H), azimuth rows
    W - 1 and 0 copied to rows 0 and W + 1. `act` is "identity", "silu" or
    "relu". Differentiable in x, weight, bias and shift.

    CUDA tensors go to the kernel pair, which takes float32 or bfloat16 x,
    float32 or bfloat16 parameters and shift; anything else raises. CPU
    tensors, and meta tensors (shapes only, as a FLOP counter runs the
    model), go to `group_norm_act_reference`."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; one of {sorted(ACTS)}")
    if x.device.type in ("cpu", "meta"):
        return group_norm_act_reference(x, weight, bias, groups, eps, act,
                                        shift, wrap)
    _check_kernel_input(x, weight, bias, shift, groups)
    return GroupNormAct.apply(x, weight, bias, shift, int(groups), float(eps),
                              act, bool(wrap))
