"""The port's attention backward (rangeldm_tpu_torch/ops/attention.py:
`attention_bwd_t_reference`, `fused_attention_bwd_t`, `FusedAttention`)
against the JAX package: the Pallas backward body run in interpret mode on
the CPU, as tests/test_flash_attention.py runs it, and `jax.grad` of the JAX
Attention block on its einsum path.

Tolerances. f32: rtol 2e-4 / atol 2e-5, those of
tests/test_flash_attention.py:87 for the backward. bf16: 3e-2 * max|ref|.
Both sides round eb, g / rowsum and dl to bf16 at the same points, but the
f32 values they round come from sums taken in other orders and from other
exp2 implementations, so a value near a rounding boundary can land on the
neighbouring bf16 number (a relative step of 2^-8 = 3.9e-3); each gradient
sums T such values, and entries near zero carry the error of the large ones,
so the bound is relative to the largest entry. The CUDA kernel itself is
held against `attention_bwd_t_reference` on the card by chip_smoke.py and
tests/test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.models.unet import Attention as JaxAttention
from rangeldm_tpu.ops.attention import fused_attention_bwd_t as jax_bwd_t

from rangeldm_tpu_torch.convert import unet_state_dict_from_jax
from rangeldm_tpu_torch.models.unet import Attention
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.ops.attention import (
    BWD_KERNEL, attention_bwd_t_reference,
    attention_t_reference, fused_attention_bwd_t, fused_attention_t,
)
from test_torch_port_common import nhwc_to_torch, perturb

F32 = dict(rtol=2e-4, atol=2e-5)
BF16_REL = 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 8, t)).astype(np.float32)
            for _ in range(4)]


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        bound = BF16_REL * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (
            np.abs(got - want).max(), bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,t", [(2, 256), (3, 64), (2, 200)])
def test_bwd_reference_matches_pallas_kernel_body(n, t, dtype):
    """T = 256 and 64 as in the UNet; T = 200 is ragged (not a multiple of
    the CUDA kernel's 128-wide tiles)."""
    q, k, v, g = _inputs(n, t, seed=n * t)
    scale = 8 ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_bwd_t(*(jnp.asarray(u, jdt) for u in (q, k, v, g)), scale,
                     interpret=True)
    tdt = getattr(torch, dtype)
    # bf16 inputs are the same bf16 values on both sides
    got = attention_bwd_t_reference(
        *(torch.from_numpy(u).to(tdt) for u in (q, k, v, g)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == (n, 8, t), name
        _assert_close(a.float().numpy(), b, dtype)


@pytest.mark.parametrize("t", [256, 64, 200])
def test_bwd_reference_matches_autograd(t):
    """In f32 the rounding points are no-ops, so the reference is the exact
    gradient of the plain forward."""
    q, k, v, g = (torch.from_numpy(u) for u in _inputs(3, t, seed=t))
    scale = 0.3
    qkv = [u.clone().requires_grad_(True) for u in (q, k, v)]
    attention_t_reference(*qkv, scale).backward(g)
    got = attention_bwd_t_reference(q, k, v, g, scale)
    for a, u in zip(got, qkv):
        np.testing.assert_allclose(a.numpy(), u.grad.numpy(), **F32)


def test_fused_attention_on_cpu_differentiates_with_the_plain_backward():
    q, k, v, g = (torch.from_numpy(u) for u in _inputs(2, 64, seed=5))
    qkv = [u.clone().requires_grad_(True) for u in (q, k, v)]
    before = kernels.LAUNCHES[BWD_KERNEL]
    out = fused_attention_t(*qkv, 0.25)
    assert out.grad_fn is not None and "FusedAttention" in out.grad_fn.name()
    out.backward(g)
    want = attention_bwd_t_reference(q, k, v, g, 0.25)
    for a, u in zip(want, qkv):
        assert torch.equal(u.grad, a)
    assert kernels.LAUNCHES[BWD_KERNEL] == before
    assert torch.equal(fused_attention_bwd_t(q, k, v, g, 0.25)[0], want[0])


def test_bwd_wrapper_rejects_mismatched_cotangent():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fused_attention_bwd_t(q, q, q, torch.zeros(2, 8, 17), 1.0)
    with pytest.raises(TypeError):
        fused_attention_bwd_t(q, q, q, q.to(torch.bfloat16), 1.0)


@pytest.mark.parametrize("hw", [(8, 32), (4, 16)])
def test_attention_block_gradients_match_jax(hw):
    """Every parameter gradient of the Attention block (group_norm, to_q,
    to_k, to_v, to_out) and the input gradient, through `FusedAttention`
    on the CPU, against `jax.grad` of the JAX block on its einsum path.
    T = 256 and 64. Each tensor is held to 1e-4 of its own largest entry
    plus 1e-6 of the block's largest gradient: to_k.bias has an exact
    gradient of zero (a key bias shifts all logits of a row alike), so on
    both sides it holds only the rounding noise of sums of the other
    gradients' size."""
    h, w = hw
    c = 64
    rng = np.random.default_rng(h + 40)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    ct = rng.standard_normal((2, h, w, c)).astype(np.float32)
    m = JaxAttention(use_fused=False)
    params = perturb(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=7)

    def loss(p, xx):
        return jnp.sum(m.apply(p, xx) * jnp.asarray(ct))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, gp))

    blk = Attention(c, use_fused=None)
    blk.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    xt = nhwc_to_torch(x).requires_grad_(True)
    (blk(xt) * nhwc_to_torch(ct)).sum().backward()
    got = dict(blk.named_parameters())
    assert set(got) == set(want)
    floor = 1e-6 * max(np.abs(g.numpy()).max() for g in want.values())
    assert {"group_norm.weight", "to_q.weight", "to_k.bias",
            "to_v.weight"} <= set(got)
    for name, p in got.items():
        ref = want[name].numpy()
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + floor, (name, err)
    np.testing.assert_allclose(
        xt.grad.numpy().transpose(0, 3, 2, 1), np.asarray(gx),
        rtol=1e-4, atol=1e-4 * np.abs(np.asarray(gx)).max())
