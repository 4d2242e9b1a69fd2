"""The port's attention (rangeldm_tpu_torch/ops/attention.py, models/unet.py
Attention) against the JAX package's Pallas kernel body, run in interpret
mode on the CPU as tests/test_flash_attention.py runs it.

Tolerances are those of tests/test_flash_attention.py: 2e-5 in f32; 3e-2
in bf16, where both sides round the softmax weights to bf16 at different
points. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py and tests/test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rangeldm_tpu.models.unet import Attention as JaxAttention
from rangeldm_tpu.ops.attention import fused_attention_t as jax_fused_t

from rangeldm_tpu_torch.convert import unet_state_dict_from_jax
from rangeldm_tpu_torch.models.unet import Attention
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.ops.attention import (
    attention_t_reference, fused_attention_t,
)
from test_torch_port_common import nhwc_to_torch, perturb, torch_to_nhwc


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,t", [(2, 1024), (3, 256)])
def test_reference_matches_pallas_kernel_body(n, t, dtype):
    rng = np.random.default_rng(n * t)
    q, k, v = (rng.standard_normal((n, 8, t)).astype(np.float32)
               for _ in range(3))
    scale = 8 ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_fused_t(*(jnp.asarray(u, jdt) for u in (q, k, v)),
                                  scale=scale, interpret=True), np.float32)
    tdt = getattr(torch, dtype)
    # bf16 inputs are the same bf16 values on both sides
    tq, tk, tv = (torch.from_numpy(u).to(tdt) for u in (q, k, v))
    got = attention_t_reference(tq, tk, tv, scale)
    assert got.dtype == tdt and got.shape == (n, 8, t)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 8, 64))
                                .astype(np.float32)) for _ in range(3))
    before = kernels.LAUNCHES["attention_fwd"]
    got = fused_attention_t(q, k, v)
    assert torch.equal(got, attention_t_reference(q, k, v, 8 ** -0.5))
    assert kernels.LAUNCHES["attention_fwd"] == before


def test_wrapper_rejects_mismatched_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fused_attention_t(q, torch.zeros(2, 8, 17), q)
    with pytest.raises(TypeError):
        fused_attention_t(q, q.to(torch.bfloat16), q)


@pytest.mark.parametrize("use_fused", [None, False])
@pytest.mark.parametrize("hw", [(8, 32), (4, 16)])
def test_attention_block_matches_jax_fused(hw, use_fused):
    """The channel-major Attention block, tokens flattened in (W, H) order,
    against the JAX block on its Pallas path (use_fused=True, interpret
    mode). T = 256 and 64."""
    h, w = hw
    c = 64
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    m = JaxAttention(use_fused=True)
    params = perturb(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    want = np.asarray(m.apply(params, jnp.asarray(x)))

    blk = Attention(c, use_fused=use_fused)
    blk.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = torch_to_nhwc(blk(nhwc_to_torch(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
