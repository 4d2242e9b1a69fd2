"""The CUDA attention kernel (rangeldm_tpu_torch/csrc/attention_fwd.cu)
against its plain PyTorch version, on the card. The kernel has no CPU
mode, so without a CUDA device every test here skips. On a machine with a
card (and without JAX, which this file does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances are those of tests/test_flash_attention.py: 2e-5 in f32, 3e-2
in bf16."""

import dataclasses

import pytest
import torch

from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.ops.attention import (
    KERNEL, attention_t_reference, fused_attention_t, max_seq_len,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 8, 1024), (128, 8, 256),
                                   (128, 8, 64), (5, 8, 200), (3, 8, 1),
                                   (2, 8, 2048)])
def test_kernel_matches_plain_version(shape, dtype):
    q, k, v = _qkv(shape, dtype)
    before = kernels.LAUNCHES[KERNEL]
    got = fused_attention_t(q, k, v, 0.3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[KERNEL] == before + 1
    want = attention_t_reference(q, k, v, 0.3)
    assert got.dtype == dtype and got.shape == shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(2, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fused_attention_t(*[torch.zeros(2, 16, 16, device="cuda")] * 3)
    with pytest.raises(TypeError):
        fused_attention_t(*[q.half()] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 16, 8, device="cuda").transpose(1, 2)
        fused_attention_t(t, t, t)
    with pytest.raises(ValueError, match="limit"):
        long = torch.zeros(1, 8, max_seq_len(torch.float32) + 1,
                           device="cuda")
        fused_attention_t(long, long, long)
    with pytest.raises(ValueError, match="device"):
        fused_attention_t(q, q.cpu(), q)


def test_unet_through_the_kernel():
    """A narrow UNet of the flagship grammar: all 16 attention layers
    launch the kernel and agree with the einsum path."""
    cfg = UNetConfig(sample_size=(16, 64), block_out_channels=(32, 32, 64,
                                                               64))
    torch.manual_seed(0)
    fused = UNet2D(cfg).cuda().eval()
    plain = UNet2D(dataclasses.replace(cfg, use_fused_attention=False))
    plain.load_state_dict(fused.state_dict())
    plain = plain.cuda().eval()
    x = torch.randn(2, 5, 64, 16, device="cuda")
    with torch.inference_mode():
        before = kernels.LAUNCHES[KERNEL]
        got = fused(x, torch.tensor([10, 900], device="cuda"))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[KERNEL] - before == 16
        want = plain(x, torch.tensor([10, 900], device="cuda"))
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
