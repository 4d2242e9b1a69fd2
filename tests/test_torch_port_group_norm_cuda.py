"""The GroupNorm -> activation -> wrap kernel pair
(rangeldm_tpu_torch/csrc/group_norm_act.cu) against its plain PyTorch
versions, on the card. The kernels have no CPU mode, so without a CUDA
device every test here skips. On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_group_norm_cuda.py

Shapes are the main path's: the flagship UNet's level-0 slices (one block a
slice) at training batch 32, RangeDM's and the VAE's full-resolution slices
(a cluster of blocks a slice) at their batches, and deep-level tiny slices.
The forward is held to the unfused chain computed in float32 and rounded
once to the dtype (one bf16 ulp where a statistic rounds the other way), the
backward to `group_norm_act_bwd_reference` in float32."""

import pytest
import torch

from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.ops import group_norm as gn
from rangeldm_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # of the largest entry


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# (B, C, W, H, groups, eps): flagship level 0 (down and up blocks), RangeDM
# level 0 (512 KB and 1 MB bf16 slices), the VAE's level 0 (64 and 128
# channels), deep flagship levels, slices too large to stage even split 8
# ways (2 and 4 MB), ragged shapes
SHAPES = [(32, 128, 256, 16, 32, 1e-5), (32, 256, 256, 16, 32, 1e-5),
          (8, 128, 1024, 64, 32, 1e-5), (8, 256, 1024, 64, 32, 1e-5),
          (16, 64, 1024, 64, 32, 1e-6), (16, 128, 1024, 64, 32, 1e-6),
          (32, 256, 64, 4, 32, 1e-5), (32, 256, 32, 2, 32, 1e-5),
          (4, 128, 256, 16, 32, 1e-5), (2, 512, 1024, 64, 32, 1e-6),
          (3, 96, 10, 6, 32, 1e-5), (2, 8, 1, 3, 4, 1e-5)]
# (act, shift, wrap)
VARIANTS = [("silu", True, True), ("silu", False, True),
            ("identity", False, False), ("relu", False, True)]


def _inputs(shape, dtype, with_shift, seed=0):
    b, c, w, h, groups, eps = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, c, w, h), generator=g, device="cuda") * 2
         + 0.5).to(dtype)
    weight = 1 + 0.1 * torch.randn(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    shift = (torch.randn((b, c), generator=g, device="cuda").to(dtype)
             if with_shift else None)
    return x, weight, bias, shift, groups, eps


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_plain_version(shape, dtype, variant):
    act, with_shift, wrap = variant
    x, weight, bias, shift, groups, eps = _inputs(shape, dtype, with_shift)
    before = kernels.LAUNCHES[gn.KERNEL]
    got = gn.group_norm_act(x, weight, bias, groups, eps, act, shift, wrap)
    again = gn.group_norm_act(x, weight, bias, groups, eps, act, shift, wrap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[gn.KERNEL] == before + 2
    want = gn.group_norm_act_reference(
        x.float(), weight, bias, groups, eps, act,
        None if shift is None else shift.float(), wrap).to(dtype)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])
    assert torch.equal(got, again)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_plain_version(shape, dtype, variant):
    """dx, dweight, dbias and dshift, the wrapped gradient folded; two
    backward passes bit-equal. ReLU's derivative jumps at 0, where the two
    versions' roundings of the pre-activation may fall on either side: its
    output gradient is zero within 1e-3 of the jump."""
    act, with_shift, wrap = variant
    x, weight, bias, shift, groups, eps = _inputs(shape, dtype, with_shift, 1)
    leaves = [t.detach().requires_grad_(True) if t is not None else None
              for t in (x, weight, bias, shift)]
    b, c, w, h = x.shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = torch.randn((b, c, w + 2 if wrap else w, h), generator=gen,
                    device="cuda").to(dtype)
    if act == "relu":
        z = gn.group_norm_act_reference(
            x.float(), weight, bias, groups, eps, "identity",
            None if shift is None else shift.float(), wrap)
        g = g * (z.abs() >= 1e-3)
    grads = []
    for _ in range(2):
        before = kernels.LAUNCHES[gn.BWD_KERNEL]
        out = gn.group_norm_act(leaves[0], leaves[1], leaves[2], groups, eps,
                                act, leaves[3], wrap)
        got = torch.autograd.grad(out, [t for t in leaves if t is not None],
                                  g)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[gn.BWD_KERNEL] == before + 1
        grads.append(got)
    assert all(torch.equal(p, q) for p, q in zip(*grads))
    want = gn.group_norm_act_bwd_reference(
        x.float(), weight, bias, groups, eps, act,
        None if shift is None else shift.float(), g.float(), wrap)
    for got, ref, like in zip(grads[0], [u for u in want if u is not None],
                              [t for t in (x, weight, bias, shift)
                               if t is not None]):
        assert got.dtype == like.dtype and got.shape == like.shape
        _close(got, ref, BWD_TOL[dtype])


def test_plans_of_the_main_path():
    """The adaptation the wrapper makes for the card (SMS SMs): one block a
    flagship slice, a cluster of 8 for RangeDM's level 0."""
    small = gn.plan(32, 128, 32, 256, 16, 2, True)
    assert small.clusters == 1 and small.stage_x and small.vec == 8
    big = gn.plan(8, 256, 32, 1024, 64, 2, True)
    assert big.clusters == 8 and big.stage_x
    assert not gn.plan(8, 256, 32, 1024, 64, 2, True, True).stage_g
    assert not gn.plan(2, 512, 32, 1024, 64, 2, True).stage_x


def test_graph_replay_equals_eager():
    """A captured forward and backward replay bit-equal to eager calls."""
    x, weight, bias, shift, groups, eps = _inputs(
        (8, 128, 1024, 64, 32, 1e-5), torch.bfloat16, True)
    g = torch.randn((8, 128, 1026, 64), device="cuda").to(torch.bfloat16)

    def step():
        leaf = x.detach().requires_grad_(True)
        out = gn.group_norm_act(leaf, weight, bias, groups, eps, "silu",
                                shift, True)
        return out, torch.autograd.grad(out, [leaf], g)[0]

    eager = step()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()                                     # warm on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, static))


def test_flagship_unet_launches_one_pair_per_norm():
    """61 GroupNorm sites a flagship UNet (45 with SiLU, 16 attention
    norms): 61 forward launches a forward, 61 backward launches a
    backward, under bf16 autocast as the train step runs them."""
    from rangeldm_tpu_torch.models import zoo
    cfg = zoo.rangeldm_kitti360().unet
    torch.manual_seed(0)
    model = UNet2D(cfg).cuda().train()
    h, w = cfg.sample_size
    x = torch.randn(2, cfg.in_channels, w, h, device="cuda")
    before = (kernels.LAUNCHES[gn.KERNEL], kernels.LAUNCHES[gn.BWD_KERNEL])
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x, torch.tensor([10, 900], device="cuda"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[gn.KERNEL] - before[0] == 61
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[gn.BWD_KERNEL] - before[1] == 61
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_flagship_unet_on_the_card_matches_the_cpu():
    """The full-width flagship UNet in float32 (TF32 off) through the kernel
    pair against the same weights on the CPU (the unfused chain): output
    and every parameter's gradient, within 1e-3 of the tensor's largest
    entry plus 1e-5 of the largest of all (some tensors' gradients are
    rounding noise near 1e-12)."""
    from rangeldm_tpu_torch.models import zoo
    cfg = zoo.rangeldm_kitti360().unet
    torch.manual_seed(0)
    cpu = UNet2D(cfg).train()
    card = UNet2D(cfg).cuda().train()
    card.load_state_dict(cpu.state_dict())
    h, w = cfg.sample_size
    x = torch.randn(1, cfg.in_channels, w, h)
    t = torch.tensor([300])
    want = cpu(x, t)
    want.square().mean().backward()
    got = card(x.cuda(), t.cuda())
    got.square().mean().backward()
    torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-4)
    top = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        err = (q.grad.cpu() - p.grad).abs().max().item()
        assert err <= 1e-3 * p.grad.abs().max().item() + 1e-5 * top, name


def test_kernel_rejects_what_it_does_not_take():
    x = torch.zeros(2, 8, 4, 4, device="cuda")
    w, b = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    with pytest.raises(TypeError):
        gn.group_norm_act(x.half(), w, b, 4, 1e-5)
    with pytest.raises(ValueError, match="multiple"):
        gn.group_norm_act(x, w, b, 3, 1e-5)
    with pytest.raises(ValueError, match="shift"):
        gn.group_norm_act(x, w, b, 4, 1e-5, shift=torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="weight"):
        gn.group_norm_act(x, w.cpu(), b, 4, 1e-5)
