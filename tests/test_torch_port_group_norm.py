"""`ops/group_norm.py` on the CPU: the plain versions of the GroupNorm ->
activation -> wrap kernel pair held to the unfused module chain, the
kernels' plan at the main path's shapes, and the modules that now run every
norm through it (same outputs, bit for bit, and the same state-dict keys as
the unfused code). The kernels themselves are held to these plain versions
on the card (tests/test_torch_port_group_norm_cuda.py). f32, toy sizes."""

import itertools

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from rangeldm_tpu_torch.models.layers import (
    CircularConv, VaeResnetBlock, norm_act, norm_act_conv,
)
from rangeldm_tpu_torch.models.unet import ResnetBlock2D, UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import Decoder, VaeConfig
from rangeldm_tpu_torch.ops import group_norm as gn
from rangeldm_tpu_torch.ops import kernels

ACTS = {"identity": lambda y: y, "silu": F.silu, "relu": F.relu}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _unfused(norm, conv, x, act, shift):
    """The chain as the modules ran it before: shift, GroupNorm, the
    activation, and the conv with its own circular pad."""
    if shift is not None:
        x = x + shift[:, :, None, None]
    return conv(ACTS[act](norm(x)))


@pytest.mark.parametrize("act,with_shift,wrap,eps", list(itertools.product(
    ["identity", "silu", "relu"], [False, True], [False, True],
    [1e-5, 1e-6])))
def test_plain_versions_match_the_unfused_chain(act, with_shift, wrap, eps):
    """Forward, and the backward's arithmetic (`group_norm_act_bwd_reference`,
    the wrapped gradient folded) against autograd through the unfused
    chain: x, weight, bias and shift."""
    g = torch.Generator().manual_seed(7)
    norm = nn.GroupNorm(4, 8, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(8, generator=g))
        norm.bias.copy_(0.2 * torch.randn(8, generator=g))
    conv = CircularConv(8, 3, 3, 1, 1)
    x = (torch.randn(2, 8, 6, 4, generator=g) * 1.5 + 0.3).requires_grad_()
    shift = (torch.randn(2, 8, generator=g).requires_grad_()
             if with_shift else None)
    ct = torch.randn(2, 3, 6, 4, generator=g)

    want = _unfused(norm, conv, x, act, shift)
    inputs = [t for t in (x, norm.weight, norm.bias, shift) if t is not None]
    want_grads = torch.autograd.grad((want * ct).sum(), inputs)

    y = gn.group_norm_act(x, norm.weight, norm.bias, 4, eps, act, shift, wrap)
    assert y.shape == (2, 8, 8 if wrap else 6, 4)
    yl = y.detach().requires_grad_()
    got = conv(yl, wrapped=wrap)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    gy, = torch.autograd.grad((got * ct).sum(), [yl])
    got_grads = gn.group_norm_act_bwd_reference(
        x.detach(), norm.weight.detach(), norm.bias.detach(), 4, eps, act,
        None if shift is None else shift.detach(), gy, wrap)
    for a, b in zip([u for u in got_grads if u is not None], want_grads):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_fold_undoes_the_wrap():
    """The fold is the adjoint of the wrap: <wrap(y), g> = <y, fold(g)>."""
    g = torch.Generator().manual_seed(1)
    y, gw = torch.randn(2, 3, 5, 4, generator=g), torch.randn(
        2, 3, 7, 4, generator=g)
    wrapped = F.pad(y, (0, 0, 1, 1), mode="circular")
    torch.testing.assert_close((wrapped * gw).sum(),
                               (y * gn.fold_wrapped(gw)).sum())


# (B, C, W, H, itemsize): flagship levels 0-3 at batch 32 and the sampling
# CLI's batch 4, RangeDM's levels 0-1 at batch 8, the VAE's level 0 in f32
# and bf16, the gate's batch 1, and ragged ones
PLAN_SHAPES = [(32, 128, 256, 16, 2), (32, 256, 256, 16, 2),
               (32, 128, 128, 8, 2), (32, 256, 64, 4, 2),
               (32, 256, 32, 2, 2), (4, 128, 256, 16, 2),
               (8, 128, 1024, 64, 2), (8, 256, 1024, 64, 2),
               (8, 256, 512, 32, 2), (16, 64, 1024, 64, 4),
               (16, 128, 1024, 64, 4), (32, 64, 1024, 64, 2),
               (1, 128, 256, 16, 2), (2, 512, 1024, 64, 2),
               (3, 96, 10, 6, 4), (2, 8, 1, 3, 2)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_the_slice(shape, wrap, backward):
    """Every plan cuts the slice into whole, aligned vectors the kernels
    take (the bounds csrc/group_norm_act.cu checks), stages only what fits
    in shared memory, and splits a slice only into a cluster the card
    schedules."""
    b, c, w, h, itemsize = shape
    groups = 32 if c % 32 == 0 else 4
    p = gn.plan(b, c, groups, w, h, itemsize, wrap, backward)
    n = c // groups * w * h
    assert p.clusters * p.portions * p.portion == n
    assert 1 <= p.clusters <= gn.MAX_CLUSTER
    assert 1 <= p.portions <= gn.MAX_PORTIONS
    assert p.portions * p.tpc <= p.threads <= gn.MAX_THREADS
    assert p.threads % 32 == 0 and p.tpc & (p.tpc - 1) == 0
    assert p.portion % p.vec == 0 and p.vec * itemsize <= 16
    assert (h if wrap else w * h) % p.vec == 0
    staged = p.portions * p.portion * itemsize * (p.stage_x + p.stage_g)
    assert staged <= gn.SMEM_BYTES
    assert p.stage_g <= (backward and p.stage_x)


def test_plan_adapts_on_the_slice_size():
    """One block a flagship slice at batch 32; a cluster of 8 blocks for
    RangeDM's and the VAE's full-resolution slices, staged in shared memory
    up to 1 MB and read twice beyond; blocks split further to fill the card
    at the sampling CLI's batch 4; a misaligned pointer narrows the
    loads."""
    flagship = gn.plan(32, 128, 32, 256, 16, 2, True)
    assert (flagship.clusters, flagship.vec, flagship.stage_x) == (1, 8, True)
    rangedm = gn.plan(8, 256, 32, 1024, 64, 2, True)
    assert rangedm.clusters == 8 and rangedm.stage_x
    bwd = gn.plan(8, 256, 32, 1024, 64, 2, True, backward=True)
    assert bwd.stage_x and not bwd.stage_g
    bwd = gn.plan(8, 128, 32, 1024, 64, 2, True, backward=True)
    assert bwd.clusters == 8 and bwd.stage_x and not bwd.stage_g
    bwd = gn.plan(32, 256, 32, 256, 16, 2, True, backward=True)
    assert bwd.stage_x and bwd.stage_g
    assert gn.plan(16, 64, 32, 1024, 64, 4, True).clusters == 8
    assert not gn.plan(2, 512, 32, 1024, 64, 2, True).stage_x
    assert gn.plan(4, 128, 32, 256, 16, 2, True).clusters > 1
    assert gn.plan(32, 128, 32, 256, 16, 2, True, align=4).vec == 2
    assert gn.plan(32, 256, 32, 64, 4, 2, True).vec == 4


def test_cpu_and_meta_run_no_kernel():
    """CPU tensors and meta tensors (a FLOP counter's UNet, as chip_smoke.py
    `unet_work` runs it) take the plain version; an unknown activation
    raises."""
    before = dict(kernels.LAUNCHES)
    x = torch.randn(2, 8, 4, 4)
    w, b = torch.ones(8), torch.zeros(8)
    gn.group_norm_act(x, w, b, 4, 1e-5, "silu", wrap=True)
    meta = gn.group_norm_act(x.to("meta"), w.to("meta"), b.to("meta"), 4,
                             1e-5, "silu", wrap=True)
    assert meta.device.type == "meta" and meta.shape == (2, 8, 6, 4)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="activation"):
        gn.group_norm_act(x, w, b, 4, 1e-5, "gelu")


@pytest.mark.parametrize("args,wrapped", [
    ((3, 1, 1, True, False), True), ((3, 2, 1, True, False), True),
    ((3, 1, 1, True, True), False), ((1, 1, 0, False, False), False),
    ((3, 1, 1, False, False), False), ((3, 2, ((0, 1), (0, 1))), False),
    ((5, 1, (1, 2)), False)])
def test_takes_wrapped(args, wrapped):
    """Only a circular 3x3 conv with one row of wrap a side, no coordinate
    channel and equal beam pads takes the norm's wrapped output; where it
    does, the conv of the wrap with `wrapped=True` equals `forward`."""
    conv = CircularConv(4, 4, *args)
    assert conv.takes_wrapped is wrapped
    if wrapped:
        x = torch.randn(2, 4, 6, 5)
        torch.testing.assert_close(
            conv(F.pad(x, (0, 0, 1, 1), mode="circular"), wrapped=True),
            conv(x), rtol=0, atol=0)


def _resnet_before(blk: ResnetBlock2D, x, temb):
    h = blk.conv1(F.silu(blk.norm1(x)))
    h = h + blk.time_emb_proj(F.silu(temb))[:, :, None, None]
    h = blk.conv2(blk.dropout(F.silu(blk.norm2(h))))
    if hasattr(blk, "conv_shortcut"):
        x = blk.conv_shortcut(x)
    return x + h


def _vae_block_before(blk: VaeResnetBlock, x):
    act = F.silu if blk.act == "silu" else F.relu
    h = blk.conv1(act(blk.norm1(x)))
    h = blk.conv2(blk.dropout(act(blk.norm2(h))))
    if hasattr(blk, "nin_shortcut"):
        x = blk.nin_shortcut(x)
    return x + h


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_resnet_blocks_are_unchanged(dropout):
    """ResnetBlock2D and VaeResnetBlock (silu, relu, coordconv): the same
    outputs bit for bit and the same state-dict keys as the unfused code,
    in training mode with and without dropout (the wrap is skipped where
    dropout acts)."""
    torch.manual_seed(0)
    blk = ResnetBlock2D(32, 64, 16, groups=32, dropout=dropout).train()
    x, temb = torch.randn(2, 32, 8, 4), torch.randn(2, 16)
    torch.manual_seed(1)
    got = blk(x, temb)
    torch.manual_seed(1)
    assert torch.equal(got, _resnet_before(blk, x, temb))
    assert sorted(blk.state_dict()) == sorted(
        ["norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias",
         "time_emb_proj.weight", "time_emb_proj.bias", "norm2.weight",
         "norm2.bias", "conv2.weight", "conv2.bias", "conv_shortcut.weight",
         "conv_shortcut.bias"])
    for act, coord in (("silu", False), ("relu", False), ("silu", True)):
        vblk = VaeResnetBlock(32, 64, dropout, act, coord=coord).train()
        x = torch.randn(2, 32, 8, 4)
        torch.manual_seed(2)
        got = vblk(x)
        torch.manual_seed(2)
        assert torch.equal(got, _vae_block_before(vblk, x))
        assert sorted(vblk.state_dict()) == sorted(
            [f"{m}.{p}" for m in ("norm1", "conv1", "norm2", "conv2",
                                  "nin_shortcut") for p in ("weight", "bias")])


def test_unet_and_decoder_are_unchanged():
    """A small UNet2D with attention, and Decoder with and without
    pre_end: the same outputs bit for bit as the unfused head over the
    same trunk."""
    torch.manual_seed(0)
    cfg = UNetConfig(sample_size=(4, 16), in_channels=3, out_channels=2,
                     block_out_channels=(32, 32),
                     down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                     up_block_types=("AttnUpBlock2D", "UpBlock2D"))
    unet = UNet2D(cfg).eval()
    x, t = torch.randn(2, 3, 16, 4), torch.tensor([3, 500])
    with torch.no_grad():
        got = unet(x, t)
        trunk = _unet_trunk(unet, x, t)
        want = unet.conv_out(F.silu(unet.conv_norm_out(trunk)))
    assert torch.equal(got, want)

    torch.manual_seed(0)
    dec = Decoder(VaeConfig(ch=32, ch_mult=(1, 2))).eval()
    z = torch.randn(2, 4, 8, 4)
    with torch.no_grad():
        feats = dec(z, pre_end=True)
        out = dec(z)
        trunk = dec.mid(dec.conv_in(z))
        for level in reversed(dec.up):
            trunk = level.blocks(trunk)
            if hasattr(level, "upsample"):
                trunk = level.upsample(trunk)
        want = F.silu(dec.norm_out(trunk))
    assert torch.equal(feats, want)
    assert torch.equal(out, dec.conv_out(want))


def _unet_trunk(unet, x, t):
    """UNet2D.forward up to conv_norm_out (the modules' own forwards)."""
    from rangeldm_tpu_torch.models.layers import timestep_embedding
    c = unet.cfg
    temb = unet.time_embedding(timestep_embedding(
        t, c.block_out_channels[0], c.flip_sin_to_cos, c.freq_shift))
    h = unet.conv_in(x)
    skips = [h]
    for blk in unet.down_blocks:
        h, s = blk(h, temb)
        skips += s
    h = unet.mid_block(h, temb)
    for blk in unet.up_blocks:
        h = blk(h, skips, temb)
    return h


def test_norm_act_helpers_match_their_modules():
    """norm_act is the module's GroupNorm then the activation; norm_act_conv
    with an active dropout convolves the dropped-out activation."""
    torch.manual_seed(0)
    norm, conv = nn.GroupNorm(4, 8), CircularConv(8, 8, 3, 1, 1)
    x = torch.randn(2, 8, 6, 4)
    assert torch.equal(norm_act(norm, x, "silu"), F.silu(norm(x)))
    drop = nn.Dropout(0.5).train()
    torch.manual_seed(3)
    got = norm_act_conv(norm, x, "silu", conv, dropout=drop)
    torch.manual_seed(3)
    assert torch.equal(got, conv(drop(F.silu(norm(x)))))


def _zoo_model(name):
    """(model, input) of a shipped configuration's model, on the meta
    device (shapes only; attention on its plain path, which meta takes)."""
    import dataclasses
    from rangeldm_tpu_torch.models import zoo
    from rangeldm_tpu_torch.models.vae import AutoencoderKL
    spec = getattr(zoo, name.split(".")[0])()
    part = name.split(".")[1]
    with torch.device("meta"):
        if part == "unet":
            h, w = spec.unet.sample_size
            cfg = dataclasses.replace(spec.unet, use_fused_attention=False)
            return UNet2D(cfg), (torch.zeros(2, cfg.in_channels, w, h),
                                 torch.zeros(2))
        cfg = spec.vae if part != "vae_gan" else VaeConfig(
            ch=64, ch_mult=(1, 2, 4), z_channels=4, circular=True)
        vae, (h, w) = AutoencoderKL(cfg), spec.image_size
        if part == "decoder":
            f = cfg.down_factor
            return vae.decoder, (torch.zeros(2, cfg.z_channels, w // f,
                                             h // f),)
        model = vae.encoder if part == "encoder" else vae
        return model, (torch.zeros(2, cfg.in_channels, w, h),)


@pytest.mark.parametrize("name", [
    "rangeldm_kitti360.unet", "rangeldm_kitti360.encoder",
    "rangeldm_kitti360.decoder", "rangedm_kitti360.unet",
    "rangeldm_upsample.unet", "rangeldm_inpainting.unet",
    "rangeldm_kitti360.vae_gan"])
def test_every_group_norm_runs_the_pair_once_a_pass(name, monkeypatch):
    """Each GroupNorm layer of the shipped models calls `group_norm_act`
    once a forward, so the pair's counters read the model's GroupNorm
    layers a pass (61 for the flagship UNet, as chip_smoke.py requires on
    the main paths)."""
    from rangeldm_tpu_torch.models import layers
    calls = []

    def counted(x, weight, *args):
        calls.append(weight)
        return gn.group_norm_act(x, weight, *args)

    monkeypatch.setattr(layers, "group_norm_act", counted)
    model, inputs = _zoo_model(name)
    norms = [m.weight for m in model.modules() if isinstance(m, nn.GroupNorm)]
    model(*inputs)
    assert len(calls) == len(norms) and all(
        any(c is w for c in calls) for w in norms)
    if name == "rangeldm_kitti360.unet":
        assert len(calls) == 61
