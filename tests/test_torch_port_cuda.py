"""The CUDA attention kernels (rangeldm_tpu_torch/csrc/attention_fwd.cu and
attention_bwd.cu) against their plain PyTorch versions, on the card. The
kernels have no CPU mode, so without a CUDA device every test here skips.
On a machine with a card (and without JAX, which this file does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances are those of tests/test_flash_attention.py: forward 2e-5 in f32
and 3e-2 in bf16; backward rtol 2e-4 / atol 2e-5 in f32 and 3e-2 of the
largest entry in bf16 (tests/test_torch_port_attention_bwd.py says why)."""

import dataclasses

import pytest
import torch

from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.models.unet import Attention
from rangeldm_tpu_torch.ops.attention import (
    BWD_KERNEL, KERNEL, attention_bwd_t_reference, attention_t_reference,
    fused_attention_bwd_t, fused_attention_t, max_seq_len, max_seq_len_bwd,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(shape, dtype, seed=0, n=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(n)]


# the flagship shapes at batch 4 and at the parity gate's stage-report
# batch 1, RangeDM's at its training batch 8, ragged T, T = 1, a long T;
# then one head at every tile edge of the bf16 kernels (16-wide tiles, 64
# rows a block) and at the longest T each kernel takes for the dtype ("max")
SHAPES = [(64, 8, 1024), (128, 8, 256), (128, 8, 64), (16, 8, 1024),
          (32, 8, 256), (32, 8, 64), (512, 8, 256), (512, 8, 64),
          (5, 8, 200), (3, 8, 1), (2, 8, 2048)] + [
    (1, 8, t) for t in (1, 15, 16, 17, 63, 65, 200, 1024, 2048)] + ["max"]


def _shape(shape, limit):
    return (1, 8, limit) if shape == "max" else shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(shape, dtype):
    shape = _shape(shape, max_seq_len(dtype))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_kernel_matches_plain_version(shape, dtype):
    """The shapes of the forward's test, with the backward's longest T."""
    shape = _shape(shape, max_seq_len_bwd(dtype))
    q, k, v, g = _qkv(shape, dtype, seed=1, n=4)
    before = kernels.LAUNCHES[BWD_KERNEL]
    got = fused_attention_bwd_t(q, k, v, g, 0.3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[BWD_KERNEL] == before + 1
    want = attention_bwd_t_reference(q, k, v, g, 0.3)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        else:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= 3e-2 * b.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 8, 1024), (5, 8, 200), (1, 8, 17)])
def test_kernels_are_deterministic(shape, dtype):
    """No atomics and one writer per output: two calls of each kernel on
    the same inputs give bit-identical outputs."""
    q, k, v, g = _qkv(shape, dtype, seed=3, n=4)
    outs = [(fused_attention_t(q, k, v, 0.3),
             *fused_attention_bwd_t(q, k, v, g, 0.3)) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bwd_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(2, 8, 16, device="cuda")
    with pytest.raises(TypeError):
        fused_attention_bwd_t(*[q.half()] * 4, 1.0)
    with pytest.raises(TypeError):
        fused_attention_bwd_t(q, q, q, q.to(torch.bfloat16), 1.0)
    with pytest.raises(ValueError, match="shape"):
        fused_attention_bwd_t(q, q, q, torch.zeros(2, 8, 17, device="cuda"),
                              1.0)
    with pytest.raises(ValueError, match="head_dim"):
        fused_attention_bwd_t(*[torch.zeros(2, 16, 16, device="cuda")] * 4,
                              1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 16, 8, device="cuda").transpose(1, 2)
        fused_attention_bwd_t(q, q, q, t, 1.0)
    with pytest.raises(ValueError, match="limit"):
        long = torch.zeros(1, 8, max_seq_len_bwd(torch.float32) + 1,
                           device="cuda")
        fused_attention_bwd_t(long, long, long, long, 1.0)


@pytest.mark.parametrize("channels,hw", [(128, (16, 64)), (256, (8, 32))])
def test_attention_block_gradients_through_the_kernels(channels, hw):
    """The Attention block's parameter and input gradients through
    `FusedAttention` (both kernels) against the same block on the einsum
    path, f32 with TF32 off, at the flagship's T = 1024 and 256. Each
    tensor within 1e-4 of its largest entry plus 1e-6 of the block's
    largest gradient (to_k.bias has an exact gradient of zero)."""
    torch.manual_seed(0)
    fused = Attention(channels, use_fused=None).cuda()
    plain = Attention(channels, use_fused=False).cuda()
    plain.load_state_dict(fused.state_dict())
    h, w = hw
    x, ct = _qkv((2, channels, w, h), torch.float32, seed=2, n=2)
    grads = []
    for blk in (fused, plain):
        xx = x.clone().requires_grad_(True)
        before = (kernels.LAUNCHES[KERNEL], kernels.LAUNCHES[BWD_KERNEL])
        (blk(xx) * ct).sum().backward()
        torch.cuda.synchronize()
        launched = (kernels.LAUNCHES[KERNEL] - before[0],
                    kernels.LAUNCHES[BWD_KERNEL] - before[1])
        assert launched == ((1, 1) if blk is fused else (0, 0))
        grads.append({"x": xx.grad,
                      **{n: p.grad for n, p in blk.named_parameters()}})
    got, want = grads
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    for name, ref in want.items():
        assert got[name] is not None, name
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + floor, (name, err)


def test_unet_backward_through_the_kernels():
    """One training backward of a narrow flagship-grammar UNet in bf16
    under autocast: 16 forward and 16 backward launches, finite gradients
    for every parameter."""
    cfg = UNetConfig(sample_size=(16, 64), block_out_channels=(32, 32, 64,
                                                               64))
    torch.manual_seed(0)
    model = UNet2D(cfg).cuda().train()
    x = torch.randn(2, 5, 64, 16, device="cuda")
    kernels.reset_launches()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x, torch.tensor([10, 900], device="cuda"))
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[KERNEL] == 16
    assert kernels.LAUNCHES[BWD_KERNEL] == 16
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("name", ["rangeldm_upsample", "rangeldm_inpainting"])
def test_conditional_unet_through_the_kernel(name):
    """The full-width conditional UNets (12 and 9 input channels) in f32:
    all 16 attention layers launch the kernel and agree with the einsum
    path within 5e-4."""
    from rangeldm_tpu_torch.models import zoo
    cfg = getattr(zoo, name)().unet
    torch.manual_seed(0)
    fused = UNet2D(cfg).cuda().eval()
    plain = UNet2D(dataclasses.replace(cfg, use_fused_attention=False))
    plain.load_state_dict(fused.state_dict())
    plain = plain.cuda().eval()
    h, w = cfg.sample_size
    x = torch.randn(2, cfg.in_channels, w, h, device="cuda")
    t = torch.tensor([10, 900], device="cuda")
    with torch.inference_mode():
        before = kernels.LAUNCHES[KERNEL]
        got = fused(x, t)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[KERNEL] - before == 16
        want = plain(x, t)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


def test_rangedm_unet_through_both_kernels():
    """The full-width pixel-space RangeDM UNet (64x1024 image) in f32 at
    batch 2: its 6 attention layers launch each kernel once in a forward
    and backward, and the output and the attention layers' gradients agree
    with the einsum path (5e-4; 1e-4 of each tensor's largest entry plus
    1e-6 of the largest gradient)."""
    from rangeldm_tpu_torch.models import zoo
    cfg = zoo.rangedm_kitti360().unet
    torch.manual_seed(0)
    fused = UNet2D(cfg).cuda().train()
    plain = UNet2D(dataclasses.replace(cfg, use_fused_attention=False))
    plain.load_state_dict(fused.state_dict())
    plain = plain.cuda().train()
    h, w = cfg.sample_size
    x, ct = _qkv((2, cfg.in_channels, w, h), torch.float32, seed=5, n=2)
    ct = ct[:, :cfg.out_channels]
    t = torch.tensor([10, 900], device="cuda")
    outs, grads = [], []
    for model in (fused, plain):
        kernels.reset_launches()
        out = model(x, t)
        (out * ct).mean().backward()
        torch.cuda.synchronize()
        launched = (kernels.LAUNCHES[KERNEL], kernels.LAUNCHES[BWD_KERNEL])
        assert launched == ((6, 6) if model is fused else (0, 0))
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if ".attentions." in n})
    torch.testing.assert_close(outs[0], outs[1], rtol=5e-4, atol=5e-4)
    got, want = grads
    assert len(want) == 6 * 10          # norm, q, k, v, out: weight, bias
    floor = 1e-6 * max(v.abs().max().item() for v in want.values())
    for name, ref in want.items():
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + floor, (name, err)


@pytest.mark.parametrize("mode", ["upsample", "inpainting"])
def test_conditional_train_step_through_both_kernels(mode):
    """One conditional train step of a narrow flagship-grammar UNet in f32,
    with the condition built from the batch: 16 forward and 16 backward
    launches, and every gradient within 1e-4 of its own largest entry (plus
    1e-6 of the model's largest) of the same step on the einsum path."""
    from rangeldm_tpu_torch.diffusion.schedule import Schedule
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    from rangeldm_tpu_torch.training import conditions
    from rangeldm_tpu_torch.training.ldm_trainer import (
        LdmTrainConfig, make_ldm_train_step,
    )
    from rangeldm_tpu_torch.training.train_state import (
        TrainState, make_adamw,
    )
    cfg = UNetConfig(sample_size=(16, 64), block_out_channels=(32, 32, 64,
                                                               64),
                     in_channels=12 if mode == "upsample" else 9)
    torch.manual_seed(0)
    vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2, 2),
                                  num_res_blocks=1)).cuda().eval()
    vae.requires_grad_(False)
    fused = UNet2D(cfg).cuda().train()
    plain = UNet2D(dataclasses.replace(cfg, use_fused_attention=False))
    plain.load_state_dict(fused.state_dict())
    plain = plain.cuda().train()
    g = torch.Generator(device="cuda").manual_seed(4)
    images = torch.randn(2, 2, 256, 64, device="cuda", generator=g)
    mask = -torch.ones(2, 1, 256, 64, device="cuda")
    mask[:, :, :16] = 1.0
    batch = {"jpg": images, "down": images[..., 2::4],
             "masked_image": torch.where(mask > 0, -1.0, images),
             "inpainting_mask": mask}
    cond_fn = (conditions.make_upsample_cond_fn(4) if mode == "upsample"
               else conditions.make_inpainting_cond_fn(vae, 0.18215,
                                                       (16, 64)))
    draws = dict(noise=torch.randn(2, 4, 64, 16, device="cuda", generator=g),
                 timesteps=torch.tensor([10, 900], device="cuda"),
                 posterior_noise=torch.randn(2, 4, 64, 16, device="cuda",
                                             generator=g),
                 cond_posterior_noise=torch.randn(2, 4, 64, 16,
                                                  device="cuda",
                                                  generator=g))
    grads = []
    for model in (fused, plain):
        state = TrainState.create(model, make_adamw(model.parameters(),
                                                    grad_clip=1e9),
                                  with_ema=False)
        step = make_ldm_train_step(Schedule(), LdmTrainConfig(
            pos_encoding=False), vae, cond_fn=cond_fn)
        kernels.reset_launches()
        step(state, batch, **draws)
        torch.cuda.synchronize()
        launched = (kernels.LAUNCHES[KERNEL], kernels.LAUNCHES[BWD_KERNEL])
        assert launched == ((16, 16) if model is fused else (0, 0))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    got, want = grads
    floor = 1e-6 * max(v.abs().max().item() for v in want.values())
    for name, ref in want.items():
        assert got[name] is not None and torch.isfinite(got[name]).all()
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + floor, (name, err)


# ---------------------------------------------------------------------------
# the scoring path: RangeNet++, MMD, chamfer and histograms on the card
# ---------------------------------------------------------------------------

def _rangenet(seed=0):
    """A darknet53 with seeded random weights and BatchNorm statistics."""
    from rangeldm_tpu_torch.metrics.rangenet import RangeNet
    gen = torch.Generator().manual_seed(seed)
    model = RangeNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.normal_(0, 0.02, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.normal_(0.7, 0.1, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
                m.running_mean.normal_(0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def test_rangenet_on_the_card_matches_the_cpu():
    """Full width (2 x 5 x 64 x 1024) in float32: features and logits
    within 1e-5 of their scale. TF32 is switched on around the call: the
    forward turns it off for itself and gives the setting back. The same
    layers run with TF32 on land above the bound, so a forward that leaked
    TF32 would fail."""
    model = _rangenet()
    x = torch.randn(2, 5, 64, 1024, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want_f, want_l = model(x)
        card = model.cuda()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_f, got_l = card(x.cuda())
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
            leaked = card.decoder(*card.backbone(x.cuda()))
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    for got, want in ((got_f, want_f), (got_l, want_l)):
        scale = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale
    scale = want_f.abs().max().item()
    assert (leaked.cpu() - want_f).abs().max().item() > 1e-5 * scale


def test_rangenet_features_on_the_card_do_not_depend_on_the_batch():
    model = _rangenet().cuda()
    model.train()                      # stays on the running statistics
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(8, 5, 64, 1024, device="cuda", generator=g)
    with torch.inference_mode():
        alone = model(x[5:6])[0]
        batch = model(x)[0][5:6]
    assert (alone - batch).abs().max().item() <= 1e-4 * alone.abs().max()


def _clouds(seed, n=4000, count=6):
    g = torch.Generator().manual_seed(seed)
    azi = torch.rand(count, n, generator=g) * 6.2832 - 3.1416
    r = torch.rand(count, n, generator=g) * 77.5 + 2.5
    zen = torch.rand(count, n, generator=g) * 0.46 - 0.43
    return torch.stack([r * torch.cos(zen) * torch.cos(azi),
                        r * torch.cos(zen) * torch.sin(azi),
                        r * torch.sin(zen)], dim=-1)


def test_histograms_and_mmd_on_the_card():
    """histogram_batch on the card equals it on the CPU bit for bit, and
    the float32 MMD on the card holds the float64 host value at rtol
    1e-4."""
    from rangeldm_tpu_torch.metrics.histogram import (
        histogram_batch, kitti_histogram,
    )
    from rangeldm_tpu_torch.metrics.mmd import compute_mmd
    pc = _clouds(3)
    mask = torch.rand(pc.shape[:2],
                      generator=torch.Generator().manual_seed(4)) < 0.9
    got = histogram_batch(pc.cuda(), mask.cuda())
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), histogram_batch(pc, mask))
    a = [kitti_histogram(c.numpy()) for c in pc]
    b = [kitti_histogram(c.numpy()) for c in _clouds(5)]
    host = compute_mmd(a, b)
    card = compute_mmd(a, b, device=True)
    assert abs(card - host) <= 1e-4 * abs(host)


def test_chamfer_on_the_card():
    from rangeldm_tpu_torch.metrics.chamfer import chamfer_distance
    a, b = _clouds(6, n=3000, count=2).double()
    valid = torch.rand(3000, generator=torch.Generator().manual_seed(7)) < 0.8
    d = torch.cdist(a, b) ** 2
    want = (d[:, valid].min(1).values.mean()
            + d[:, valid].min(0).values.mean())
    got = chamfer_distance(a.float().cuda(), b.float().cuda(),
                           b_valid=valid.cuda())
    assert got.device.type == "cuda"
    assert abs(got.item() - want.item()) <= 1e-4 * want.item()
    none = torch.zeros(3000, dtype=torch.bool, device="cuda")
    assert torch.isnan(chamfer_distance(a.cuda(), b.cuda(), b_valid=none))


# -- VAE-GAN training (training/vae_trainer.py): no kernel of its own; the
# steps on the card against the same steps on the CPU, f32, TF32 off ------

def _vae_gan_state(device, cfg):
    from rangeldm_tpu_torch.models.discriminator import (
        NLayerDiscriminatorMetaKernel,
    )
    from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
    from rangeldm_tpu_torch.training.vae_trainer import VaeGanState
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2),
                                      num_res_blocks=1))
        disc = NLayerDiscriminatorMetaKernel(2, ndf=8, n_layers=2)
    return VaeGanState.create(vae.to(device), disc.to(device), 1e-3, cfg)


@pytest.mark.parametrize("disc_start", [0, 10 ** 9])
def test_vae_gan_steps_on_the_card_match_the_cpu(disc_start):
    """One generator and one discriminator step at the parity tests' size
    (ch 32, 64x16 images, batch 2, MetaKernel ndf 8) on the card against
    the CPU (chip_smoke.vae_gan_card_vs_cpu): every metric within 1e-4 of
    its size, with the adaptive weight below its clip; after each step the
    updated VAE, logvar and EMA, then the discriminator, within what one
    Adam step explains, and the running statistics within 1e-5."""
    from chip_smoke import VAE_CARD_TOL, vae_gan_card_vs_cpu
    out = vae_gan_card_vs_cpu("cuda", disc_start)
    assert out["rel"] <= VAE_CARD_TOL, out
    assert not out["problems"], out["problems"][:5]
    assert 0 < out["d_weight"] < out["d_weight_clip"], out


def test_vae_gan_steps_in_bf16_on_the_card():
    """mixed_precision bf16: autocast over the VAE's and discriminator's
    forwards only; the metrics stay f32 and finite, the parameters f32."""
    from rangeldm_tpu_torch.training.vae_trainer import (
        VaeLossConfig, make_vae_gan_steps,
    )
    cfg = VaeLossConfig(disc_start=0)
    state = _vae_gan_state("cuda", cfg)
    gen, disc = make_vae_gan_steps(cfg, compute_dtype=torch.bfloat16)
    x = torch.rand(2, 2, 64, 16, device="cuda")
    gen_g = torch.Generator(device="cuda").manual_seed(0)
    m = gen(state, x, generator=gen_g)
    m.update(disc(state, x, generator=gen_g))
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.vae.parameters())
