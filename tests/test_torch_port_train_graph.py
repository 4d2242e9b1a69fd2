"""The training step's CUDA graph (rangeldm_tpu_torch/training/
ldm_trainer.py) on the CPU. The capture itself runs on the card
(tests/test_torch_port_cuda.py); here a stand-in graph takes its place,
which, as a capture does, runs the step's Python once and leaves the state
as it found it, and at each replay runs the step and writes its loss and
gradient norm into the static outputs, leaving no host spans. With it:
each key runs eager, then captured, then replayed; a new batch shape or a
new train state gets its own graphs; the graphed steps equal the eager
ones bit for bit (plain, gradient accumulation, the upsample and the
inpainting conditions), a replayed loss is not overwritten by the next,
and a resume in place continues the graphed run. The CPU, a process group
and draws given keep the step eager; the EMA update reads a device-tensor
weight as it reads a float."""

import numpy as np
import pytest
import torch

from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.training import conditions, ema, ldm_trainer
from rangeldm_tpu_torch.training.ldm_trainer import (
    LdmTrainConfig, make_ldm_train_step, step_ema_weight,
)
from rangeldm_tpu_torch.training.train_state import TrainState, make_adamw
from rangeldm_tpu_torch.utils import profiling
from rangeldm_tpu_torch.utils.profiling import spans

KINDS = ("train_graph_replay", "train_graph_capture", "train_eager")
PHASES = ("encode", "forward", "backward", "clip", "adamw", "ema")
IMAGE = (64, 16)                    # (W, H): a (16, 4) latent
# mode -> (UNet input channels, gradient accumulation steps)
MODES = {"plain": (4, 1), "accum": (4, 2), "upsample": (12, 1),
         "inpainting": (9, 1)}


@pytest.fixture(autouse=True)
def _fresh_ring():
    torch.set_num_threads(2)
    profiling._RING.clear()
    yield
    profiling._RING.clear()


class CpuStepGraph(ldm_trainer._StepGraph):
    """A captured step on the CPU (module docstring); one launch of a
    made-up kernel counted by the capture, as a kernel's wrapper would."""
    state = None

    def _capture(self, fn, generators):
        saved = self.state.state_dict()
        kernels.count_launch("fake_kernel")
        out = fn()
        self.state.load_state_dict(saved)
        self.fn = fn
        return out

    def replay(self):
        n = len(profiling._RING)
        for k, v in self.fn().items():
            self.out[k].copy_(v)
        while len(profiling._RING) > n:
            profiling._RING.pop()


def graphed(monkeypatch, state):
    monkeypatch.setattr(ldm_trainer, "_graphable", lambda tensors, given:
                        True)
    monkeypatch.setattr(CpuStepGraph, "state", state)
    monkeypatch.setattr(ldm_trainer, "_StepGraph", CpuStepGraph)
    monkeypatch.setitem(kernels.LAUNCHES, "fake_kernel", 0)


def setup(mode: str, device: str = "cpu"):
    """A tiny conditional-capable VAE and UNet on `device`, AdamW with an
    EMA, the generator, and the step function of `mode`."""
    in_channels, k = MODES[mode]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vae = AutoencoderKL(VaeConfig(ch=32, ch_mult=(1, 2, 2),
                                      num_res_blocks=1))
        unet = UNet2D(UNetConfig(
            sample_size=(4, 16), in_channels=in_channels, out_channels=4,
            block_out_channels=(32, 32),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"))).train()
    vae = vae.to(device).eval().requires_grad_(False)
    unet = unet.to(device)
    state = TrainState.create(unet, make_adamw(
        unet.parameters(), learning_rate=1e-3, warmup_steps=2))
    state.generator = torch.Generator(device=device).manual_seed(3)
    cond_fn = {"upsample": conditions.make_upsample_cond_fn(4),
               "inpainting": conditions.make_inpainting_cond_fn(
                   vae, 0.18215, (4, 16))}.get(mode)
    step = make_ldm_train_step(
        Schedule(ScheduleConfig()),
        LdmTrainConfig(pos_encoding=False, grad_accum_steps=k), vae,
        cond_fn=cond_fn)
    return state, step


def batches(mode: str, n: int, b: int = 2, seed: int = 1,
            device: str = "cpu") -> list:
    """n batches of `mode`'s entries, (B, C, W, H), on `device`."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        images = torch.randn(b, 2, *IMAGE, generator=g)
        batch = {"jpg": images}
        if mode == "upsample":
            batch["down"] = images[..., 2::4].contiguous()
        if mode == "inpainting":
            mask = -torch.ones(b, 1, *IMAGE)
            mask[:, :, :16] = 1.0
            batch["masked_image"] = torch.where(mask > 0, -1.0, images)
            batch["inpainting_mask"] = mask
        out.append({k: v.to(device) for k, v in batch.items()})
    return out


def run(state, step, feed) -> list:
    return [step(state, batch, state.generator) for batch in feed]


def kinds() -> list:
    """The graph span of each step, in order."""
    names = [s.name for s in spans() if s.name in KINDS]
    profiling._RING.clear()
    return names


def assert_same_state(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.ema, b.ema):
        assert torch.equal(x, y)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["adam_count"] == sb["adam_count"]
    for key in sa:
        if key.startswith("adam/"):
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graphed_steps_equal_the_eager_ones(mode, monkeypatch):
    """Four steps eager against four graphed (eager, capture, replay,
    replay) from the same state: losses, gradient norms, parameters, EMA,
    moments and the generator bit for bit; each step leaves one graph
    span, and a replay no host phase; each replay adds the capture's
    launches."""
    feed = batches(mode, 4)
    eager_state, eager_step = setup(mode)
    want = run(eager_state, eager_step, feed)
    assert kinds() == ["train_eager"] * 4

    state, step = setup(mode)
    graphed(monkeypatch, state)
    got = run(state, step, feed)
    ring = spans()
    assert kinds() == ["train_eager", "train_graph_capture",
                       "train_graph_replay", "train_graph_replay"]
    by_id = {s.id: s for s in ring}
    replays = {s.id for s in ring if s.name == "train_graph_replay"}
    assert not [s for s in ring if s.parent in replays]
    phases = [s.name for s in ring if s.name in PHASES
              and by_id[s.parent].name == "train_graph_capture"]
    assert set(phases) == set(PHASES)
    assert kernels.LAUNCHES["fake_kernel"] == 3
    for g, w in zip(got, want):
        assert torch.equal(g["loss"], w["loss"])
        assert torch.equal(g["grad_norm"], w["grad_norm"])
    # a replay hands out its own copy: the next replay overwrote nothing
    assert len({float(g["loss"]) for g in got}) == 4
    assert_same_state(state, eager_state)


def test_a_new_shape_or_state_gets_its_own_graphs(monkeypatch):
    state, step = setup("plain")
    graphed(monkeypatch, state)
    run(state, step, batches("plain", 3))
    assert kinds() == ["train_eager", "train_graph_capture",
                       "train_graph_replay"]
    run(state, step, batches("plain", 3, b=4))
    assert kinds() == ["train_eager", "train_graph_capture",
                       "train_graph_replay"]
    # the first shape's graph is still kept
    run(state, step, batches("plain", 1))
    assert kinds() == ["train_graph_replay"]
    # another train state: the graphs of the first are dropped
    other, _ = setup("plain")
    monkeypatch.setattr(CpuStepGraph, "state", other)
    run(other, step, batches("plain", 3))
    assert kinds() == ["train_eager", "train_graph_capture",
                       "train_graph_replay"]


def test_a_resume_in_place_continues_the_graphed_run(monkeypatch):
    """A graphed run saved at step 3 and loaded back into the same state
    after step 5 replays steps 4 and 5 again as it did: the moments are
    copied into the tensors the graph writes to."""
    state, step = setup("plain")
    graphed(monkeypatch, state)
    feed = batches("plain", 5)
    run(state, step, feed[:3])
    saved = state.state_dict()
    moments = [dict(st) for st in state.optimizer.state.values()]
    first = run(state, step, feed[3:])
    at_5 = state.state_dict()
    state.load_state_dict(saved)
    for st, before in zip(state.optimizer.state.values(), moments):
        assert all(st[k] is before[k] for k in before)
    assert state.step == 3
    again = run(state, step, feed[3:])
    assert kinds()[-2:] == ["train_graph_replay"] * 2
    for g, w in zip(again, first):
        assert torch.equal(g["loss"], w["loss"])
    sd = state.state_dict()
    assert sd.keys() == at_5.keys()
    for key, value in at_5.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(sd[key], value), key
        else:
            assert sd[key] == value, key


def test_a_fresh_optimizer_loads_through_its_state_dict():
    """With no moments yet (no step made), the load makes them."""
    state, step = setup("plain")
    run(state, step, batches("plain", 2))
    saved = state.state_dict()
    fresh, _ = setup("plain")
    assert not fresh.optimizer.state
    fresh.load_state_dict(saved)
    assert_same_state(fresh, state)


class CardTensor:
    """What `_graphable` reads of a CUDA tensor."""
    is_cuda = True


def test_only_one_process_on_the_card_without_draws_is_graphed(monkeypatch):
    card, none = CardTensor(), (None,) * 4
    assert ldm_trainer._graphable([card, card], none)
    assert not ldm_trainer._graphable([card, torch.ones(2)], none)
    assert not ldm_trainer._graphable([], none)
    for i in range(4):
        given = tuple(torch.ones(2) if j == i else None for j in range(4))
        assert not ldm_trainer._graphable([card], given)
    monkeypatch.setattr(ldm_trainer, "distributed", lambda: True)
    assert not ldm_trainer._graphable([card], none)


def test_a_cpu_step_with_draws_given_runs_eager():
    state, step = setup("plain")
    feed = batches("plain", 2)
    g = torch.Generator().manual_seed(9)
    for batch in feed:
        step(state, batch, noise=torch.randn(2, 4, 16, 4, generator=g))
    assert kinds() == ["train_eager"] * 2


@pytest.mark.parametrize("step", [0, 1, 7, 500, 10 ** 6])
def test_the_ema_reads_a_tensor_weight_as_a_float(step):
    g = torch.Generator().manual_seed(step % 97)
    shapes = [(8, 4), (16,), (3, 3, 2, 2)]
    params = [torch.randn(s, generator=g) for s in shapes]
    shadow = [torch.randn(s, generator=g) for s in shapes]
    by_tensor = [s.clone() for s in shadow]
    weight = step_ema_weight(step, LdmTrainConfig())
    ema.ema_update(shadow, params, weight)
    ema.ema_update(by_tensor, params, torch.tensor(weight))
    for a, b in zip(shadow, by_tensor):
        assert torch.equal(a, b)
    assert weight == float(np.float32(1) - np.float32(ema.power_decay(step)))
