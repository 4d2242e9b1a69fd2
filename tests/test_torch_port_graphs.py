"""The sampling loop's graphed model function
(rangeldm_tpu_torch/pipelines/graphs.py `GraphedUNet`) on the CPU: where it
cannot graph it calls the module as it is and leaves `unet_eager` spans,
the pipeline keeps one per replica across calls, and its cache runs each
key eager, then captured, then replayed, keeps the launch counter true and
drops the least recently used graph. The captures themselves run on the
card (tests/test_torch_port_cuda.py)."""

import contextlib

import numpy as np
import pytest
import torch

from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.ops import kernels
from rangeldm_tpu_torch.pipelines import RangePipeline, graphs
from rangeldm_tpu_torch.pipelines.graphs import MAX_GRAPHS, GraphedUNet
from rangeldm_tpu_torch.utils import profiling
from rangeldm_tpu_torch.utils.profiling import spans

RUNNER_SPANS = ("unet_graph_replay", "unet_graph_capture", "unet_eager")
UNET_CFG = UNetConfig(sample_size=(4, 32), in_channels=5, out_channels=4,
                      block_out_channels=(32, 32),
                      down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                      up_block_types=("AttnUpBlock2D", "UpBlock2D"))


@pytest.fixture(autouse=True)
def _fresh_ring():
    torch.set_num_threads(2)
    profiling._RING.clear()
    yield
    profiling._RING.clear()


def runner_spans():
    return [s.name for s in spans() if s.name in RUNNER_SPANS]


def tiny_unet():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return UNet2D(UNET_CFG).eval()


MODES = {
    "no_grad": torch.no_grad,
    "inference_mode": torch.inference_mode,
    "autocast": lambda: torch.autocast("cpu", dtype=torch.bfloat16),
    "grad": contextlib.nullcontext,
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_cpu_evaluation_is_the_bare_modules(mode):
    unet = tiny_unet()
    fn = GraphedUNet(unet)
    x = torch.randn(2, 5, 32, 4, generator=torch.Generator().manual_seed(1))
    with MODES[mode]():
        got = [fn(x, 500) for _ in range(3)]
        want = unet(x, 500)
    for out in got:
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert runner_spans() == ["unet_eager"] * 3
    assert not fn._graphs


def tiny_pipe():
    vcfg = VaeConfig(ch=32, ch_mult=(1, 2), z_channels=4, num_res_blocks=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = UNet2D(UNET_CFG).eval().requires_grad_(False)
        vae = AutoencoderKL(vcfg).eval().requires_grad_(False)
    return dict(meta={"pos_encoding": True}, unet=unet, unet_cfg=UNET_CFG,
                vae=vae, vae_cfg=vcfg, schedule=Schedule(ScheduleConfig()),
                device=torch.device("cpu"), dtype=torch.float32)


def test_a_cpu_pipeline_call_runs_eager_and_keeps_its_runner():
    pipe = RangePipeline(tiny_pipe())
    first = pipe(batch_size=2, num_inference_steps=3, seed=4)
    runner = pipe._p["graphed"]["cpu"]
    assert isinstance(runner, GraphedUNet) and runner.module is pipe._p["unet"]
    second = pipe(batch_size=2, num_inference_steps=3, seed=4)
    assert pipe._p["graphed"] == {"cpu": runner}
    np.testing.assert_array_equal(first, second)
    assert runner_spans() == ["unet_eager"] * 6
    by_id = {s.id: s for s in spans()}
    assert all(by_id[s.parent].name == "unet_eval" for s in spans()
               if s.name == "unet_eager")
    assert not runner._graphs


class FakeGraph:
    """A capture that runs on the CPU: the module's output, and one launch
    of a made-up kernel counted by the capture as a wrapper would."""
    made = []

    def __init__(self, module, x):
        kernels.count_launch("fake_kernel")
        self.module, self.launches = module, {"fake_kernel": 1}
        FakeGraph.made.append(tuple(x.shape))

    def run(self, x, t):
        return self.module(x, t)


def test_each_key_runs_eager_then_captured_then_replayed(monkeypatch):
    monkeypatch.setattr(graphs, "_graphable", lambda x, t: True)
    monkeypatch.setattr(graphs, "_Graph", FakeGraph)
    monkeypatch.setattr(FakeGraph, "made", [])
    monkeypatch.setitem(kernels.LAUNCHES, "fake_kernel", 0)
    fn = GraphedUNet(lambda x, t: x * 2 + t)
    x = torch.ones(3, 2)
    outs = [fn(x, 1) for _ in range(4)]
    assert all(torch.equal(o, x * 2 + 1) for o in outs)
    assert runner_spans() == ["unet_eager", "unet_graph_capture"] + [
        "unet_graph_replay"] * 2
    # the capture counted its launch, each replay adds the capture's count
    assert kernels.LAUNCHES["fake_kernel"] == 3
    # MAX_GRAPHS more batch sizes: the least recently used graph goes
    sizes = [4 + i for i in range(MAX_GRAPHS)]
    for b in sizes:
        fn(torch.ones(b, 2), 0)
        fn(torch.ones(b, 2), 0)
    assert [k[1][0] for k in fn._graphs] == sizes
    # a dropped key is captured again without another eager evaluation
    profiling._RING.clear()
    fn(x, 1)
    assert runner_spans() == ["unet_graph_capture"]
    assert [k[1][0] for k in fn._graphs] == sizes[1:] + [3]
    assert FakeGraph.made == [(3, 2)] + [(b, 2) for b in sizes] + [(3, 2)]


class CardTensor:
    """What `_graphable` reads of a CUDA tensor."""
    is_cuda = True

    def __init__(self, contiguous=True):
        self.contiguous = contiguous

    def is_contiguous(self):
        return self.contiguous


def test_only_what_a_capture_can_hold_is_graphed():
    card = CardTensor()
    with torch.inference_mode():
        assert graphs._graphable(card, 5)
        assert not graphs._graphable(torch.ones(2), 5)
        assert not graphs._graphable(CardTensor(contiguous=False), 5)
        assert not graphs._graphable(card, torch.tensor(5))
        torch.set_autocast_enabled("cuda", True)
        try:
            assert not graphs._graphable(card, 5)
        finally:
            torch.set_autocast_enabled("cuda", False)
    with torch.no_grad():
        assert graphs._graphable(card, 5)
    assert not graphs._graphable(card, 5)
