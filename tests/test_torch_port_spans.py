"""The port's spans (rangeldm_tpu_torch/utils/profiling.py `step_annotation`,
`record_span`, `spans`, `span_summary`) on the CPU: where the training,
VAE-GAN training and sampling paths put them, their parents across
threads, the ring's bound, their clock against torch.profiler's, the
idle-gap label they give perfbench/trace.py, the benchmark's readers of
host time by layer (perfbench/metrics/host_*.py, trainer_init_s.train.py),
its device time by span (perfbench/span_device.py and the readers of the
VAE-GAN cell), the conditional step's `condition` span under `encode`,
the observer a graph's capture sets (`observe_spans`), and the split of a
replayed graph's device time by phase (perfbench/graph_phases.py and the
inpainting cell's reader)."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from perfbench import trace as bench_trace
from rangeldm_tpu_torch.data.datasets import RangeLoader
from rangeldm_tpu_torch.diffusion.schedule import Schedule, ScheduleConfig
from rangeldm_tpu_torch.models.unet import UNet2D, UNetConfig
from rangeldm_tpu_torch.models.vae import AutoencoderKL, VaeConfig
from rangeldm_tpu_torch.pipelines import RangePipeline
from rangeldm_tpu_torch.training.latent_cache import MomentsDataset
from rangeldm_tpu_torch.utils import profiling
from rangeldm_tpu_torch.utils.profiling import (
    RING_LEN, Span, record_span, span_summary, spans, step_annotation,
)

TRAIN_CFG = {
    "model_config": {"sample_size": [32, 4], "in_channels": 5,
                     "out_channels": 4, "block_out_channels": [32, 32],
                     "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
                     "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]},
    "vae_config": {"ch": 32, "ch_mult": [1, 2], "z_channels": 4},
    "train_batch_size": 2, "lr_warmup_steps": 1, "tensorboard": False,
}
IMAGE = (16, 128)
STEP_CHILDREN = ["batch_wait", "to_device", "train_eager"]
# the eager step's phases (a CPU step is never graphed)
EAGER_CHILDREN = ["encode", "forward", "backward", "clip", "adamw", "ema"]
METRICS = harness.BENCH_DIR / "metrics"


@pytest.fixture(autouse=True)
def _fresh_ring():
    """The ring is the process's: other tests of this worker leave spans
    in it."""
    torch.set_num_threads(2)
    profiling._RING.clear()
    yield
    profiling._RING.clear()


def dur(s: Span) -> int:
    return s.end_ns - s.start_ns


def children(ring, parent: Span):
    return [s for s in ring if s.parent == parent.id]


def trainer(tmp_path, **cfg):
    from rangeldm_tpu_torch.train_ldm import LdmTrainer
    return LdmTrainer(dict(TRAIN_CFG, output_dir=str(tmp_path), **cfg),
                      device="cpu")


def test_fit_leaves_a_train_step_root_per_step(tmp_path):
    tr = trainer(tmp_path)
    rng = np.random.default_rng(0)
    tr.fit(({"jpg": rng.standard_normal((2, *IMAGE, 2)).astype(np.float32)}
            for _ in range(3)), log_every=50)
    ring = spans()
    init, = [s for s in ring if s.name == "trainer_init"]
    assert init.parent == 0
    assert sorted(s.name for s in children(ring, init)) == [
        "build_models", "ema_clone", "optimizer"]
    roots = [s for s in ring if s.name == "train_step"]
    assert len(roots) == 3 and all(r.parent == 0 for r in roots)
    summary = span_summary()["spans"]
    for root in roots:
        kids = sorted(children(ring, root), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == STEP_CHILDREN
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in kids)
        assert sum(dur(s) for s in kids) <= dur(root)
        phases = sorted(children(ring, kids[-1]), key=lambda s: s.start_ns)
        assert [s.name for s in phases] == EAGER_CHILDREN
        assert sum(dur(s) for s in phases) <= dur(kids[-1])
    for stats in summary.values():
        assert 0 <= stats["self_ms"] <= stats["total_ms"]
    # the exhausted iterator's last pull leaves nothing
    assert summary["batch_wait"]["count"] == 3


@pytest.mark.parametrize("mode", ["inpainting", "unconditional"])
def test_condition_span_lies_under_encode(tmp_path, mode):
    """An inpainting step opens `condition` (the masked image's posterior
    draw, encode, mask resize and concat) as the one child of `encode`; an
    unconditional step's `encode` has no child."""
    cfg = {}
    if mode == "inpainting":
        cfg = dict(model_config=dict(TRAIN_CFG["model_config"],
                                     in_channels=9),
                   pos_encoding=False, inpainting=0.0625)
    tr = trainer(tmp_path, **cfg)
    rng = np.random.default_rng(5)

    def batch():
        # the UNet's sample size, (4, 32), at the VAE's factor 2: the
        # condition's resized mask is made for it
        images = rng.standard_normal((2, 8, 64, 2)).astype(np.float32)
        mask = -np.ones((2, 8, 64, 1), np.float32)
        mask[:, :, :8] = 1.0
        return {"jpg": images, "inpainting_mask": mask,
                "masked_image": np.where(mask > 0, -1.0, images)}

    tr.fit((batch() for _ in range(2)), log_every=50)
    ring = spans()
    encodes = [s for s in ring if s.name == "encode"]
    assert len(encodes) == 2
    for enc in encodes:
        kids = children(ring, enc)
        assert [s.name for s in kids] == (
            ["condition"] if mode == "inpainting" else [])
        assert all(enc.start_ns <= s.start_ns <= s.end_ns <= enc.end_ns
                   for s in kids)


def test_an_observer_sees_the_spans_of_its_own_thread():
    """`observe_spans`: each span's start and end on the observing thread,
    nested spans inside out; another thread's spans and spans after the
    block are not seen."""
    seen = []
    other = threading.Thread(target=lambda: step_annotation("elsewhere")
                             .__enter__().__exit__(None, None, None))
    with profiling.observe_spans(lambda name, entering: seen.append(
            (name, entering))):
        with step_annotation("outer"):
            with step_annotation("inner"):
                pass
            other.start()
            other.join(5)
    with step_annotation("after"):
        pass
    assert not other.is_alive()
    assert seen == [("outer", True), ("inner", True), ("inner", False),
                    ("outer", False)]
    assert {s.name for s in spans()} == {"outer", "inner", "elsewhere",
                                         "after"}


def test_micro_batches_and_the_loader_wait(tmp_path):
    """grad_accum_steps 2: a forward and a backward span per micro-batch,
    under the step; RangeLoader's waits under the batch pull, and the
    wait fraction from the same clock reads."""
    tr = trainer(tmp_path, gradient_accumulation_steps=2)
    rng = np.random.default_rng(1)
    moments = rng.standard_normal((6, 4, 32, 8)).astype(np.float32)
    loader = RangeLoader(MomentsDataset(moments), batch_size=2,
                         num_threads=1)
    tr.fit(loader, max_steps=3, log_every=1, loader=loader)
    ring = spans()
    by_id = {s.id: s for s in ring}
    for root in [s for s in ring if s.name == "train_step"]:
        kids = sorted(children(ring, root), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["batch_wait", "to_device",
                                          "train_eager", "log_sync"]
        names = [s.name for s in sorted(children(ring, kids[2]),
                                        key=lambda s: s.start_ns)]
        assert names == ["encode", "forward", "backward", "forward",
                         "backward", "clip", "adamw", "ema"]
    waits = [s for s in ring if s.name == "loader_wait"]
    assert len(waits) == 3
    assert all(by_id[s.parent].name == "batch_wait" for s in waits)
    assert 0.0 <= loader.wait_fraction <= 1.0


def tiny_pipe():
    ucfg = UNetConfig(sample_size=(4, 32), in_channels=5, out_channels=4,
                      block_out_channels=(32, 32),
                      down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                      up_block_types=("AttnUpBlock2D", "UpBlock2D"))
    vcfg = VaeConfig(ch=32, ch_mult=(1, 2), z_channels=4, num_res_blocks=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = UNet2D(ucfg).eval().requires_grad_(False)
        vae = AutoencoderKL(vcfg).eval().requires_grad_(False)
    return dict(meta={"pos_encoding": True}, unet=unet, unet_cfg=ucfg,
                vae=vae, vae_cfg=vcfg, schedule=Schedule(ScheduleConfig()),
                device=torch.device("cpu"), dtype=torch.float32)


def test_pipeline_call_leaves_one_sample_call():
    images = RangePipeline(tiny_pipe())(batch_size=2, num_inference_steps=4,
                                        seed=3)
    assert images.shape[0] == 2
    ring = spans()
    root, = [s for s in ring if s.name == "sample_call"]
    assert root.parent == 0
    names = [s.name for s in sorted(children(ring, root),
                                    key=lambda s: s.start_ns)]
    assert names == ["unet_eval", "sampler_update"] * 4 + [
        "vae_decode", "to_host"]
    counts = {n: s["count"] for n, s in
              span_summary(["unet_eval", "to_host"])["spans"].items()}
    assert counts == {"unet_eval": 4, "to_host": 1}


def test_threads_keep_their_own_parents():
    ready, go = threading.Barrier(2), threading.Event()

    def work(tag):
        with step_annotation(f"outer_{tag}"):
            ready.wait()
            with step_annotation(f"inner_{tag}"):
                go.wait(5)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    time.sleep(0.05)
    go.set()
    for t in threads:
        t.join()
    ring = {s.name: s for s in spans()}
    for tag in "ab":
        outer, inner = ring[f"outer_{tag}"], ring[f"inner_{tag}"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert inner.thread == outer.thread
    assert ring["outer_a"].thread != ring["outer_b"].thread


def test_the_ring_drops_its_oldest_spans():
    for i in range(RING_LEN + 10):
        record_span(f"s{i}", i, i + 1)
    ring = spans()
    assert len(ring) == RING_LEN
    assert ring[0].name == "s10" and ring[-1].name == f"s{RING_LEN + 9}"


def test_span_summary_self_time_and_launches():
    record_span("outer", 0, 10_000_000)     # recorded as a root
    with step_annotation("outer") as outer:
        record_span("inner", 0, 3_000_000)
        record_span("inner", 0, 1_000_000)
    out = span_summary()
    assert set(out) == {"spans", "launches"}
    assert isinstance(out["launches"], dict)
    inner = out["spans"]["inner"]
    assert inner["count"] == 2 and inner["total_ms"] == pytest.approx(4.0)
    assert inner["p50_ms"] == pytest.approx(1.0)
    assert inner["p95_ms"] == pytest.approx(3.0)
    mine = dur(next(s for s in spans() if s.id == outer.id)) / 1e6
    assert out["spans"]["outer"]["self_ms"] == pytest.approx(
        10.0 + mine - 4.0)


def test_span_is_a_host_event_on_the_profilers_clock():
    x = torch.ones(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with step_annotation("clock_check"):
            x = x @ x
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "clock_check"]
    assert not ev.is_user_annotation()
    span, = [s for s in spans() if s.name == "clock_check"]
    assert abs(span.start_ns - ev.start_ns()) < 1_000_000
    assert abs(span.end_ns - (ev.start_ns() + ev.duration_ns())) < 1_000_000


def test_an_idle_gap_in_a_span_takes_its_name():
    """perfbench/trace.py labels a gap by the innermost host event at its
    middle: the host's Python inside a span now reads as the span."""
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = a @ a
        with step_annotation("host_layer"):
            time.sleep(0.02)
        torch.tanh(b)
    device, host = bench_trace.from_profile(prof)
    span, = [h for h in host if h[2] == "host_layer"]
    before = max(e for s, e, name in host if e <= span[0])
    after = min(s for s, e, name in host if s >= span[1])
    planted = [("k_before", before - 1e-4, before),
               ("k_after", after, after + 1e-4)]
    reduced = bench_trace.reduce(device + planted, host)
    assert reduced["idle_gaps"][0][0] == "host_layer"


# -- the benchmark's readers -----------------------------------------------

def _planted_train_ring(graph=True):
    """trainer_init (2.5 s), 3 set-up steps, 4 window steps, 2 profiled
    steps; each step's children last what the table below says, beside
    the step's graph span (`graph`: none, as on a program without the
    graphed step)."""
    ring, ids = [], iter(range(1, 10_000))
    t = 0

    def add(name, ms, parent=0):
        nonlocal t
        s = Span(name, next(ids), parent, 1, t, t + int(ms * 1e6))
        ring.append(s)
        return s

    init = add("trainer_init", 2500)
    t = 0
    for name in ("build_models", "optimizer", "ema_clone"):
        add(name, 100, init.id)
    # (encode, forward, backward, clip, adamw, ema, log_sync) per step
    plan = [(9, 9, 9, 9, 9, 9, 0)] * 3 + [
        (1, 2, 3, 1, 1, 1, 0), (2, 2, 3, 1, 2, 1, 0),
        (3, 2, 3, 1, 3, 1, 8), (4, 2, 3, 1, 4, 1, 0),
    ] + [(50, 50, 50, 50, 50, 50, 0)] * 2
    for row, kind in zip(plan, STEP_GRAPH_PLAN):
        root = add("train_step", 500)
        if graph:
            add(kind, 1, root.id)
        for name, ms in zip(("encode", "forward", "backward", "clip",
                             "adamw", "ema", "log_sync"), row):
            if ms:
                add(name, ms, root.id)
    return ring


# the graphed step's span under each step: set-up's 3, the window's 4
# (replay shares 100, 0, 100, 100), the profiled 2
STEP_GRAPH_PLAN = (["train_eager", "train_graph_capture",
                    "train_graph_replay"]
                   + ["train_graph_replay", "train_eager"]
                   + ["train_graph_replay"] * 4)
# the graphed model function's span under each call's 4 evaluations
EAGER, CAPTURE, REPLAY = ("unet_eager", "unet_graph_capture",
                          "unet_graph_replay")
RUNNER_PLAN = [(EAGER, CAPTURE, REPLAY, REPLAY)] + [
    (REPLAY,) * 4, (CAPTURE,) + (REPLAY,) * 3, (REPLAY,) * 4] + [
    (EAGER,) * 4]


def _planted_sampling_ring(runner=True):
    ring, ids = [], iter(range(1, 10_000))
    for ms, kinds in zip([30, 10, 20, 40, 90],   # 1 set-up, 3, 1
                         RUNNER_PLAN):
        root = Span("sample_call", next(ids), 0, 1, 0, 10 ** 9)
        ring.append(root)
        for j, kind in enumerate(kinds):
            ev = Span("unet_eval", next(ids), root.id, 1, 0,
                      int((ms + j) * 1e6))
            ring.append(ev)
            if runner:
                ring.append(Span(kind, next(ids), ev.id, 1, 0,
                                 int((ms + j) * 1e6)))
            ring.append(Span("sampler_update", next(ids), root.id, 1, 0,
                             10 ** 6))
    return ring


TRAIN_RECORD = {"kind": "train", "units": 2, "evals": 2,
                "unprofiled": {"units": 4, "wall_s": 2.0}}
SAMPLING_RECORD = {"kind": "sampling", "units": 1, "evals": 4,
                   "unprofiled": {"units": 3, "wall_s": 3.0}}
READERS = {
    # window steps' model ms: 6, 7, 8, 9 -> median 7.5
    "host_model_ms_per_step.train": (TRAIN_RECORD, 7.5),
    # clip + adamw + ema: 3, 4, 5, 6 -> median 4.5
    "host_update_ms_per_step.train": (TRAIN_RECORD, 4.5),
    # log_sync + checkpoint: 0, 0, 8, 0 -> mean 2
    "host_sync_ms_per_step.train": (TRAIN_RECORD, 2.0),
    "trainer_init_s.train": (TRAIN_RECORD, 2.5),
    # calls 10, 20, 40 ms + (0..3) a step -> 11.5, 21.5, 41.5 -> 21.5
    "host_ms_per_unet_eval.sampling": (SAMPLING_RECORD, 21.5),
    # window calls' replays: 4, 3 (and a capture), 4 of 4 -> 100, 75, 100
    "unet_graph_replay_share.sampling": (SAMPLING_RECORD, 100.0),
    # window steps' replays: 1, 0, 1, 1 of 1 -> 100, 0, 100, 100
    "train_graph_replay_share.train": (TRAIN_RECORD, 100.0),
}


def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               "spans_test_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_window_of_a_planted_ring(name, monkeypatch):
    record, want = READERS[name]
    ring = (_planted_sampling_ring() if record["kind"] == "sampling"
            else _planted_train_ring())
    monkeypatch.setattr(profiling, "spans", lambda: list(ring))
    read = reader(name).read
    assert read(record, {}) == pytest.approx(want)
    # the other kind of cell, or too few roots, reads nothing
    other = SAMPLING_RECORD if record is TRAIN_RECORD else TRAIN_RECORD
    assert read(other, {}) is None
    if name != "trainer_init_s.train":
        assert read(dict(record, units=len(ring)), {}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_a_program_without_spans_reads_none(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    record, _ = READERS[name]
    assert reader(name).read(record, {}) is None


def test_readers_are_listed_for_their_cells():
    bench = harness.load_json(Path(harness.BENCH_DIR).parent /
                              "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name, (record, _) in READERS.items():
        m = listed[name]
        assert m["source"] == "program_span"
        # the kind of record each cell's traffic makes
        kinds = {harness.load_module(
            harness.BENCH_DIR / "traffic" / f"{harness.Cell(c).kind}.py",
            "spans_test_kind_" + harness.Cell(c).kind).Traffic.kind
            for c in m["workloads"]}
        assert kinds == {record["kind"]}


def test_replay_share_of_a_program_without_the_graphed_unet_reads_none(
        monkeypatch):
    """The parent's ring: `unet_eval` spans with no runner span under
    them; the other sampling reader reads as before."""
    ring = _planted_sampling_ring(runner=False)
    monkeypatch.setattr(profiling, "spans", lambda: list(ring))
    assert reader("unet_graph_replay_share.sampling").read(
        SAMPLING_RECORD, {}) is None
    assert reader("host_ms_per_unet_eval.sampling").read(
        SAMPLING_RECORD, {}) == pytest.approx(21.5)


def test_replay_share_of_a_program_without_the_graphed_step_reads_none(
        monkeypatch):
    """The parent's ring: `train_step` roots with no graph span under
    them; the other train readers read as before."""
    ring = _planted_train_ring(graph=False)
    monkeypatch.setattr(profiling, "spans", lambda: list(ring))
    assert reader("train_graph_replay_share.train").read(
        TRAIN_RECORD, {}) is None
    assert reader("host_model_ms_per_step.train").read(
        TRAIN_RECORD, {}) == pytest.approx(7.5)


# -- VAE-GAN training --------------------------------------------------------

VAE_CFG = {"vae": {"ch": 32, "ch_mult": [1, 2]}, "data": {"width": 32},
           "loss": {"disc_start": 0, "disc_num_layers": 2},
           "batch_size": 2, "tensorboard": False, "seed": 3}
VAE_STEP_CHILDREN = ["batch_wait", "to_device", "gen_step", "disc_step"]
GEN_CHILDREN = ["vae_forward", "disc_forward", "gen_loss",
                "adaptive_weight", "gen_backward", "gen_update", "ema"]
DISC_CHILDREN = ["disc_recon", "disc_forward", "disc_forward",
                 "disc_backward", "disc_update"]


def vae_trainer(tmp_path):
    from rangeldm_tpu_torch.train_vae import VaeTrainer
    return VaeTrainer(dict(VAE_CFG, output_dir=str(tmp_path)), device="cpu")


def vae_batches(n):
    rng = np.random.default_rng(4)
    return [rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
            for _ in range(n)]


def named(ring, parent):
    return [s.name for s in sorted(children(ring, parent),
                                   key=lambda s: s.start_ns)]


def test_vae_gan_fit_leaves_a_train_step_root_per_step(tmp_path):
    tr = vae_trainer(tmp_path)
    tr.fit(iter(vae_batches(3)), log_every=2)
    ring = spans()
    init, = [s for s in ring if s.name == "trainer_init"]
    assert init.parent == 0
    assert sorted(s.name for s in children(ring, init)) == [
        "build_models", "ema_clone", "optimizer"]
    roots = [s for s in ring if s.name == "train_step"]
    assert len(roots) == 3 and all(r.parent == 0 for r in roots)
    for i, root in enumerate(roots):
        kids = named(ring, root)
        # the log's sync at step 2
        assert kids == VAE_STEP_CHILDREN + (["log_sync"] if i == 1 else [])
        gen, = [s for s in children(ring, root) if s.name == "gen_step"]
        disc, = [s for s in children(ring, root) if s.name == "disc_step"]
        assert named(ring, gen) == GEN_CHILDREN
        assert named(ring, disc) == DISC_CHILDREN
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in children(ring, root))
    # the exhausted iterator's last pull leaves nothing
    assert span_summary()["spans"]["batch_wait"]["count"] == 3


def test_vae_gan_steps_are_bit_equal_under_a_profiler(tmp_path):
    runs = []
    for k, traced in enumerate((False, True)):
        tr = vae_trainer(tmp_path / str(k))
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                last = tr.fit(iter(vae_batches(3)), log_every=3)
        else:
            last = tr.fit(iter(vae_batches(3)), log_every=3)
        st = tr.state
        runs.append((last, [t.clone() for t in (
            *st.vae.parameters(), *st.disc.parameters(),
            *st.disc.buffers(), *st.ema)]))
    (m0, t0), (m1, t1) = runs
    # every logged metric but the steps per second
    assert m0.pop("sps") > 0 and m1.pop("sps") > 0
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(t0, t1))


def test_device_time_goes_to_the_span_that_launched_it():
    """Planted operations: a launch from another thread's time inside the
    main thread's span goes to that span; overlapping operations count
    each instant once, so the spans sum to the busy time; an operation
    with no launch goes to "(none)"."""
    from perfbench import span_device
    main = [("train_step", 0, 1000), ("gen_step", 10, 500),
            ("gen_backward", 200, 400), ("disc_step", 500, 900)]
    launches = {1: 20, 2: 250, 3: 260, 4: 600}
    # (start, end, correlation) in ns
    ops = [(100, 300, 1), (300, 500, 2), (450, 520, 3), (700, 800, 4),
           (900, 950, 9)]
    got = span_device.attribute(ops, launches, main)
    assert got == pytest.approx({"gen_step": 200e-6,
                                 "gen_backward": 220e-6,
                                 "disc_step": 100e-6, "(none)": 50e-6})
    busy = sum(e - s for s, e in bench_trace.union(
        (s, e) for s, e, _ in ops))
    assert sum(got.values()) == pytest.approx(busy / 1e6)


def test_device_time_by_span_of_a_profiled_fit(tmp_path):
    """On the CPU the profile has no device operation: the attribution is
    empty and sums to no more than the busy time (0); the main thread's
    spans are found from the last `train_step` root."""
    from perfbench import span_device
    tr = vae_trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.fit(iter(vae_batches(2)), log_every=50)
    by_span = span_device.by_span(prof)
    busy = bench_trace.reduce(*bench_trace.from_profile(prof))["busy_s"]
    assert by_span == {} and sum(by_span.values()) <= busy * 1e3
    names = {n for n, _, _ in span_device.main_thread_spans(
        spans(), "train_step")}
    assert {"gen_backward", "disc_recon", "trainer_init"} <= names


VAE_GAN_READERS = {
    "disc_device_ms_per_step.vae_gan": 2 * (10 + 20 + 5) / 2,
    "vae_fwd_device_ms_per_step.vae_gan": 2 * (30 + 8) / 2,
}


@pytest.mark.parametrize("name", sorted(VAE_GAN_READERS))
def test_vae_gan_device_readers(name):
    by_span = {"disc_forward": 20.0, "disc_backward": 40.0,
               "adaptive_weight": 10.0, "vae_forward": 60.0,
               "disc_recon": 16.0, "gen_backward": 500.0, "(none)": 1.0}
    record = dict(TRAIN_RECORD, device_ms_by_span=by_span)
    read = reader(name).read
    assert read(record, {}) == pytest.approx(VAE_GAN_READERS[name])
    # the parent's record: no spans, or none of the named ones
    assert read(dict(TRAIN_RECORD, device_ms_by_span=None), {}) is None
    assert read(dict(TRAIN_RECORD, device_ms_by_span={"(none)": 5.0}),
                {}) is None
    assert read(SAMPLING_RECORD, {}) is None


# -- device time by phase of a replayed graph --------------------------------

def test_graph_phases_split_replays_by_the_captures_counts():
    """perfbench/graph_phases.py on planted operations: two replays of a
    graph of 5 device operations (correlation ids 7 and 8, listed out of
    order) split by the capture's counts, nested phases each whole; an
    operation of another launch (9) is left out, and so is a replay that
    lost an operation; no whole replay, no phases or no launch read
    None."""
    from perfbench import graph_phases
    phases = [("condition", 1, 3), ("encode", 0, 3), ("forward", 3, 5)]
    ops = [(100, 150, 7), (0, 10, 7), (30, 60, 7), (10, 30, 7), (60, 100, 7),
           (200, 205, 9), (306, 310, 8), (300, 301, 8), (303, 306, 8),
           (301, 303, 8), (310, 315, 8)]
    got = graph_phases.split(ops, {7, 8}, 5, phases)
    assert got["replays"] == 2
    assert got["ms"] == pytest.approx({"condition": (20 + 30 + 2 + 3) / 1e6,
                                       "encode": (60 + 6) / 1e6,
                                       "forward": (90 + 9) / 1e6})
    lost = graph_phases.split(ops[:-1], {7, 8}, 5, phases)
    assert lost["replays"] == 1
    assert lost["ms"] == pytest.approx({"condition": 50 / 1e6,
                                        "encode": 60 / 1e6,
                                        "forward": 90 / 1e6})
    assert graph_phases.split(ops, {7, 8}, 6, phases) is None
    assert graph_phases.split(ops, {7, 8}, 5, []) is None
    assert graph_phases.split(ops, set(), 5, phases) is None
    assert graph_phases.by_phase(None, object()) is None


def test_cond_device_reader():
    read = reader("cond_device_ms_per_step.inpaint").read
    split = {"replays": 8, "ms": {"condition": 200.0, "encode": 600.0}}
    assert read(dict(TRAIN_RECORD, device_ms_by_graph_phase=split),
                {}) == pytest.approx(25.0)
    # the parent's record, a step with no condition, another kind of cell
    assert read(dict(TRAIN_RECORD, device_ms_by_graph_phase=None), {}) \
        is None
    assert read(dict(TRAIN_RECORD, device_ms_by_graph_phase={
        "replays": 8, "ms": {"encode": 1.0}}), {}) is None
    assert read(dict(SAMPLING_RECORD, device_ms_by_graph_phase=split),
                {}) is None
