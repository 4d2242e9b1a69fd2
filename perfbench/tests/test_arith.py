"""The arithmetic the metrics are made of, against cases worked by hand."""

import pytest

from perfbench import harness, trace

METRICS = harness.BENCH_DIR / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               "test_metric_" + name.replace(".", "_")).read


def test_union_and_busy():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 8.0)]
    assert trace.union(spans) == [[0.0, 3.0], [5.0, 6.0], [8.0, 8.0]]
    assert trace.reduce([("k", s, e) for s, e in spans], [])["busy_s"] == 4.0
    assert trace.union([]) == []


def test_reduce_gaps_and_labels():
    device = [("attention_fwd_kernel", 0.0, 1.0), ("Memcpy HtoD", 1.0, 1.5),
              ("elementwise_kernel", 4.0, 5.0), ("cudnn_conv", 5.0, 7.0)]
    host = [(0.0, 10.0, "aten::conv2d"), (1.6, 3.9, "aten::item"),
            (2.0, 3.0, "cudaStreamSynchronize")]
    r = trace.reduce(device, host)
    assert r["operations"] == 4 and r["kernels"] == 3
    assert r["busy_s"] == 4.5
    assert r["time_by_group"]["attention_fwd"] == 1.0
    assert r["time_by_group"]["convolution"] == 2.0
    # one gap, 1.5 .. 4.0, whose middle lies in the synchronisation
    assert r["idle_gaps"] == [["aten::item > cudaStreamSynchronize", 2.5]]
    b = trace.breakdown(r)
    assert len(b["device_ops"]) <= 10 and b["idle_gaps"] == r["idle_gaps"]


def test_group_of_follows_the_program_profile():
    assert trace.group_of("attention_bwd_bf16") == "attention_bwd"
    assert trace.group_of("multi_tensor_apply_kernel") == "optimizer_ema"
    assert trace.group_of("sm90_xmma_gemm") == "convolution"
    assert trace.group_of("void at::native::vectorized_elementwise") == \
        "elementwise"
    assert trace.group_of("something") == "other"


def test_rate_and_p95_over_all_steps():
    assert harness.rate(32 * 10, 4.0) == 80.0
    steps = [float(i) for i in range(1, 101)]      # 1 .. 100 ms
    assert harness.percentile(steps, 95) == 95.0
    assert harness.percentile([5.0, 1.0, 3.0], 95) == 5.0
    assert harness.percentile([2.0] * 19 + [50.0], 95) == 2.0
    assert harness.percentile([2.0] * 18 + [50.0, 60.0], 95) == 50.0


def record(kind="sampling"):
    return {"kind": kind, "units": 2, "evals": 100, "kernels": 90000,
            "busy_s": 1.5, "window_s": 3.0,
            "time_by_name": {"attention_fwd_bf16": 0.02,
                             "attention_bwd_bf16": 0.05, "conv": 1.0},
            "unprofiled": {"units": 20, "wall_s": 20.0}}


WORK = {"flops_per_unit": 989e12 * 0.05, "peak_flops": 989e12,
        "attn_fwd_bound_s_per_unit": 0.001,
        "attn_bwd_bound_s_per_unit": 0.005}


def test_sampling_readers():
    r = record()
    assert reader("kernels_per_unet_eval.sampling")(r, WORK) == 900.0
    # 20 calls of 0.05 peak-seconds each in 20 s: 5 %
    assert reader("mfu.sampling")(r, WORK) == pytest.approx(5.0)
    # busy 0.75 s a call against 1 s a call unprofiled: 25 % idle
    assert reader("device_idle_share.sampling")(r, WORK) == \
        pytest.approx(25.0)
    assert reader("device_ms_per_call.sampling")(r, WORK) == \
        pytest.approx(750.0)
    # 2 calls x 1 ms of bound over 20 ms of attention_fwd time: 10 %
    assert reader("attn_fwd_roofline.sampling")(r, WORK) == \
        pytest.approx(10.0)
    for name in ("kernels_per_step.train", "mfu.train",
                 "device_idle_share.train", "attn_bwd_roofline.train",
                 "device_ms_per_step.train"):
        assert reader(name)(r, WORK) is None


def test_train_readers():
    r = record("train")
    assert reader("kernels_per_step.train")(r, WORK) == 45000.0
    assert reader("mfu.train")(r, WORK) == pytest.approx(5.0)
    assert reader("device_idle_share.train")(r, WORK) == pytest.approx(25.0)
    assert reader("attn_bwd_roofline.train")(r, WORK) == pytest.approx(20.0)
    assert reader("device_ms_per_step.train")(r, WORK) == pytest.approx(750.0)
    assert reader("attn_fwd_roofline.sampling")(r, WORK) is None


def test_readers_return_nothing_without_something_to_read():
    r = dict(record(), kernels=0, busy_s=0.0, time_by_name={"conv": 1.0})
    for name in ("kernels_per_unet_eval.sampling", "attn_fwd_roofline."
                 "sampling", "device_idle_share.sampling"):
        assert reader(name)(r, WORK) is None


def test_leaf_gap_takes_the_larger_of_leaf_and_median():
    from perfbench.traffic.train import leaf_gap
    want = {"a": 1.0, "b": 2.0, "c": 3.0, "tiny": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 3.0, "tiny": 2e-9}
    # a: 0.1 over the median 1.5 (larger than its own 1); tiny: 1e-9 / 1.5
    assert leaf_gap(got, want) == pytest.approx(0.1 / 1.5)
    got["c"] = 0.0
    assert leaf_gap(got, want) == pytest.approx(1.0)
    got["c"] = 3.0
    got["b"] = 2.5
    assert leaf_gap(got, want) == pytest.approx(0.25)


def test_scan_gap_is_the_widest_scan():
    import numpy as np
    from perfbench.traffic.sampling import Traffic
    want = np.ones((3, 2, 2, 1))
    got = want.copy()
    got[1] *= 1.5
    assert Traffic.scan_gap(got, want) == pytest.approx(0.5)


def test_seeds_take_large_numbers():
    a = harness.derived_seeds(2 ** 33 + 7, 0, 3)
    assert a == harness.derived_seeds(2 ** 33 + 7, 0, 3)
    assert a != harness.derived_seeds(2 ** 33 + 8, 0, 3)
    assert all(0 <= s < 2 ** 31 for s in a)
