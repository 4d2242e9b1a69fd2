"""The work counts of perfbench/work.py against figures counted before on
the program's models, and the attention bounds of chip_smoke.py."""

import json

import pytest

from perfbench import harness, work

CONFIGS = harness.BENCH_DIR / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_flagship_counts():
    cfg = config("rangeldm_kitti360")
    mc, vc, size = cfg["model_config"], cfg["vae_config"], cfg["image_size"]
    assert work.unet_flops(mc) / 1e9 == pytest.approx(33.98, abs=0.005)
    assert work.vae_decode_flops(vc, size) / 1e9 == pytest.approx(
        156.99, abs=0.005)
    assert work.vae_encode_flops(vc, size) / 1e9 == pytest.approx(
        75.73, abs=0.005)
    # forward and backward without the input's gradient, which a step
    # never computes (counting it too gives 101.94)
    assert work.unet_train_flops(mc) / 1e9 == pytest.approx(101.89,
                                                            abs=0.005)
    assert work.unet_flops(mc, 32) == pytest.approx(32 * work.unet_flops(mc))


def test_rangedm_counts():
    mc = config("rangedm_kitti360")["model_config"]
    assert work.unet_flops(mc) / 1e9 == pytest.approx(496.88, abs=0.005)
    assert work.unet_train_flops(mc) / 1e9 == pytest.approx(1490.18,
                                                            abs=0.005)
    shapes = work.attention_shapes(mc, 8)
    assert sorted(set(shapes)) == [(512, 8, 64), (512, 8, 256)]
    assert len(shapes) == 6


def test_attention_shapes_and_chip_smoke_bounds():
    mc = config("rangeldm_kitti360")["model_config"]
    shapes = work.attention_shapes(mc, 4)
    assert sorted(shapes) == sorted([(64, 8, 1024)] * 5 + [(128, 8, 256)] * 5
                                    + [(128, 8, 64)] * 6)

    def whole(kernel, batch):
        """chip_smoke's bound: the summed work of a pass at once."""
        ops = [work.attention_work(kernel, s, 2)
               for s in work.attention_shapes(mc, batch)]
        return work.bound_s(sum(f for f, _ in ops), sum(b for _, b in ops))

    assert whole("attention_fwd", 4) * 1e3 == pytest.approx(0.0123,
                                                            abs=5e-5)
    assert whole("attention_bwd", 32) * 1e3 == pytest.approx(0.2463,
                                                             abs=5e-5)
    # the metrics take each call's own bound, so small calls bound by
    # bytes count in full
    assert work.attention_bound_s(mc, 4, "attention_fwd") >= whole(
        "attention_fwd", 4)
    assert work.attention_bound_s(mc, 32, "attention_bwd") * 1e3 == \
        pytest.approx(0.2741, abs=5e-5)


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 0.0, "float32") == pytest.approx(1.0)
