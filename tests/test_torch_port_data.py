"""The port's data slice (rangeldm_tpu_torch/geometry/projection.py numpy
path, geometry/sensors.py, data/datasets.py) against the JAX package's, on
the same synthetic scans. Projections, samples and conditions must be
bit-exact; the loaders must yield the same batches in the same order.

Both datasets project through their C++ cores (the port's is its own copy
of the JAX package's, tests/test_torch_port_native.py), which match the
numpy path within 1e-5; the dataset test holds the port against the JAX
package with both cores on and with both off."""

import numpy as np
import pytest

import rangeldm_tpu.native
from rangeldm_tpu.data import datasets as jd
from rangeldm_tpu.geometry import projection as jp
from rangeldm_tpu.geometry import sensors as js

from conftest import synthetic_scan
from rangeldm_tpu_torch.data import datasets as td
from rangeldm_tpu_torch.geometry import projection as tp
from rangeldm_tpu_torch.geometry import sensors as ts

SENSORS = ["kitti360", "nuscenes", "kitti360_vanilla", "stf"]


@pytest.fixture(params=["native", "numpy"])
def cores(request, monkeypatch):
    """Both datasets on their C++ cores, or both on the numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(rangeldm_tpu.native, "available", lambda: False)
        monkeypatch.setattr(td, "range_image_native", tp.range_image_np)
    else:
        assert rangeldm_tpu.native.available()
    return request.param


def _scan(sensor, seed, n=20000):
    rng = np.random.default_rng(seed)
    if sensor in ("nuscenes", "stf"):
        beams = 32 if sensor == "nuscenes" else 64
        return synthetic_scan(rng, n=n, n_beams=beams, with_ring=True)
    return synthetic_scan(rng, n=n)


@pytest.mark.parametrize("sensor", SENSORS)
def test_sensor_specs_match_jax(sensor):
    got, want = ts.get_spec(sensor, width=512), js.get_spec(sensor, width=512)
    for f in ("name", "n_beams", "width", "row_mode", "range_fill",
              "intensity_fill", "mean", "std", "log", "inverse", "min_depth",
              "fov_up", "fov_down", "grid_sizes", "pc_range"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.height, want.height)
    np.testing.assert_array_equal(got.zenith, want.zenith)


# the three row modes (kitti, ring, uniform), the log and inverse
# encodings, a custom normalization and a narrow width
PROJECTIONS = [("kitti360", {}), ("kitti360", dict(log=True)),
               ("kitti360", dict(inverse=True, width=256)),
               ("nuscenes", {}), ("stf", dict(mean=10.0, std=30.0)),
               ("kitti360_vanilla", {})]


@pytest.mark.parametrize("sensor,kw", PROJECTIONS,
                         ids=[f"{s}-{'-'.join(k) or 'default'}"
                              for s, k in PROJECTIONS])
def test_range_image_np_is_bit_exact(sensor, kw):
    pc = _scan(sensor, seed=len(kw) + SENSORS.index(sensor))
    # nearest-point ties and equal ranges exercise the stable order
    pc = np.concatenate([pc, pc[:500]])
    got = tp.range_image_np(pc, ts.get_spec(sensor, **kw))
    want = jp.range_image_np(pc, js.get_spec(sensor, **kw))
    for g, w, name in zip(got, want, ("img", "mask", "car_window")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].any(), "no car-window pixel: the mask goes untested"
    np.testing.assert_array_equal(
        tp.project_np(pc, ts.get_spec(sensor, **kw)),
        jp.project_np(pc, js.get_spec(sensor, **kw)))


def test_decode_log_range_matches_jax():
    v = np.linspace(-0.2, 1.2, 101).astype(np.float32)
    np.testing.assert_array_equal(tp.decode_log_range(v),
                                  jp.decode_log_range(v))


def _kitti_root(path, seed=0, per_drive=3, n=6000):
    rng = np.random.default_rng(seed)
    for drive in ("0000_sync", "0002_sync", "0003_sync", "0004_sync"):
        d = (path / "data_3d_raw" / f"2013_05_28_drive_{drive}"
             / "velodyne_points" / "data")
        d.mkdir(parents=True)
        for i in range(per_drive):
            synthetic_scan(rng, n=n).tofile(d / f"{i:010d}.bin")
    return str(path)


# the loader's default settings with both conditions; another sensor,
# width, encoding, beam and azimuth strides, one channel and the coord
# channel (a tagged cache name)
DATASETS = {
    "default": dict(downsample=4, inpainting=0.0625),
    "vanilla_log": dict(sensor="kitti360_vanilla", width=256, log=True,
                        downsample=[2, 4], inpainting=0.25, used_feature=1,
                        coord=True),
}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_dataset_matches_jax(tmp_path, cores, case):
    # each package projects on its own (the caches are the next test's)
    kw = dict(DATASETS[case], cache=False)
    root = _kitti_root(tmp_path / "kitti")
    for train in (True, False):
        got = td.RangeImageDataset(td.DatasetConfig(root=root, **kw), train)
        want = jd.RangeImageDataset(jd.DatasetConfig(root=root, **kw), train)
        assert got.files == want.files and len(got) == 6
        assert all(("0000_sync" in f or "0002_sync" in f) != train
                   for f in got.files)
        assert got._spec_tag == want._spec_tag
        assert (got._spec_tag == "") == (case == "default")
        for i in range(len(got)):
            assert got._cache_path(got.files[i]) == want._cache_path(
                want.files[i])
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b) == sorted(
                ["jpg", "mask", "car_window_mask", "down",
                 "inpainting_mask", "masked_image"])
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sample = got[0]
    h, w, c = sample["jpg"].shape
    sa, sb = got.downsample
    assert sample["down"].shape == (h // sb, w // sa, c)
    assert set(np.unique(sample["inpainting_mask"])) == {-1.0, 1.0}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_are_read_across_packages(tmp_path, monkeypatch, writer):
    """One package projects and caches a root; the other, with its
    projection switched off, reads the same samples back."""
    root = _kitti_root(tmp_path / "kitti", per_drive=2)
    cfgs = {"port": td.DatasetConfig(root=root, cache_compress=False),
            "jax": jd.DatasetConfig(root=root, cache_compress=False)}
    make = {"port": td.RangeImageDataset, "jax": jd.RangeImageDataset}
    reader = "jax" if writer == "port" else "port"
    first = make[writer](cfgs[writer])
    written = [first[i] for i in range(len(first))]

    def no_projection(*a, **k):
        raise AssertionError("projected instead of reading the cache")

    monkeypatch.setattr(td, "range_image_native", no_projection)
    monkeypatch.setattr(jd, "range_image_np", no_projection)
    monkeypatch.setattr(rangeldm_tpu.native, "range_image_native",
                        no_projection)
    second = make[reader](cfgs[reader])
    assert second.files == first.files
    for i, a in enumerate(written):
        b = second[i]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Items:
    """A dataset of numbered items; `bad` raises on one index."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"item {i}")
        return {"i": np.array(i), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_loader_order_matches_jax(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=drop_last,
              num_threads=2)
    got = td.RangeLoader(_Items(11), **kw)
    want = jd.RangeLoader(_Items(11), **kw)
    assert len(got) == len(want) == (3 if drop_last else 4)
    orders = []
    for _ in range(3):          # epochs reshuffle with seed + epoch
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["i"], y["i"])
            np.testing.assert_array_equal(x["x"], y["x"])
        orders.append(np.concatenate([x["i"] for x in a]))
    if shuffle:
        assert not np.array_equal(orders[0], orders[1])
    assert 0.0 <= got.wait_fraction <= 1.0


def test_loader_shards_the_same_order_on_one_process():
    """Without an initialized process group the shard is the whole order."""
    assert td.process_shard() == (0, 1)
    kw = dict(batch_size=2, seed=1, num_threads=1)
    a = td.RangeLoader(_Items(7), shard_by_process=True, **kw)
    b = td.RangeLoader(_Items(7), **kw)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["i"], y["i"])


def test_loader_forwards_producer_exceptions_and_stops_early():
    loader = td.RangeLoader(_Items(12, bad=7), batch_size=2, shuffle=False,
                            num_threads=2)
    seen = []
    with pytest.raises(RuntimeError, match="producer failed") as err:
        for batch in loader:
            seen.append(batch["i"].tolist())
    assert isinstance(err.value.__cause__, ValueError)
    assert seen == [[0, 1], [2, 3], [4, 5]]
    # a consumer that stops after one batch leaves the next epoch whole
    ok = td.RangeLoader(_Items(6), batch_size=2, shuffle=False,
                        num_threads=2, prefetch=1)
    for _ in ok:
        break
    assert [b["i"].tolist() for b in ok] == [[0, 1], [2, 3], [4, 5]]
