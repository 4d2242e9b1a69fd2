"""The port's C++ projection core (rangeldm_tpu_torch/csrc/projection.cpp,
built by rangeldm_tpu_torch/native) against the JAX package's core
(rangeldm_tpu.native, the same source with the same flags): bit-equal in
every sensor mode, and within 1e-5 of the numpy path with equal masks
(tests/test_native.py's bound and inputs). Its build is keyed on the
source, made once under concurrent first use, and raises with the
compiler's output."""

import threading

import numpy as np
import pytest
import torch

from rangeldm_tpu import native as jax_native
from rangeldm_tpu.geometry import get_spec as jax_get_spec

from conftest import synthetic_scan
from rangeldm_tpu_torch import native
from rangeldm_tpu_torch.geometry.projection import range_image_np
from rangeldm_tpu_torch.geometry.sensors import get_spec

# the three row modes, the log and inverse encodings
CASES = [("kitti360", {}), ("kitti360_vanilla", {}), ("nuscenes", {}),
         ("kitti360", dict(log=True)), ("kitti360", dict(inverse=True))]
IDS = [f"{s}-{'-'.join(k) or 'default'}" for s, k in CASES]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scan(sensor, n, rng):
    if sensor == "nuscenes":
        return synthetic_scan(rng, n=n, n_beams=32, with_ring=True)
    return synthetic_scan(rng, n=n)


@pytest.mark.parametrize("sensor,kw", CASES, ids=IDS)
def test_native_core_equals_jax(sensor, kw):
    """Bit-equal on 120,000-point scans (one HDL-64E scan) with equal-range
    duplicates."""
    assert jax_native.available()
    rng = np.random.default_rng(len(kw) + len(sensor))
    pc = _scan(sensor, 120000, rng)
    pc = np.concatenate([pc, pc[:500]])
    got = native.range_image_native(pc, get_spec(sensor, **kw))
    want = jax_native.range_image_native(pc, jax_get_spec(sensor, **kw))
    for g, w, name in zip(got, want, ("img", "mask", "cw")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].any(), "no car-window pixel: the mask goes untested"


@pytest.mark.parametrize("sensor,kw", CASES[:4], ids=IDS[:4])
def test_native_core_matches_numpy(rng, sensor, kw):
    """Within 1e-5 of the numpy path, masks equal, on tests/test_native.py's
    inputs (30,000 points; 10,000 for the ring mode and the log encoding).
    On larger scans a point whose azimuth lies within float32 rounding of
    a column edge lands in one column on one path and in its neighbour on
    the other (a few pixels of 120,000 points), in the JAX package's core
    as in this one."""
    n = 10000 if sensor == "nuscenes" or kw else 30000
    pc = _scan(sensor, n, rng)
    spec = get_spec(sensor, **kw)
    got, plain = native.range_image_native(pc, spec), range_image_np(pc, spec)
    np.testing.assert_allclose(got[0], plain[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_array_equal(got[2], plain[2])


def test_native_core_rejects_short_rows():
    pc = synthetic_scan(np.random.default_rng(0), n=1000)
    with pytest.raises(ValueError, match="4-column"):
        native.range_image_native(pc[:, :3].copy(), get_spec("kitti360"))
    with pytest.raises(ValueError, match="5-column"):
        native.range_image_native(pc, get_spec("nuscenes"))


def test_build_is_keyed_on_the_source_and_made_once(tmp_path, monkeypatch):
    """Eight threads that find no library build one, under the lock, and
    leave no temporary file; an edited source gets a new name."""
    src = tmp_path / "projection.cpp"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(paths) == 8 and len(set(paths)) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [paths[0].name, "projection.lock"])
    first = native.target()
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.target() != first


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "projection.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        "projection.lock"]
