"""The port's tensor projection (`geometry/projection.py`: `pad_points`,
`project`, `process_miss_value`, `normalize`, `range_image`) against the
JAX package's device pipeline on the same numpy-seeded padded points, with
tests/test_geometry.py's bounds for pixels at a column edge (a last-ulp
atan2 difference may move a point to the next column); the TensorBoard
event files of `ScalarLogger` read back by TensorBoard's own loader and by
the port's reader; and the leftovers `save_generated` and
`ModelSpec.make_schedule` against the JAX package's. f32 on the CPU, a few
thousand points a scan: the `kitti` rows hold an (N, 64) intermediate."""

import json
import os
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rangeldm_tpu import geometry as jg
from rangeldm_tpu.geometry.laserscan import save_generated as jax_save_generated
from rangeldm_tpu.models.zoo import get_model_spec as jax_get_model_spec

import chip_smoke
from conftest import synthetic_scan
from rangeldm_tpu_torch import geometry as tg
from rangeldm_tpu_torch.geometry.laserscan import save_generated
from rangeldm_tpu_torch.models.zoo import get_model_spec
from rangeldm_tpu_torch.training import event_file
from rangeldm_tpu_torch.training.loggers import ScalarLogger
from test_torch_port_common import assert_tb_equals_jsonl, tb_scalars

N_POINTS, N_MAX = 3000, 4096
# the row modes (kitti, uniform, ring) and the log encoding
CASES = [("kitti360", {}), ("kitti360_vanilla", {}), ("nuscenes", {}),
         ("kitti360", {"log": True})]
IDS = ["kitti360", "kitti360_vanilla", "nuscenes", "kitti360-log"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _specs(sensor, kw):
    return tg.get_spec(sensor, **kw), jg.get_spec(sensor, **kw)


def _scan(sensor, seed, n=N_POINTS):
    rng = np.random.default_rng(seed)
    if sensor == "nuscenes":
        return synthetic_scan(rng, n=n, n_beams=32, with_ring=True)
    return synthetic_scan(rng, n=n)


def _both(fn_port, fn_jax, pts, valid, spec, jspec):
    got = fn_port(torch.from_numpy(pts), torch.from_numpy(valid), spec)
    want = fn_jax(jnp.asarray(pts), jnp.asarray(valid), jspec)
    return got, want


def _edge_mismatches(got, want, tol):
    return ~np.isclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("sensor,kw", CASES, ids=IDS)
def test_project_matches_jax(sensor, kw):
    """tests/test_geometry.py:38-45's bound on range pixels; the intensity
    is equal wherever the range matches."""
    spec, jspec = _specs(sensor, kw)
    pts, valid = tg.pad_points(_scan(sensor, 1), N_MAX)
    got, want = _both(tg.project, jg.project, pts, valid, spec, jspec)
    assert got.shape == (spec.n_beams, spec.width, 2)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got, want = got.numpy(), np.asarray(want)
    diff = _edge_mismatches(got[..., 0], want[..., 0], 1e-6)
    assert diff.sum() <= max(4, want.size // 10000), diff.sum()
    np.testing.assert_array_equal(got[..., 1][~diff], want[..., 1][~diff])
    assert (got[..., 0] > 0).sum() > N_POINTS // 2


@pytest.mark.parametrize("sensor,kw", CASES[:3], ids=IDS[:3])
def test_range_image_matches_jax(sensor, kw):
    """tests/test_geometry.py:70-75's bounds: 16 values, 8 mask and 8
    car-window pixels."""
    spec, jspec = _specs(sensor, kw)
    pts, valid = tg.pad_points(_scan(sensor, 2), N_MAX)
    (img, mask, cw), (jimg, jmask, jcw) = _both(
        tg.range_image, jg.range_image, pts, valid, spec, jspec)
    assert mask.dtype == cw.dtype == torch.bool
    assert _edge_mismatches(img.numpy(), np.asarray(jimg), 1e-5).sum() <= 16
    assert (mask.numpy() != np.asarray(jmask)).sum() <= 8
    assert (cw.numpy() != np.asarray(jcw)).sum() <= 8
    assert cw.any() and not (img[..., 0] == -1).any()


@pytest.mark.parametrize("first", ["original", "copy"])
def test_equal_range_ties_go_to_the_smallest_index(first):
    """Copies of 500 points (the same xyz, so the same range bits) with
    intensities above 10: the one with the smaller index wins each pixel,
    in the port as in JAX."""
    spec, jspec = _specs("kitti360", {})
    pc = _scan("kitti360", 3, n=2000)
    dup = pc[:500].copy()
    dup[:, 3] += 10.0
    pc = np.concatenate([pc, dup] if first == "original" else [dup, pc])
    pts, valid = tg.pad_points(pc, N_MAX)
    got, want = _both(tg.project, jg.project, pts, valid, spec, jspec)
    got, want = got.numpy(), np.asarray(want)
    diff = _edge_mismatches(got[..., 0], want[..., 0], 1e-6)
    assert diff.sum() <= max(4, want.size // 10000)
    np.testing.assert_array_equal(got[..., 1][~diff], want[..., 1][~diff])
    won_by_copy = (got[..., 1] >= 10.0).sum()
    if first == "original":
        assert won_by_copy == 0
    else:   # every pixel a copied point reaches is won by the copy
        assert won_by_copy >= 400


def test_batch_equals_the_scans_one_at_a_time():
    """A batch of 3 scans with 3000, 4096 (truncated) and 1000 points is
    one scatter; it equals the three calls bit for bit, and a second call
    equals the first."""
    spec = tg.get_spec("kitti360")
    padded = [tg.pad_points(_scan("kitti360", 10 + i, n), N_MAX)
              for i, n in enumerate((3000, 5000, 1000))]
    pts = torch.from_numpy(np.stack([p for p, _ in padded]))
    valid = torch.from_numpy(np.stack([v for _, v in padded]))
    batch = tg.range_image(pts, valid, spec)
    again = tg.range_image(pts, valid, spec)
    for i in range(3):
        one = tg.range_image(pts[i], valid[i], spec)
        for b, o, a in zip(batch, one, again):
            assert torch.equal(b[i], o)
            assert torch.equal(b, a)
    assert batch[0].shape == (3, 64, 1024, 2)


def test_points_under_min_depth_never_win():
    """512 points at 0.5 m, ahead of the scan and nearer than every other
    point, would win their pixels without nuScenes' 2 m filter
    (tests/test_geometry.py::test_nuscenes_ring_rows); the image equals
    JAX's."""
    spec, jspec = _specs("nuscenes", {})
    pc = _scan("nuscenes", 4)
    near = pc[:512].copy()
    near[:, :3] *= 0.5 / np.linalg.norm(near[:, :3], axis=1, keepdims=True)
    pts, valid = tg.pad_points(np.concatenate([near, pc]), N_MAX)
    got, want = _both(tg.project, jg.project, pts, valid, spec, jspec)
    got, want = got.numpy(), np.asarray(want)
    hit = got[..., 0] > 0
    assert hit.sum() > 1000 and got[..., 0][hit].min() > 2.0
    diff = _edge_mismatches(got[..., 0], want[..., 0], 1e-6)
    assert diff.sum() <= max(4, want.size // 10000)


def test_ring_rows_outside_the_image_as_in_jax():
    """Ring ids past the sensor's beams: a negative row wraps once into the
    image (numpy's and JAX's indexing), a row past the image is dropped
    (JAX's scatter), on the same pixels as JAX."""
    spec, jspec = _specs("nuscenes", {})
    pc = _scan("nuscenes", 7, n=1000)
    pc[:300:3, 4] = 32.0 + pc[:300:3, 4]           # rows -1 .. -32
    pc[1:300:3, 4] = -1.0 - pc[1:300:3, 4]         # rows 32 .. 63
    pts, valid = tg.pad_points(pc, 1024)
    got, want = _both(tg.project, jg.project, pts, valid, spec, jspec)
    got, want = got.numpy(), np.asarray(want)
    diff = _edge_mismatches(got[..., 0], want[..., 0], 1e-6)
    assert diff.sum() <= 4
    np.testing.assert_array_equal(got[..., 1][~diff], want[..., 1][~diff])
    assert (got[..., 0] > 0).sum() > 750


def test_ring_mode_needs_a_ring_column():
    spec = tg.get_spec("nuscenes")
    pts, valid = tg.pad_points(_scan("kitti360", 5, n=100), 128)
    with pytest.raises(ValueError, match="5-column"):
        tg.project(torch.from_numpy(pts), torch.from_numpy(valid), spec)


@pytest.mark.parametrize("n", [3000, N_MAX, 5000])
def test_pad_points_matches_jax(n):
    pc = _scan("nuscenes", 6, n=n)
    got, want = tg.pad_points(pc, N_MAX), jg.pad_points(pc, N_MAX)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- the TensorBoard sink ---------------------------------------------------

def test_crc32c_check_value():
    assert event_file.crc32c(b"123456789") == 0xE3069283
    assert event_file.crc32c(b"") == 0
    payload = b"\x00\x01payload"
    framed = event_file.frame(payload)
    assert len(framed) == 8 + 4 + len(payload) + 4


def _log_three_steps(out_dir):
    logger = ScalarLogger(str(out_dir))
    rows = [{"loss": 0.1234567891, "sps": 3.3},
            {"loss": 1e-8, "grad_norm": 12345.678},
            {"loss": -2.5, "sps": 4.0, "lr": 2e-4}]
    for step, row in enumerate(rows, start=1):
        logger.log(step, row)
    return logger


def test_event_file_reads_back_in_tensorboard(tmp_path, caplog):
    """ScalarLogger's default sink: TensorBoard's EventFileLoader reads the
    file; tags, steps and float32 values equal the jsonl rows, and the
    port's own reader (the one chip_smoke.py uses) gives the same."""
    pytest.importorskip("tensorboard")
    _log_three_steps(tmp_path).close()
    assert "tensorboard" not in caplog.text.lower()
    (path,) = event_file.event_files(str(tmp_path / "tb"))
    assert os.path.basename(path).startswith("events.out.tfevents.")
    assert_tb_equals_jsonl(tmp_path)
    want = [(1, "loss", float(np.float32(0.1234567891))),
            (1, "sps", float(np.float32(3.3)))]
    assert tb_scalars(tmp_path / "tb")[:2] == want
    events = [event_file.decode_event(p)
              for p in event_file.read_records(path)]
    assert events[0]["file_version"] == "brain.Event:2"
    assert all(e["wall_time"] > 1e9 for e in events)


def test_event_files_of_two_runs_read_in_order(tmp_path):
    """A resumed run opens a second file; both read back in order."""
    _log_three_steps(tmp_path).close()
    second = ScalarLogger(str(tmp_path))
    second.log(4, {"loss": 0.5})
    second.close()
    assert len(event_file.event_files(str(tmp_path / "tb"))) == 2
    assert event_file.read_scalars(str(tmp_path / "tb"))[-1] == (
        4, "loss", 0.5)
    assert_tb_equals_jsonl(tmp_path)


def test_a_cut_or_corrupted_record_raises(tmp_path):
    _log_three_steps(tmp_path).close()
    (path,) = event_file.event_files(str(tmp_path / "tb"))
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-1])
    with pytest.raises(ValueError, match="cut short"):
        event_file.read_scalars(str(tmp_path / "tb"))
    with open(path, "wb") as f:
        f.write(data[:-6] + bytes([data[-6] ^ 1]) + data[-5:])
    with pytest.raises(ValueError, match="bad payload CRC"):
        event_file.read_scalars(str(tmp_path / "tb"))


def test_close_flushes_and_closes(tmp_path):
    logger = _log_three_steps(tmp_path)
    assert not logger.tb.closed
    logger.close()
    assert logger.tb.closed
    logger.close()                      # a second close is harmless
    assert len(event_file.read_scalars(str(tmp_path / "tb"))) == 7


def test_only_rank_0_writes_tb(tmp_path, monkeypatch, caplog):
    """tensorboard=True is the default; a rank but 0 writes nothing, and
    only the wandb sink, which is not ported, warns."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    logger = ScalarLogger(str(tmp_path / "rank1"), wandb=True)
    logger.log(1, {"loss": 1.0})
    logger.close()
    assert not (tmp_path / "rank1").exists() and not caplog.text
    monkeypatch.setenv("RANK", "0")
    ScalarLogger(str(tmp_path / "rank0"), wandb=True).close()
    assert (tmp_path / "rank0" / "tb").is_dir()
    assert "wandb" in caplog.text and "tensorboard" not in caplog.text


# -- the leftovers ----------------------------------------------------------

def test_save_generated_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(7)
    image = np.stack([rng.uniform(-0.1, 1.1, (64, 256)),
                      rng.uniform(0.0, 1.0, (64, 256))], -1).astype(
        np.float32)
    save_generated(image, str(tmp_path / "port"))
    jax_save_generated(image, str(tmp_path / "jax"))
    got = (tmp_path / "port.bin").read_bytes()
    assert got == (tmp_path / "jax.bin").read_bytes()
    assert 0 < len(got) < 64 * 256 * 16 and len(got) % 16 == 0


@pytest.mark.parametrize("name", ["rangeldm_kitti360", "rangedm_kitti360"])
def test_make_schedule_matches_jax(name):
    """alphas_cumprod within 1e-5 relative, the port's rounding bound
    for the schedule (ROADMAP, rounding tolerances)."""
    got = get_model_spec(name).make_schedule().alphas_cumprod
    want = np.asarray(jax_get_model_spec(name).make_schedule().alphas_cumprod)
    assert got.shape == want.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- chip_smoke.py's projection phase and its event-file check, on the CPU --

def test_chip_smoke_reads_the_event_files_back(tmp_path):
    _log_three_steps(tmp_path).close()
    second = ScalarLogger(str(tmp_path))
    second.log(4, {"loss": 0.5})
    second.close()
    assert chip_smoke.tb_matches_log(str(tmp_path), 2)["scalars"] == 8
    with pytest.raises(AssertionError, match="event files"):
        chip_smoke.tb_matches_log(str(tmp_path), 1)


def test_chip_smoke_projection_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's checks at a small size on the CPU, with a host timer and
    no memory counters: every sensor's batch within the bounds."""

    def host_ms(fn, iters, warmup=1):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    monkeypatch.setattr(chip_smoke, "SCAN_POINTS", 2000)
    monkeypatch.setattr(chip_smoke, "PROJ_POINTS", 2560)
    monkeypatch.setattr(chip_smoke, "PROJ_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    out = chip_smoke.phase_projection("cpu", device="cpu")
    assert set(out) == set(chip_smoke.PROJ_SENSORS)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "projection"
    for name, rec in out.items():
        for ref in ("numpy", "native"):
            assert all(c <= b for c, b in zip(
                rec["mismatches"][ref]["max_per_scan"],
                chip_smoke.PROJ_BOUNDS)), (name, ref)
        assert rec["card_ms_per_scan"] > 0 and rec["mask_pixels_per_scan"] > 0
