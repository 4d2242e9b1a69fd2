"""The port's scoring functions against the JAX package's on the same numpy
inputs: the LaserScan projection, BEV histograms, MMD, JSD, the Frechet
distance, chamfer distance and the KNN post-processing.

Tolerances: the projection, the histograms (host and batched) and KNN are
bit-exact; host MMD rtol 1e-10 (both float64 numpy); the port's float32
MMD path rtol 1e-4 against the float64 value (and 1e-2 against the JAX
package's float32 path, which loses up to 1 %); JSD and the
Frechet distance rtol 1e-8 (float64; the Frechet distance at a size where
its covariances are well conditioned); chamfer rtol 1e-4, as
tests/test_chamfer.py holds the JAX function against its own reference.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import synthetic_scan
from rangeldm_tpu.geometry import laserscan as jax_laserscan
from rangeldm_tpu.metrics import chamfer as jax_chamfer
from rangeldm_tpu.metrics import frd as jax_frd
from rangeldm_tpu.metrics import histogram as jax_hist
from rangeldm_tpu.metrics import jsd as jax_jsd
from rangeldm_tpu.metrics import knn as jax_knn
from rangeldm_tpu.metrics import mmd as jax_mmd

from rangeldm_tpu_torch.geometry import laserscan
from rangeldm_tpu_torch.metrics import chamfer, frd, histogram, jsd, knn, mmd

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(64, 1024), (32, 256)])
def test_laserscan_projection_is_bit_exact(rng, hw):
    pc = synthetic_scan(rng, n=30000)
    pc[0] = [5.0, 0.0, -0.5, 0.3]       # a point index 0 that wins a pixel
    got = laserscan.laserscan_project(pc[:, :3], pc[:, 3], h=hw[0], w=hw[1])
    want = jax_laserscan.laserscan_project(pc[:, :3], pc[:, 3], h=hw[0],
                                           w=hw[1])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the reference's off-by-one: the pixel won by point 0 counts as empty
    assert got[3].sum() < (got[0] >= 0).sum()
    no_rem = laserscan.laserscan_project(pc[:, :3], h=hw[0], w=hw[1])
    np.testing.assert_array_equal(
        no_rem[2], jax_laserscan.laserscan_project(pc[:, :3], h=hw[0],
                                                   w=hw[1])[2])


def test_load_matrices_matches(tmp_path, rng):
    (tmp_path / "calibration").mkdir()
    (tmp_path / "data_poses" / "drive").mkdir(parents=True)
    cam_to_velo = np.eye(4)[:3] + 0.1 * rng.standard_normal((3, 4))
    np.savetxt(tmp_path / "calibration" / "calib_cam_to_velo.txt",
               cam_to_velo.reshape(1, 12))
    rows = [f"image_0{i}: " + " ".join(map(str, rng.standard_normal(12)))
            for i in range(2)]
    (tmp_path / "calibration" / "calib_cam_to_pose.txt").write_text(
        "\n".join(rows) + "\n")
    poses = np.concatenate([np.arange(5)[:, None],
                            rng.standard_normal((5, 12))], axis=1)
    np.savetxt(tmp_path / "data_poses" / "drive" / "poses.txt", poses)
    got = laserscan.load_matrices(str(tmp_path), "drive")
    want = jax_laserscan.load_matrices(str(tmp_path), "drive")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_histograms_are_bit_exact(rng):
    pc = synthetic_scan(rng, n=20000)
    pc[:3, :2] = [[80.0, -80.0], [-80.0, 80.0], [80.0, 80.0]]
    for name in ("kitti_histogram", "nuscenes_histogram"):
        np.testing.assert_array_equal(getattr(histogram, name)(pc),
                                      getattr(jax_hist, name)(pc))
    np.testing.assert_array_equal(histogram.point_cloud_to_histogram(pc),
                                  jax_hist.point_cloud_to_histogram(pc))
    np.testing.assert_array_equal(histogram.depth_mask(pc, 3.0, 70.0),
                                  jax_hist.depth_mask(pc, 3.0, 70.0))


def test_histogram_batch_matches_jax_and_histogramdd(rng):
    b, n = 3, 4000
    pc = rng.uniform(-90.0, 90.0, (b, n, 3)).astype(np.float32)
    # upper and lower edges, bin edges (multiples of 1.6 m) and points just
    # outside the field
    edges = np.array([80.0, -80.0, 78.4, -78.4, 1.6, 0.0, -1.6, 80.0001,
                      -80.0001, 79.99999], np.float32)
    pc[:, :len(edges), 0] = edges
    pc[:, :len(edges), 1] = edges[::-1]
    pc[:, len(edges):2 * len(edges), 0] = 80.0
    mask = rng.uniform(size=(b, n)) < 0.8
    got = histogram.histogram_batch(torch.from_numpy(pc),
                                    torch.from_numpy(mask))
    want = np.asarray(jax_hist.histogram_batch_jax(jnp.asarray(pc),
                                                   jnp.asarray(mask)))
    assert got.dtype == torch.float32 and got.shape == (b, 100, 100)
    np.testing.assert_array_equal(got.numpy(), want)
    # np.histogramdd's own edges: the upper edge in the last bin, points
    # outside dropped. Interior bin edges are left out of this comparison:
    # both packages bin in float32, where 78.4 m can land one bin below
    # histogramdd's float64 edge.
    interior = np.isin(pc[..., :2], edges[2:5]).any(-1) | np.isin(
        pc[..., :2], edges[6:7]).any(-1)
    keep = torch.from_numpy(mask & ~interior)
    plain = histogram.histogram_batch(torch.from_numpy(pc), keep)
    for i in range(b):
        np.testing.assert_array_equal(
            plain[i].numpy(),
            histogram.point_cloud_to_histogram(pc[i][keep[i].numpy()]))


def _hist_sets(rng, n_a=6, n_b=5):
    def one():
        return histogram.kitti_histogram(synthetic_scan(rng, n=6000))
    return [one() for _ in range(n_a)], [one() for _ in range(n_b)]


def test_mmd_matches_jax_on_both_paths(rng):
    a, b = _hist_sets(rng)
    host = mmd.compute_mmd(a, b)
    assert isinstance(host, float) and host > 0
    np.testing.assert_allclose(host, jax_mmd.compute_mmd(a, b), rtol=1e-10)
    # the float32 path sums each kernel mean's distance from 1, so it holds
    # the float64 value at rtol 1e-4; the JAX package's float32 path sums
    # the O(1) terms as they stand and loses 0.1-1 % of an O(1e-4) MMD,
    # as its docstring says; device=True runs it on the card, so here it
    # is called on the CPU directly
    f32 = mmd._mmd_torch(mmd._stack(a), mmd._stack(b), "cpu")
    np.testing.assert_allclose(f32, jax_mmd.compute_mmd(a, b), rtol=1e-4)
    np.testing.assert_allclose(f32, jax_mmd.compute_mmd(a, b, device=True),
                               rtol=1e-2)
    np.testing.assert_allclose(mmd.compute_mmd(a, a), 0.0, atol=1e-12)


def test_mmd_on_the_device_needs_a_card(rng, monkeypatch):
    a, b = _hist_sets(rng, 2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mmd.compute_mmd(a, b, device=True)


def test_jsd_matches_jax(rng):
    a, b = _hist_sets(rng)
    np.testing.assert_allclose(jsd.compute_jsd(a, b),
                               jax_jsd.compute_jsd(a, b), rtol=1e-8)
    p, q = rng.uniform(size=(2, 40, 40))
    p[p < 0.3] = 0.0
    np.testing.assert_allclose(jsd.jsd_2d(p, q), jax_jsd.jsd_2d(p, q),
                               rtol=1e-8)


def test_frd_indices_are_the_reference_subsample():
    got = frd.frd_indices()
    np.testing.assert_array_equal(got, jax_frd.frd_indices())
    assert got.shape == (4096,) and len(set(got.tolist())) == 4096
    np.testing.assert_array_equal(frd.frd_indices(16, 256),
                                  jax_frd.frd_indices(16, 256))


def test_frd_matches_jax_where_it_is_stable(rng):
    """NCHW features against the JAX package's NHWC ones: the same
    activations, and the same distance at N = 64 scans of 16 dims, where
    both covariances are full rank."""
    feats_a = rng.standard_normal((64, 4, 4, 8))          # (N, C, H, W)
    feats_b = 0.8 * rng.standard_normal((64, 4, 4, 8)) + 0.3
    idx = frd.frd_indices(16, 128)
    acts = frd.features_to_activations(feats_a, idx)
    np.testing.assert_array_equal(acts, jax_frd.features_to_activations(
        feats_a.transpose(0, 2, 3, 1), idx))
    got = frd.compute_frd(feats_a, feats_b, n_dims=16)
    want = jax_frd.compute_frd(feats_a.transpose(0, 2, 3, 1),
                               feats_b.transpose(0, 2, 3, 1), n_dims=16)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-8)
    act_b = frd.features_to_activations(feats_b, idx)
    np.testing.assert_allclose(frd.frd_from_activations(acts, act_b),
                               jax_frd.frd_from_activations(acts, act_b),
                               rtol=1e-8)
    mu1, mu2 = acts.mean(0), act_b.mean(0)
    s1, s2 = np.cov(acts, rowvar=False), np.cov(act_b, rowvar=False)
    np.testing.assert_allclose(frd.frechet_distance(mu1, s1, mu2, s2),
                               jax_frd.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-8)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_chamfer_matches_jax(rng, chunk):
    a = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    b = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    av = rng.uniform(size=500) < 0.9
    bv = rng.uniform(size=300) < 0.9
    got = chamfer.chamfer_distance(a, b, chunk=chunk)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jax_chamfer.chamfer_distance(
        a, b)), rtol=1e-4)
    np.testing.assert_allclose(
        float(chamfer.chamfer_distance(torch.from_numpy(a), b, av, bv,
                                       chunk=chunk)),
        float(jax_chamfer.chamfer_distance(a, b, av, bv)), rtol=1e-4)


def test_chamfer_is_nan_when_a_side_is_empty(rng):
    a = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    b = rng.uniform(-5, 5, (30, 3)).astype(np.float32)
    none_b = np.zeros(30, bool)
    assert np.isnan(float(chamfer.chamfer_distance(a, b, b_valid=none_b)))
    assert np.isnan(float(jax_chamfer.chamfer_distance(a, b,
                                                       b_valid=none_b)))
    assert np.isnan(float(chamfer.chamfer_distance(
        a, b, a_valid=np.zeros(40, bool))))
    assert abs(float(chamfer.chamfer_distance(a, a))) < 1e-5


def _knn_inputs(rng, h=8, w=16, n_points=200, nclasses=20):
    """A range image with empty (-1) pixels, zero ranges and repeated
    values, and points on every border pixel: the zero-padded window then
    holds many equal distances."""
    proj = rng.choice([-1.0, 0.0, 2.0, 5.0, 5.0, 7.5], size=(h, w))
    proj = proj.astype(np.float32)
    argmax = rng.integers(0, nclasses, (h, w)).astype(np.int32)
    border = [(y, x) for y in range(h) for x in range(w)
              if y in (0, h - 1) or x in (0, w - 1)]
    inner = [(int(rng.integers(h)), int(rng.integers(w)))
             for _ in range(n_points - len(border))]
    py, px = np.array(border + inner, np.int32).T
    unproj = rng.choice([0.0, 2.0, 5.0, 6.0], size=len(py)).astype(
        np.float32)
    return proj, unproj, argmax, px, py


def test_gaussian_kernel_matches():
    np.testing.assert_array_equal(knn.gaussian_kernel(5, 1.0),
                                  jax_knn.gaussian_kernel(5, 1.0))


@pytest.mark.parametrize("params", [
    {}, {"knn": 7, "search": 5, "cutoff": 1.0},
    {"knn": 3, "search": 3, "sigma": 0.5, "cutoff": 0.0}])
def test_knn_postprocess_matches_jax_exactly_with_border_ties(rng, params):
    proj, unproj, argmax, px, py = _knn_inputs(rng)
    got = knn.knn_postprocess(*map(torch.from_numpy,
                                   (proj, unproj, argmax, px, py)), **params)
    want = np.asarray(jax_knn.knn_postprocess(
        *map(jnp.asarray, (proj, unproj, argmax, px, py)), **params))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the inputs do tie: some point's window holds equal weighted distances
    # around its k-th smallest
    search = params.get("search", 5)
    k = params.get("knn", 5)
    pad = (search - 1) // 2
    pr = np.pad(proj, pad)
    ties = 0
    inv = 1.0 - knn.gaussian_kernel(search, params.get("sigma", 1.0))
    for y, x, r in zip(py, px, unproj):
        win = pr[y:y + search, x:x + search].copy()
        win[win < 0] = np.inf
        win[pad, pad] = r
        d = np.sort((np.abs(win - r) * inv).ravel())
        ties += d[k - 1] == d[k]
    assert ties > 0


def test_per_point_labels_dispatch(rng):
    proj, unproj, argmax, px, py = _knn_inputs(rng)
    t = list(map(torch.from_numpy, (proj, unproj, argmax, px, py)))
    j = list(map(jnp.asarray, (proj, unproj, argmax, px, py)))
    for use_knn in (False, True):
        np.testing.assert_array_equal(
            knn.per_point_labels(*t, use_knn=use_knn).numpy(),
            np.asarray(jax_knn.per_point_labels(*j, use_knn=use_knn)))
    with pytest.raises(ValueError, match="odd"):
        knn.knn_postprocess(*t, search=4)
