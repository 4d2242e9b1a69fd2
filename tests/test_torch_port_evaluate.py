"""The port's evaluation command line and release parity gate
(`rangeldm_tpu_torch.evaluate`, `rangeldm_tpu_torch.parity_gate`) against
the JAX package's on the same dump directories, checkpoint and synthetic
KITTI-360 tree, on the CPU.

Tolerances: MMD rtol 1e-10 and JSD rtol 1e-8 (both packages take the same
float64 numpy path); MAE exact (the same numpy code); the FRD activations
within 1e-4 of their scale (tests/test_torch_port_rangenet.py); IoU and
accuracy within 2e-3 (label maps of full-width scans: both packages
back-project the dumps in float32 through different trigonometric
kernels, so a point on a pixel border can land in the neighbouring pixel);
the VAE stage's statistics rtol 1e-3 (float32 convolutions summed in
different orders).

The FRD value itself is compared only where it is stable: at `--limit 2`
each side's covariance has rank 1 in 4096 dimensions, and scipy's
`sqrtm` of that product is ill-conditioned and takes minutes. Here the
last step (`frd_from_activations`) is replaced in both packages by the
squared distance of the activation means, so the CLI's orchestration,
limits and the on-device gather are held to the JAX package's while the
Frechet step is held to it in tests/test_torch_port_metrics.py.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import synthetic_scan
from rangeldm_tpu import evaluate as jax_evaluate
from rangeldm_tpu import parity_gate as jax_gate
from rangeldm_tpu.geometry import get_spec as jax_get_spec
from rangeldm_tpu.geometry import range_image_np as jax_range_image_np
from rangeldm_tpu.metrics import frd_pipeline as jax_pipeline
from rangeldm_tpu.models.unet import UNetConfig as JaxUNetConfig
from test_nuscenes_path import make_nuscenes_tree
from test_rangenet_parity import build_torch_rangenet
from test_released_pipeline import build_fake_release

from rangeldm_tpu_torch import evaluate, parity_gate
from rangeldm_tpu_torch.metrics import frd_pipeline
from rangeldm_tpu_torch.models.unet import UNetConfig
from rangeldm_tpu_torch.models.vae import VaeConfig

torch.set_num_threads(1)
GEN = (0, 1, 2, 3, 10)          # unpadded names, one of two digits


def _kitti_root(root, rng, per_drive=3, n=6000):
    for drive in ("0000_sync", "0002_sync"):
        d = root / "data_3d_raw" / f"2013_05_28_drive_{drive}" / \
            "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(per_drive):
            synthetic_scan(rng, n=n).tofile(d / f"{i:010d}.bin")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A released-format RangeNet checkpoint, a synthetic KITTI-360
    held-out split, and an experiment dir with generated .bin samples and
    densification and inpainting triplets."""
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("eval")
    ckpt = base / "rangenet"
    ckpt.mkdir()
    for name, module in zip(("backbone", "segmentation_decoder",
                             "segmentation_head"), build_torch_rangenet()):
        torch.save(module.state_dict(), ckpt / name)
    root = _kitti_root(base / "kitti", rng)
    exp = base / "exp"
    exp.mkdir()
    for i in GEN:
        synthetic_scan(rng, n=6000).tofile(exp / f"{i}.bin")
    spec = jax_get_spec("kitti360")
    for prefix in ("densification", "inpainting"):
        for sub in ("result", "target"):
            (exp / f"{prefix}_{sub}").mkdir()
        for i in range(3):
            img, _, _ = jax_range_image_np(synthetic_scan(rng, n=8000), spec)
            noisy = img.copy()
            noisy[..., 0] += 0.05 * rng.standard_normal(img.shape[:2])
            np.save(exp / f"{prefix}_target" / f"{i}.npy", img)
            np.save(exp / f"{prefix}_result" / f"{i}.npy",
                    noisy.astype(np.float32))
    return dict(ckpt=str(ckpt), root=root, exp=str(exp))


def _mean_gap(seen):
    """Stand-in for the Frechet step: records the activations and returns
    the squared distance of their means."""
    def fn(a, b):
        seen.append((a, b))
        return float(np.sum((a.mean(0) - b.mean(0)) ** 2))
    return fn


@pytest.fixture(scope="module")
def both_runs(tree):
    """One `evaluate.main` with every scoring flag, in each package, over
    the same directories (--limit 2)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KITTI360_DATASET", tree["root"])
    seen = {"jax": [], "port": []}
    mp.setattr(jax_pipeline, "frd_from_activations", _mean_gap(seen["jax"]))
    mp.setattr(frd_pipeline, "frd_from_activations", _mean_gap(seen["port"]))
    argv = ["--exp", tree["exp"], "--mmd", "--jsd", "--frd", "--iou",
            "--accuracy", "--mae", "--inpainting_mae", "--cond_prefix",
            "densification", "--rangenet", tree["ckpt"], "--limit", "2"]
    try:
        want = jax_evaluate.main(argv)
        got = evaluate.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    return got, want, seen


def test_evaluate_matches_jax_on_every_leg(both_runs, capsys):
    got, want, seen = both_runs
    assert sorted(got) == sorted(want)
    json.dumps(got)                                    # plain floats only
    np.testing.assert_allclose(got["mmd"], want["mmd"], rtol=1e-10)
    np.testing.assert_allclose(got["jsd"], want["jsd"], rtol=1e-8)
    for k in ("mae", "mae_bicubic", "mae_nearest", "inpainting_mae"):
        assert got[k] == want[k], k
    for k in ("iou", "accuracy"):
        assert 0.0 < got[k] < 1.0
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    (ga, gb), = seen["port"]
    (ja, jb), = seen["jax"]
    # --limit 2 on both sides, the reference's 4096-dim subsample
    assert ga.shape == gb.shape == ja.shape == (2, 4096)
    for g, j in ((ga, ja), (gb, jb)):
        scale = max(float(np.abs(j).max()), 1.0)
        assert float(np.abs(g - j).max()) <= 1e-4 * scale
    np.testing.assert_allclose(got["frd"], want["frd"], rtol=1e-3)


def test_evaluate_reads_generated_files_in_index_order(tree):
    files = frd_pipeline.generated_sample_files(tree["exp"], 4)
    assert [os.path.basename(f) for f in files] == [
        "0.bin", "1.bin", "2.bin", "3.bin"]
    assert files == jax_pipeline.generated_sample_files(tree["exp"], 4)
    assert [os.path.basename(f) for f in frd_pipeline.generated_sample_files(
        tree["exp"], 10)][-1] == "10.bin"
    assert (evaluate.kitti_reference_files(4, tree["root"])
            == jax_evaluate.kitti_reference_files(4, tree["root"]))


def test_evaluate_refusals(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("KITTI360_DATASET", tree["root"])
    base = ["--exp", tree["exp"], "--device", "cpu"]
    with pytest.raises(ValueError, match="rangenet"):
        evaluate.main(base + ["--frd"])
    with pytest.raises(ValueError, match="rangenet"):
        evaluate.main(base + ["--iou"])
    with pytest.raises(SystemExit, match="KITTI-only"):
        evaluate.main(base + ["--frd", "--nus", "--rangenet", tree["ckpt"]])
    with pytest.raises(FileNotFoundError, match="no generated"):
        evaluate.main(["--exp", str(tmp_path), "--mmd", "--device", "cpu"])
    # result/target dumps of unequal index sets are refused, not paired by
    # position
    exp = tmp_path / "exp"
    shutil.copytree(tree["exp"], exp)
    os.rename(exp / "densification_result" / "2.npy",
              exp / "densification_result" / "7.npy")
    argv = ["--exp", str(exp), "--mae", "--limit", "3"]
    with pytest.raises(SystemExit, match="index set"):
        evaluate.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="index set"):
        jax_evaluate.main(argv)
    with pytest.raises(ValueError, match="index set"):
        frd_pipeline.compute_segmentation_scores(
            str(exp), "densification", tree["ckpt"], limit=3, device="cpu")


def test_evaluate_runs_on_cuda_unless_the_cpu_is_asked_for(tree):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--exp", tree["exp"], "--mmd"])


def test_evaluate_nuscenes_mmd_jsd_matches_jax(tmp_path, rng, monkeypatch):
    root, _ = make_nuscenes_tree(tmp_path / "nus", rng)
    exp = tmp_path / "gen"
    exp.mkdir()
    for i in range(3):
        synthetic_scan(rng, n=5000).tofile(exp / f"{i}.bin")
    monkeypatch.setenv("NUSCENES_DATASET", root)
    argv = ["--exp", str(exp), "--mmd", "--jsd", "--nus"]
    got = evaluate.main(argv + ["--device", "cpu"])
    want = jax_evaluate.main(argv)
    np.testing.assert_allclose(got["mmd"], want["mmd"], rtol=1e-10)
    np.testing.assert_allclose(got["jsd"], want["jsd"], rtol=1e-8)
    assert (evaluate.nuscenes_reference_files(5, root)
            == jax_evaluate.nuscenes_reference_files(5, root))


# ---------------------------------------------------------------------------
# the parity gate
# ---------------------------------------------------------------------------

# attention-free tiny release: image = unet (4, 32) x vae down 2 = (8, 64)
TINY_UNET = dict(sample_size=(4, 32), in_channels=5, out_channels=4,
                 block_out_channels=(32, 32),
                 down_block_types=("DownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "UpBlock2D"))


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    base = tmp_path_factory.mktemp("gate")
    rng = np.random.default_rng(1)
    weights = build_fake_release(base, rng, ucfg=JaxUNetConfig(**TINY_UNET))
    return dict(weights=weights, root=_kitti_root(base / "kitti", rng),
                out=str(base / "gate_out"))


def _report(out):
    with open(os.path.join(out, "parity_report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sampled(release):
    """The port's gate end to end on the CPU: load, stage reports, DDIM-2
    sampling of 4 samples in float32, scores, the FAIL verdict."""
    code = parity_gate.main([
        "--weights", release["weights"], "--data", release["root"],
        "--out", release["out"], "--samples", "4", "--batch_size", "3",
        "--steps", "2", "--fp32", "--device", "cpu"])
    return code, _report(release["out"])


def test_gate_samples_scores_and_fails_random_weights(sampled, release):
    code, report = sampled
    assert code == 1 and report["pass"] is False
    assert report["target"] == "rangeldm_kitti360"
    assert report["image_size"] == [8, 64]
    assert report["pipeline"]["source"] == "diffusers"
    assert report["n_sampled"] == 4
    assert report["unet_stage"]["finite"]
    assert report["vae_stage"]["n_scans"] == 4
    files = sorted(os.listdir(release["out"]))
    assert files == ["0.bin", "1.bin", "2.bin", "3.bin", "parity_report.json"]
    for k in ("mmd", "jsd"):
        assert np.isfinite(report["scores"][k])
        check = report["checks"][k]
        assert check["published"] == parity_gate.PUBLISHED[
            "rangeldm_kitti360"][k]
        assert check["bound"] == pytest.approx(check["published"] * 1.05)


def test_gate_matches_jax_on_the_same_samples(sampled, release):
    """Both gates re-score the port's samples (--skip_sampling): the same
    scores, checks and verdicts, and the same VAE stage report from the
    same weights and held-out scans; then both pass under loosened
    targets."""
    args = ["--weights", release["weights"], "--data", release["root"],
            "--out", release["out"], "--samples", "4", "--skip_sampling",
            "--fp32"]
    assert jax_gate.main(args) == 1
    want = _report(release["out"])
    assert parity_gate.main(args + ["--device", "cpu"]) == 1
    got = _report(release["out"])
    for k in ("target", "image_size", "tolerance", "pass"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["scores"]["mmd"], want["scores"]["mmd"],
                               rtol=1e-10)
    np.testing.assert_allclose(got["scores"]["jsd"], want["scores"]["jsd"],
                               rtol=1e-8)
    assert ((got["scores"]["n_gen"], got["scores"]["n_ref"])
            == (want["scores"]["n_gen"], want["scores"]["n_ref"]))
    assert sorted(got["checks"]) == sorted(want["checks"])
    for k, c in got["checks"].items():
        assert c["ok"] == want["checks"][k]["ok"]
        assert c["bound"] == want["checks"][k]["bound"]
    for k in ("recon_mae_m", "recon_psnr", "latent_mean", "latent_std"):
        np.testing.assert_allclose(got["vae_stage"][k], want["vae_stage"][k],
                                   rtol=1e-3, atol=1e-5)
    loose = ["--mmd_target", "1e6", "--jsd_target", "1e6"]
    assert jax_gate.main(args + loose) == 0
    assert parity_gate.main(args + loose + ["--device", "cpu"]) == 0
    assert _report(release["out"])["pass"] is True


def test_gate_frd_leg_gates_on_frd_alone(sampled, release, monkeypatch):
    """--rangenet adds the FRD row through compute_frd_for_dirs with the
    held-out files truncated to --samples; --gate_frd makes it gate."""
    calls = []

    def fake_frd(out_dir, reference_files, rangenet, limit, device):
        calls.append((out_dir, reference_files, rangenet, limit, device))
        return 2.5

    monkeypatch.setattr(frd_pipeline, "compute_frd_for_dirs", fake_frd)
    args = ["--weights", release["weights"], "--data", release["root"],
            "--out", release["out"], "--samples", "4", "--skip_sampling",
            "--fp32", "--device", "cpu", "--rangenet", "ckpt_dir",
            "--mmd_target", "1e6", "--jsd_target", "1e6"]
    assert parity_gate.main(args + ["--gate_frd", "--frd_target", "1"]) == 1
    report = _report(release["out"])
    assert report["scores"]["frd"] == 2.5
    assert report["checks"]["frd"]["ok"] is False
    assert report["checks"]["mmd"]["ok"] and report["checks"]["jsd"]["ok"]
    assert parity_gate.main(args + ["--gate_frd", "--frd_target", "3"]) == 0
    assert parity_gate.main(args) == 0         # report-only without the flag
    out, refs, ckpt, limit, device = calls[0]
    assert (out, ckpt, limit, device) == (release["out"], "ckpt_dir", 4,
                                          torch.device("cpu"))
    assert refs == evaluate.kitti_reference_files(4, release["root"])


def test_gate_exit_codes_on_errors(tmp_path, release, capsys):
    """0 PASS, 1 FAIL, 2 error: a missing directory, a directory that is
    not a diffusers pipeline (an orbax one) and a missing card exit 2."""
    rc = parity_gate.main(["--weights", str(tmp_path / "nope"), "--data",
                           str(tmp_path), "--device", "cpu"])
    assert rc == 2
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["pass"] is None and "no such directory" in rep["error"]
    orbax = tmp_path / "orbax_pipeline"
    (orbax / "unet").mkdir(parents=True)
    (orbax / "model_index.json").write_text("{}")
    assert parity_gate.main(["--weights", str(orbax), "--data",
                             str(tmp_path), "--device", "cpu"]) == 2
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ("orbax" in rep["error"]
            and "tools/export_pipeline.py" in rep["error"])
    if not torch.cuda.is_available():
        assert parity_gate.main(["--weights", release["weights"], "--data",
                                 release["root"]]) == 2
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "CUDA" in rep["error"]
    with pytest.raises(SystemExit):
        parity_gate.main(["--weights", release["weights"], "--data",
                          release["root"], "--gate_frd"])


def test_detect_target_matches_jax():
    def fake(cfgs, h_img, with_vae):
        ucfg_cls, vcfg_cls = cfgs
        vcfg = vcfg_cls(ch=32, ch_mult=(1, 2, 4), z_channels=4) \
            if with_vae else None
        f = vcfg.down_factor if vcfg else 1
        ucfg = ucfg_cls(**{**TINY_UNET, "sample_size": (h_img // f,
                                                        1024 // f)})
        return {"meta": {}, "unet_cfg": ucfg, "vae_cfg": vcfg,
                "vae": object() if with_vae else None}

    from rangeldm_tpu.models.vae import VaeConfig as JaxVaeConfig
    for h_img in (32, 64):
        for with_vae in (False, True):
            got = fake((UNetConfig, VaeConfig), h_img, with_vae)
            want = fake((JaxUNetConfig, JaxVaeConfig), h_img, with_vae)
            assert (parity_gate.detect_target(got)
                    == jax_gate.detect_target(want))
            assert (parity_gate.pipe_image_size(got)
                    == jax_gate.pipe_image_size(want) == (h_img, 1024))
    assert parity_gate.PUBLISHED == jax_gate.PUBLISHED
