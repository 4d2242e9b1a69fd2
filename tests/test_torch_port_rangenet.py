"""The port's RangeNet++ darknet53 (rangeldm_tpu_torch/metrics/rangenet.py)
against the JAX package's, on weights carried across with
`convert.rangenet_state_dicts_from_jax`, and the released three-file
checkpoint loading with strict=True.

Inputs are small (batch 2, 5 x 8 x 64: the azimuth must divide by 32). The
features and head logits must stay within 1e-4 of their scale (the JAX
package's own torch check, tests/test_rangenet_parity.py:161, allows 1e-3;
float32 accumulation through 53 layers is about 1e-5 of the scale, and a
transposed kernel gives O(1) errors).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import synthetic_scan
from rangeldm_tpu.metrics import frd_pipeline as jax_pipeline
from rangeldm_tpu.metrics import rangenet as jax_rangenet
from test_rangenet_parity import build_torch_rangenet

from rangeldm_tpu_torch.convert import rangenet_state_dicts_from_jax
from rangeldm_tpu_torch.metrics import frd_pipeline, rangenet

torch.set_num_threads(1)
REL = 1e-4


def _perturbed_variables(variables, seed):
    """Random BatchNorm statistics and affine terms and non-zero biases, so
    a wrong mapping of any leaf shows."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "mean":
                v = 0.2 * rng.standard_normal(v.shape)
            elif k == "scale":
                v = rng.normal(0.7, 0.1, v.shape)
            elif k == "bias":
                v = 0.1 * rng.standard_normal(v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {k: walk(v, (k,)) for k, v in variables.items()}


@pytest.fixture(scope="module")
def jax_net():
    """(variables as numpy, jitted apply) of the JAX RangeNet with a head."""
    model = jax_rangenet.RangeNet()
    x = jnp.zeros((1, 8, 64, 5), jnp.float32)
    variables = jax.tree.map(np.asarray,
                             jax.jit(model.init)(jax.random.PRNGKey(0), x))
    variables = _perturbed_variables(variables, seed=1)
    return variables, jax.jit(model.apply)


def _close(got, want, rel=REL):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs error {err} at scale {scale}"


def test_features_and_logits_match_jax(jax_net):
    variables, apply = jax_net
    model = rangenet.RangeNet.from_state_dicts(
        *rangenet_state_dicts_from_jax(variables))
    x = np.random.default_rng(2).standard_normal((2, 5, 8, 64)).astype(
        np.float32)
    with torch.no_grad():
        feats, logits = model(torch.from_numpy(x))
    want_f, want_l = apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert feats.shape == (2, 32, 8, 64) and logits.shape == (2, 20, 8, 64)
    _close(feats.numpy(), np.asarray(want_f).transpose(0, 3, 1, 2))
    _close(logits.numpy(), np.asarray(want_l).transpose(0, 3, 1, 2))


def test_dec_stage_matches_jax_at_non_symmetric_kernels(jax_net):
    """One decoder stage on its own: ConvTranspose2d((1, 4), stride (1, 2),
    padding (0, 1)) against the JAX package's lhs-dilated conv with the
    flipped kernel. Its (1, 4) kernels are random, so a flipped or
    transposed weight shows."""
    variables, _ = jax_net
    _, decoder, _ = rangenet_state_dicts_from_jax(variables)
    stage = rangenet.dec_layer((64, 32)).eval()
    stage.load_state_dict({k[len("dec1."):]: v for k, v in decoder.items()
                           if k.startswith("dec1.")}, strict=True)
    kernel = variables["params"]["dec1"]["upconv"]["kernel"]
    assert not np.allclose(kernel, kernel[:, ::-1])
    x = np.random.default_rng(3).standard_normal((2, 64, 4, 16)).astype(
        np.float32)
    with torch.no_grad():
        got = stage(torch.from_numpy(x)).numpy()
    want = jax_rangenet.DecStage((64, 32)).apply(
        {"params": variables["params"]["dec1"],
         "batch_stats": variables["batch_stats"]["dec1"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert got.shape == (2, 32, 4, 32)
    _close(got, np.asarray(want).transpose(0, 3, 1, 2))


def _numpy_tree(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float32), tree)


@pytest.mark.parametrize("parts", ["all", "no_head", "backbone_only"])
def test_carried_weights_invert_the_jax_converter(jax_net, parts):
    variables, _ = jax_net
    bb, dec, head = rangenet_state_dicts_from_jax(variables)
    if parts != "all":
        head = None
    if parts == "backbone_only":
        dec = None

    def sd(d):
        return None if d is None else {
            k: v.numpy() for k, v in d.items()
            if not k.endswith("num_batches_tracked")}

    back = _numpy_tree(jax_rangenet.convert_rangenet_state_dict(
        sd(bb), sd(dec), sd(head)))
    want = variables
    if parts != "all":
        want = {c: {k: v for k, v in t.items() if k != "head_conv"}
                for c, t in want.items()}
    if parts == "backbone_only":
        want = {c: {"backbone": t["backbone"]} for c, t in want.items()}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    again = rangenet_state_dicts_from_jax(back)
    assert (again[1] is None) == (dec is None)
    assert (again[2] is None) == (head is None)
    for got, ref in zip(again, (bb, dec, head)):
        if ref is not None:
            assert list(got) == list(ref)
            for k in ref:
                torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A seeded darknet53 checkpoint in the released on-disk format, and
    the torch modules it was written from (the reference's layout,
    tests/test_rangenet_parity.py)."""
    bb, dec, head = build_torch_rangenet()
    d = tmp_path_factory.mktemp("rangenet")
    torch.save(bb.state_dict(), d / "backbone")
    torch.save(dec.state_dict(), d / "segmentation_decoder.pth")
    torch.save(head.state_dict(), d / "segmentation_head")
    return str(d), (bb, dec, head)


def test_released_files_load_strict_and_match_the_reference_layout(released):
    path, (bb, dec, head) = released
    model = frd_pipeline.load_rangenet(path, device="cpu")
    assert model.with_head and not model.training
    for ours, ref in ((model.backbone, bb), (model.decoder, dec),
                      (model.head, head)):
        assert list(ours.state_dict()) == list(ref.state_dict())
    x = torch.randn(2, 5, 8, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        feats, logits = model(x)
        ref_f = dec(*bb(x))
        ref_l = head(ref_f)
    _close(feats.numpy(), ref_f.numpy(), rel=1e-6)
    _close(logits.numpy(), ref_l.numpy(), rel=1e-6)


def test_load_rangenet_refuses_incomplete_dirs(tmp_path, released):
    path, (bb, dec, _) = released
    with pytest.raises(FileNotFoundError, match="segmentation_decoder"):
        frd_pipeline.load_rangenet(str(tmp_path), device="cpu")
    torch.save(bb.state_dict(), tmp_path / "backbone.pytorch")
    torch.save({"state_dict": dec.state_dict()},
               tmp_path / "segmentation_decoder")
    model = frd_pipeline.load_rangenet(str(tmp_path), device="cpu")
    assert not model.with_head
    with pytest.raises(ValueError, match="segmentation head"):
        frd_pipeline.extract_labels(model, [], h=8, w=64)
    bad = dict(bb.state_dict())
    bad.pop("conv1.weight")
    torch.save(bad, tmp_path / "backbone.pytorch")
    with pytest.raises(RuntimeError, match="conv1.weight"):
        frd_pipeline.load_rangenet(str(tmp_path), device="cpu")


def test_features_do_not_depend_on_the_batch(released):
    """BatchNorm runs on its running statistics, also after train(): one
    scan's features are the same alone and in a batch of 8."""
    path, _ = released
    model = frd_pipeline.load_rangenet(path, device="cpu")
    model.train()
    assert not model.training and not model.backbone.bn1.training
    x = torch.randn(8, 5, 8, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        alone = model(x[3:4])[0]
        batch = model(x)[0][3:4]
    _close(alone.numpy(), batch.numpy(), rel=1e-6)


def test_preprocess_scan_matches(rng):
    from rangeldm_tpu_torch.geometry.laserscan import laserscan_project
    pc = synthetic_scan(rng, n=5000)
    proj = laserscan_project(pc[:, :3], pc[:, 3], h=8, w=64)
    np.testing.assert_array_equal(rangenet.preprocess_scan(*proj),
                                  jax_rangenet.preprocess_scan(*proj))
    np.testing.assert_array_equal(rangenet.KITTI_IMG_MEANS,
                                  jax_rangenet.KITTI_IMG_MEANS)
    np.testing.assert_array_equal(rangenet.KITTI_IMG_STDS,
                                  jax_rangenet.KITTI_IMG_STDS)


def test_extract_features_and_labels_match_jax(released, rng):
    """Projection, normalization, a ragged last batch and the head's
    argmax, against the JAX pipeline on the same checkpoint."""
    path, _ = released
    scans = [synthetic_scan(rng, n=5000) for _ in range(3)]
    model = frd_pipeline.load_rangenet(path, device="cpu")
    jmodel, jvars = jax_pipeline.load_rangenet(path)
    kw = dict(batch_size=2, h=8, w=64)
    feats = frd_pipeline.extract_features(model, scans, **kw)
    want = jax_pipeline.extract_features(jmodel, jvars, scans, **kw)
    assert feats.shape == (3, 32, 8, 64) and feats.dtype == np.float32
    _close(feats, want.transpose(0, 3, 1, 2))
    labels = frd_pipeline.extract_labels(model, scans, **kw)
    want_l = jax_pipeline.extract_labels(jmodel, jvars, scans, **kw)
    assert labels.dtype == np.int32 and labels.shape == (3, 8, 64)
    # a label may differ only where the logits' top two are within the
    # logits' tolerance of each other
    with torch.no_grad():
        _, logits = model(torch.from_numpy(np.stack([
            frd_pipeline.project_scan(s, 8, 64) for s in scans])))
    top2 = np.sort(logits.numpy(), axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * REL * max(
        float(np.abs(top2).max()), 1.0)
    assert np.all((labels == want_l) | near_tie)
    assert frd_pipeline.extract_features(model, [], **kw).shape == (
        0, 32, 8, 64)
