"""The port stands alone: no module of `rangeldm_tpu_torch`, nor
chip_smoke.py, imports JAX, Flax, the JAX package or PyYAML (the machine
with the card has none of them), and importing the whole package leaves
them unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rangeldm_tpu", "yaml"}


def _sources():
    files = sorted((ROOT / "rangeldm_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(tree):
    """Every module name an import statement or an import call names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.name for p in _sources()}
    assert {"attention.py", "unet.py", "vae.py", "samplers.py", "api.py",
            "sample_ldm.py", "convert.py", "chip_smoke.py", "train_ldm.py",
            "ldm_trainer.py", "train_state.py", "ema.py", "loggers.py",
            "config.py", "datasets.py", "projection.py", "sensors.py",
            "conditions.py", "sample_conditional.py", "mae.py",
            "checkpoint.py", "latent_cache.py", "image_logger.py",
            "evaluate.py", "parity_gate.py", "laserscan.py", "histogram.py",
            "mmd.py", "jsd.py", "frd.py", "rangenet.py", "knn.py",
            "frd_pipeline.py", "chamfer.py", "precision.py",
            "discriminator.py", "lpips.py", "vae_trainer.py", "train_vae.py",
            "eval_vae.py", "mesh.py", "spatial.py", "sharded_vae.py",
            "sliced.py", "experimental.py", "profiling.py",
            "event_file.py"} <= names
    assert (ROOT / "rangeldm_tpu_torch" / "native" / "__init__.py") in set(
        _sources())


CLIS = {"sample_ldm", "sample_conditional", "train_ldm", "train_vae",
        "eval_vae", "evaluate", "parity_gate"}
LAYERS = ("pipelines", "metrics", "training", "models", "data", "geometry",
          "parallel", "utils", "ops", "diffusion", "native")


def test_no_layer_imports_a_command_line():
    """The arrows point one way: no module of the package's layers, nor
    convert.py, imports a top-level CLI module, by any import form."""
    pkg = ROOT / "rangeldm_tpu_torch"
    files = [pkg / "convert.py"] + sorted(
        f for layer in LAYERS for f in (pkg / layer).rglob("*.py"))
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                # relative imports are read from the package's root
                base = ".".join(["rangeldm_tpu_torch"] * bool(node.level)
                                + [node.module] * bool(node.module))
                names = {base} | {f"{base}.{a.name}" for a in node.names}
            else:
                continue
            bad += [f"{path.relative_to(pkg)}:{node.lineno} {n}"
                    for n in sorted(names)
                    if n.split(".")[:2] in (["rangeldm_tpu_torch", c]
                                            for c in CLIS)]
    assert len(files) > 50
    assert not bad, bad


def _run(code_or_args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rangeldm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'rangeldm_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 63


def test_conditional_sampling_cli_starts_as_a_module():
    proc = _run(["-m", "rangeldm_tpu_torch.sample_conditional", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--mode" in proc.stdout


def test_training_cli_starts_as_a_module():
    proc = _run(["-m", "rangeldm_tpu_torch.train_ldm", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--cfg" in proc.stdout and "--device" in proc.stdout


def test_sampling_cli_starts_as_a_module():
    """`python -m rangeldm_tpu_torch.sample_ldm` imports cleanly."""
    proc = _run(["-m", "rangeldm_tpu_torch.sample_ldm", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--pipeline" in proc.stdout


@pytest.mark.parametrize("module,flags", [
    ("evaluate", ("--device", "--frd", "--rangenet", "--limit")),
    ("parity_gate", ("--device", "--weights", "--skip_sampling",
                     "--gate_frd"))])
def test_scoring_clis_start_as_modules(module, flags):
    proc = _run(["-m", f"rangeldm_tpu_torch.{module}", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert all(flag in proc.stdout for flag in flags)


@pytest.mark.parametrize("module,flags", [
    ("train_vae", ("--cfg", "--max_steps", "--device")),
    ("eval_vae", ("--vae", "--data", "--count", "--device"))])
def test_vae_clis_start_as_modules(module, flags):
    proc = _run(["-m", f"rangeldm_tpu_torch.{module}", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert all(flag in proc.stdout for flag in flags)


def test_instantiate_maps_jax_targets_without_importing_jax():
    """A config's `target:` in the JAX package builds the port's
    counterpart, and neither JAX nor the JAX package gets imported."""
    code = (
        "import sys\n"
        "from rangeldm_tpu_torch.utils.config import instantiate\n"
        "m = instantiate({'target': 'rangeldm_tpu.models.discriminator."
        "NLayerDiscriminatorMetaKernel', 'params': {'ndf': 8}})\n"
        "assert type(m).__module__ == 'rangeldm_tpu_torch.models."
        "discriminator', type(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_the_new_modules_load_no_jax():
    """The spatial parallelism, the research modules, the profiling hooks
    and the converters of this slice, each imported alone."""
    code = (
        "import sys\n"
        "from rangeldm_tpu_torch.parallel.spatial import (\n"
        "    shard_azimuth, gather_azimuth, halo_exchange_w,\n"
        "    halo_conv_local, sharded_circular_conv2d)\n"
        "from rangeldm_tpu_torch.parallel.sharded_vae import (\n"
        "    sharded_vae_decode, sharded_vae_encode)\n"
        "from rangeldm_tpu_torch.models.sliced import (\n"
        "    SlicedConv, SlicedDownsample, SlicedUpsample,\n"
        "    SlicedResnetBlock, SlicedConfig, SlicedEncoder, SlicedDecoder)\n"
        "from rangeldm_tpu_torch.models.experimental import (\n"
        "    EdgeConv, EdgeConvResnetBlock, range_downsample, PerRowConv,\n"
        "    SparseRangeImageEncoder)\n"
        "from rangeldm_tpu_torch.utils.profiling import (\n"
        "    maybe_trace, step_annotation, trace_op_breakdown,\n"
        "    device_memory_stats)\n"
        "from rangeldm_tpu_torch.convert import (\n"
        "    sliced_state_dict_from_jax, experimental_state_dict_from_jax)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["sample_ldm", "sample_conditional",
                                    "parity_gate"])
def test_sampling_clis_take_a_local_mesh(module):
    proc = _run(["-m", f"rangeldm_tpu_torch.{module}", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--mesh_devices" in proc.stdout

