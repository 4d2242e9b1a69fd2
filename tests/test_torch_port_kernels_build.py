"""The kernels' build keys and shared-memory limits, on the CPU (no nvcc,
no card needed).

* A library is named after a hash of its `.cu` source, every `csrc/*.cuh`
  header and the nvcc flags (`ops/kernels.py::_target`), so that an edited
  header is rebuilt rather than loaded stale.
* The longest T each attention kernel takes (`max_seq_len`,
  `max_seq_len_bwd`) stays within 2 % of the limits of the unpadded
  layout (3632 / 7264 forward, 2152 / 3874 backward, f32 / bf16) and never
  below 2048, while the padded bf16 layout fits in one block's shared
  memory at the limit and not one tile beyond it."""

import pytest
import torch

from rangeldm_tpu_torch.ops import attention, kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "tile.cuh"\n')
    (src / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    return src


@pytest.mark.parametrize("edited", ["tile.cuh", "k.cu", "new.cuh"])
def test_build_key_follows_sources_and_headers(csrc, edited):
    before = kernels._target(csrc / "k.cu")
    assert before == kernels._target(csrc / "k.cu")
    assert before.parent == kernels.BUILD_DIR and before.name.startswith("k-")
    (csrc / edited).write_text("// v2\n")
    assert kernels._target(csrc / "k.cu") != before


def test_build_key_ignores_other_sources(csrc):
    before = kernels._target(csrc / "k.cu")
    (csrc / "other.cu").write_text("// another kernel\n")
    assert kernels._target(csrc / "k.cu") == before


def test_build_all_reports_every_source_built_or_cached(csrc, tmp_path,
                                                      monkeypatch):
    """Each source is compiled once; a later call reports the ptxas output
    kept beside the library instead of nothing."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    f'echo x >> {calls}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n'
                    'echo "ptxas info    : Used 7 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    first = kernels.build_all()
    again = kernels.build_all()
    assert first == again == {"k": "ptxas info    : Used 7 registers\n"}
    assert calls.read_text().count("x") == 1
    assert kernels._target(csrc / "k.cu").exists()


UNPADDED_LIMITS = {("fwd", torch.float32): 3632, ("fwd", torch.bfloat16): 7264,
              ("bwd", torch.float32): 2152, ("bwd", torch.bfloat16): 3874}
LIMIT_FN = {"fwd": attention.max_seq_len, "bwd": attention.max_seq_len_bwd}


@pytest.mark.parametrize("kernel,dtype", sorted(UNPADDED_LIMITS, key=str))
def test_seq_limits_do_not_fall(kernel, dtype):
    got = LIMIT_FN[kernel](dtype)
    assert got >= 2048
    assert abs(got - UNPADDED_LIMITS[kernel, dtype]) <= 0.02 * UNPADDED_LIMITS[
        kernel, dtype]


@pytest.mark.parametrize("kernel,bytes_per_key", [("fwd", 2 * 8 * 2),
                                                  ("bwd", 3 * 8 * 2 + 12)])
def test_bf16_limit_fills_shared_memory(kernel, bytes_per_key):
    """At the limit the padded rows (T rounded up to 16, plus 8) fit in
    232,448 bytes; one more tile of keys does not."""
    def padded(t):
        return -(-t // 16) * 16 + 8

    t = LIMIT_FN[kernel](torch.bfloat16)
    assert t % 16 == 0
    assert padded(t) * bytes_per_key <= attention._SMEM_BYTES
    assert padded(t + 1) * bytes_per_key > attention._SMEM_BYTES
