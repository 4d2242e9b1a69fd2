"""The port's profiling hooks (rangeldm_tpu_torch/utils/profiling.py:
maybe_trace, step_annotation, trace_op_breakdown, device_memory_stats), the
counterparts of the JAX package's (rangeldm_tpu/utils/profiling.py), on the
CPU: the trace falls back to the host's operators, as JAX's falls back to
its host plane (tests/test_profiling.py)."""

import os

import pytest
import torch

from rangeldm_tpu_torch.utils.profiling import (
    GROUPS, device_memory_stats, maybe_trace, step_annotation,
    trace_op_breakdown,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def work(steps=3):
    x = torch.ones(256, 256)
    y = x
    for _ in range(steps):
        with step_annotation("step"):
            y = torch.tanh(y @ x) @ x
    return y


@pytest.mark.parametrize("enabled,log_dir", [(False, "trace"), (True, ""),
                                             (True, None)])
def test_maybe_trace_disabled_writes_nothing(tmp_path, monkeypatch, enabled,
                                             log_dir):
    monkeypatch.chdir(tmp_path)
    with maybe_trace(log_dir and str(tmp_path / log_dir), enabled=enabled):
        work(1)
    assert not os.listdir(tmp_path)


def test_trace_op_breakdown_of_a_trace(tmp_path):
    with maybe_trace(str(tmp_path / "trace"), enabled=True):
        work()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")

    bd = trace_op_breakdown(str(tmp_path),
                            groups={"matmul": ("matmul", "aten::mm"),
                                    "nothing": ("no_such_op_name",)})
    assert set(bd) == {"plane", "total_ms", "groups", "events", "top_ops"}
    assert bd["plane"] == "/host:cpu"          # no card: the host's ops
    assert bd["total_ms"] > 0
    assert bd["groups"]["matmul"] > 0          # the six products dominate
    assert bd["events"] == {"matmul": 6, "nothing": 0}
    assert bd["groups"]["nothing"] == 0
    assert bd["groups"]["matmul"] <= bd["total_ms"]
    assert bd["top_ops"] and bd["top_ops"][0][1] >= bd["top_ops"][-1][1]
    # the annotations are ranges, not operators
    assert not any(name == "step" for name, _ in bd["top_ops"])


def test_trace_op_breakdown_default_groups(tmp_path):
    """Without groups, the step profile's table: every op in one group of
    GROUPS or in "other"."""
    with maybe_trace(str(tmp_path), enabled=True):
        work()
    bd = trace_op_breakdown(str(tmp_path))
    assert list(bd["groups"]) == [g for g, _ in GROUPS] + ["other"]
    assert sum(bd["groups"].values()) == pytest.approx(bd["total_ms"],
                                                       abs=0.05)
    assert bd["groups"]["other"] > 0      # aten::mm is no kernel name
    assert sum(bd["events"].values()) >= 6


def test_trace_op_breakdown_empty_or_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_op_breakdown(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        trace_op_breakdown(str(tmp_path))


def test_device_memory_stats_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}
