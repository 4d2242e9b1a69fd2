"""The control of the correctness check: the reference computed with float8
e4m3 operands in the program's place has to come out not correct, while
the program passes.

On the card (marker `cuda`) at each cell's own size, one seed a cell; on
the CPU at the tiny size of perfbench/tests/tiny.py, where the program
computes in bfloat16 as the cells' configurations state."""

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests import tiny

CELLS = [w for w in harness.load_json(
    harness.BENCH_DIR.parent / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's attention kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_control_fails_at_the_cells_size(card, cell):
    c = harness.Cell(cell)
    row = calibrate.readings(c, 2 ** 31 + 101, card, control=True)
    assert not fails(row["program"], c.spec["limits"]), row
    assert fails(row["control"], c.spec["limits"]), row


@pytest.fixture(scope="module")
def bf16_bench(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make_copy(tmp_path_factory.mktemp("bf16"), dtype="bf16")


@pytest.mark.parametrize("cell", [c for c, *_ in tiny.CELLS])
def test_control_reads_far_above_the_program_on_the_cpu(bf16_bench, cell):
    c = harness.Cell(cell, bf16_bench)
    row = calibrate.readings(c, 11, torch.device("cpu"), control=True)
    assert any(row["control"][k] >= 3 * row["program"][k]
               for k in row["program"]), row
