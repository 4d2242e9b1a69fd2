"""The benchmark of rangeldm_tpu_torch on one NVIDIA H100, one cell a run:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON line on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`
(and with --trace 1 `breakdown`), and last `checks`, each number of the
correctness check beside its limit, which also end standard error. Exits
non-zero with no result line when there is no CUDA card, too few for the
cell, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# import perfbench and the program from the checkout, not from perfbench/
sys.path[0] = str(ROOT)
# the caches of the program's toolchains stay inside the checkout, at
# fixed paths (the program builds its CUDA kernels into its own _build/)
CACHE = ROOT / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    import torch

    chips = int(harness.load_json(HERE / "workloads" /
                                  f"{args.workload}.json")["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              f"visible", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda",
                         t_start=T_START, count=chips)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for line in harness.checks_text(
            [(k, v["value"], v["limit"]) for k, v in
             result["checks"].items()]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
