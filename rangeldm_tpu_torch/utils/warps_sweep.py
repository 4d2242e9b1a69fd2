"""Time the bf16 attention kernels built with other block sizes, on the card.

    python -m rangeldm_tpu_torch.utils.warps_sweep [WARPS ...]

Copies `csrc/attention_fwd.cu` and `attention_bwd.cu` into
`rangeldm_tpu_torch/_build/sweep/` with `kWarps` (warps a block, 16 rows
each) set to each given value (default 4, 8 and 16), builds them with the
package's nvcc flags, one process each, all started together, and times
every copy's forward and backward with CUDA events at the flagship UNet's
bf16 shapes at batch 4 and 32, in two rounds, alternating the copies. Each
copy's outputs are held against the plain versions. Prints one JSON line
per shape and the card's name, power limit and highest SM clock. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from rangeldm_tpu_torch.ops import attention, kernels

SHAPES = [(64, 8, 1024), (128, 8, 256), (128, 8, 64), (512, 8, 1024),
          (1024, 8, 256), (1024, 8, 64)]
BWD_TOL = 3e-2           # of the largest entry, as in chip_smoke.py
FWD_TOL = 3e-2


def _build(warps):
    """{(warps, kernel): C entry point} of every copy."""
    out = kernels.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = []
    for w in warps:
        for name in (attention.KERNEL, attention.BWD_KERNEL):
            src = (kernels.CSRC / f"{name}.cu").read_text()
            line = "constexpr int kWarps = "
            start = src.index(line) + len(line)
            src = src[:start] + str(w) + src[src.index(";", start):]
            path = out / f"{name}_{w}.cu"
            path.write_text(src)
            so = out / f"{name}_{w}.so"
            jobs.append((w, name, so, subprocess.Popen(
                [kernels._nvcc(), *flags, "-I", str(kernels.CSRC), "-o",
                 str(so), str(path)])))
    fns = {}
    for w, name, so, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name} with {w} warps")
        fn = getattr(ctypes.CDLL(str(so)), name)
        n_ptr, n_scale = (4, 1) if name == attention.KERNEL else (8, 2)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_float] * n_scale + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[w, name] = fn
    return fns


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("warps_sweep: no CUDA device", file=sys.stderr)
        return 1
    warps = [int(w) for w in (argv if argv is not None else sys.argv[1:])]
    warps = warps or [4, 8, 16]
    fns = _build(warps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 8 ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        n, d, t = shape
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        stats = torch.empty((n, 3, t), device="cuda")
        want = attention.attention_t_reference(q, k, v, scale)
        want_bwd = attention.attention_bwd_t_reference(q, k, v, g, scale)
        ptrs = [u.data_ptr() for u in (q, k, v)]
        bwd_ptrs = ptrs + [u.data_ptr() for u in (g, dq, dk, dv, stats)]
        times = {w: {"fwd_ms": [], "bwd_ms": []} for w in warps}
        for _ in range(2):
            for w in warps:
                def fwd():
                    kernels.check(fns[w, attention.KERNEL](
                        *ptrs, out.data_ptr(), n, d, t, 1,
                        scale * attention.LOG2E, stream), attention.KERNEL)

                def bwd():
                    kernels.check(fns[w, attention.BWD_KERNEL](
                        *bwd_ptrs, n, d, t, 1, scale * attention.LOG2E,
                        scale, stream), attention.BWD_KERNEL)
                times[w]["fwd_ms"].append(_ms(fwd, 50))
                times[w]["bwd_ms"].append(_ms(bwd, 30))
                if (out.float() - want.float()).abs().max() > FWD_TOL:
                    raise AssertionError(f"forward, {w} warps, {shape}")
                for a, b in zip((dq, dk, dv), want_bwd):
                    err = (a.float() - b.float()).abs().max()
                    if err > BWD_TOL * b.float().abs().max():
                        raise AssertionError(f"backward, {w} warps, {shape}")
        print(json.dumps({"shape": list(shape), "dtype": "bfloat16",
                          "ms_by_warps": times}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
