"""Time three designs of B.5's fused score-and-select on one CUDA card.

Builds ``src/repro_torch/csrc/placement_score.cu`` (the shipped
``placement_select_kernel``: one thread per four rows, an FMA penalty)
and ``tools/placement_select_designs.cu`` (``prev``: one thread per two
rows, a popcount penalty; ``warp``: one warp per row, a shuffle
reduction).  It holds the shipped kernel bit-equal to its plain version
and both other designs bit-equal to the shipped kernel at R in 24, 1,
257, 65,537 and 5,000,000 under ``max_latency_ms`` 10 and inf, then times
the three at R = 24 and R = 5,000,000 (K = 124, G = 3) with CUDA events,
in the order shipped, prev, warp, warp, prev, shipped, beside the bound
that ``chip_smoke.py`` prints for the shipped kernel.  Logs the card's
name and power limit, and prints one JSON line last.  Run from the root
of a checkout, on a machine with one card::

    python3 tools/placement_select_designs.py
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DESIGNS_CU = ROOT / "tools" / "placement_select_designs.cu"
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402  (device, timing and bound helpers)

SIZES = (24, 1, 257, 65537, 5_000_000)
TIMED = ((24, 200), (5_000_000, 20))        # (R, CUDA-event iterations)
ORDER = ("shipped", "prev", "warp", "warp", "prev", "shipped")


def build_designs() -> dict:
    """``{"prev": fn, "warp": fn}``: the C entry points of the designs'
    library, built with the port's nvcc flags into its build directory."""
    from repro_torch.kernels import build

    h = hashlib.sha256(DESIGNS_CU.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    lib = build.build_dir() / f"libplacement_select_designs-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                               str(DESIGNS_CU)], capture_output=True, text=True)
        if done.returncode != 0:
            cs.fail(f"nvcc {DESIGNS_CU.name}: {done.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("prev", "warp"):
        fn = getattr(dll, f"select_{name}_launch")
        fn.argtypes = [vp] * 6 + [ctypes.c_longlong, ci, ci, ctypes.c_float, vp, vp]
        fn.restype = ci
        fns[name] = fn
    return fns


def wrap(fn, name: str):
    """``placement_select_cuda``'s call on one of the designs."""
    import torch

    from repro_torch.kernels import build

    def call(*args, max_latency_ms: float):
        reads, rp = args[0], args[2]
        (r, g), k = reads.shape, rp.shape[0]
        out = torch.empty((3, r), dtype=torch.int32, device=reads.device)
        err = fn(*(t.data_ptr() for t in args), r, k, g, float(max_latency_ms),
                 out.data_ptr(), build.stream_ptr(reads))
        build.check(err, name)
        return out

    return call


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a card")
    from repro_torch.kernels import placement_score as pls
    from torch_port_helpers import placement_inputs

    card = cs.phase_device()["smi"]
    fns = build_designs()
    designs = {"shipped": pls.placement_select_cuda,
               "prev": wrap(fns["prev"], "prev"), "warp": wrap(fns["warp"], "warp")}
    dev = torch.device("cuda")
    for r in SIZES:
        args = placement_inputs(np.random.default_rng(r), r, dev)
        for max_lat in (10.0, float("inf")):
            want = designs["shipped"](*args, max_latency_ms=max_lat)
            if not torch.equal(want, pls.placement_select_ref(
                    *args, max_latency_ms=max_lat)):
                cs.fail(f"shipped R={r} max_lat={max_lat}: differs from the plain version")
            for name in ("prev", "warp"):
                if not torch.equal(designs[name](*args, max_latency_ms=max_lat), want):
                    cs.fail(f"{name} R={r} max_lat={max_lat}: differs from the shipped kernel")
        del args
    cs.log(f"[designs] shipped, prev, warp bit-equal at R in {SIZES} x max_lat 10, inf")

    results = {}
    for r, iters in TIMED:
        args = placement_inputs(np.random.default_rng(r), r, dev)
        k, g = args[2].shape
        n_bytes = 2 * r * g * 4 + (3 * k * g + 2 * k) * 4 + 3 * r * 4
        n_ops = r * k * (4 * g + 5) + 2 * r * g + k * (g + 1)
        bound, by = cs.bound_ms(n_bytes, n_ops)
        ms = {name: [] for name in designs}
        for name in ORDER:
            ms[name].append(cs.cuda_time_ms(
                lambda f=designs[name]: f(*args, max_latency_ms=10.0), iters))
        results[f"R={r}"] = {
            "shape": f"R={r}, K={k}, G={g}", "bound_ms": bound, "bound_by": by,
            **{name: {"ms": t, "bound_share": [bound / x for x in t]}
               for name, t in ms.items()}}
        cs.log(f"[designs] R={r}: bound {bound:.6f} ms ({by}); " + "; ".join(
            f"{name} " + " / ".join(f"{x:.6f}" for x in t) + " ms"
            for name, t in ms.items()))
        del args
    print(json.dumps({"placement_select_designs": results, "card": card}))


if __name__ == "__main__":
    main()
