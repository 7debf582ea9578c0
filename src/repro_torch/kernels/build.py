"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``lib<name>-<hash>.so`` for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so an edited kernel rebuilds.
The first kernel requested builds every kernel whose library is missing,
one ``nvcc`` process per source, all started together.  Libraries go to
``build/kernels/`` at the root of the source checkout (listed in
``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR``.  Every C entry point
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("op_ingest", "vclock_audit", "vclock_chain", "digest_compare",
           "histogram", "placement_score", "policy_score", "session_floor",
           "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> {"seconds": float, "log": str} for builds made in this process.
BUILD_LOG: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        pathlib.Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and pathlib.Path(c).exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS, *, force: bool = False) -> dict[str, dict]:
    """Compile ``names`` in parallel; returns ``BUILD_LOG`` entries."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            continue
        exe = exe or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: BUILD_LOG[n] for n in procs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _LOCK:
        if name not in _LIBS:
            if not lib_path(name).exists():
                build(KERNELS)
            _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        return _LIBS[name]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer (the
    raw handle, without building a ``torch.cuda.Stream``: a few
    microseconds less per launch)."""
    global _RAW_STREAM
    if _RAW_STREAM is None:
        import torch

        _RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", False)
    if _RAW_STREAM:
        return _RAW_STREAM(t.get_device())
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


_RAW_STREAM = None
