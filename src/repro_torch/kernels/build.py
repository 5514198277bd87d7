"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``src/repro_torch/**/csrc/`` becomes one shared
library with a plain C interface, compiled for ``sm_90a`` into
``build/torch_kernels/`` at the repository root on first use.  The file
name carries a hash of the source, the headers beside it (``*.cuh``) and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for every one.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]            # src/repro_torch
ROOT = _PKG.parents[1]                                 # repository root
BUILD_DIR = ROOT / "build" / "torch_kernels"
SOURCES = {
    "lstm_fwd": _PKG / "kernels" / "csrc" / "lstm_fwd.cu",
    "lstm_bwd": _PKG / "kernels" / "csrc" / "lstm_bwd.cu",
    "lstm_bwd_chunked": _PKG / "kernels" / "csrc" / "lstm_bwd_chunked.cu",
    "lstm_stack": _PKG / "kernels" / "csrc" / "lstm_stack.cu",
    "beam_step": _PKG / "decode" / "csrc" / "beam_step.cu",
    "decode_attention": _PKG / "kernels" / "csrc" / "decode_attention.cu",
    "argmax": _PKG / "decode" / "csrc" / "argmax.cu",
    "ssd_scan": _PKG / "kernels" / "csrc" / "ssd_scan.cu",
    "flash_attention": _PKG / "kernels" / "csrc" / "flash_attention.cu",
    "moe_dense": _PKG / "kernels" / "csrc" / "moe_dense.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

_LIBS: dict = {}


def cuda_tool(name: str = "nvcc") -> str:
    """The path of the CUDA toolkit's program ``name`` (``nvcc``,
    ``cuobjdump``): under ``$CUDA_HOME/bin`` (default /usr/local/cuda),
    else on PATH; raises where neither has it."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / name
    if path.exists():
        return str(path)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on "
                           f"PATH)")
    return found


def lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def build(names=None) -> dict:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` each, in parallel.  Returns ``{name: seconds}`` for
    the ones compiled now; raises with the compiler's output on failure."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or cuda_tool()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_bytes(log)
        if proc.returncode == 0:
            os.replace(tmp, out)          # atomic: readers never see a partial
        else:
            failed.append(f"{name} (rc {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
