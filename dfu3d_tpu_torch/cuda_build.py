"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each kernel module names its source and its extra nvcc flags. A source is
compiled for sm_90a into a plain C shared library under
dfu3d_tpu_torch/csrc_build/, named by a digest of the source and the flags,
so an unchanged source is built once per checkout. `build` starts one nvcc
per missing library, all at once, and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "csrc_build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(source: Path, flags=()) -> Path:
    flags = (*BASE_FLAGS, *flags)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(*specs) -> list:
    """Compile each (source, extra_flags) whose library is not built yet, all
    nvcc processes running at once; returns the libraries' paths in order."""
    libs = [_library_path(src, flags) for src, flags in specs]
    jobs = []
    for (src, flags), lib in zip(specs, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *BASE_FLAGS, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((proc, tmp, lib))
    errors = []
    for proc, tmp, lib in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {lib.name} ({proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(source: Path, flags, symbol: str, argtypes):
    """Build if needed, load the library and return its C function `symbol`,
    typed with `argtypes` and an int (cudaError_t) result."""
    fn = getattr(ctypes.CDLL(str(build((source, flags))[0])), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
