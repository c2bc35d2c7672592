"""Build the port's host C++ sources with g++ into plain C shared libraries,
and load each once per process.

A library is built at first use into dfu3d_tpu_torch/csrc_build/, named by a
digest of the source and the flags, so an unchanged source is built once per
checkout. A failed build raises: no caller falls back quietly to its plain
twin.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(source: Path, build_dir: Path, stem: str) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"{stem}_{digest[:16]}.so"


def _build(source: Path, lib: Path, what: str):
    """g++ `source` into `lib` (through a temporary name, so that a process
    building the same library at the same time never loads a half-written
    file); raises RuntimeError naming `what` when g++ is missing or fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {what}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {Path(source).name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)


def load(source: Path, build_dir: Path, stem: str, what: str, signatures: dict) -> ctypes.CDLL:
    """The library built from `source`, built if missing and loaded once per
    process. `signatures` maps each exported function to its
    (restype, argtypes), set once when the library is loaded."""
    lib_path = library_path(source, build_dir, stem)
    with _lock:
        lib = _loaded.get(lib_path)
        if lib is None:
            if not lib_path.exists():
                _build(source, lib_path, what)
            lib = ctypes.CDLL(str(lib_path))
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded[lib_path] = lib
        return lib
