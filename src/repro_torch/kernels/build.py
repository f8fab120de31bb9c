"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is one kernel library with a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/lib<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source and every ``csrc/*.cuh`` it may include, and
loaded with ``ctypes``. ``build_all`` compiles every library at once, one
``nvcc`` process per source. No library links ``-lcuda``: K4 encodes its
tensor maps with ``cuTensorMapEncodeTiled`` of the CUDA driver API, which
it looks up at run time through the CUDA runtime
(``cudaGetDriverEntryPointByVersion``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Tuple

__all__ = ["KERNEL_SOURCES", "build_kernel", "build_all", "load_kernel"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("spmm_accel", "spmm_windowed", "spmm_hbm", "grouped_matmul")

_locks: Dict[str, threading.Lock] = {n: threading.Lock() for n in KERNEL_SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled from "
                       "src/repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def build_kernel(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` for ``sm_90a`` (once per source content)
    and return the library path and the compiler's ``-Xptxas -v`` report."""
    if name not in _locks:
        raise ValueError(f"unknown kernel source {name!r}; one of "
                         f"{'|'.join(KERNEL_SOURCES)}")
    source = _CSRC / f"{name}.cu"
    digest = hashlib.blake2b(source.read_bytes(), digest_size=8)
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib_path = _BUILD_DIR / f"lib{name}-{digest.hexdigest()}.so"
    log_path = lib_path.with_suffix(".log")
    with _locks[name]:
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", str(_CSRC), "-o", str(tmp),
                   str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        log = log_path.read_text() if log_path.exists() else ""
    return lib_path, log


def build_all() -> Dict[str, Tuple[Path, str]]:
    """Compile every kernel library, all ``nvcc`` processes at once."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {n: pool.submit(build_kernel, n) for n in KERNEL_SOURCES}
        return {n: f.result() for n, f in futures.items()}


def load_kernel(name: str,
                declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use;
    ``declare`` sets the ``argtypes`` and ``restype`` of its functions."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path, _ = build_kernel(name)
    with _locks[name]:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _libs[name] = lib
    return _libs[name]
