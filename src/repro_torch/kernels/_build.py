"""Build and load the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each kernel's source in ``csrc/`` is compiled at first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, under
``build/`` at the repository root, named ``<stem>-<hash of the source>.so``
so an edited source is rebuilt and an unchanged one is not.  The library is
loaded with ``ctypes``; the caller declares the entry points' ``argtypes``
(``c_void_p`` for every pointer and for the stream).  Nothing here runs
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/ with the CUDA toolkit")
    return path


def build_library(source: Path) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` (unless this version is built already) and load
    it.  Returns the library and the compiler's log (``-Xptxas -v``:
    registers, shared memory, spills), empty when it was built before.
    Several sources may build at once: each writes its own temporary
    file and renames it into place."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}-{tag}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib_path)), log
