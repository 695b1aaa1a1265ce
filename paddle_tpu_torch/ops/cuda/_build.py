"""Build the port's CUDA sources into shared libraries and load them.

Every ``paddle_tpu_torch/csrc/*.cu`` file compiles on its own, with a plain
C interface, into ``paddle_tpu_torch/csrc/build/<stem>-<hash>.so``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The hash covers the source text and the flags, so an edited source
rebuilds and an unchanged one is reused. All sources that need a build are
compiled at once, one ``nvcc`` process each. ``nvcc`` comes from the CUDA
toolkit that PyTorch finds (``CUDA_HOME``) or from ``PATH``. Nothing here
runs at import time: the first :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put the CUDA toolkit's bin "
            "directory on PATH); the port's kernels are built from "
            f"{CSRC} on first use")
    return found


def _lib_path(source):
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build_all(sources=None):
    """Compile every source (default: all ``csrc/*.cu``) whose library is
    missing, one ``nvcc`` per source, all started together. Returns
    ``{stem: (library path, compiler log)}``; the log holds ``ptxas``'s
    register and shared-memory report. Raises if any build fails."""
    if sources is None:
        sources = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                         if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, out = [], {}
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = _lib_path(src)
        if os.path.exists(lib):
            out[stem] = (lib, "")
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, lib, tmp, proc))
    failed = []
    for stem, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic publish: concurrent builders agree
        out[stem] = (lib, log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(stem):
    """The ``ctypes.CDLL`` of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path, _ = build_all([os.path.join(CSRC, stem + ".cu")])[stem]
            lib = _libs[stem] = ctypes.CDLL(path)
        return lib
