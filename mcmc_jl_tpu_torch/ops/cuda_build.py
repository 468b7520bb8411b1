"""Build the package's CUDA sources into a shared library and load it.

The kernels in ``mcmc_jl_tpu_torch/csrc`` expose a plain C interface, so they
are compiled by ``nvcc`` alone (no PyTorch headers, seconds instead of
minutes) and bound with ``ctypes``.  The first use in a process builds
``csrc/<name>.cu`` into ``build/mcmc_jl_tpu_torch/<hash>/lib<name>.so`` under
the checkout, where the hash covers the sources, the flags and the compiler
path; later uses load the cached library.  A failed build raises with
``nvcc``'s output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "mcmc_jl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}
_COUNT_LOCK = threading.Lock()


def count(counts, name):
    """Add one launch to ``counts[name]``; the wrappers of a mesh's shards
    on distinct devices launch from one host thread a device."""
    with _COUNT_LOCK:
        counts[name] += 1


def find_nvcc():
    """The ``nvcc`` on PATH, else the one under PyTorch's CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (not on PATH and no CUDA_HOME): "
                       "the CUDA kernels cannot be built")


def library_path(name, nvcc):
    """Where the library built from ``csrc/<name>.cu`` with these flags lives."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless the cached library exists; returns
    (path, ptxas report or "" when cached)."""
    nvcc = find_nvcc()
    out = library_path(name, nvcc)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{name}.cu:\n{res.stderr}{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, res.stderr + res.stdout


def load(name):
    """The ``ctypes`` handle of ``lib<name>.so``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
