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


def free_bytes(device):
    """Bytes the card of ``device`` can still give: the driver's free memory
    and what PyTorch's allocator holds unused; None off the card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def nbytes_of(*tensors):
    """Bytes of memory that ``tensors`` hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def scratch_buffer(cache, key, nbytes, device, slice_bytes, reserve):
    """(buffer, bytes) of a kernel's scratch in device memory: one float32
    buffer for each ``key`` of ``cache``, allocated once and grown when a
    launch needs more than it holds; the old buffer goes before the new one
    is made.  A growth takes the launch's whole request ``nbytes`` (a slice
    of ``slice_bytes`` for each block it runs at once) when the card can
    give it and ``reserve`` bytes besides: the launch's outputs and
    collected rows, which the run's next launch allocates again while these
    are still held.  Only when it cannot does the buffer take fewer whole
    slices, as many as fit there and one at least; the kernels run no more
    blocks than the buffer holds slices for (they check the size they are
    given), so fewer blocks walk the same tiles in turn."""
    import torch

    buf = cache.get(key)
    have = 0 if buf is None else 4 * buf.numel()
    if have >= nbytes:
        return buf, have
    free = free_bytes(device)
    if free is not None and nbytes > free + have - reserve:
        nbytes = max((free + have - reserve) // slice_bytes * slice_bytes,
                     slice_bytes)
        if have >= nbytes:
            return buf, have
    cache.pop(key, None)
    del buf
    buf = cache[key] = torch.empty(-(-nbytes // 4), dtype=torch.float32,
                                   device=device)
    return buf, 4 * buf.numel()


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
