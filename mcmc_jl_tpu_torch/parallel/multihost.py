"""Multi-process operation (port of ``mcmc_jl_tpu/parallel/multihost.py``).

The reference's cluster story is ``@everywhere using MCMC`` plus Julia
Distributed ``pmap`` (examples/parallel_serialmc.jl): closures are shipped
to workers and whole chains gathered back.  The port's is single program,
multiple processes: every process runs the same program,
``torch.distributed`` wires them into one world, and the global mesh spans
every process's devices.  A process runs the shards whose entries it owns;
the reductions that cross processes go through ``all_reduce``
(:func:`~.collectives.psum`), and the results are gathered so every process
returns the same global result.

Chains are independent, so the sampling path needs no communication; only
a data axis that spans processes, pooled adaptation and the ensemble
runners' cross-shard statistics reduce.

Typical use::

    from mcmc_jl_tpu_torch.parallel import multihost
    multihost.initialize("tcp://localhost:29500", num_processes=2,
                         process_id=rank)
    mesh = multihost.global_mesh()
    chains = mt.prun(tasks, mesh=mesh)

Every helper degrades to the one process when the world is not
initialized.
"""
from __future__ import annotations

import numpy as np
import torch

_LOCAL = {"devices": None}


def _local_devices():
    if _LOCAL["devices"] is not None:
        return list(_LOCAL["devices"])
    from .mesh import default_devices

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and torch.cuda.is_available():
        # one card a process: the process's rank picks it
        n = torch.cuda.device_count()
        return [torch.device("cuda", dist.get_rank() % n)]
    return default_devices()


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               devices=None):
    """Wire this process into a ``torch.distributed`` world (idempotent; a
    no-op for one process).  ``coordinator_address`` is the init method
    (``tcp://host:port``, or ``host:port``), ``num_processes`` the world
    size and ``process_id`` this process's rank.  ``devices`` are this
    process's devices (default: its visible CUDA device of index rank mod
    count); the backend is gloo when they are CPU devices, nccl when
    CUDA."""
    import torch.distributed as dist

    if devices is not None:
        _LOCAL["devices"] = [torch.device(d) for d in devices]
    if num_processes in (None, 1) or dist.is_initialized():
        return
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator_address "
                         "(tcp://host:port)")
    addr = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    devs = _LOCAL["devices"]
    cpu = devs is not None and all(d.type == "cpu" for d in devs) \
        or (devs is None and not torch.cuda.is_available())
    dist.init_process_group("gloo" if cpu else "nccl", init_method=addr,
                            world_size=num_processes, rank=process_id)


def global_devices():
    """``(devices, process_ids)`` of every device of every process, in rank
    order (this process's alone when the world is not initialized)."""
    import torch.distributed as dist

    from .mesh import _rank, world_size

    local = _local_devices()
    if world_size() == 1:
        return local, [_rank()] * len(local)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in local])
    devices, pids = [], []
    for rank, devs in enumerate(everyone):
        devices += [torch.device(d) for d in devs]
        pids += [rank] * len(devs)
    return devices, pids


def global_mesh(axis="chains"):
    """1-D mesh over every device of every process."""
    from .mesh import Mesh

    devices, pids = global_devices()
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, (axis,), process_ids=np.asarray(pids))


def process_chain_slice(n_chains):
    """The [start, stop) slice of the global chain axis owned by this
    process (for process-local IO of per-chain results)."""
    from .mesh import _rank, world_size

    per = n_chains // world_size()
    start = per * _rank()
    return start, start + per


def scaling_efficiency(rate_1host, rate_nhost, n_hosts):
    """samples/s scaling efficiency against linear."""
    return rate_nhost / (rate_1host * n_hosts)
