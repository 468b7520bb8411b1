"""Cross-shard reductions and pooled adaptation (port of
``mcmc_jl_tpu/parallel/collectives.py``).

The reference adapts each chain's step size from its own acceptance counts
(EmpMCTuner, samplers.jl:31-50; dual averaging, HMCDA.jl/NUTS.jl).  With
many chains the adaptation can be *pooled* across the chain axis: after
every step the adapted scalars (step sizes, dual-averaging statistics) are
replaced by their cross-chain (geometric) mean, which cuts adaptation noise
by about sqrt(n_chains) and keeps every chain's control flow identical.
Counters (accepted/proposed) stay per chain: each chain's local rate feeds
its local update, and pooling the resulting step sizes does the averaging.

The port has one reduction primitive, :func:`psum`, the counterpart of
``jax.lax.psum``: it sums each group's per-shard tensors in a fixed shard
order on the group's first device and hands every shard the result; in a
multi-process world it all-reduces the process's partial with
``torch.distributed.all_reduce``.  :func:`all_gather` is a ``psum`` of
zero-padded slots.  Every ``psum`` adds one a group to ``PSUMS[(axis,
shape, dtype)]``, as ``LAUNCHES`` counts kernels: the port's stand-in for
the collective counts of a compiled XLA program.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..samplers.base import TuneState

# fields pooled with a geometric mean (positive scales)
_GEO_FIELDS = ("leap_step", "dual_leap_step", "epsilon")
# fields pooled with an arithmetic mean
_ARITH_FIELDS = ("dual_h", "hbar", "lebar")

#: reductions issued, one a group a call, keyed by (axis, per-shard shape,
#: dtype)
PSUMS = {}
_LOCK = threading.Lock()


def reset_counts():
    """Zero the reduction counter."""
    with _LOCK:
        PSUMS.clear()


def psum_count(axis=None):
    """The reductions issued over ``axis`` (every axis when None)."""
    with _LOCK:
        return sum(n for (a, _, _), n in PSUMS.items()
                   if axis is None or a == axis)


def _pooled(v, rule):
    """The cross-chain pool of ``v`` (chains first) broadcast to its shape."""
    if rule == "geo":
        return torch.exp(torch.mean(torch.log(v), dim=0)).expand(
            v.shape).clone()
    if rule == "max":
        return torch.amax(v, dim=0).expand(v.shape).clone()
    return torch.mean(v, dim=0).expand(v.shape).clone()


def pooled_fields(states):
    """``[(path, rule)]`` of the adaptation fields ``states`` carries:
    ``tune.step_size`` (geometric) and ``tune.n_leaps`` (max) of a
    ``TuneState``, then the geometric and arithmetic fields."""
    out = []
    if isinstance(getattr(states, "tune", None), TuneState):
        out += [("tune.step_size", "geo"), ("tune.n_leaps", "max")]
    out += [(f, "geo") for f in _GEO_FIELDS if hasattr(states, f)]
    out += [(f, "arith") for f in _ARITH_FIELDS if hasattr(states, f)]
    return out


def get_field(states, path):
    """The field of ``states`` at a dotted ``path`` (``"tune.step_size"``)."""
    for p in path.split("."):
        states = getattr(states, p)
    return states


def pool_tuner_states(states, full=None):
    """Average the adaptation state across the leading chain axis and
    broadcast the pooled values back to every chain; ``states`` unchanged
    for samplers without adaptation state.

    ``full`` (``{path: tensor}``, from :func:`all_gather` on a mesh) gives
    each field over every chain of the run, of which ``states`` holds a
    shard: the pool is computed from it, identically on every shard, and
    broadcast to this shard's shape."""
    fields = pooled_fields(states)
    if not fields:
        return states
    pooled = {}
    for path, rule in fields:
        local = get_field(states, path)
        src = local if full is None else full[path].to(local.device)
        pooled[path] = _pooled(src, rule)[:1].expand(local.shape).clone()
    updates = {k: v for k, v in pooled.items() if "." not in k}
    if "tune.step_size" in pooled:
        t = states.tune
        updates["tune"] = TuneState(step_size=pooled["tune.step_size"],
                                    n_leaps=pooled["tune.n_leaps"],
                                    accepted=t.accepted, proposed=t.proposed)
    return states.replace(**updates)


def _world_allreduce(t, members, mesh):
    """All-reduce ``t`` across the processes owning ``members`` (every
    process of the world, or just this one)."""
    owners = {int(mesh.process_ids[m]) for m in members}
    if len(owners) <= 1:
        return t
    import torch.distributed as dist

    if len(owners) != dist.get_world_size():
        raise NotImplementedError(
            "a reduction group that spans some but not all processes needs "
            "a process subgroup, which the port's meshes do not build: lay "
            "the mesh out so each group is within one process or spans "
            "them all")
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def psum(parts, mesh, axis):
    """Sum over ``axis``: ``parts`` maps mesh entries (index tuples) to
    per-shard tensors of one shape (those of the entries this process
    owns); returns ``{entry: sum over its group}`` on each entry's device.

    Each group (the entries that differ only in their ``axis`` coordinate)
    sums its tensors in the order of that coordinate on the device of its
    first entry; across processes each sums its own and ``all_reduce``
    adds the partials.  One count a group in ``PSUMS``."""
    a = mesh.axis_names.index(axis)
    groups = {}
    for idx in np.ndindex(mesh.devices.shape):  # row-major: ``a`` ascends
        groups.setdefault(idx[:a] + idx[a + 1:], []).append(idx)
    out = {}
    for members in groups.values():
        mine = [m for m in members if m in parts]
        if not mine:
            continue
        dev = parts[mine[0]].device
        total = parts[mine[0]]
        for m in mine[1:]:
            total = total + parts[m].to(dev)
        if len(mine) == 1:  # a tensor of its own: all_reduce writes in place
            total = total.clone()
        total = _world_allreduce(total, members, mesh)
        key = (axis, tuple(total.shape), str(total.dtype).replace(
            "torch.", ""))
        with _LOCK:
            PSUMS[key] = PSUMS.get(key, 0) + 1
        for m in mine:
            out[m] = total if parts[m].device == dev \
                else total.to(parts[m].device)
    return out


def all_gather(parts, mesh, axis):
    """The concatenation over ``axis`` of each group's equal-shaped
    per-shard tensors (their leading dimension), on every entry: one
    :func:`psum` of the tensors placed in zero-padded slots (bool tensors
    travel as uint8).  Exact: every slot adds zeros to one value."""
    a = mesh.axis_names.index(axis)
    n = mesh.devices.shape[a]
    slots = {}
    for m, t in parts.items():
        x = t.to(torch.uint8) if t.dtype == torch.bool else t
        per = x.shape[0]
        slot = torch.zeros((n * per,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        slot[m[a] * per:(m[a] + 1) * per] = x
        slots[m] = slot
    out = psum(slots, mesh, axis)
    return {m: (v.to(torch.bool) if parts[m].dtype == torch.bool else v)
            for m, v in out.items()}
