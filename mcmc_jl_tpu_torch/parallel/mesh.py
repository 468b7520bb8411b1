"""Device meshes: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package has one controller over many devices: a ``Mesh``,
``shard_map`` and ``psum``.  The port keeps one controller too.  A
:class:`Mesh` is an array of ``torch.device`` entries with named axes, and
a shard is a slice of the chain (or row) axis placed on its entry's device.
An entry may repeat a device (virtual shards): the CPU tests build an
8-entry mesh of ``"cpu"``, the smoke script a 4-entry mesh of ``cuda:0``.

The drivers split their batch into the groups of one axis
(:func:`axis_groups`), run each group on its device (:func:`for_each`:
groups on distinct devices concurrently, one host thread a device, groups
on one device in turn), and join the results (:func:`gather`,
:func:`concat_chains`).  Within a process nothing else joins them; the
reductions that cross shards are in :mod:`.collectives`.  Across processes
(:mod:`.multihost`) each entry also names the process that owns it: a
process runs the groups it owns an entry of, and :func:`gather` hands
every process the same global result, as JAX's global arrays do.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading

import numpy as np
import torch

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def world_size():
    """The number of processes of the ``torch.distributed`` world (1 when it
    is not initialized)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


class Mesh:
    """An n-d array of devices with named axes.

    ``devices``: a nested sequence (or ndarray) of ``torch.device`` or
    device strings; ``axis_names``: one name a dimension.  ``mesh.devices``
    is the object ndarray, ``mesh.shape`` a dict from axis name to size and
    ``mesh.axis_names`` the tuple, the surface the JAX drivers read.
    ``process_ids`` (same shape, default: this process for every entry)
    names the process that owns each entry."""

    def __init__(self, devices, axis_names, process_ids=None):
        raw = np.asarray(devices, dtype=object)
        arr = np.empty(raw.shape, dtype=object)
        for idx in np.ndindex(raw.shape):
            arr[idx] = torch.device(raw[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.process_ids = (np.full(arr.shape, _rank(), dtype=int)
                            if process_ids is None
                            else np.asarray(process_ids, dtype=int))
        if self.process_ids.shape != arr.shape:
            raise ValueError("process_ids must have the devices' shape")

    @property
    def size(self):
        return self.devices.size

    def is_local(self, idx):
        """True when this process owns entry ``idx``."""
        return int(self.process_ids[idx]) == _rank()

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh({self.shape}, devices={devs}"
                + (f", processes={sorted(set(self.process_ids.flat))}"
                   if len(set(self.process_ids.flat)) > 1 else "") + ")")


def default_devices():
    """Every visible CUDA device.  With none visible this raises: there is
    no CPU fallback, a CPU mesh is built from explicit ``"cpu"`` entries."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible and no devices were given: build the "
            "mesh from explicit devices (e.g. Mesh(['cpu'] * 8, "
            "('chains',)) on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(axis=CHAIN_AXIS, devices=None):
    """A 1-D mesh over ``devices`` (default: every visible CUDA device)
    (pchains.py ``default_mesh``)."""
    devices = default_devices() if devices is None else list(devices)
    return Mesh(devices, (axis,))


def axis_groups(mesh, axis):
    """The entries of ``mesh`` grouped by their coordinate on ``axis``:
    ``mesh.shape[axis]`` lists of index tuples, each in the order of the
    other axes (a row-major walk)."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: "
                         f"{mesh.axis_names})")
    a = mesh.axis_names.index(axis)
    others = [range(n) for i, n in enumerate(mesh.devices.shape) if i != a]
    groups = []
    for c in range(mesh.devices.shape[a]):
        members = []
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(a, c)
            members.append(tuple(idx))
        groups.append(members)
    return groups


def local_groups(mesh, axis):
    """``[(group index, device)]`` of the groups along ``axis`` of which this
    process owns an entry, each with the device of its first owned entry:
    the device the group's chains live on."""
    out = []
    for i, members in enumerate(axis_groups(mesh, axis)):
        mine = [m for m in members if mesh.is_local(m)]
        if mine:
            out.append((i, mesh.devices[mine[0]]))
    return out


def chain_axis(mesh):
    """The axis a mesh splits chains over: ``'chains'`` when it has one,
    else its first."""
    return CHAIN_AXIS if CHAIN_AXIS in mesh.shape else mesh.axis_names[0]


def split_sizes(n_chains, parts, axis=CHAIN_AXIS):
    """``n_chains // parts`` after checking that ``parts`` divides it."""
    assert n_chains % parts == 0, (
        f"n_chains ({n_chains}) must be divisible by the '{axis}' mesh axis "
        f"size ({parts})")
    return n_chains // parts


def _key(dev):
    return (dev.type, dev.index)


def for_each(fn, items):
    """``{i: fn(i, device)}`` for ``items = [(i, device), ...]``.  Items on
    distinct devices run concurrently, one host thread a device (each with
    that device current), so no shard waits for another's host
    synchronizations; items on one device run in turn, in order.  The first
    failure is raised after every thread has stopped."""
    by_dev = {}
    for i, dev in items:
        by_dev.setdefault(_key(dev), []).append((i, dev))

    def run(group):
        out = {}
        for i, dev in group:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out[i] = fn(i, dev)
            else:
                out[i] = fn(i, dev)
        return out

    if len(by_dev) <= 1 or world_size() > 1:
        # one device, or several processes whose collectives must be
        # issued in the same order everywhere: in turn, in order
        return run(list(items))
    results, errors = {}, []

    def worker(group):
        try:
            results.update(run(group))
        except BaseException as e:  # re-raised in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(g,))
               for g in by_dev.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _to_host(tree):
    """``tree`` (tensors in dicts, tuples, lists and state dataclasses) with
    every tensor copied to the host, for ``all_gather_object``."""
    from ..samplers.base import tree_map

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return tree_map(_to_host, tree)
    return tree


def gather(results, n):
    """The list of ``n`` group results from ``{i: result}`` of the groups
    this process ran.  With several processes every process receives every
    group's result (tensors through the host, ``all_gather_object``), so
    every process returns the same global result."""
    if world_size() > 1:
        import torch.distributed as dist

        everyone = [None] * world_size()
        dist.all_gather_object(everyone, {i: _to_host(r)
                                          for i, r in results.items()})
        merged = {}
        for part in everyone:
            for i, r in part.items():
                merged.setdefault(i, r)
        results = merged
    missing = [i for i in range(n) if i not in results]
    if missing:
        raise RuntimeError(f"no process ran the groups {missing}")
    return [results[i] for i in range(n)]


def _cat(parts, dim, device):
    return torch.cat([p.to(device) for p in parts], dim=dim)


def concat_chains(parts, device, dim=0):
    """Join per-group results along their chain dimension on ``device``:
    tensors, dicts of tensors (infos, ``dim`` 1 for rows stacked over
    steps), state dataclasses (``dim`` 0) and tuples of these (``dim`` a
    tuple with one entry an element)."""
    from ..samplers.base import tree_map

    first = parts[0]
    if isinstance(first, torch.Tensor):
        return _cat(parts, dim, device)
    if isinstance(first, tuple):  # ``dim`` one an element, or one for all
        dims = dim if isinstance(dim, tuple) else (dim,) * len(first)
        return tuple(concat_chains([p[k] for p in parts], device, dims[k])
                     for k in range(len(first)))
    if isinstance(first, dict):
        return {k: concat_chains([p[k] for p in parts], device, dim)
                for k in first}
    return tree_map(lambda *xs: _cat(xs, 0, device), *parts)


def split_chains(tree, n, index):
    """Slice ``index`` of ``n`` equal slices of the leading (chain)
    dimension of every tensor of ``tree`` (a tensor or a state
    dataclass)."""
    from ..samplers.base import tree_map

    def one(x):
        per = x.shape[0] // n
        return x[index * per:(index + 1) * per]

    return one(tree) if isinstance(tree, torch.Tensor) else tree_map(one,
                                                                     tree)


def to_device(tree, device):
    """``tree`` (a tensor or a state dataclass) on ``device``; unchanged
    where it is there already."""
    from ..samplers.base import tree_map

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree_map(lambda x: x.to(device), tree)


def shard_seed(seed, index):
    """The seed of shard ``index`` of a run seeded with ``seed``: the
    counterpart of ``fold_in(key, index)``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))


def shard_generators(items, seed=None, generator=None):
    """One ``torch.Generator`` a shard, ``{i: generator on device}`` for
    ``items = [(i, device), ...]``: seeded from :func:`shard_seed` of
    ``seed`` and the shard's index, or, given a ``generator``, from seeds
    drawn from it (one draw of ``max(i) + 1`` seeds, so every process of a
    multi-process run, holding the same generator, draws the same)."""
    from ..samplers.base import make_generator

    if generator is not None:
        n = max(i for i, _ in items) + 1
        seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                              device=generator.device).tolist()
    else:
        seeds = {i: shard_seed(seed, i) for i, _ in items}
    return {i: make_generator(dev, seeds[i]) for i, dev in items}


def map_chain_shards(fn, tree, mesh, device, *, axis=None, seed=None,
                     generator=None, dim=0):
    """Run ``fn(i, dev, shard, gen)`` on every chain shard of ``tree`` (a
    tensor or a state dataclass, chains first) and join the results on
    ``device``: the one split-run-join of the chain-sharded drivers.

    The chains split into ``mesh.shape[axis]`` equal slices (``axis``
    default :func:`chain_axis`; it must divide them); slice ``i`` goes to
    the device of group ``i``'s entry with its own generator ``gen``
    (:func:`shard_generators` of ``seed`` or ``generator``).  The groups
    this process owns run through :func:`for_each`, so shards on distinct
    devices never wait for each other, and every process receives every
    group's result (:func:`gather`); :func:`concat_chains` joins them along
    ``dim``."""
    axis = chain_axis(mesh) if axis is None else axis
    n = mesh.shape[axis]
    lead = tree if isinstance(tree, torch.Tensor) else tree.pars
    split_sizes(lead.shape[0], n, axis=axis)
    items = local_groups(mesh, axis)
    gens = shard_generators(items, seed=seed, generator=generator)

    def one(i, dev):
        return fn(i, dev, to_device(split_chains(tree, n, i), dev), gens[i])

    return concat_chains(gather(for_each(one, items), n), device, dim)


_CACHE_LOCK = threading.Lock()


def on_devices():
    """A per-call cache ``put(tensor, device)`` of copies of replicated
    inputs (a design matrix, a prior), one copy a device."""
    copies = {}

    def put(t, device):
        if t is None or not isinstance(t, torch.Tensor) \
                or t.device == device:
            return t
        key = (id(t), _key(device))
        with _CACHE_LOCK:
            c = copies.get(key)
            if c is None:
                c = copies[key] = t.to(device)
        return c

    return put


def group_entries(mesh, axis, items):
    """``{i: entry}``: the first entry this process owns of each group ``i``
    of ``items`` along ``axis``, the entry a group's tensors stand for in
    :mod:`.collectives`."""
    groups = axis_groups(mesh, axis)
    return {i: next(m for m in groups[i] if mesh.is_local(m))
            for i, _ in items}


def model_on(model, device):
    """``model`` evaluated on ``device``: itself when it lives there; a GLM
    rebuilt from its spec's tensors copied there; any other model with its
    ``init`` and ``scale`` moved (its functions must hold no tensors of
    another device: a callable that closes over data evaluates only on the
    device of that data)."""
    if model.device == device or (model.device.type == device.type == "cpu"):
        return model
    spec = model.glm_spec
    if spec is not None:
        from ..models.model import model as make

        put = lambda t: None if t is None else t.to(device)  # noqa: E731
        m = make(glm=(spec.kind, put(spec.X), put(spec.Y)),
                 weights=put(spec.weights), offsets=put(spec.offsets),
                 prior_prec=spec.prior_prec, device=device,
                 dtype=model.dtype)
        return dataclasses.replace(m, init=model.init.to(device),
                                   scale=model.scale.to(device))
    return dataclasses.replace(model, init=model.init.to(device),
                               scale=model.scale.to(device))
