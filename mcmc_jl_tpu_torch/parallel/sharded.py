"""Mesh-sharded chain engine with a data-sharded likelihood (port of
``mcmc_jl_tpu/parallel/sharded.py``).

The reference's only scale axes are chains and the data rows of the
likelihood, so the mesh is 2-D::

    mesh = ('chains', 'data')

- **chains** is data parallelism over independent chains (the reference's
  ``prun`` process pool, runners.jl:35-42): each chain group runs on its
  own device with its own stream;
- **data** shards the likelihood's observation rows: each entry of a chain
  group evaluates the log-likelihood and gradient of its rows, and ONE
  :func:`~.collectives.psum` over ``'data'`` of the packed ``[g | ll]``
  joins them a gradient.

Where the JAX package rebuilds the model inside a ``shard_map`` body around
the local shard, the port's single controller builds one model a chain
group (:class:`ShardGroup`) whose evaluation visits every data entry of
the group, so every generic sampler runs unchanged on sharded data.  The
JAX pitfall holds here as well: the gradient is summed explicitly, beside
the log-likelihood, and the prior is counted once, outside the sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.model import LogDensityModel, _sanitize_allg
from ..samplers.base import RunCtx
from .collectives import psum
from .mesh import (CHAIN_AXIS, DATA_AXIS, Mesh, axis_groups, concat_chains,
                   for_each, gather, local_groups, shard_generators,
                   split_sizes)


def make_mesh(n_chain_devices=None, n_data_devices=1, devices=None):
    """A ``('chains', 'data')`` mesh over ``devices`` (default: every device
    of the run: the visible CUDA devices, or with several processes every
    process's devices, :func:`~.multihost.global_devices`)."""
    pids = None
    if devices is None:
        from .multihost import global_devices

        devices, pids = global_devices()
    devices = list(devices)
    if n_chain_devices is None:
        n_chain_devices = len(devices) // n_data_devices
    n = n_chain_devices * n_data_devices
    if n > len(devices) or n < 1:
        raise ValueError(f"a ({n_chain_devices}, {n_data_devices}) mesh "
                         f"needs {n} devices, {len(devices)} given")
    devs = np.empty(n, dtype=object)
    devs[:] = devices[:n]
    return Mesh(devs.reshape(n_chain_devices, n_data_devices),
                (CHAIN_AXIS, DATA_AXIS),
                process_ids=None if pids is None
                else np.asarray(pids[:n]).reshape(n_chain_devices,
                                                  n_data_devices))


@dataclasses.dataclass
class ShardGroup:
    """The data of one chain group of a ``('chains', 'data')`` mesh: for each
    entry of the group this process owns, the tuple of its row shards on
    that entry's device.  ``device`` is where the group's chains live (its
    first owned entry's)."""

    mesh: Any
    entries: Tuple[tuple, ...]
    data: Dict[tuple, tuple]

    @property
    def device(self):
        return self.mesh.devices[self.entries[0]]


def shard_data(data, mesh, group, data_specs=None):
    """The :class:`ShardGroup` of chain group ``group``: every array of
    ``data`` split along its first dimension over ``'data'`` (or, where
    ``data_specs`` holds None for it, whole on every entry), each shard on
    its entry's device."""
    n_d = mesh.shape[DATA_AXIS]
    specs = data_specs if data_specs is not None else (DATA_AXIS,) * len(
        data)
    members = [m for m in axis_groups(mesh, CHAIN_AXIS)[group]
               if mesh.is_local(m)]
    a = mesh.axis_names.index(DATA_AXIS)
    out = {}
    for m in members:
        dev = mesh.devices[m]
        out[m] = tuple(
            (torch.tensor_split(d, n_d)[m[a]] if s == DATA_AXIS else d)
            .to(dev) for d, s in zip(data, specs))
    return ShardGroup(mesh, tuple(members), out)


def sharded_glm_model(loglik_shard, prior, size, init, scale=1.0):
    """A factory ``make(group) -> LogDensityModel`` whose likelihood is
    data-sharded.

    ``loglik_shard(theta, *row_shards) -> scalar`` is the log-likelihood of
    one entry's rows at one parameter vector ``theta`` (d,); ``prior(theta)
    -> scalar`` is counted once, added after the sum.  ``make`` takes a
    :class:`ShardGroup` (:func:`shard_data`) and returns a model on its
    device whose ``evalallg`` evaluates every entry's rows for all chains
    (``torch.func`` value and gradient, vmapped over chains), packs ``[g |
    ll]`` and sums it over ``'data'`` in ONE :func:`~.collectives.psum`,
    then adds the prior; a NaN log-density becomes -inf and the gradient of
    a non-finite one 0 (sharded.py:74-82)."""

    def make(group):
        dev = group.device
        init_t = torch.as_tensor(init, device=dev)
        if not init_t.is_floating_point():
            init_t = init_t.to(torch.get_default_dtype())
        mesh, first = group.mesh, group.entries[0]

        def per_entry(entry):
            shards = group.data[entry]
            one = lambda th: loglik_shard(th, *shards)  # noqa: E731
            return (torch.func.vmap(one),
                    torch.func.vmap(torch.func.grad_and_value(one)))

        fns = {e: per_entry(e) for e in group.entries}
        prior_v = torch.func.vmap(prior)
        prior_vg = torch.func.vmap(torch.func.grad_and_value(prior))

        def rows(theta):
            return theta.reshape(-1, size)

        def logp(theta):
            flat = rows(theta)
            parts = {e: fns[e][0](flat.to(group.mesh.devices[e]))[:, None]
                     for e in group.entries}
            ll = psum(parts, mesh, DATA_AXIS)[first][:, 0]
            lp = ll + prior_v(flat)
            lp = torch.where(torch.isnan(lp), -torch.inf, lp)
            return lp.reshape(theta.shape[:-1])

        def allg(theta):
            flat = rows(theta)
            parts = {}
            for e in group.entries:
                g, ll = fns[e][1](flat.to(group.mesh.devices[e]))
                parts[e] = torch.cat([g, ll[:, None]], dim=1)
            packed = psum(parts, mesh, DATA_AXIS)[first]
            gp, pl = prior_vg(flat)
            lp = packed[:, size] + pl
            g = packed[:, :size] + gp
            return lp.reshape(theta.shape[:-1]), g.reshape(theta.shape)

        evalallg = _sanitize_allg(allg)
        return LogDensityModel(
            eval=logp, evalg=lambda th: evalallg(th)[1], evalallg=evalallg,
            pmap={"pars": (1, (size,))}, size=size, init=init_t,
            scale=torch.broadcast_to(torch.as_tensor(
                scale, dtype=init_t.dtype, device=dev), (size,)).clone())

    return make


def run_chains_sharded(make_model, data, sampler, runner, mesh, n_chains,
                       generator=None, seed=0, inits=None, data_specs=None):
    """Run ``n_chains`` chains of ``sampler`` under a ``('chains', 'data')``
    mesh.

    - ``make_model(group) -> LogDensityModel`` (e.g. from
      :func:`sharded_glm_model`), called once a chain group;
    - ``data``: a tuple of tensors, each split along its first dimension
      over ``'data'`` (``data_specs``: None for an array every entry takes
      whole);
    - chains are split over ``'chains'``; chain group ``i`` draws from its
      own generator (:func:`~.mesh.shard_generators` of ``seed``, or of
      ``generator``), initialization included.

    Returns ``(final_states, infos)`` with infos stacked as (steps, chains,
    ...), joined on the first chain group's device; with several processes
    every process returns the whole result."""
    from .pchains import _scan_chains

    n_c = mesh.shape[CHAIN_AXIS]
    c_loc = split_sizes(n_chains, n_c)
    items = local_groups(mesh, CHAIN_AXIS)
    gens = shard_generators(items, seed=seed, generator=generator)
    ctx = RunCtx(burnin=runner.burnin)

    def one(i, dev):
        model = make_model(shard_data(data, mesh, i, data_specs))
        if inits is None:
            th0 = model.init.expand(c_loc, model.size).clone()
        else:
            th0 = torch.as_tensor(inits, dtype=model.dtype)[
                i * c_loc:(i + 1) * c_loc].to(dev)
        states = sampler.init(model, th0, gens[i])
        return _scan_chains(model, sampler, ctx, states, gens[i], runner.len)

    parts = gather(for_each(one, items), n_c)
    dev0 = items[0][1]
    return (concat_chains([p[0] for p in parts], dev0),
            concat_chains([p[1] for p in parts], dev0, dim=1))
