"""Chain and sampler-state checkpoints (port of ``mcmc_jl_tpu/utils/io.py``).

The reference's suspend/resume keeps a live coroutine in process memory
(MCMC.jl:33-39), so a chain cannot survive the session.  Here the sampler
state is a dataclass of tensors, so a checkpoint is plain serialization:
``save_task`` / ``load_task_into`` round-trip the continuation (state
leaves, generator state, step position) through an ``.npz`` file, and
``save_chain`` / ``load_chain`` also keep the kept samples, gradients and
diagnostics.  The layout is the JAX package's: ``leaf_<i>`` (the state's
tensor leaves in :func:`~mcmc_jl_tpu_torch.samplers.base.tree_map` order),
``key`` (the ``torch.Generator`` state as uint8), ``pos``, and for a chain
``samples``, ``gradients``, ``diag_<name>``, ``range``, ``run_time`` and
``meta`` (the column names as JSON bytes).  Resuming a loaded task
continues the chain bit for bit, tuner state included.
"""
from __future__ import annotations

import dataclasses
import itertools
import json

import numpy as np
import torch

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import make_generator, tree_map
from .table import Table


def _leaves(state):
    """The tensor leaves of a state dataclass, in tree_map order."""
    if dataclasses.is_dataclass(state):
        return [leaf for f in dataclasses.fields(state)
                for leaf in _leaves(getattr(state, f.name))]
    return [state]


def _npz(path):
    return np.load(path if str(path).endswith(".npz") else str(path) + ".npz")


def _continuation(task):
    """The arrays of a task's continuation."""
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(_leaves(task.state))}
    arrays["key"] = np.asarray(task.key.cpu().numpy(), dtype=np.uint8)
    arrays["pos"] = np.asarray(task.pos)
    return arrays


def _restore(data, task):
    """A copy of ``task`` carrying the saved continuation: each leaf on the
    task's model device in the dtype of the task's own state (a fresh
    ``sampler.init`` at the model's init when it has none), the generator
    state checked against a generator on that device."""
    model = task.model
    template = task.state
    if template is None:
        template = task.sampler.init(model, model.init,
                                     make_generator(model.device, 0))
    index = itertools.count()
    state = tree_map(lambda leaf: torch.as_tensor(
        data[f"leaf_{next(index)}"], dtype=leaf.dtype, device=model.device),
        template)
    if data["key"].dtype != np.uint8:
        raise ValueError(
            f"the checkpoint's key is a {data['key'].dtype} array, not a "
            f"torch generator state (uint8): the JAX package writes its PRNG "
            f"key there, and the port cannot continue from it; load the "
            f"file's samples with load_chain(path) alone")
    key = torch.from_numpy(np.array(data["key"], dtype=np.uint8))
    want = torch.Generator(device=model.device).get_state().numel()
    if key.numel() != want:
        kind = "cuda" if key.numel() == 16 else "cpu"
        raise ValueError(
            f"the checkpoint's generator state is a {kind} generator's "
            f"({key.numel()} bytes), but the task's model lives on "
            f"{model.device} ({want} bytes); load it into a task whose "
            f"model is on a {kind} device")
    return MCMCTask(model, task.sampler, task.runner, state=state, key=key,
                    pos=int(data["pos"]))


def save_task(path, task: MCMCTask):
    """Save a task's continuation (state, generator state, pos) to
    ``path`` (``.npz``).  The model, sampler and runner are code, not data:
    the caller builds them again and re-attaches the saved state with
    :func:`load_task_into`."""
    if task.state is None:
        raise ValueError("the task has no live state (run it first)")
    np.savez(path, **_continuation(task))


def load_task_into(path, task: MCMCTask) -> MCMCTask:
    """Load a continuation saved by :func:`save_task` into a freshly built
    task of the same model, sampler and runner structure.  A generator state
    saved on one kind of device (CPU or CUDA) loads only into a task whose
    model lives on the same kind."""
    return _restore(_npz(path), task)


def save_chain(path, chain: MCMCChain):
    """Save a chain's kept samples, gradients and diagnostics and, when its
    task has a live state, the continuation."""
    arrays = {
        "samples": chain.samples.values,
        "range": np.asarray([chain.range.start, chain.range.stop,
                             chain.range.step]),
        "run_time": np.asarray(chain.run_time),
    }
    if not chain.gradients.empty:
        arrays["gradients"] = chain.gradients.values
    for k, v in chain.diagnostics.items():
        arrays[f"diag_{k}"] = np.asarray(v)
    meta = {"columns": chain.samples.columns}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    task = chain.task if isinstance(chain.task, MCMCTask) else None
    if task is not None and task.state is not None:
        arrays.update(_continuation(task))
    np.savez(path, **arrays)


def load_chain(path, task: MCMCTask = None) -> MCMCChain:
    """Load a chain saved by :func:`save_chain`; pass the task built again
    to restore the continuation (so that the chain resumes)."""
    data = _npz(path)
    columns = json.loads(bytes(data["meta"]).decode())["columns"]
    samples = Table(data["samples"], columns)
    gradients = (Table(data["gradients"], columns) if "gradients" in data
                 else Table(np.zeros((0, len(columns))), columns))
    diags = {k[5:]: data[k] for k in data.files if k.startswith("diag_")}
    start, stop, step = (int(x) for x in data["range"])
    new_task = task
    if task is not None and "key" in data.files:
        new_task = _restore(data, task)
    return MCMCChain(range=range(start, stop, step), samples=samples,
                     gradients=gradients, diagnostics=diags, task=new_task,
                     run_time=float(data["run_time"]))
