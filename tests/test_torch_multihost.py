"""The port's multi-process runtime (parallel/multihost.py and
``torch.distributed``) on the CPU, as tests/test_multiprocess.py checks the
JAX package's.

Two processes are wired together with ``multihost.initialize`` (gloo, one
``"cpu"`` device each, so a 2-entry global mesh), and run the data-sharded
likelihood engine with the data axis across the processes: every gradient's
packed ``[g | ll]`` is all-reduced between them.  Both processes print the
same checksums, bit for bit, and those equal a single-process run of the
same program on a 2-entry mesh at 1e-12 (tests/test_multiprocess.py:124).
A chain axis across the processes gathers each process's chains into the
same global result on both.  Then the single-process helpers
(tests/test_model_extra.py:56-58)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcmc_jl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

_PROGRAM = r"""
import numpy as np
import torch
import mcmc_jl_tpu_torch as mt
from mcmc_jl_tpu_torch.parallel.sharded import (make_mesh,
                                                run_chains_sharded,
                                                sharded_glm_model)

torch.set_num_threads(1)
rng = np.random.default_rng(1)
nbeta, n_obs = 4, 16
X = np.column_stack([np.ones(n_obs), rng.standard_normal((n_obs, nbeta - 1))])
beta0 = rng.standard_normal(nbeta)
Y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
X, Y = torch.tensor(X), torch.tensor(Y)


def loglik_shard(theta, X_blk, Y_blk):
    logits = X_blk @ theta
    return Y_blk @ logits - torch.logaddexp(torch.zeros_like(logits),
                                            logits).sum()


def checksums(layout, devices=None):
    mesh = make_mesh(*layout, devices=devices)
    make_model = sharded_glm_model(loglik_shard, lambda th: -0.5 * th @ th,
                                   nbeta, torch.zeros(nbeta,
                                                      dtype=torch.float64))
    final_states, infos = run_chains_sharded(
        make_model, (X, Y), mt.HMC(3, 0.1), mt.SerialMC(steps=20), mesh,
        n_chains=2, seed=0)
    return (float(infos["plogtarget"].sum()),
            float(final_states.pars.sum()))
"""

_CHILD = _PROGRAM + r"""
import sys
import torch.distributed as dist
from mcmc_jl_tpu_torch.parallel import multihost

coord, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid, devices=["cpu"])
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)  # idempotent
assert dist.get_world_size() == 2
mesh = make_mesh(1, 2)
assert mesh.process_ids.tolist() == [[0, 1]], mesh.process_ids
assert multihost.process_chain_slice(16) == (8 * pid, 8 * pid + 8)
for layout in ((1, 2), (2, 1)):
    a, b = checksums(layout)
    print(f"CHECKSUM {layout[0]}{layout[1]} {a:.17e} {b:.17e}", flush=True)
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sums(stdout):
    out = {}
    for ln in stdout.splitlines():
        if ln.startswith("CHECKSUM"):
            _, layout, a, b = ln.split()
            out[layout] = (float(a), float(b))
    return out


def test_two_process_torch_distributed_psum():
    coord = f"tcp://127.0.0.1:{_free_port()}"
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, coord,
                               str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=cwd) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, _, stderr in outs:
        assert rc == 0, stderr[-3000:]
    sums = [_sums(stdout) for _, stdout, _ in outs]
    assert set(sums[0]) == {"12", "21"}
    # both processes hold the identical global result, bit for bit
    assert sums[0] == sums[1], sums

    # and it is the single-process run of the same program on a 2-entry
    # mesh of the one CPU device
    ns = {}
    exec(compile(_PROGRAM, "program", "exec"), ns)
    for layout in ((1, 2), (2, 1)):
        ref = ns["checksums"](layout, devices=["cpu"] * 2)
        np.testing.assert_allclose(sums[0][f"{layout[0]}{layout[1]}"], ref,
                                   rtol=1e-12)


def test_multihost_helpers_single_process(monkeypatch):
    monkeypatch.setitem(multihost._LOCAL, "devices", None)
    multihost.initialize(num_processes=1, devices=["cpu"])
    mesh = multihost.global_mesh()
    assert mesh.devices.size == 1 and mesh.shape == {"chains": 1}
    assert mesh.process_ids.tolist() == [0]
    devices, pids = multihost.global_devices()
    assert devices == [torch.device("cpu")] and pids == [0]
    s, e = multihost.process_chain_slice(16)
    assert (s, e) == (0, 16)
    assert multihost.scaling_efficiency(100.0, 180.0, 2) == 0.9
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0)
