"""Real 2-process jax.distributed bring-up of parallel/multihost.py:
two CPU processes initialize against a local
coordinator, build the global mesh, and run one psum + one sharded
NLTGV2 smoothing call across process boundaries."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, os.environ["FLAME_REPO"])

from flame_tpu.parallel import multihost
from flame_tpu.parallel.sharding import AXIS

multihost.initialize(coordinator_address=os.environ["COORD"],
                     num_processes=2,
                     process_id=int(os.environ["PID_IDX"]))
assert jax.process_count() == 2, jax.process_count()
mesh = multihost.global_mesh()
assert mesh.devices.size == 4  # 2 processes x 2 local virtual devices

# Cross-process psum: every process contributes its local device values.
from jax.sharding import NamedSharding, PartitionSpec as P
vals = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(AXIS)),
    np.full((2,), float(jax.process_index() + 1), np.float32), (4,))

def body(v):
    return jax.lax.psum(v, AXIS)

total = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(AXIS),
                              out_specs=P(AXIS)))(vals)
local = np.asarray(
    [s.data for s in total.addressable_shards][0])
assert local[0] == 6.0, local  # 1 + 1 + 2 + 2

# Sharded smoothing across hosts: a ring graph, edge capacity 4-divisible.
from flame_tpu.optimize import nltgv2
from flame_tpu.parallel import sharding
from flame_tpu.params import RegularizerParams

V, E = 32, 64
g = nltgv2.empty(V, E, 4)
nv = 16
edges = np.zeros((E, 2), np.int64)
edges[:nv, 0] = np.arange(nv)
edges[:nv, 1] = (np.arange(nv) + 1) % nv
emask = np.zeros(E, bool); emask[:nv] = True
vmask = np.zeros(V, bool); vmask[:nv] = True
rng = np.random.default_rng(0)
g = g._replace(
    pos=jnp.asarray(rng.uniform(0, 50, (V, 2)).astype(np.float32)),
    x=jnp.asarray(rng.uniform(0.1, 0.3, V).astype(np.float32)),
    data_term=jnp.full((V,), 0.2, jnp.float32),
    data_weight=jnp.asarray(vmask.astype(np.float32)),
    vtx_mask=jnp.asarray(vmask),
    edges=jnp.asarray(edges.astype(np.int32)),
    alpha=jnp.asarray(emask.astype(np.float32) * 0.2),
    beta=jnp.asarray(emask.astype(np.float32)),
    edge_mask=jnp.asarray(emask))
g = g._replace(x_bar=g.x)
g2 = sharding.sharded_smooth(RegularizerParams(), g, 10, mesh)
x2 = np.asarray([s.data for s in g2.x.addressable_shards][0])
assert np.isfinite(x2).all()

# Observation-sharded BA across process boundaries: every process holds
# the identical window (the SPMD deployment model); the solver converts
# to global arrays internally and psums partial Hessians over the
# 2-process mesh. Result must match the local single-device solve.
from flame_tpu.ba import schur, residuals as resid
from flame_tpu.parallel import distributed_ba
from flame_tpu.params import BAParams
from flame_tpu.geometry import camera

rng2 = np.random.default_rng(5)
Pn, Ln, M = 4, 12, 64
K = camera.make_k(100.0, 100.0, 64.0, 48.0)
Kinv = camera.inv_k(K)
qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (Pn, 1))
ts = np.stack([np.array([0.3 * i, 0, 0], np.float32) for i in range(Pn)])
lm = rng2.uniform(0.15, 0.3, Ln).astype(np.float32)
a_idx = rng2.integers(0, Pn - 1, M).astype(np.int32)
o_idx = (a_idx + 1).astype(np.int32)
l_idx = rng2.integers(0, Ln, M).astype(np.int32)
u_ref = rng2.uniform(20, 100, (M, 2)).astype(np.float32)
# Observations = projections with mild noise.
import jax.numpy as jnp2
from flame_tpu.geometry import epipolar as epi
u_obs = np.zeros((M, 2), np.float32)
for m in range(M):
    from flame_tpu.geometry import se3 as se3m
    geo = epi.load_relative(jnp2.asarray(K), jnp2.asarray(Kinv),
                            (jnp2.asarray(qs[a_idx[m]]), jnp2.asarray(ts[a_idx[m]])),
                            (jnp2.asarray(qs[o_idx[m]]), jnp2.asarray(ts[o_idx[m]])))
    uo, _ = epi.project_idepth(geo, jnp2.asarray(u_ref[m]), jnp2.asarray(lm[l_idx[m]]))
    u_obs[m] = np.asarray(uo) + rng2.normal(0, 0.3, 2)
obs = resid.BAObservations(
    anchor_idx=jnp2.asarray(a_idx), obs_idx=jnp2.asarray(o_idx),
    lm_idx=jnp2.asarray(l_idx), u_ref=jnp2.asarray(u_ref),
    u_obs=jnp2.asarray(u_obs), valid=jnp2.ones((M,), bool))
prob = schur.BAProblem(q=jnp2.asarray(qs), t=jnp2.asarray(ts),
                       lm_idepth=jnp2.asarray(lm),
                       lm_valid=jnp2.ones((Ln,), bool), obs=obs)
bp = BAParams(n_gn_iters=3)
q_s, t_s, lm_s, cost_s = distributed_ba.solve_window_sharded(
    bp, jnp2.asarray(K), jnp2.asarray(Kinv), prob, mesh, n_fixed=2)
q_l, t_l, lm_l, cost_l = schur.solve_window(
    bp, jnp2.asarray(K), jnp2.asarray(Kinv), prob, n_fixed=2)
t_s_local = np.asarray([s.data for s in t_s.addressable_shards][0])
np.testing.assert_allclose(t_s_local, np.asarray(t_l), atol=1e-4)
assert abs(float(cost_s) - float(cost_l)) < 1e-2 * max(float(cost_l), 1.0)
print(f"proc {jax.process_index()} BA-sharded OK", flush=True)

print(f"proc {jax.process_index()} OK", flush=True)
"""


@pytest.mark.skipif(os.environ.get("FLAME_SKIP_MULTIHOST") == "1",
                    reason="multihost test disabled")
def test_two_process_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(COORD=coord, PID_IDX=str(pid), FLAME_REPO=repo,
                   JAX_PLATFORMS="cpu")
        # Each process must see exactly its own 2 virtual devices.
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out
