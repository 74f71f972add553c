"""ShardedFlame: the WHOLE per-frame pipeline under a device mesh.

Where parallel/sharding.py provides hand-written shard_map kernels for the
two hot stages (feature-parallel tracking, edge-sharded / halo-exchange
smoothing), this orchestrator runs the complete Flame host loop — frame
creation, tracking, detection, graph sync, smoothing, triangle filters,
rasterization, outputs — with the persistent device state placed under
`jax.sharding.NamedSharding`s over a Mesh and the existing jitted pipeline
steps compiled by GSPMD against those placements (the scaling-book recipe:
pick a mesh, annotate the state shardings, let XLA insert the
collectives). The reference has no distributed layer at all (SURVEY.md
section 0); this is the end-to-end analogue SURVEY.md section 2b maps out:

  * DP axis: per-feature state (tracking filters, graph vertex state) is
    block-sharded over the mesh; per-feature ops partition exactly; the
    per-edge smoothing terms induce XLA collectives where edges cross
    feature blocks.
  * Replicated: images/poseframe stack/dense maps — every device holds
    the frame data it needs to track its feature block.

SolverParams(smoother="halo") swaps the GSPMD-partitioned vertex smoother
for the vertex-partitioned halo-exchange one (parallel/halo.py). The
multi-device dry run (`__graft_entry__.dryrun_multichip`) and
tests/test_sharded_e2e.py exercise both on virtual CPU meshes;
`chip_smoke.py --four-cards` runs both on four GPUs.
"""

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flame_tpu.core.flame import Flame
from flame_tpu.params import Params
from flame_tpu.parallel.sharding import AXIS, make_mesh


class ShardedFlame(Flame):
    """Flame with its persistent device state sharded over a Mesh.

    Every update() then compiles/executes the same fused pipeline steps
    as the single-device path, partitioned by GSPMD across the mesh:
    feature-indexed arrays (filter state, graph vertex state, per-edge
    arrays) are sharded on the mesh axis; frames, poseframe stack, and
    dense outputs are replicated.
    """

    def __init__(self, width: int, height: int, K, Kinv,
                 params: Params = None, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self._ba_mesh = self.mesh  # routes BA through the psum'd assembly
        self._sharding_mesh = self.mesh  # halo smoother routing
        params = params or Params()
        n = int(self.mesh.devices.size)
        if params.feature_capacity % n or params.edge_capacity % n:
            raise ValueError("feature/edge capacity must divide the mesh "
                             f"size {n}")
        super().__init__(width, height, K, Kinv, params)

        shard = NamedSharding(self.mesh, P(AXIS))
        rep = NamedSharding(self.mesh, P())

        def place(tree, sharding):
            return jax.tree.map(
                lambda a: jax.device_put(a, sharding), tree)

        # Feature-indexed state: DP-sharded. Graph state: vertex- and
        # edge-indexed leaves all lead with a capacity axis divisible by
        # the mesh, so one block-sharded axis works for every leaf.
        self._feats = place(self._feats, shard)
        self._curr = place(self._curr, shard)
        self._graph = place(self._graph, shard)
        self._vtx_idepths = place(self._vtx_idepths, shard)
        self._vtx_normals = place(self._vtx_normals, shard)
        # Replicated state: frames, stack, dense maps, triangles.
        self._stack = place(self._stack, rep)
        self._idepthmap = place(self._idepthmap, rep)
        self._tris = place(self._tris, rep)
        self._tri_mask = place(self._tri_mask, rep)
        self._tri_validity = place(self._tri_validity, rep)
