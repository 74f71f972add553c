"""Checkpoint/resume for the full pipeline state.

The reference has no checkpointing at all (SURVEY.md section 5: all state
is in-memory; clear() is the only lifecycle op). Here every piece of
pipeline state is already array-shaped (SoA + masks), so a checkpoint is a
flat dict of numpy arrays + a small JSON-able header, saved with numpy's
npz container. Orbax is available in the environment but npz keeps
checkpoints dependency-free and trivially inspectable.

save() first QUIESCES the instance — flushes any buffered batch frames
(solver.frame_batch) through the pipeline and drains the asynchronous
fetch/triangulation stages into their host-side canonical form — then
snapshots device state, host mirrors, staged topology, and the BA
observation store (a checkpoint must not lose buffered
frames or the BA window history). Because the quiesce mutates the live
instance into exactly the state load() reproduces, a run that saves and
continues is bit-identical to a run that restores and continues (tested
in tests/test_checkpoint.py).
"""

import json
import os
from typing import Dict

import numpy as np
import jax
import jax.numpy as jnp


def _flatten(prefix: str, tree) -> Dict[str, np.ndarray]:
    out = {}
    if hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            if v is None:
                continue
            if k == "img_pack":
                # Derived state (FrameStack invariant: img_pack[i] ==
                # pack_image(img_pad[i])); rebuilt on load. Also npz
                # cannot round-trip bf16 (reloads as void16).
                continue
            out.update(_flatten(f"{prefix}.{k}", v))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _quiesce(fl) -> None:
    """Bring the async pipeline to its canonical host-side resting state:
    no buffered batch frames, no in-flight transfers, no pending host
    triangulation work."""
    fl._flush_batch()
    while fl._packed_queue:
        pk, pk_frame, pk_meta, _tent = fl._packed_queue.popleft()
        fl._sheds_since_consume = 0
        if not fl._consume_packed(pk.get(), pk_frame, pk_meta):
            break  # instance cleared itself (too few features)
    fl._adopt_tri_result(force=True)
    if fl._ba is not None:
        # Join and apply any in-flight asynchronous BA solve so the
        # snapshot carries its result (a discarded solve would make the
        # resumed run diverge from the uninterrupted one).
        fl._ba.quiesce(fl)


def save(path: str, fl) -> None:
    """Snapshot a Flame instance to <path> (.npz). Quiesces the instance
    first (see module docstring) — the live instance afterwards is in
    exactly the state a load() of this snapshot reproduces."""
    _quiesce(fl)

    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten("feats", fl._feats))
    arrays.update(_flatten("curr", fl._curr))
    arrays.update(_flatten("graph", fl._graph))
    arrays.update(_flatten("stack", fl._stack))
    arrays["tris"] = np.asarray(fl._tris)
    arrays["tri_mask"] = np.asarray(fl._tri_mask)
    arrays["tri_validity"] = np.asarray(fl._tri_validity)
    arrays["vtx_idepths"] = np.asarray(fl._vtx_idepths)
    arrays["vtx_normals"] = np.asarray(fl._vtx_normals)
    arrays["idepthmap"] = np.asarray(fl._idepthmap)
    arrays["edges_np"] = fl._edges_np
    arrays["tris_np"] = np.asarray(fl._tris_np, np.int64)
    arrays["last_stats"] = np.asarray(fl._last_stats_dev)
    # The host validity mirror lags feats.valid by design (it reflects
    # the last consumed packed transfer); persist it as-is so a resumed
    # run sees the same mirror, not a fresher one.
    arrays["feat_valid_np"] = fl._feat_valid_np

    header = {
        "width": fl.width, "height": fl.height,
        "inited": fl.inited, "num_imgs": fl.num_imgs,
        "num_data_updates": fl.num_data_updates,
        "num_regularizer_updates": fl.num_regularizer_updates,
        "graph_scale": float(np.asarray(fl._graph_scale_dev)),
        "n_edges": fl._n_edges, "n_tris": fl._n_tris,
        "n_members": int(getattr(fl, "_n_members", 0)),
        "pf_slot_by_id": {str(k): int(v)
                          for k, v in fl._pf_slot_by_id.items()},
        "curr_pf_slot": fl._curr_pf_slot,
        "curr_pf_id": fl._curr_pf_id,
        # Verbatim, order included: _alloc_pf_slot pops from the END, so
        # re-deriving the free list in sorted order would make the next
        # allocation differ from the saved-and-continued run.
        "pf_free": [int(s) for s in fl._pf_free],
        "feat_id_counter": fl._feat_id_counter,
        "dispatches": fl._dispatches,
        "coalesce": bool(getattr(fl, "_coalesce", False)),
        "staged_offset": fl._staged_offset,
        "staged_fresh": bool(fl._staged_fresh),
        "staged_frame": fl._staged_frame,
    }

    # Frames: the per-frame fast path needs the previous frame's pose (and
    # debug imagery its pixels); persist (id, q, t, img) and re-create the
    # Frame deterministically on load.
    for name, f in (("fnew", fl._fnew), ("fprev", fl._fprev)):
        header[name] = f is not None
        if f is not None:
            arrays[f"{name}.img"] = np.asarray(f.img)
            arrays[f"{name}.q"] = np.asarray(f.q)
            arrays[f"{name}.t"] = np.asarray(f.t)
            arrays[f"{name}.id"] = np.asarray(f.frame_id)

    if fl._last_sync_pose is not None:
        arrays["sync_q"] = np.asarray(fl._last_sync_pose[0])
        arrays["sync_t"] = np.asarray(fl._last_sync_pose[1])
    if fl._last_topo_host is not None:
        arrays["last_topo_host"] = fl._last_topo_host
    if fl._curr_pf_pose_np is not None:
        arrays["pf_pose_q"] = np.asarray(fl._curr_pf_pose_np[0])
        arrays["pf_pose_t"] = np.asarray(fl._curr_pf_pose_np[1])

    # Staged topology (either form the drain can leave behind).
    if fl._pending_topo is not None:
        buf, n_tris, tris_np, edges_np, n_edges = fl._pending_topo
        arrays["pend.buf"] = buf
        arrays["pend.tris"] = np.asarray(tris_np, np.int64)
        arrays["pend.edges"] = np.asarray(edges_np, np.int64)
        header["pend"] = [int(n_tris), int(n_edges)]
    if fl._staged_tris is not None:
        buf_dev, n_tris, tris_np, edges_np, n_edges = fl._staged_tris
        arrays["staged.buf"] = np.asarray(buf_dev)
        arrays["staged.tris"] = np.asarray(tris_np, np.int64)
        arrays["staged.edges"] = np.asarray(edges_np, np.int64)
        header["staged"] = [int(n_tris), int(n_edges)]

    # BA observation store (window history survives resume).
    if fl._ba is not None:
        st = fl._ba.store
        arrays["ba.aid"] = st._aid
        arrays["ba.oid"] = st._oid
        arrays["ba.fid"] = st._fid
        arrays["ba.uref"] = st._uref
        arrays["ba.uobs"] = st._uobs
        header["ba"] = [int(st._n), int(st._head), int(st.capacity)]
        # The async BA layer's decision state: the latest decoded
        # snapshot and its dirty flag drive WHEN the next solve stages
        # and from WHICH poses/landmarks — without them a resumed run
        # would stage a different first solve than the continued one
        # (breaking bit-equal resume).
        if fl._ba._snap is not None:
            for k, v in fl._ba._snap.items():
                arrays[f"ba_snap.{k}"] = v
            header["ba_snap_dirty"] = bool(fl._ba._snap_dirty)
        # The solve-cadence counter: without it a resumed run stages
        # its next solve at a different point than the continued one
        # whenever solve_min_new_pfs > 1 (bit-equal resume diverges).
        header["ba_new_pf_count"] = int(fl._ba._new_pf_count)
        # Input-pose anchors (the pose-prior reference; ba/window.py).
        ip = fl._ba._input_pose_by_id
        if ip:
            fids = sorted(ip.keys())
            arrays["ba_input.fids"] = np.array(fids, np.int64)
            arrays["ba_input.q"] = np.stack([ip[f][0] for f in fids])
            arrays["ba_input.t"] = np.stack([ip[f][1] for f in fids])

    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str, fl) -> None:
    """Restore a Flame instance in place from a snapshot.

    The instance must have been constructed with the same Params
    (capacities/shapes must match).
    """
    from flame_tpu.core import frame as frame_mod

    with np.load(path) as npz:
        data = dict(npz)  # materialize; the zip handle must not leak
    header = json.loads(bytes(data["__header__"]).decode())
    assert header["width"] == fl.width and header["height"] == fl.height, \
        "checkpoint resolution mismatch"

    def put(arr, proto):
        """Restore an array WITH the live instance's placement: under a
        ShardedFlame the constructor already laid out empty state with
        its NamedShardings, so re-placing each restored array with its
        prototype's sharding preserves the mesh layout (a plain
        jnp.asarray would collapse a resumed ShardedFlame onto one
        device). Single-device instances see a no-op."""
        if isinstance(proto, jax.Array):
            return jax.device_put(arr, proto.sharding)
        return jnp.asarray(arr)

    def unflat(prefix, proto):
        kwargs = {}
        for k, v in proto._asdict().items():
            key = f"{prefix}.{k}"
            if v is None:
                kwargs[k] = None
            elif k == "img_pack":
                # Derived from img_pad (not persisted); rebuilt below
                # once the restored img_pad rows are in place.
                kwargs[k] = v
            elif hasattr(v, "_asdict"):
                kwargs[k] = unflat(key, v)
            else:
                arr = data[key]
                assert arr.shape == tuple(v.shape), \
                    f"{key}: {arr.shape} vs {v.shape}"
                kwargs[k] = put(arr, v)
        return type(proto)(**kwargs)

    fl._feats = unflat("feats", fl._feats)
    fl._curr = unflat("curr", fl._curr)
    fl._graph = unflat("graph", fl._graph)
    fl._stack = unflat("stack", fl._stack)
    from flame_tpu.ops import interp as _interp
    _pdt = fl._stack.img_pack.dtype
    fl._stack = fl._stack._replace(img_pack=put(
        jax.vmap(lambda im: _interp.pack_image(im, _pdt))(
            fl._stack.img_pad).reshape(-1, 4),
        fl._stack.img_pack))
    fl._tris = put(data["tris"], fl._tris)
    fl._tri_mask = put(data["tri_mask"], fl._tri_mask)
    fl._tri_validity = put(data["tri_validity"], fl._tri_validity)
    fl._vtx_idepths = put(data["vtx_idepths"], fl._vtx_idepths)
    fl._vtx_normals = put(data["vtx_normals"], fl._vtx_normals)
    fl._idepthmap = put(data["idepthmap"], fl._idepthmap)
    fl._edges_np = data["edges_np"]
    fl._tris_np = data["tris_np"]
    fl._last_stats_dev = jnp.asarray(data["last_stats"])

    fl.inited = bool(header["inited"])
    fl.num_imgs = int(header["num_imgs"])
    fl.num_data_updates = int(header["num_data_updates"])
    fl.num_regularizer_updates = int(header["num_regularizer_updates"])
    fl._graph_scale_dev = jnp.float32(header["graph_scale"])
    fl._n_edges = int(header["n_edges"])
    fl._n_tris = int(header["n_tris"])
    fl._n_members = int(header.get("n_members", 0))
    fl._pf_slot_by_id = {int(k): int(v)
                         for k, v in header["pf_slot_by_id"].items()}
    fl._curr_pf_slot = header["curr_pf_slot"]
    fl._curr_pf_id = header.get("curr_pf_id")
    fl._feat_id_counter = int(header.get("feat_id_counter", 0))
    fl._dispatches = int(header.get("dispatches", 0))
    fl._coalesce = bool(header.get("coalesce", False))
    fl._staged_offset = int(header.get("staged_offset", 0))
    fl._staged_fresh = bool(header.get("staged_fresh", False))
    fl._staged_frame = header.get("staged_frame")
    if "pf_free" in header:
        fl._pf_free = [int(s) for s in header["pf_free"]]
    else:  # older snapshot: derive (ascending — allocation order may
        # differ from the saved instance after prunes)
        used = set(fl._pf_slot_by_id.values())
        fl._pf_free = [s for s in range(fl.params.poseframe_capacity)
                       if s not in used]

    def mkframe(name):
        if not header.get(name):
            return None
        return frame_mod.create(
            jnp.asarray(data[f"{name}.id"]),
            jnp.asarray(data[f"{name}.q"]), jnp.asarray(data[f"{name}.t"]),
            jnp.asarray(data[f"{name}.img"]), fl.params.pad)

    fl._fnew = mkframe("fnew")
    fl._fprev = mkframe("fprev")
    fl._last_sync_pose = (jnp.asarray(data["sync_q"]),
                          jnp.asarray(data["sync_t"])) \
        if "sync_q" in data else None
    fl._last_topo_host = (np.array(data["last_topo_host"])
                          if "last_topo_host" in data else None)
    fl._topo_dev = None
    fl._curr_pf_pose_np = ((np.array(data["pf_pose_q"]),
                            np.array(data["pf_pose_t"]))
                           if "pf_pose_q" in data else None)

    fl._pending_topo = None
    if "pend" in header:
        n_tris, n_edges = header["pend"]
        fl._pending_topo = (np.array(data["pend.buf"]), n_tris,
                            data["pend.tris"], data["pend.edges"], n_edges)
    fl._staged_tris = None
    if "staged" in header:
        n_tris, n_edges = header["staged"]
        fl._staged_tris = (jnp.asarray(data["staged.buf"]), n_tris,
                           data["staged.tris"], data["staged.edges"],
                           n_edges)
    fl._tri_pending = None
    # Pre-restore in-flight transfers are un-cancellable: keep them on
    # the zombie list so the link-depth accounting stays honest (same
    # bookkeeping as Flame.clear), and reset the shed/latency state the
    # snapshot does not carry.
    for pk, _fr, _m, _tent in fl._packed_queue:
        fl._zombie_fetches.append((pk, None))
    fl._packed_queue.clear()
    fl._sheds_since_consume = 0
    fl._entry_stamp.clear()
    fl._latency_samples = []
    fl._batch_pending = []
    fl._tris_staged = (fl._tris_np, fl._n_tris)

    if fl._ba is not None and "ba" in header:
        n, head, cap = header["ba"]
        st = fl._ba.store
        assert cap == st.capacity, "BA obs_capacity mismatch"
        st._aid = np.array(data["ba.aid"])
        st._oid = np.array(data["ba.oid"])
        st._fid = np.array(data["ba.fid"])
        st._uref = np.array(data["ba.uref"])
        st._uobs = np.array(data["ba.uobs"])
        st._n = n
        st._head = head
        if "ba_snap.uo" in data:
            fl._ba._snap = {k.split(".", 1)[1]: np.array(data[k])
                            for k in data
                            if k.startswith("ba_snap.")}
            fl._ba._snap_dirty = bool(header.get("ba_snap_dirty", False))
        else:
            fl._ba._snap = None
            fl._ba._snap_dirty = False
        fl._ba._inflight = None  # quiesced before save
        fl._ba._new_pf_count = int(header.get("ba_new_pf_count", 0))
        fl._ba._input_pose_by_id = {}
        if "ba_input.fids" in data:
            for f, q, t in zip(data["ba_input.fids"].tolist(),
                               data["ba_input.q"], data["ba_input.t"]):
                fl._ba._input_pose_by_id[int(f)] = (np.array(q),
                                                    np.array(t))

    if "feat_valid_np" in data:
        fl._feat_valid_np = np.array(data["feat_valid_np"])
        fl._n_valid = int(fl._feat_valid_np.sum())
    else:
        fl._refresh_feat_mirror()
