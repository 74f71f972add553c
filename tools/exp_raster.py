#!/usr/bin/env python
"""Decompose rasterizer cost: level-1 binning, level-2 binning, eval."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.utils import compile_cache

compile_cache.enable()

from tools.timing import make_graph, timeit


def main():
    print(f"device: {jax.devices()[0]}")
    g, edges_np, n_e, tris_np, n_used = make_graph()
    T_cap = 12288
    tris = np.zeros((T_cap, 3), np.int32)
    tris[:tris_np.shape[0]] = tris_np
    tmask = np.zeros(T_cap, bool)
    tmask[:tris_np.shape[0]] = True
    tris_d = jnp.asarray(tris)
    tmask_d = jnp.asarray(tmask)
    verts = g.pos
    vals = jnp.where(g.vtx_mask, g.x, 0.0)
    H, W = 480, 640
    tile_h, tile_w, K = 64, 128, 256

    from flame_tpu.ops.rasterize import _tri_setup

    def stage1(verts, tris, vals, tri_valid):
        vxy = jnp.concatenate([verts, vals[:, None],
                               jnp.zeros((verts.shape[0], 1), verts.dtype)],
                              axis=1)
        cg = vxy[tris]
        a, b, c, area2 = _tri_setup(verts, tris, True, corners=cg[..., :2])
        p = jnp.trunc(cg[..., :2])
        xmin = jnp.min(p[:, :, 0], axis=1)
        xmax = jnp.max(p[:, :, 0], axis=1)
        ymin = jnp.min(p[:, :, 1], axis=1)
        ymax = jnp.max(p[:, :, 1], axis=1)
        nty = -(-H // tile_h)
        ntx = -(-W // tile_w)
        n_tiles = nty * ntx
        tids = jnp.arange(n_tiles)
        ty = (tids // ntx).astype(jnp.float32) * tile_h
        tx = (tids % ntx).astype(jnp.float32) * tile_w
        overlap = ((xmin[None, :] <= tx[:, None] + (tile_w - 1)) &
                   (xmax[None, :] >= tx[:, None]) &
                   (ymin[None, :] <= ty[:, None] + (tile_h - 1)) &
                   (ymax[None, :] >= ty[:, None]) &
                   tri_valid[None, :] & (area2[None, :] > 0))
        return overlap

    def stage1b(verts, tris, vals, tri_valid):
        overlap = stage1(verts, tris, vals, tri_valid)
        T = tris.shape[0]
        n_tiles = overlap.shape[0]
        rank = jnp.cumsum(overlap, axis=1) - overlap
        dest = jnp.where(overlap & (rank < K), rank, K)
        tri_ids = jnp.broadcast_to(jnp.arange(T)[None, :], overlap.shape)
        order = jnp.zeros((n_tiles, K + 1), jnp.int32)
        order = order.at[
            jnp.broadcast_to(jnp.arange(n_tiles)[:, None], overlap.shape),
            dest].set(tri_ids, mode="drop")[:, :K]
        return order

    j1 = jax.jit(stage1)
    j1b = jax.jit(stage1b)

    def run1():
        np.asarray(j1(verts, tris_d, vals, tmask_d)[0, 0])
    def run1b():
        np.asarray(j1b(verts, tris_d, vals, tmask_d)[0, 0])

    print(f"raster/overlap-only        {timeit(run1)*1e3:8.2f} ms")
    print(f"raster/overlap+rankscatter {timeit(run1b)*1e3:8.2f} ms")

    def stage2(verts, tris, vals, tri_valid):
        order = stage1b(verts, tris, vals, tri_valid)
        overlap = stage1(verts, tris, vals, tri_valid)
        k_valid = jnp.take_along_axis(overlap, order, axis=1)
        vxy = jnp.concatenate(
            [verts, vals[:, None],
             jnp.zeros((verts.shape[0], 1), verts.dtype)], axis=1)
        cg = vxy[tris]
        p = jnp.trunc(cg[..., :2])
        xmin = jnp.min(p[:, :, 0], axis=1)
        xmax = jnp.max(p[:, :, 0], axis=1)
        ymin = jnp.min(p[:, :, 1], axis=1)
        ymax = jnp.max(p[:, :, 1], axis=1)
        bxmin = xmin[order]
        bxmax = xmax[order]
        bymin = ymin[order]
        bymax = ymax[order]
        nty, ntx = -(-H // tile_h), -(-W // tile_w)
        n_tiles = nty * ntx
        tids = jnp.arange(n_tiles)
        ty = (tids // ntx).astype(jnp.float32) * tile_h
        tx = (tids % ntx).astype(jnp.float32) * tile_w
        cell_h, cell_w, K2 = 16, 32, 40
        ncy, ncx = tile_h // cell_h, tile_w // cell_w
        n_cell = ncy * ncx
        cids = jnp.arange(n_cell)
        cy = (cids // ncx).astype(jnp.float32) * cell_h
        cx = (cids % ncx).astype(jnp.float32) * cell_w
        acy = ty[:, None] + cy[None, :]
        acx = tx[:, None] + cx[None, :]
        overlap2 = ((bxmin[:, None, :] <= acx[:, :, None] + (cell_w - 1)) &
                    (bxmax[:, None, :] >= acx[:, :, None]) &
                    (bymin[:, None, :] <= acy[:, :, None] + (cell_h - 1)) &
                    (bymax[:, None, :] >= acy[:, :, None]) &
                    k_valid[:, None, :])
        rank2 = jnp.cumsum(overlap2, axis=2) - overlap2
        dest2 = jnp.where(overlap2 & (rank2 < K2), rank2, K2)
        gids = jnp.broadcast_to(order[:, None, :], overlap2.shape)
        order2 = jnp.zeros((n_tiles, n_cell, K2 + 1), jnp.int32)
        order2 = order2.at[
            jnp.broadcast_to(jnp.arange(n_tiles)[:, None, None],
                             overlap2.shape),
            jnp.broadcast_to(jnp.arange(n_cell)[None, :, None],
                             overlap2.shape),
            dest2].set(gids, mode="drop")[:, :, :K2]
        return order2

    j2 = jax.jit(stage2)
    def run2():
        np.asarray(j2(verts, tris_d, vals, tmask_d)[0, 0, 0])
    print(f"raster/thru-level2-binning {timeit(run2)*1e3:8.2f} ms")

    from flame_tpu.ops import rasterize as raster
    full = jax.jit(lambda: raster.rasterize(verts, tris_d, vals, tmask_d,
                                            H, W))
    def runf():
        np.asarray(full()[0, 0])
    print(f"raster/full                {timeit(runf)*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
