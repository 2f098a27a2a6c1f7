"""Regular-grid terrain heightmaps.

The reference wraps gym_quadruped HeightMap sensors (13x7 cells at 4 cm around each
reference foothold, yaw-aligned — simulation/simulation.py:489-509) in a cKDTree for
nearest-neighbour height lookups (helpers/visual_foothold_adaptation.py:21-35). For a
REGULAR grid, nearest-neighbour lookup is just an inverse affine transform + round +
clip — O(1), branch-free, and batchable on device, so no tree is needed.

A heightmap is a pytree: per-leg grids stack along a leading axis and whole scenarios
batch above that.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GridHeightMap:
    """Yaw-aligned regular grid of terrain heights.

    World position of cell (i, j):
        center + R(yaw) @ [ (i - (R-1)/2) * res, (j - (C-1)/2) * res ]
    ``heights`` carries z values; shape (..., R, C).
    """

    center: Any  # (..., 2) world xy of the grid center
    yaw: Any  # (...,) grid orientation
    resolution: Any  # scalar
    heights: Any  # (..., R, C)

    def tree_flatten(self):
        return (self.center, self.yaw, self.resolution, self.heights), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.heights.shape[-2:]

    def cell_world_xy(self):
        """World xy of every cell: (..., R, C, 2)."""
        R, C = self.shape
        i = jnp.arange(R, dtype=jnp.float32) - (R - 1) / 2.0
        j = jnp.arange(C, dtype=jnp.float32) - (C - 1) / 2.0
        gx = i[:, None] * self.resolution  # grid-frame x
        gy = j[None, :] * self.resolution
        c, s = jnp.cos(self.yaw), jnp.sin(self.yaw)
        wx = self.center[..., None, None, 0] + c[..., None, None] * gx - s[..., None, None] * gy
        wy = self.center[..., None, None, 1] + s[..., None, None] * gx + c[..., None, None] * gy
        return jnp.stack([wx, wy], axis=-1)


def lookup_nearest(hm: GridHeightMap, points_xy):
    """Nearest-cell height at world points (..., 2) -> (...,).

    Equivalent to the reference's cKDTree nearest-neighbour query for a regular grid
    (points outside the grid clamp to the border, like the tree returns the nearest
    existing point). No sensor offset is applied here — callers add it, mirroring
    FastHeightMap.get_height's +0.02 (visual_foothold_adaptation.py:31-35).
    """
    R, C = hm.shape
    d = points_xy - hm.center
    c, s = jnp.cos(hm.yaw), jnp.sin(hm.yaw)
    # World -> grid frame (inverse rotation).
    gx = c * d[..., 0] + s * d[..., 1]
    gy = -s * d[..., 0] + c * d[..., 1]
    i = jnp.clip(jnp.round(gx / hm.resolution + (R - 1) / 2.0).astype(jnp.int32), 0, R - 1)
    j = jnp.clip(jnp.round(gy / hm.resolution + (C - 1) / 2.0).astype(jnp.int32), 0, C - 1)
    return hm.heights[i, j]


def heightmap_from_fn(terrain_fn, center_xy, yaw, resolution=0.04, rows=13, cols=7):
    """Sample a GridHeightMap from an analytic/world terrain height function
    z = terrain_fn(x, y) (vectorized). Mirrors HeightMap.update_height_map placing the
    grid around a reference foothold with the base yaw (wb_interface.py:233-234)."""
    hm = GridHeightMap(
        center=jnp.asarray(center_xy, jnp.float32),
        yaw=jnp.asarray(yaw, jnp.float32),
        resolution=jnp.asarray(resolution, jnp.float32),
        heights=jnp.zeros((rows, cols), jnp.float32),
    )
    pts = hm.cell_world_xy()
    return GridHeightMap(hm.center, hm.yaw, hm.resolution, terrain_fn(pts[..., 0], pts[..., 1]))
