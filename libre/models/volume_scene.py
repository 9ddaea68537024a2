"""Differentiable volume scene: brick densities + transfer function as a
parameter pytree, with rendering and sharding helpers.

The "model" of this framework (the reference has data, not parameters —
differentiability is the new capability, BASELINE.json north star).  A
scene wraps a BrickSet's geometry as static structure and exposes
``{"density", "tf"}`` as trainable leaves; it renders through the
single-device marcher or the (ray × brick) sharded path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from libre.ops import raycast, rays as ray_ops
from libre.ops.reference import (
    BrickSet,
    Camera,
    RenderParams,
    max_steps_for_bricks,
    single_brick_set,
)
from libre.ops.transfer_function import default_color_map
from libre.parallel.render import render_rays_sharded, shard_bricks_front_to_back


@dataclasses.dataclass
class VolumeScene:
    """Scene = brick geometry (static) + density/TF parameters (leaves)."""

    bricks: BrickSet  # data field = current density estimate
    tf: jnp.ndarray  # (T, 4)
    global_min: np.ndarray
    global_max: np.ndarray
    params: RenderParams

    @classmethod
    def from_volume(
        cls,
        volume_zyx,
        tf: Optional[np.ndarray] = None,
        params: Optional[RenderParams] = None,
    ) -> "VolumeScene":
        vol = jnp.asarray(volume_zyx, jnp.float32)
        return cls(
            bricks=single_brick_set(vol),
            tf=jnp.asarray(tf if tf is not None else default_color_map()),
            global_min=np.float32([-0.5] * 3),
            global_max=np.float32([0.5] * 3),
            params=params
            or RenderParams(data_source_range=(0.0, 1.0), filter_mode="trilinear"),
        )

    # ------------------------------------------------------------ params
    @property
    def parameters(self) -> dict:
        return {"density": self.bricks.data, "tf": self.tf}

    def with_parameters(self, params: dict) -> "VolumeScene":
        return dataclasses.replace(
            self,
            bricks=self.bricks._replace(data=params["density"]),
            tf=params["tf"],
        )

    # ------------------------------------------------------------ render
    def max_steps(self) -> int:
        return max_steps_for_bricks(
            np.asarray(jax.lax.stop_gradient(self.bricks.world_min)),
            np.asarray(jax.lax.stop_gradient(self.bricks.world_max)),
            self.params.step_size,
        )

    def render(self, camera: Camera, chunk: int = 32) -> jnp.ndarray:
        """(H, W, 4) image through the single-device marcher."""
        return raycast.render(
            self.bricks,
            self.tf,
            camera,
            self.params,
            self.global_min,
            self.global_max,
            chunk=chunk,
            max_steps=self.max_steps(),
        )

    def render_sharded(
        self, mesh: Mesh, camera: Camera, chunk: int = 32
    ) -> jnp.ndarray:
        """(H, W, 4) image over a (ray, brick) mesh; bricks are reordered
        front-to-back and padded to the brick-axis size."""
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport
        )
        dirs = dirs.reshape(-1, 3)
        tnp = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
        n_brick = mesh.shape.get("brick", 1)
        bricks, _ = shard_bricks_front_to_back(
            self.bricks, np.asarray(eye), n_brick
        )
        out = render_rays_sharded(
            mesh,
            bricks,
            self.tf,
            eye,
            dirs,
            tnp,
            self.params,
            self.global_min,
            self.global_max,
            self.max_steps(),
            chunk=chunk,
        )
        vx, vy, vw, vh = camera.viewport
        return out.reshape(vh, vw, 4)
