"""Inverse rendering through the shear-warp fast path.

The marcher-based trainer (train/trainer.py) shards density BRICKS
model-parallel — the out-of-core-faithful path.  This trainer is the
fast dense-volume variant: optimize a full (Z, Y, X) density grid and
the transfer function against multi-view target images through the
sharded jnp shear-warp pipeline (parallel/shearwarp_sharded.py).  On a
(ray × brick) mesh the forward shards slope rows and plane ranges; the
volume and TF are replicated, so shard_map's transpose psums their
cotangents across the mesh automatically.

Early exit is disabled under training (a step function of the
parameters — same rule as InverseRenderProblem; SURVEY.md §7 stage 2),
and classification must be "pre" or "post" as configured — both are
differentiable.

This is BASELINE config 5 at dense-level granularity; per-view plans
(major axis, slope bounds) are host-built constants of the compiled
step, exactly like camera matrices in the reference's FrameData.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from libre.ops import shearwarp as sw
from libre.ops.reference import Camera, RenderParams
from libre.parallel.shearwarp_sharded import render_slope_grid_sharded


@dataclasses.dataclass(frozen=True)
class ShearWarpProblem:
    """Static problem description: views + render configuration."""

    plans: Tuple[sw.ShearWarpPlan, ...]
    world_min: np.ndarray
    world_max: np.ndarray
    params: RenderParams
    swp: sw.ShearWarpParams

    @classmethod
    def from_cameras(
        cls,
        cameras: Sequence[Camera],
        world_min,
        world_max,
        params: RenderParams,
        swp: sw.ShearWarpParams,
    ) -> "ShearWarpProblem":
        # Disable early exit under grad: it is a step function of the
        # parameters and would zero gradients behind the cut.
        params = dataclasses.replace(params, early_exit=1.1)
        return cls(
            plans=tuple(sw.make_plan(c, swp.slope_margin) for c in cameras),
            world_min=np.asarray(world_min, np.float32),
            world_max=np.asarray(world_max, np.float32),
            params=params,
            swp=swp,
        )

    def render_views(self, mesh, volume, tf) -> List[jnp.ndarray]:
        """All views' slope-grid images (V, U, 4), sharded over the mesh
        (single-device when mesh is None)."""
        outs = []
        for plan in self.plans:
            if mesh is None:
                img, _, _ = sw.render_slope_grid(
                    volume, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
                    self.world_min, self.world_max, self.params, self.swp,
                )
            else:
                img = render_slope_grid_sharded(
                    mesh, volume, tf, plan.eye, plan.axis, plan.sign,
                    plan.bounds, self.world_min, self.world_max,
                    self.params, self.swp,
                )
            outs.append(img)
        return outs


def make_train_step(problem: ShearWarpProblem, optimizer, mesh=None):
    """jitted (params, opt_state, targets) -> (params, opt_state, loss);
    params = {"volume": (Z,Y,X), "tf": (T,4)} — both replicated, both
    optimized."""

    def loss_fn(params, targets):
        imgs = problem.render_views(mesh, params["volume"], params["tf"])
        losses = [
            jnp.mean((img - tgt) ** 2) for img, tgt in zip(imgs, targets)
        ]
        return sum(losses) / len(losses)

    @jax.jit
    def step(params, opt_state, targets):
        loss, grads = jax.value_and_grad(loss_fn)(params, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # physical ranges: densities and TF entries live in [0, 1]
        params = {
            "volume": jnp.clip(params["volume"], 0.0, 1.0),
            "tf": jnp.clip(params["tf"], 0.0, 1.0),
        }
        return params, opt_state, loss

    return step


def fit(
    problem: ShearWarpProblem,
    targets: Sequence[jnp.ndarray],
    init_volume: jnp.ndarray,
    init_tf: jnp.ndarray,
    *,
    mesh=None,
    optimizer: Optional[optax.GradientTransformation] = None,
    steps: int = 100,
):
    """Run the optimization; returns (params, losses)."""
    optimizer = optimizer or optax.adam(3e-2)
    params = {"volume": jnp.asarray(init_volume), "tf": jnp.asarray(init_tf)}
    opt_state = optimizer.init(params)
    step = make_train_step(problem, optimizer, mesh)
    losses = []
    targets = [jnp.asarray(t) for t in targets]
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, targets)
        losses.append(float(loss))
    return params, losses
