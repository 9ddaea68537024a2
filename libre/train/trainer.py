"""Sharded inverse-rendering train step.

Parameters:
  * ``density`` — the (N, BZ, BY, BX) brick stack, sharded along the mesh
    brick axis (each device owns its brick range and its gradients — the
    model-parallel axis);
  * ``tf`` — the (T, 4) transfer function, replicated; its cotangents are
    psum-reduced across the mesh by shard_map's transpose rule.

The forward is the sharded marcher (sort-first rays × sort-last bricks,
libre/parallel/render.py); the loss is mean squared error against
target RGBA images; updates come from any optax optimizer.  Gradient
cross-device reduction rides the same collectives XLA inserts for the
compositing all_gather's transpose (a reduce_scatter).

Early termination is disabled under training by default
(``early_exit=1.1``): the forward's exact skip rule is a step function of
the parameters, so keeping it would make loss surfaces piecewise (the
reference has no such concern — it never differentiates;
SURVEY.md §7 stage 2 'watch early-exit').
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libre.ops.reference import BrickSet, RenderParams
from libre.parallel.mesh import BRICK_AXIS, RAY_AXIS
from libre.parallel.render import render_rays_sharded


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: Dict[str, jnp.ndarray]  # {"density": (N,BZ,BY,BX), "tf": (T,4)}
    opt_state: Any
    step: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class InverseRenderProblem:
    """Static description of what is being optimized.

    ``bricks`` supplies placement metadata (world/tex boxes, front-to-back
    ordered via shard_bricks_front_to_back); its ``data`` field is the
    initial density estimate.
    """

    bricks: BrickSet
    global_min: Any
    global_max: Any
    params: RenderParams
    max_steps: int
    chunk: int = 32

    def render(self, mesh, density, tf, eye, dirs, t_near_plane):
        return render_rays_sharded(
            mesh,
            self.bricks._replace(data=density),
            tf,
            eye,
            dirs,
            t_near_plane,
            self.params,
            self.global_min,
            self.global_max,
            self.max_steps,
            chunk=self.chunk,
        )


def init_state(
    problem: InverseRenderProblem,
    tf_init: jnp.ndarray,
    optimizer: optax.GradientTransformation,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    params = {
        "density": problem.bricks.data,
        "tf": jnp.asarray(tf_init, jnp.float32),
    }
    if mesh is not None:
        params = {
            "density": jax.device_put(
                params["density"], NamedSharding(mesh, P(BRICK_AXIS))
            ),
            "tf": jax.device_put(params["tf"], NamedSharding(mesh, P())),
        }
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=jnp.zeros((), jnp.int32),
    )


def make_train_step(
    problem: InverseRenderProblem,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    loss_fn: Optional[Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]] = None,
) -> Callable[[TrainState, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray], Tuple[TrainState, jnp.ndarray]]:
    """Build the jitted train step.

    step(state, eye, dirs, t_near_plane, target_rgba) -> (state, loss)
    with ``dirs``/``t_near_plane``/``target_rgba`` sharded along the ray
    axis and density along the brick axis.
    """
    if loss_fn is None:
        loss_fn = lambda out, target: jnp.mean((out - target) ** 2)

    def loss(params, eye, dirs, tnp, target):
        out = problem.render(
            mesh, params["density"], params["tf"], eye, dirs, tnp
        )
        return loss_fn(out, target)

    @partial(
        jax.jit,
        in_shardings=(
            None,
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P(RAY_AXIS)),
            NamedSharding(mesh, P(RAY_AXIS)),
            NamedSharding(mesh, P(RAY_AXIS)),
        ),
    )
    def step(state: TrainState, eye, dirs, tnp, target):
        loss_val, grads = jax.value_and_grad(loss)(
            state.params, eye, dirs, tnp, target
        )
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        # Keep the TF a valid colormap: premultiplied RGBA in [0, 1]
        # (the GUI's transfer-function editor enforces the same box).
        params["tf"] = jnp.clip(params["tf"], 0.0, 1.0)
        return (
            TrainState(params=params, opt_state=opt_state, step=state.step + 1),
            loss_val,
        )

    return step
