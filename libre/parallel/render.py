"""Sharded rendering: sort-first ray tiles × sort-last brick ranges.

The reference's two work decompositions (README.md:24, SURVEY.md §2.12)
expressed over a ``(ray, brick)`` jax mesh with shard_map:

  * the **ray** axis shards the flat ray batch — zero communication, the
    sort-first/tile path (each Equalizer channel renders its viewport);
  * the **brick** axis shards the front-to-back brick list — each device
    marches only its brick range and the partial (rgb, a) segments are
    over-composited in range order (eq::Compositor::blendFrames,
    Channel.cpp:444-533).

Because the marcher samples on the exact global step grid with half-open
brick membership (libre/ops/reference.py), the sharded result equals
the single-device march up to the early-termination caveat: each device
starts its segment with zero accumulated alpha, so samples that a
monolithic march would have skipped past the 0.999 threshold are still
composited — but they enter the final image scaled by the upstream
transmittance (< 0.001), bounding the deviation at ~1e-3 — the same
semantics as the reference's per-channel DB rendering, where early
termination is also local to a channel.

Differentiability: shard_map is transparently differentiable; cotangents
of replicated inputs (the transfer function, camera) are psum-reduced
across the mesh by its transpose rule, while brick-sharded density
gradients stay sharded — the natural "tensor-parallel" layout for
inverse rendering.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from libre.ops import raycast
from libre.ops.reference import BrickSet, RenderParams
from libre.parallel.compositing import fold_over
from libre.parallel.mesh import BRICK_AXIS, RAY_AXIS


def shard_bricks_front_to_back(
    bricks: BrickSet, eye: np.ndarray, n_shards: int
) -> Tuple[BrickSet, np.ndarray]:
    """Reorder bricks front-to-back and pad to a multiple of ``n_shards``.

    Returns (reordered brick set, original index of each slot; -1 = pad).
    Contiguous chunk d of the reordered list is device d's range — the
    index-interval split of the sorted visible list (SelectVisibles.cpp:
    120-142) with chunk order standing in for Channel::orderFrames.
    Padding replicates the last brick with a degenerate (empty) world box
    so every shard has equal static shape.
    """
    wmin = np.asarray(bricks.world_min)
    wmax = np.asarray(bricks.world_max)
    order = raycast.sort_bricks_front_to_back(wmin, wmax, eye)
    n = len(order)
    n_pad = (-n) % n_shards
    idx = np.concatenate([order, np.full(n_pad, order[-1])]).astype(np.int32)
    take = lambda arr: jnp.take(jnp.asarray(arr), jnp.asarray(idx), axis=0)
    new_wmin = take(wmin)
    new_wmax = take(wmax)
    if n_pad:
        # Degenerate boxes: a unit box FAR outside the scene.  Its slab
        # interval starts at t ~ 1e8, beyond any sample's t (≤ a few
        # world units), so interval-based sample ownership
        # (reference._march_one_brick) can never claim a sample — and
        # the box has nonzero extent so the world→texture MAD stays
        # finite.  (An inverted min>max box does NOT work: the slab
        # test min/max-normalizes it into a real box.)
        pad_min = jnp.broadcast_to(
            jnp.asarray([1e8, 2e8, 3e8], jnp.float32), (n_pad, 3)
        )
        pad_max = pad_min + 1e7  # extent must survive f32 at 1e8 scale
        new_wmin = jnp.concatenate([new_wmin[:n], pad_min])
        new_wmax = jnp.concatenate([new_wmax[:n], pad_max])
    out = BrickSet(
        data=take(bricks.data),
        world_min=new_wmin,
        world_max=new_wmax,
        tex_min=take(bricks.tex_min),
        tex_max=take(bricks.tex_max),
    )
    slot_to_orig = np.concatenate([order, np.full(n_pad, -1)]).astype(np.int32)
    return out, slot_to_orig


def render_rays_sharded(
    mesh: Mesh,
    bricks: BrickSet,  # front-to-back ordered, num_bricks % brick_axis == 0
    tf: jnp.ndarray,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,  # (R, 3), R % ray_axis == 0
    t_near_plane: jnp.ndarray,  # (R,)
    params: RenderParams,
    global_min,
    global_max,
    max_steps: int,
    clip_planes: Optional[np.ndarray] = None,
    chunk: int = 32,
    ray_axis: str = RAY_AXIS,
    brick_axis: str = BRICK_AXIS,
) -> jnp.ndarray:
    """March rays over a (ray, brick) mesh → (R, 4), replicated on brick.

    ``bricks`` must already be globally front-to-back ordered (use
    :func:`shard_bricks_front_to_back`); device d on the brick axis takes
    the d-th contiguous chunk, and chunk order is the compositing order.
    """
    gmin = jnp.asarray(global_min, jnp.float32)
    gmax = jnp.asarray(global_max, jnp.float32)
    brick_spec = jax.tree.map(lambda _: P(brick_axis), bricks)

    def body(bricks_l, tf_l, eye_l, dirs_l, tnp_l):
        # The scan carry is device-varying from step one; mark the zero
        # init as varying over the mesh axes so shard_map's varying-axes
        # typing accepts the scan.
        axes = tuple(mesh.axis_names)
        init = (
            jax.lax.pcast(
                jnp.zeros((dirs_l.shape[0], 3), jnp.float32), axes, to="varying"
            ),
            jax.lax.pcast(
                jnp.zeros((dirs_l.shape[0],), jnp.float32), axes, to="varying"
            ),
        )
        rgb_a = raycast.render_rays(
            bricks_l,
            tf_l,
            eye_l,
            dirs_l,
            tnp_l,
            params,
            gmin,
            gmax,
            clip_planes=clip_planes,
            max_steps=max_steps,
            chunk=chunk,
            init_carry=init,
        )
        return rgb_a[None]  # leading per-device segment axis

    # shard_map does only the per-device march (everything it returns is
    # genuinely device-varying, so the varying-axes check holds); the
    # ordered over-reduce across brick ranges happens outside in plain
    # jnp, where GSPMD inserts the gather/reduce collectives and standard
    # AD rules apply.
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(brick_spec, P(), P(), P(ray_axis), P(ray_axis)),
        out_specs=P(brick_axis, ray_axis),
    )
    parts = fn(bricks, tf, eye, dirs, t_near_plane)  # (D_brick, R, 4)
    rgb, a = fold_over(parts[..., :3], parts[..., 3])
    return jnp.concatenate([rgb, a[:, None]], axis=-1)
