"""Multi-device shear-warp: slope rows × plane ranges over the mesh.

The same two decomposition axes as the marcher (SURVEY.md §2.12), mapped
onto the shear-warp pipeline:

  * **ray axis** shards the slope-grid rows (V) — sort-first tiles, zero
    communication;
  * **brick axis** shards the plane stack (K) into contiguous
    front-to-back ranges — the ray-segment (sort-last/DB) axis; each
    device composites its plane range in closed form and the partial
    (rgb, a) segments fold with the over operator in rank order
    (eq::Compositor::blendFrames, Channel.cpp:444-533).

Per-device work is the same batched-matmul pipeline as
ops/shearwarp.render_slope_grid with the plane/row subranges selected by
the device's mesh coordinates; the fold happens outside shard_map so
GSPMD inserts the collectives and standard AD applies (gradients of the
replicated volume/TF psum across the mesh).  The production sharded
path is parallel/bricked_sharded.py (the bricked plane march per
device).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from libre.ops.reference import RenderParams
from libre.ops.shearwarp import (
    _BC_AXES,
    _PERM,
    HP,
    ShearWarpParams,
    _composite_planes,
    _lerp_matrix,
    precompute_classified_volume,
)
from libre.parallel.compositing import fold_over
from libre.parallel.mesh import BRICK_AXIS, RAY_AXIS


def render_slope_grid_sharded(
    mesh: Mesh,
    volume_zyx: jnp.ndarray,
    tf: jnp.ndarray,
    eye: np.ndarray,
    axis: int,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: ShearWarpParams,
    ray_axis: str = RAY_AXIS,
    brick_axis: str = BRICK_AXIS,
) -> jnp.ndarray:
    """→ (V, U, 4) slope-space image, V sharded / plane-folded.

    V must divide the ray-axis size and K the brick-axis size.
    """
    K = swp.n_planes
    V, U = swp.inter_size
    d_k = mesh.shape[brick_axis]
    d_v = mesh.shape[ray_axis]
    if V % d_v or K % d_k:
        raise ValueError(f"V={V} K={K} must divide mesh axes {d_v}x{d_k}")
    K_l, V_l = K // d_k, V // d_v

    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    perm = _PERM[axis]
    b_axis, c_axis = _BC_AXES[axis]
    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    wb0, wb1 = float(wmin[b_axis]), float(wmax[b_axis])
    wc0, wc1 = float(wmin[c_axis]), float(wmax[c_axis])
    ea, eb, ec = float(eye[axis]), float(eye[b_axis]), float(eye[c_axis])
    u0, u1, v0, v1 = slope_bounds
    dz = (wa1 - wa0) / K

    chans = precompute_classified_volume(
        volume_zyx, tf, params.data_source_range
    )
    chans = jnp.stack([jnp.transpose(ch, perm) for ch in chans])  # (4,A,C,B)
    Na, Nc, Nb = chans.shape[1:]

    ug = jnp.linspace(u0, u1, U, dtype=jnp.float32)

    def body(chans_l):
        kd = jax.lax.axis_index(brick_axis)
        vd = jax.lax.axis_index(ray_axis)
        j = (kd * K_l + jnp.arange(K_l)).astype(jnp.float32)  # global planes
        z = jnp.where(sign > 0, wa0 + (j + 0.5) * dz, wa1 - (j + 0.5) * dz)
        vg = v0 + (v1 - v0) * (
            (vd * V_l + jnp.arange(V_l)).astype(jnp.float32) / (V - 1)
        )

        sa = (z - wa0) / (wa1 - wa0) * Na - 0.5
        A = _lerp_matrix(sa[None, :], Na, jnp.ones((1, K_l), jnp.float32))[0].T

        delta = (z - ea)[:, None]
        xb = eb + ug[None, :] * delta
        Mb = _lerp_matrix(
            (xb - wb0) / (wb1 - wb0) * Nb - 0.5,
            Nb,
            ((xb >= wb0) & (xb < wb1)).astype(jnp.float32),
        )
        xc = ec + vg[None, :] * delta
        Mc = _lerp_matrix(
            (xc - wc0) / (wc1 - wc0) * Nc - 0.5,
            Nc,
            ((xc >= wc0) & (xc < wc1)).astype(jnp.float32),
        )

        slabs = []
        for ch in range(4):
            vs = jnp.einsum(
                "ka,acb->kcb", A, chans_l[ch],
                preferred_element_type=jnp.float32, precision=HP,
            )
            s1 = jnp.einsum(
                "kcb,kbu->kcu", vs, Mb, preferred_element_type=jnp.float32,
                precision=HP,
            )
            slabs.append(
                jnp.einsum(
                    "kcu,kcv->kvu", s1, Mc,
                    preferred_element_type=jnp.float32, precision=HP,
                )
            )

        length = jnp.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
        corr = params.max_samples_per_ray * dz * length
        r, g, b, a = _composite_planes(
            slabs[0], slabs[1], slabs[2], slabs[3], corr, params.early_exit
        )
        return jnp.stack([r, g, b, a], axis=-1)[None]  # (1, V_l, U, 4)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=P(brick_axis, ray_axis),
    )
    parts = fn(chans)  # (d_k, V, U, 4) — rank order is plane order
    rgb, a = fold_over(parts[..., :3], parts[..., 3])
    return jnp.concatenate([rgb, a[..., None]], axis=-1)
