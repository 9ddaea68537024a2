"""Exact forward raymarcher — the gather marcher, plain XLA.

Semantically identical to :mod:`libre.ops.reference` (same global sample
grid, same half-open brick membership, same opacity-corrected compositing
and early termination — fragRaycast.glsl:113-215), but organized for
throughput instead of per-sample clarity:

  * **structure-of-arrays layout**: every materialized tensor is (rays,
    chunk) or (rays,) — never (rays, chunk, 3/4); x/y/z and r/g/b/a live
    in separate (R, C) arrays, so fusions read and write unit-stride
    rows;
  * samples are processed in (rays × chunk) blocks so the density fetch is
    a large batched gather per trilinear corner;
  * per-chunk compositing uses exclusive cumulative transmittance products
    instead of a serial per-sample scan: over-compositing is associative,
    so the chunk's contribution folds into the carried (rgb, a) in closed
    form — the same structure ring/blockwise attention uses for partial
    softmax states (SURVEY.md §5.7);
  * early termination is EXACT: a sample is excluded iff the accumulated
    alpha *before* it exceeds the threshold, which is computable from the
    unmasked prefix transmittance because alpha is monotone (see
    ``_composite_chunk``);
  * per-brick work can be wrapped in ``jax.checkpoint`` so reverse-mode AD
    recomputes chunks instead of saving O(rays × samples) residuals.

The brick loop is a Python loop (unrolled at trace time): brick counts per
pass are small (the multipass batching of GLRaycastPipeline.cpp:148-163
bounds the working set), and unrolling lets XLA schedule the bricks'
gathers back to back.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libre.ops import rays as ray_ops
from libre.ops.reference import (
    ALPHA_CLAMP,
    BrickSet,
    Camera,
    RenderParams,
)

# Carry: (r, g, b, a) premultiplied channels, each (R,).
Carry = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]


def _exclusive_cumprod(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """prod_{j<i} x_j along ``axis`` (1 at index 0)."""
    cp = jnp.cumprod(x, axis=axis)
    one = jnp.ones_like(jnp.take(cp, jnp.asarray([0]), axis=axis))
    return jnp.concatenate(
        [one, jax.lax.slice_in_dim(cp, 0, x.shape[axis] - 1, axis=axis)],
        axis=axis,
    )


def _composite_chunk(
    carry: Carry,
    src_r: jnp.ndarray,  # (R, C) chunk TF channels
    src_g: jnp.ndarray,
    src_b: jnp.ndarray,
    alpha_corrected: jnp.ndarray,  # (R, C) opacity-corrected per-sample alpha
    valid: jnp.ndarray,  # (R, C) membership mask
    early_exit: float,
) -> Carry:
    """Fold one chunk of samples into the carry, in closed form.

    Equivalent to compositing the samples serially front-to-back with the
    reference's early-exit rule (skip a sample iff accumulated alpha before
    it exceeds ``early_exit``).  Monotonicity of alpha makes the exact
    early-exit mask computable from the *unmasked* prefix transmittance.
    """
    r, g, b, a = carry
    alpha_v = alpha_corrected * valid.astype(alpha_corrected.dtype)
    t_excl_u = _exclusive_cumprod(1.0 - alpha_v, axis=1)  # (R, C)
    global_before = a[:, None] + (1.0 - a[:, None]) * (1.0 - t_excl_u)
    m = global_before <= early_exit
    alpha_eff = alpha_v * m.astype(alpha_v.dtype)
    t_excl = _exclusive_cumprod(1.0 - alpha_eff, axis=1)
    w = alpha_eff * t_excl  # per-sample weight within the chunk
    chunk_trans = jnp.prod(1.0 - alpha_eff, axis=1)
    one_minus_a = 1.0 - a
    r = r + one_minus_a * jnp.sum(w * src_r, axis=1)
    g = g + one_minus_a * jnp.sum(w * src_g, axis=1)
    b = b + one_minus_a * jnp.sum(w * src_b, axis=1)
    a = a + one_minus_a * (1.0 - chunk_trans)
    return r, g, b, a


def _tf_lookup_channels(tf: jnp.ndarray, density: jnp.ndarray):
    """GL linear 1-D TF lookup, channelwise: (T, 4) × (R, C) → 4× (R, C).

    Same math as transfer_function.lookup but gathering each channel from
    a flat (T,) table so no (R, C, 4) tensor is materialized.
    """
    n = tf.shape[0]
    s = jnp.clip(density, 0.0, 1.0) * n - 0.5
    s = jnp.clip(s, 0.0, float(n - 1))
    i0f = jnp.floor(s)
    w = s - i0f
    i0 = i0f.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    out = []
    for c in range(4):
        chan = tf[:, c]
        out.append(jnp.take(chan, i0) * (1.0 - w) + jnp.take(chan, i1) * w)
    return out


def _fetch_nearest(brick_flat, tex_x, tex_y, tex_z, dims_xyz):
    bx, by, bz = dims_xyz
    ix = jnp.clip(jnp.floor(tex_x * bx).astype(jnp.int32), 0, bx - 1)
    iy = jnp.clip(jnp.floor(tex_y * by).astype(jnp.int32), 0, by - 1)
    iz = jnp.clip(jnp.floor(tex_z * bz).astype(jnp.int32), 0, bz - 1)
    flat = (iz * by + iy) * bx + ix
    return jnp.take(brick_flat, flat)


def _fetch_trilinear(brick_flat, tex_x, tex_y, tex_z, dims_xyz):
    bx, by, bz = dims_xyz

    def prep(tex, dim):
        s = jnp.clip(tex * dim - 0.5, 0.0, dim - 1.0)
        i0 = jnp.floor(s)
        w = s - i0
        i0 = i0.astype(jnp.int32)
        i1 = jnp.minimum(i0 + 1, dim - 1)
        return i0, i1, w

    ix0, ix1, wx = prep(tex_x, bx)
    iy0, iy1, wy = prep(tex_y, by)
    iz0, iz1, wz = prep(tex_z, bz)

    def flat(ix, iy, iz):
        return (iz * by + iy) * bx + ix

    out = 0.0
    for dxb in (0, 1):
        for dyb in (0, 1):
            for dzb in (0, 1):
                ix = ix1 if dxb else ix0
                iy = iy1 if dyb else iy0
                iz = iz1 if dzb else iz0
                wgt = (
                    (wx if dxb else 1.0 - wx)
                    * (wy if dyb else 1.0 - wy)
                    * (wz if dzb else 1.0 - wz)
                )
                out = out + jnp.take(brick_flat, flat(ix, iy, iz)) * wgt
    return out


def _march_brick(
    carry: Carry,
    brick,  # (BZ, BY, BX)
    wmin,
    wmax,
    tmin,
    tmax,
    eye,
    dirs,
    t_near_plane,
    tn_global,
    hit_global,
    tf,
    clip_bounds,  # None or (t_clip_lo, t_clip_hi)
    params: RenderParams,
    max_steps: int,
    chunk: int,
) -> Carry:
    step = params.step_size
    lo, hi = params.data_source_range
    mult = 1.0 / (hi - lo)
    add = -lo / (hi - lo)
    bz, by, bx = brick.shape
    brick_flat = brick.reshape(-1)

    t0, t1, hit = ray_ops.intersect_box(eye, dirs, wmin, wmax)
    tnear = jnp.maximum(t0, t_near_plane)
    n0 = jnp.floor((tnear - tn_global) / step).astype(jnp.int32) - 1
    n_start = jnp.ceil(jnp.maximum(t_near_plane - tn_global, 0.0) / step).astype(
        jnp.int32
    )
    valid_ray = hit & hit_global

    # Per-brick scalars / per-ray (R,) arrays, split per axis (SoA).
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ex, ey, ez = eye[0], eye[1], eye[2]
    wminx, wminy, wminz = wmin[0], wmin[1], wmin[2]
    wmaxx, wmaxy, wmaxz = wmax[0], wmax[1], wmax[2]
    # world → padded-texture coords: tex = (p - wmin)/(wmax - wmin) * (tmax
    # - tmin) + tmin, folded into a single MAD per axis.
    sx = (tmax[0] - tmin[0]) / (wmaxx - wminx)
    sy = (tmax[1] - tmin[1]) / (wmaxy - wminy)
    sz = (tmax[2] - tmin[2]) / (wmaxz - wminz)
    ox = tmin[0] - wminx * sx
    oy = tmin[1] - wminy * sy
    oz = tmin[2] - wminz * sz

    n_chunks = -(-max_steps // chunk)
    fetch = _fetch_nearest if params.filter_mode == "nearest" else _fetch_trilinear

    def chunk_body(carry, c):
        k = c * chunk + jnp.arange(chunk, dtype=jnp.int32)  # (C,)
        n = n0[:, None] + k[None, :]  # (R, C)
        t = tn_global[:, None] + n.astype(jnp.float32) * step
        px = ex + dx[:, None] * t
        py = ey + dy[:, None] * t
        pz = ez + dz[:, None] * t
        # Slab-interval membership (see reference._march_one_brick):
        # half-open (t0, t1] owns each sample deterministically.
        inside = (t > t0[:, None]) & (t <= t1[:, None])
        m = valid_ray[:, None] & inside & (n >= n_start[:, None])
        if clip_bounds is not None:
            t_clip_lo, t_clip_hi = clip_bounds
            m = m & (t > t_clip_lo[:, None]) & (t <= t_clip_hi[:, None])
        tex_x = px * sx + ox
        tex_y = py * sy + oy
        tex_z = pz * sz + oz
        raw = fetch(brick_flat, tex_x, tex_y, tex_z, (bx, by, bz))
        density = jnp.clip(raw * mult + add, 0.0, 1.0)
        src_r, src_g, src_b, src_a = _tf_lookup_channels(tf, density)
        alpha = 1.0 - jnp.power(
            1.0 - jnp.minimum(src_a, ALPHA_CLAMP), params.alpha_correction
        )
        carry = _composite_chunk(
            carry, src_r, src_g, src_b, alpha, m, params.early_exit
        )
        return carry, None

    body = jax.checkpoint(chunk_body) if params.remat else chunk_body
    carry, _ = jax.lax.scan(
        body, carry, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return carry


def render_rays(
    bricks: BrickSet,
    tf: jnp.ndarray,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,  # (R, 3)
    t_near_plane: jnp.ndarray,  # (R,)
    params: RenderParams,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
    brick_order: Optional[np.ndarray] = None,
    max_steps: Optional[int] = None,
    chunk: int = 32,
    init_carry: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> jnp.ndarray:
    """March a flat batch of rays through a brick set → (R, 4).

    ``brick_order`` must be the host-computed front-to-back order (static);
    defaults to range(N) (i.e. bricks already sorted).  ``init_carry`` is
    the per-ray (rgb, a) accumulated by earlier memory-bounded passes
    (the accumulation texture persisting across multipass batches,
    GLRaycastPipeline.cpp:148-186 / fragRaycast.glsl:115) — passing it
    keeps early termination exact across pass boundaries.
    """
    n_bricks = bricks.num_bricks
    step = params.step_size

    tn_global, _, hit_global = ray_ops.intersect_box(
        eye, dirs, jnp.asarray(global_min), jnp.asarray(global_max)
    )

    if clip_planes is not None and len(clip_planes) > 0:
        clip_bounds = ray_ops.clip_ray(
            eye,
            dirs,
            jnp.full(dirs.shape[:-1], -3e38, jnp.float32),
            jnp.full(dirs.shape[:-1], 3e38, jnp.float32),
            clip_planes,
        )
    else:
        clip_bounds = None

    if max_steps is None:
        try:
            diag = np.linalg.norm(
                np.asarray(jax.lax.stop_gradient(bricks.world_max))
                - np.asarray(jax.lax.stop_gradient(bricks.world_min)),
                axis=-1,
            )
        except jax.errors.TracerArrayConversionError as exc:
            raise ValueError(
                "render_rays: pass max_steps explicitly when brick metadata "
                "is traced (inside jit) — the march trip count must be static"
            ) from exc
        max_steps = int(math.ceil(float(diag.max()) / step)) + 4

    order = range(n_bricks) if brick_order is None else [int(i) for i in brick_order]

    if init_carry is not None:
        rgb0, a0 = init_carry
        carry = (rgb0[:, 0], rgb0[:, 1], rgb0[:, 2], a0)
    else:
        zeros = jnp.zeros((dirs.shape[0],), jnp.float32)
        carry = (zeros, zeros, zeros, zeros)
    for i in order:
        carry = _march_brick(
            carry,
            bricks.data[i],
            bricks.world_min[i],
            bricks.world_max[i],
            bricks.tex_min[i],
            bricks.tex_max[i],
            eye,
            dirs,
            t_near_plane,
            tn_global,
            hit_global,
            tf,
            clip_bounds,
            params,
            max_steps,
            chunk,
        )
    r, g, b, a = carry
    return jnp.stack([r, g, b, a], axis=-1)


def render(
    bricks: BrickSet,
    tf: jnp.ndarray,
    camera: Camera,
    params: RenderParams,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
    brick_order: Optional[np.ndarray] = None,
    chunk: int = 32,
    max_steps: Optional[int] = None,
) -> jnp.ndarray:
    """Render to an (H, W, 4) image (bottom-up rows, like GL)."""
    vx, vy, vw, vh = camera.viewport
    images = []
    for s in range(params.samples_per_pixel):
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport, sample_index=s
        )
        dirs = dirs.reshape(-1, 3)
        tnp_ = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
        img = render_rays(
            bricks,
            tf,
            eye,
            dirs,
            tnp_,
            params,
            global_min,
            global_max,
            clip_planes,
            brick_order,
            chunk=chunk,
            max_steps=max_steps,
        )
        images.append(img)
    out = sum(images) / float(params.samples_per_pixel)
    return out.reshape(vh, vw, 4)


def sort_bricks_front_to_back(
    world_min: np.ndarray, world_max: np.ndarray, eye: np.ndarray
) -> np.ndarray:
    """Host-side front-to-back brick order by center distance
    (GLRaycastPipeline.cpp:106-126 DistanceOperator)."""
    centers = (np.asarray(world_min) + np.asarray(world_max)) * 0.5
    dist = np.linalg.norm(centers - np.asarray(eye), axis=-1)
    return np.argsort(dist, kind="stable")
