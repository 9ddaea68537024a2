"""Per-pixel ray generation from GL-style camera matrices.

Reproduces the unprojection of the reference ray loop
(fragRaycast.glsl:64-71,113-147 / cuda Renderer.cu:111-130): window → NDC →
eye space (via the inverse projection, at the far plane) → world space; ray
direction from the eye through the pixel; plus the eye-space near-plane
clamp distance ``tNearPlane``.

Convention: pixel (0, 0) is the *bottom-left* pixel (GL window coords);
``gl_FragCoord`` of pixel (i, j) is (i + 0.5, j + 0.5).  Images produced by
the renderer therefore have row 0 at the bottom; use ``flip_image`` for
top-down display order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Full-precision f32 products (a default one may run in TF32 on the GPU).
HP = jax.lax.Precision.HIGHEST


def glsl_rand(co_x: jnp.ndarray, co_y: jnp.ndarray) -> jnp.ndarray:
    """The classic GLSL hash ``fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453)``
    (fragRaycast.glsl:59-62), used for subpixel jitter."""
    return jnp.mod(jnp.sin(co_x * 12.9898 + co_y * 78.233) * 43758.5453, 1.0)


def make_rays(
    inv_proj: jnp.ndarray,
    inv_mv: jnp.ndarray,
    viewport: Tuple[int, int, int, int],
    sample_index: int = 0,
    frag_override=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build per-pixel rays for a viewport.

    Returns (eye (3,), dirs (H, W, 3), t_near_plane (H, W), frag (H, W, 2)).
    ``sample_index`` selects the jittered subpixel position of multi-sample
    rendering (fragRaycast.glsl:121-127); index 0 yields zero jitter, the
    single-sample default.  ``frag_override`` = (fx, fy) supplies
    precomputed jittered fragment coords instead — callers tracing this
    under jit use it to pin the jitter hash to runtime-evaluated values
    (XLA constant-folds ``sin`` with a different libm than the runtime
    kernels, and glsl_rand's fract amplifies that ulp gap into
    decorrelated jitter).
    """
    vx, vy, vw, vh = viewport
    inv_proj = jnp.asarray(inv_proj, jnp.float32)
    inv_mv = jnp.asarray(inv_mv, jnp.float32)

    if frag_override is not None:
        fx = jnp.asarray(frag_override[0], jnp.float32)
        fy = jnp.asarray(frag_override[1], jnp.float32)
    else:
        px = jnp.arange(vw, dtype=jnp.float32) + 0.5 + vx
        py = jnp.arange(vh, dtype=jnp.float32) + 0.5 + vy
        fx, fy = jnp.meshgrid(px, py, indexing="xy")  # (H, W)

        if sample_index > 0:
            i = jnp.float32(sample_index)
            fx = fx + glsl_rand(fx * i, fy * i) * 0.5
            fy = fy + glsl_rand(fx * 2 * i, fy * 2 * i) * 0.5

    # Window → NDC (fragRaycast.glsl:67-68); note z_ndc = w_ndc = 1.
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ndc = jnp.stack(
        [ndc_x, ndc_y, jnp.ones_like(ndc_x), jnp.ones_like(ndc_x)], axis=-1
    )  # (H, W, 4)

    eye_space = jnp.matmul(ndc, inv_proj.T, precision=HP)
    eye_space = eye_space / eye_space[..., 3:4]

    world = jnp.matmul(eye_space, inv_mv.T, precision=HP)
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)

    # Ray distance to the eye-space near plane (fragRaycast.glsl:145-147):
    # t = dot(n, (0,0,-near)) / dot(n, normalize(eyePos)) with n = (0,0,1).
    eye_dir = eye_space[..., :3]
    eye_dir = eye_dir / jnp.linalg.norm(eye_dir, axis=-1, keepdims=True)
    # Caller supplies near separately; return the cosine term so that
    # t_near_plane = -near / cos_z.
    cos_z = eye_dir[..., 2]
    frag = jnp.stack([fx, fy], axis=-1)
    return eye, dirs, cos_z, frag


def near_plane_t(cos_z: jnp.ndarray, near: float) -> jnp.ndarray:
    """Ray parameter of the near-plane crossing: ``-near / cos_z``."""
    return -near / cos_z


def flip_image(img: jnp.ndarray) -> jnp.ndarray:
    """Convert a GL bottom-up image to top-down row order."""
    return img[::-1]


def intersect_box(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    box_min: jnp.ndarray,
    box_max: jnp.ndarray,
    eps: float = 1e-10,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Ray/AABB slab intersection (fragRaycast.glsl:80-102).

    Broadcasts over leading dims.  Returns (t0, t1, hit) with hit = t0 <= t1.
    Zero direction components are nudged to ``eps`` exactly like the
    reference to avoid division by zero.
    """
    d = jnp.where(direction == 0.0, eps, direction)
    inv = 1.0 / d
    tbot = inv * (box_min - origin)
    ttop = inv * (box_max - origin)
    tmin = jnp.minimum(ttop, tbot)
    tmax = jnp.maximum(ttop, tbot)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    return t0, t1, t0 <= t1


def clip_ray(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_near: jnp.ndarray,
    t_far: jnp.ndarray,
    clip_planes: np.ndarray,
    eps: float = 1e-10,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Clamp a ray's [t_near, t_far] interval by clip planes
    (fragRaycast.glsl:162-174).  ``clip_planes`` is a static (P, 4) array."""
    for p in np.asarray(clip_planes, np.float32):
        normal = jnp.asarray(p[:3])
        rn = jnp.matmul(direction, normal, precision=HP)
        rn = jnp.where(rn == 0.0, eps, rn)
        t = -(jnp.matmul(origin, normal, precision=HP) + p[3]) / rn
        t_near = jnp.where(rn > 0.0, jnp.maximum(t_near, t), t_near)
        t_far = jnp.where(rn > 0.0, t_far, jnp.minimum(t_far, t))
    return t_near, t_far
