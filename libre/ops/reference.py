"""Ground-truth differentiable volume raymarcher in plain jax.numpy.

This reproduces — op for op — the semantics of the reference per-ray loop
(renderers/glRaycaster/shaders/fragRaycast.glsl:113-215 and
renderers/cudaRaycaster/cuda/Renderer.cu:95-230):

  * window→eye→world unprojection, ray through each pixel,
  * ray/AABB slab intersection for the global volume box and each brick,
  * eye-space near-plane clamp,
  * **global step-grid alignment** so per-brick marching is identical to a
    monolithic march (``residu = mod(tnear - tnearGlobal, step)``,
    fragRaycast.glsl:152-158) — the property that makes brick-parallel and
    ray-segment-parallel decompositions bitwise consistent,
  * clip-plane interval clamping,
  * point-sampled (GL_NEAREST, TexturePool.cpp:104-105) or trilinear
    density fetch, normalized by the data-source range (MAD,
    fragRaycast.glsl:188-203),
  * linear-filtered 256-entry transfer-function lookup,
  * front-to-back emission-absorption compositing with opacity correction
    ``alpha = 1 - (1 - min(a, 1 - 1/256))^(maxSamples/nSamples)``
    (fragRaycast.glsl:104-111) and early termination at alpha > 0.999,
    expressed as masks so the computation stays differentiable.

It is the correctness oracle for the fast paths and — being pure jnp — is
differentiable w.r.t. brick densities and transfer-function bins for
free.  It runs on any JAX backend.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libre.ops import rays as ray_ops
from libre.ops import transfer_function as tf_ops

EARLY_EXIT = 0.999
ALPHA_CLAMP = 1.0 - 1.0 / 256.0
MAX_SAMPLES_PER_RAY = 32  # opacity-correction reference count (GLRaycastRenderer.cpp:75)
MIN_SAMPLES_PER_RAY = 512


class BrickSet(NamedTuple):
    """A stack of same-shape padded bricks plus placement metadata.

    ``data``: (N, BZ, BY, BX) float32 raw densities (padded with ghost
    voxels); ``world_min/max``: (N, 3) world AABBs of the brick *interior*;
    ``tex_min/max``: (N, 3) normalized coordinates of the interior box
    within the padded brick (TextureObject.cpp:79-128).
    """

    data: jnp.ndarray
    world_min: jnp.ndarray
    world_max: jnp.ndarray
    tex_min: jnp.ndarray
    tex_max: jnp.ndarray

    @property
    def num_bricks(self) -> int:
        return self.data.shape[0]


class Camera(NamedTuple):
    """GL-style camera: modelview/projection pair plus viewport."""

    inv_proj: jnp.ndarray  # (4, 4)
    inv_mv: jnp.ndarray  # (4, 4)
    viewport: Tuple[int, int, int, int]  # static (x, y, w, h)
    near: float  # near-plane distance (Frustum::nearPlane())


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static marching parameters (RendererParameters defaults,
    rendererParameters.fbs:3-12)."""

    n_samples_per_ray: int = MIN_SAMPLES_PER_RAY
    samples_per_pixel: int = 1
    max_samples_per_ray: int = MAX_SAMPLES_PER_RAY
    data_source_range: Tuple[float, float] = (0.0, 255.0)
    early_exit: float = EARLY_EXIT
    filter_mode: str = "nearest"  # "nearest" (reference parity) | "trilinear"
    max_steps_per_brick: Optional[int] = None  # static inner trip count
    remat: bool = False  # jax.checkpoint chunk bodies (for reverse-mode AD)

    @property
    def step_size(self) -> float:
        return 1.0 / float(self.n_samples_per_ray)

    @property
    def alpha_correction(self) -> float:
        return float(self.max_samples_per_ray) / float(self.n_samples_per_ray)


def nyquist_samples_per_ray(
    voxels: Tuple[int, int, int], tree_depth: int, max_rendered_level: int
) -> int:
    """Auto sample count: Nyquist from the finest rendered LOD, min 512
    (GLRaycastRenderer.cpp:232-248)."""
    max_voxel_dim = float(max(voxels))
    max_voxels_at_lod = max_voxel_dim / float(1 << (tree_depth - max_rendered_level - 1))
    return int(max(max_voxels_at_lod, MIN_SAMPLES_PER_RAY))


def max_steps_for_bricks(
    world_min: np.ndarray, world_max: np.ndarray, step_size: float
) -> int:
    """Static bound on per-brick march length: brick diagonal / step."""
    diag = np.linalg.norm(np.asarray(world_max) - np.asarray(world_min), axis=-1)
    return int(math.ceil(float(np.max(diag)) / step_size)) + 4


def sample_density(
    brick: jnp.ndarray, tex_pos: jnp.ndarray, filter_mode: str
) -> jnp.ndarray:
    """Fetch density from a padded brick at normalized coords (..., 3).

    tex_pos axes are (x, y, z); the brick array is (Z, Y, X).  ``nearest``
    matches the reference's GL_NEAREST 3-D textures; ``trilinear`` treats
    voxel centers at (i + 0.5)/dim with clamp-to-edge.
    """
    bz, by, bx = brick.shape
    dims = jnp.asarray([bx, by, bz], jnp.float32)
    if filter_mode == "nearest":
        idx = jnp.clip(
            jnp.floor(tex_pos * dims).astype(jnp.int32),
            0,
            jnp.asarray([bx - 1, by - 1, bz - 1], jnp.int32),
        )
        return brick[idx[..., 2], idx[..., 1], idx[..., 0]]
    elif filter_mode == "trilinear":
        s = tex_pos * dims - 0.5
        s = jnp.clip(s, 0.0, dims - 1.0)
        i0 = jnp.floor(s).astype(jnp.int32)
        i1 = jnp.minimum(i0 + 1, jnp.asarray([bx - 1, by - 1, bz - 1], jnp.int32))
        w = s - jnp.floor(s)
        # 8-corner gather + lerp.
        def fetch(ix, iy, iz):
            return brick[iz, iy, ix]

        c000 = fetch(i0[..., 0], i0[..., 1], i0[..., 2])
        c100 = fetch(i1[..., 0], i0[..., 1], i0[..., 2])
        c010 = fetch(i0[..., 0], i1[..., 1], i0[..., 2])
        c110 = fetch(i1[..., 0], i1[..., 1], i0[..., 2])
        c001 = fetch(i0[..., 0], i0[..., 1], i1[..., 2])
        c101 = fetch(i1[..., 0], i0[..., 1], i1[..., 2])
        c011 = fetch(i0[..., 0], i1[..., 1], i1[..., 2])
        c111 = fetch(i1[..., 0], i1[..., 1], i1[..., 2])
        wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
        c00 = c000 * (1 - wx) + c100 * wx
        c10 = c010 * (1 - wx) + c110 * wx
        c01 = c001 * (1 - wx) + c101 * wx
        c11 = c011 * (1 - wx) + c111 * wx
        c0 = c00 * (1 - wy) + c10 * wy
        c1 = c01 * (1 - wy) + c11 * wy
        return c0 * (1 - wz) + c1 * wz
    raise ValueError(f"unknown filter mode {filter_mode!r}")


def composite(src: jnp.ndarray, dst_rgb: jnp.ndarray, dst_a: jnp.ndarray,
              alpha_correction: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Front-to-back over-composite with opacity correction
    (fragRaycast.glsl:104-111)."""
    alpha = 1.0 - jnp.power(1.0 - jnp.minimum(src[..., 3], ALPHA_CLAMP), alpha_correction)
    one_minus = 1.0 - dst_a
    dst_rgb = dst_rgb + src[..., :3] * (alpha * one_minus)[..., None]
    dst_a = dst_a + alpha * one_minus
    return dst_rgb, dst_a


def _march_one_brick(
    carry: Tuple[jnp.ndarray, jnp.ndarray],
    brick: jnp.ndarray,
    wmin: jnp.ndarray,
    wmax: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,
    t_near_plane: jnp.ndarray,
    tn_global: jnp.ndarray,
    hit_global: jnp.ndarray,
    tf: jnp.ndarray,
    clip_planes: np.ndarray,
    params: RenderParams,
    max_steps: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Composite one brick's ray segments onto the carried (rgb, a)."""
    rgb, a = carry
    step = params.step_size
    lo, hi = params.data_source_range
    mult = 1.0 / (hi - lo)
    add = -lo / (hi - lo)

    t0, t1, hit = ray_ops.intersect_box(eye, dirs, wmin, wmax)

    # Exact global step grid: sample n lives at t_n = tnGlobal + n*step —
    # the same float for every brick decomposition.  This strengthens the
    # reference's residu-based alignment (fragRaycast.glsl:152-158) from
    # "seam-free in exact arithmetic" to bit-exact decomposition
    # invariance, which the sort-last distributed parity tests rely on.
    tnear = jnp.maximum(t0, t_near_plane)
    n0 = jnp.floor((tnear - tn_global) / step).astype(jnp.int32) - 1
    # Samples before the near plane are excluded globally
    # (fragRaycast.glsl:149-150): first admissible grid index.
    n_start = jnp.ceil(
        jnp.maximum(t_near_plane - tn_global, 0.0) / step
    ).astype(jnp.int32)

    # Clip planes restrict the admissible t interval
    # (fragRaycast.glsl:162-174); brick extent itself is enforced
    # geometrically below, so start from an unbounded interval.
    if clip_planes is not None and len(clip_planes) > 0:
        t_clip_lo, t_clip_hi = ray_ops.clip_ray(
            eye,
            dirs,
            jnp.full(dirs.shape[:-1], -3e38, jnp.float32),
            jnp.full(dirs.shape[:-1], 3e38, jnp.float32),
            clip_planes,
        )
    else:
        t_clip_lo = t_clip_hi = None

    valid = hit & hit_global
    tex_scale = tmax - tmin

    def body(carry, k):
        rgb, a = carry
        n = n0 + k
        t = tn_global + n.astype(jnp.float32) * step
        # Early exit checked before compositing the next sample
        # (fragRaycast.glsl:115-117, 208-209).
        m = valid & (n >= n_start) & (a <= params.early_exit)
        if t_clip_lo is not None:
            m = m & (t > t_clip_lo) & (t <= t_clip_hi)
        pos = eye + dirs * t[..., None]
        # Half-open membership via the ray's slab interval: sample n is
        # owned by this brick iff t_n ∈ (t0, t1].  Equivalent to the
        # geometric pos-in-box test, but decided by per-ray SCALARS:
        # adjacent bricks share exact face values, so their intervals
        # tile (t0_A, t1_A] ∪ (t0_B, t1_B] without float knife edges — a
        # recomputed-position test flips boundary samples on sub-ulp
        # rounding that varies with compiler fusion.  Open on the LOW
        # side because the first global sample lies exactly ON the
        # entry face (t = tnGlobal):
        # its nearest-filter fetch coordinate would sit exactly on a
        # voxel boundary, ambiguous by one voxel between equivalent
        # arithmetic — excluding it deterministically keeps every
        # composited fetch off the maximal knife edge.  Clip intervals
        # use the same convention so conjunctions of intervals stay
        # interval tests.
        m = m & (t > t0) & (t <= t1)
        u = (pos - wmin) / (wmax - wmin)
        tex_pos = u * tex_scale + tmin
        raw = sample_density(brick, tex_pos, params.filter_mode)
        density = jnp.clip(raw * mult + add, 0.0, 1.0)
        src = tf_ops.lookup(tf, density)
        new_rgb, new_a = composite(src, rgb, a, params.alpha_correction)
        rgb = jnp.where(m[..., None], new_rgb, rgb)
        a = jnp.where(m, new_a, a)
        return (rgb, a), None

    (rgb, a), _ = jax.lax.scan(
        body, (rgb, a), jnp.arange(max_steps, dtype=jnp.int32)
    )
    return rgb, a


def render_reference(
    bricks: BrickSet,
    tf: jnp.ndarray,
    camera: Camera,
    params: RenderParams,
    global_min: jnp.ndarray,
    global_max: jnp.ndarray,
    clip_planes: Optional[np.ndarray] = None,
    brick_order: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Render a brick set to an (H, W, 4) image (bottom-up row order).

    ``brick_order`` optionally fixes the front-to-back brick processing
    order (host-side distance sort); by default bricks are sorted by
    distance of the brick center to the eye inside the computation
    (GLRaycastRenderer's DistanceOperator, GLRaycastPipeline.cpp:106-126).
    """
    vx, vy, vw, vh = camera.viewport
    n_bricks = bricks.num_bricks
    step = params.step_size

    if params.max_steps_per_brick is not None:
        max_steps = params.max_steps_per_brick
    else:
        diag = jnp.linalg.norm(bricks.world_max - bricks.world_min, axis=-1)
        max_steps = int(
            math.ceil(float(jnp.max(jax.lax.stop_gradient(diag))) / step)
        ) + 4

    images = []
    for s in range(params.samples_per_pixel):
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport, sample_index=s
        )
        dirs = dirs.reshape(-1, 3)
        t_near_plane = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)

        tn_global, _, hit_global = ray_ops.intersect_box(
            eye, dirs, global_min, global_max
        )

        if brick_order is None:
            centers = (bricks.world_min + bricks.world_max) * 0.5
            dist = jnp.linalg.norm(centers - eye, axis=-1)
            order = jnp.argsort(dist)
        else:
            order = brick_order

        rgb = jnp.zeros((dirs.shape[0], 3), jnp.float32)
        a = jnp.zeros((dirs.shape[0],), jnp.float32)

        def brick_step(carry, idx):
            rgb, a = _march_one_brick(
                carry,
                bricks.data[idx],
                bricks.world_min[idx],
                bricks.world_max[idx],
                bricks.tex_min[idx],
                bricks.tex_max[idx],
                eye,
                dirs,
                t_near_plane,
                tn_global,
                hit_global,
                tf,
                clip_planes,
                params,
                max_steps,
            )
            return (rgb, a), None

        if n_bricks == 1:
            (rgb, a), _ = brick_step((rgb, a), 0)
        else:
            (rgb, a), _ = jax.lax.scan(brick_step, (rgb, a), order)

        images.append(jnp.concatenate([rgb, a[..., None]], axis=-1))

    img = sum(images) / float(params.samples_per_pixel)
    return img.reshape(vh, vw, 4)


def single_brick_set(
    volume_zyx: jnp.ndarray,
    overlap: Tuple[int, int, int] = (0, 0, 0),
    world_min: Tuple[float, float, float] = (-0.5, -0.5, -0.5),
    world_max: Tuple[float, float, float] = (0.5, 0.5, 0.5),
) -> BrickSet:
    """Wrap one whole (Z, Y, X) volume as a single brick (configs 1-2;
    raw:// datasource semantics, RawDataSource.cpp:78-88)."""
    vol = jnp.asarray(volume_zyx, jnp.float32)[None]
    bz, by, bx = vol.shape[1:]
    ox, oy, oz = overlap
    padded = jnp.asarray([bx, by, bz], jnp.float32)
    tmin = jnp.asarray([[ox, oy, oz]], jnp.float32) / padded
    tmax = (padded - jnp.asarray([[ox, oy, oz]], jnp.float32)) / padded
    return BrickSet(
        data=vol,
        world_min=jnp.asarray([world_min], jnp.float32),
        world_max=jnp.asarray([world_max], jnp.float32),
        tex_min=tmin,
        tex_max=tmax,
    )
