"""Shear-warp raymarcher over a dense LOD level, in plain XLA.

Shear-warp (Lacroute & Levoy '94; perspective variant) turns volume
resampling into dense per-plane interpolation: the dense ``shearwarp``
renderer, its sharded form (parallel/shearwarp_sharded.py) and the
shearwarp trainer use it, and ``plane_oracle`` is the exactness oracle of
the bricked plane march (ops/shearwarp_bricked.py).

Factorization M = Warp2D ∘ Composite ∘ Shear:

  1. pick the volume axis most aligned with the view (the major axis);
  2. parameterize rays by their slope (u, v) = (d_b/d_a, d_c/d_a)
     through the eye — every sample of slope-ray (u, v) on axis plane
     a = z_j lies at the *affine-in-(u, v)* in-plane point
     (e_b + u·(z_j − e_a), e_c + v·(z_j − e_a));
  3. therefore resampling each (virtual) axis plane onto a regular
     (u, v) grid is a pair of 1-D linear interpolations with per-plane
     scale/offset — expressed as small dense matmuls, batched over
     planes;
  4. samples composite straight down the plane stack (front-to-back in
     closed form with the exact early-exit rule of
     ops/raycast._composite_chunk);
  5. a single 2-D bilinear warp maps the slope-space image to screen
     pixels (the only gather left: 4 indices/pixel).

Sampling semantics: trilinear interpolation at exact ray∩plane points
(axis-lerped virtual planes + in-plane bilinear = trilinear), half-open
box membership, and per-ray opacity correction
``alpha = 1−(1−min(a, 1−1/256))^(maxSamples·step_euclidean)`` — the
reference's correction (fragRaycast.glsl:104-111) with the per-ray
Euclidean step dz·√(1+u²+v²).  It differs from ops/raycast only in
WHERE samples lie: uniform in the major axis instead of uniform in ray
arc length (the documented shear-warp trade; both converge with sample
count).  ``plane_oracle`` marches the identical sample set with gathers
and is the exactness oracle for the matmul pipeline.

Classification: ``pre`` (default, classic shear-warp) applies the
transfer function to voxels once and interpolates RGBA — fast and
cacheable across frames; ``post`` classifies interpolated densities per
sample (reference semantics) via an extra per-plane lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libre.ops import rays as ray_ops
from libre.ops.reference import ALPHA_CLAMP, Camera, RenderParams
from libre.ops import transfer_function as tf_ops


@dataclasses.dataclass(frozen=True)
class ShearWarpParams:
    """Static shear-warp configuration."""

    n_planes: int = 256  # K: virtual axis planes = samples per ray
    inter_size: Tuple[int, int] = (256, 256)  # (V, U) slope-grid size
    slope_margin: float = 0.02  # widen the slope bounds by this fraction
    classification: str = "pre"  # "pre" | "post"


# Axis permutations: volume arrays are (Z, Y, X) = world axes (2, 1, 0).
# For major world axis a, permute to (A, C, B) with B the fastest dim.
_PERM = {
    0: (2, 0, 1),  # major x: (X, Z, Y) -> b = y, c = z
    1: (1, 0, 2),  # major y: (Y, Z, X) -> b = x, c = z
    2: (0, 1, 2),  # major z: (Z, Y, X) -> b = x, c = y
}
# Full-precision f32 products: a default-precision one may run in TF32
# on the GPU.
HP = jax.lax.Precision.HIGHEST
_BC_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # world (b, c) per major a


def choose_major_axis(camera: Camera) -> Tuple[int, float]:
    """Major world axis + marching sign from the central view direction
    (the shear-warp principal-axis selection)."""
    inv_mv = np.asarray(camera.inv_mv)
    view_dir = -inv_mv[:3, 2]  # camera looks down -z in eye space
    axis = int(np.argmax(np.abs(view_dir)))
    return axis, float(np.sign(view_dir[axis]) or 1.0)


def pixel_slopes(camera: Camera, axis: int):
    """Per-pixel slopes (u, v) w.r.t. the major axis + validity.

    Returns (u (H, W), v (H, W), d_a (H, W) — the major-axis direction
    component whose sign must match the marching sign).
    """
    _, dirs, _, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport
    )
    b, c = _BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = jnp.where(jnp.abs(d_a) < 1e-6, 1e-6, d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


def _pixel_slopes_np(camera: Camera, axis: int):
    """Pure-numpy pixel_slopes for per-frame host planning — make_plan
    runs every camera move and must not bounce through the device
    (rays.make_rays semantics with sample_index=0)."""
    vx, vy, vw, vh = camera.viewport
    inv_proj = np.asarray(camera.inv_proj, np.float32)
    inv_mv = np.asarray(camera.inv_mv, np.float32)
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    fx, fy = np.meshgrid(px, py, indexing="xy")
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = np.ones_like(ndc_x)
    ndc = np.stack([ndc_x, ndc_y, ones, ones], axis=-1)
    eye_space = ndc @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b, c = _BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = np.where(np.abs(d_a) < 1e-6, np.float32(1e-6), d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


def _boundary_slopes_np(camera: Camera, axis: int):
    """_pixel_slopes_np evaluated on the viewport BOUNDARY pixels only
    (~2(W+H) rays instead of W·H).  The slopes u = dir_b/dir_a are
    ratios of functions linear in pixel coordinates, so their extrema
    over the (convex) viewport lie on its boundary — sufficient for
    slope-bounds planning at ~1/60 the host cost."""
    vx, vy, vw, vh = camera.viewport
    inv_proj = np.asarray(camera.inv_proj, np.float32)
    inv_mv = np.asarray(camera.inv_mv, np.float32)
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    fx = np.concatenate([px, px, np.full(vh, px[0]), np.full(vh, px[-1])])
    fy = np.concatenate([np.full(vw, py[0]), np.full(vw, py[-1]), py, py])
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = np.ones_like(ndc_x)
    ndc = np.stack([ndc_x, ndc_y, ones, ones], axis=-1)
    eye_space = ndc @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b, c = _BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = np.where(np.abs(d_a) < 1e-6, np.float32(1e-6), d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


def choose_major_axis_np(camera: Camera) -> Tuple[int, float]:
    inv_mv = np.asarray(camera.inv_mv)
    view_dir = -inv_mv[:3, 2]
    axis = int(np.argmax(np.abs(view_dir)))
    return axis, float(np.sign(view_dir[axis]) or 1.0)


@dataclasses.dataclass(frozen=True)
class ViewPlan:
    """Light per-view plan for single-dispatch frame paths: axis, sign,
    slope bounds, eye — no per-pixel slope grids (those are computed on
    device by warp_frame_device): it touches only the viewport's
    boundary pixels, where make_plan evaluates every pixel on the
    host."""

    axis: int
    sign: float
    bounds: Tuple[float, float, float, float]
    eye: np.ndarray


def make_view_plan(camera: Camera, margin: float = 0.02) -> ViewPlan:
    axis, sign = choose_major_axis_np(camera)
    u, v, d_a = _boundary_slopes_np(camera, axis)
    return ViewPlan(
        axis=axis,
        sign=sign,
        bounds=_slope_bounds(u, v, d_a, sign, margin),
        eye=np.asarray(camera.inv_mv)[:3, 3].astype(np.float32),
    )


def _slope_bounds(u, v, d_a, sign, margin):
    """Host-side slope-grid bounds over forward-marching pixels."""
    u = np.asarray(u)
    v = np.asarray(v)
    ok = np.sign(np.asarray(d_a)) == sign
    if not ok.any():
        return (-1.0, 1.0, -1.0, 1.0)
    uu, vv = u[ok], v[ok]
    du = (uu.max() - uu.min()) * margin + 1e-6
    dv = (vv.max() - vv.min()) * margin + 1e-6
    return (
        float(uu.min() - du),
        float(uu.max() + du),
        float(vv.min() - dv),
        float(vv.max() + dv),
    )


def _lerp_matrix(coords: jnp.ndarray, n: int, inside: jnp.ndarray) -> jnp.ndarray:
    """(..., M) fractional voxel coords → (..., n, M) two-tap linear
    interpolation matrix with clamp-to-edge, zeroed outside the box."""
    s = jnp.clip(coords, -0.5, n - 0.5)
    i0f = jnp.floor(jnp.clip(s, 0.0, float(n - 1)))
    w = jnp.clip(s - i0f, 0.0, 1.0)
    i0 = i0f.astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    grid = jax.lax.broadcasted_iota(
        jnp.int32, (*coords.shape[:-1], n, coords.shape[-1]), coords.ndim - 1
    )
    m = (grid == i0[..., None, :]) * (1.0 - w[..., None, :]) + (
        grid == i1[..., None, :]
    ) * w[..., None, :]
    return m * inside[..., None, :]


def _premultiply_mask(sign: float, d_a: jnp.ndarray) -> jnp.ndarray:
    return (jnp.sign(d_a) == sign).astype(jnp.float32)


def precompute_classified_volume(volume_zyx, tf, data_source_range):
    """Pre-classification: TF applied per voxel → 4 channel volumes
    (one 256-table gather over the voxels, cacheable across frames)."""
    lo, hi = data_source_range
    density = jnp.clip(
        (volume_zyx.astype(jnp.float32) - lo) / (hi - lo), 0.0, 1.0
    )
    rgba = tf_ops.lookup(tf, density)  # (Z, Y, X, 4)
    return tuple(rgba[..., i] for i in range(4))


def _exclusive_cumprod(x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Exclusive cumulative product along ``axis`` via lax.scan.

    Functionally ``concat([1, cumprod(x)[:-1]])``, but jnp.cumprod's
    transpose breaks under shard_map ("Unexpected XLA sharding
    override" as of jax 0.9) — the scan form differentiates cleanly and
    multiplies in the same sequential order as the Pallas kernel's
    carried transmittance.
    """
    x = jnp.moveaxis(x, axis, 0)

    def step(carry, row):
        return carry * row, carry

    _, out = jax.lax.scan(step, jnp.ones_like(x[0]), x)
    return jnp.moveaxis(out, 0, axis)


def _composite_planes(
    slab_r, slab_g, slab_b, alpha, corr, early_exit
):
    """Closed-form front-to-back compositing along the plane axis (K
    leading) with exact early exit — ops/raycast._composite_chunk over
    the whole stack."""
    a_corr = 1.0 - jnp.power(
        1.0 - jnp.minimum(alpha, ALPHA_CLAMP), corr[None]
    )
    t_excl_u = _exclusive_cumprod(1.0 - a_corr, axis=0)
    global_before = 1.0 - t_excl_u
    m = (global_before <= early_exit).astype(a_corr.dtype)
    a_eff = a_corr * m
    t_excl = _exclusive_cumprod(1.0 - a_eff, axis=0)
    w = a_eff * t_excl
    out_r = jnp.sum(w * slab_r, axis=0)
    out_g = jnp.sum(w * slab_g, axis=0)
    out_b = jnp.sum(w * slab_b, axis=0)
    out_a = 1.0 - jnp.prod(1.0 - a_eff, axis=0)
    return out_r, out_g, out_b, out_a


def render_slope_grid(
    volume_zyx: jnp.ndarray,
    tf: jnp.ndarray,
    eye: jnp.ndarray,  # (3,) world
    axis: int,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: ShearWarpParams,
):
    """The shear+composite stages: → (V, U, 4) slope-space image.

    Returns (image, u_grid (U,), v_grid (V,)).
    """
    K = swp.n_planes
    V, U = swp.inter_size
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    perm = _PERM[axis]
    b_axis, c_axis = _BC_AXES[axis]

    vol_perm = lambda ch: jnp.transpose(ch, perm)
    if swp.classification == "pre":
        # Classic shear-warp: TF applied per voxel, RGBA interpolated.
        chans = precompute_classified_volume(
            volume_zyx, tf, params.data_source_range
        )
    else:
        # Post-classification (reference semantics,
        # fragRaycast.glsl:188-205): interpolate DENSITY, classify per
        # sample.  One resample channel, then a per-sample TF lookup —
        # a (K, V, U) gather; the bricked plane march
        # (ops/shearwarp_bricked.py) is the production post path.
        lo, hi = params.data_source_range
        chans = [(volume_zyx.astype(jnp.float32) - lo) / (hi - lo)]
    chans = [vol_perm(ch) for ch in chans]  # each (A, C, B)
    Na, Nc, Nb = chans[0].shape

    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    wb0, wb1 = float(wmin[b_axis]), float(wmax[b_axis])
    wc0, wc1 = float(wmin[c_axis]), float(wmax[c_axis])
    ea = eye[axis]
    eb = eye[b_axis]
    ec = eye[c_axis]

    # Plane positions, front-to-back in the marching direction.
    dz = (wa1 - wa0) / K
    j = jnp.arange(K, dtype=jnp.float32)
    z = jnp.where(sign > 0, wa0 + (j + 0.5) * dz, wa1 - (j + 0.5) * dz)  # (K,)

    u0, u1, v0, v1 = slope_bounds
    ug = jnp.linspace(u0, u1, U, dtype=jnp.float32)  # (U,)
    vg = jnp.linspace(v0, v1, V, dtype=jnp.float32)  # (V,)

    # Axis-lerp matrix A: (K, Na) — virtual plane = lerp of two slices.
    sa = (z - wa0) / (wa1 - wa0) * Na - 0.5
    A = _lerp_matrix(sa[None, :], Na, jnp.ones((1, K), jnp.float32))[0].T  # (K, Na)

    # Per-plane in-plane interpolation matrices (affine in u / v).
    delta = (z - ea)[:, None]  # (K, 1)
    xb = eb + ug[None, :] * delta  # (K, U) world b-coords
    inside_b = ((xb >= wb0) & (xb < wb1)).astype(jnp.float32)
    sb = (xb - wb0) / (wb1 - wb0) * Nb - 0.5
    Mb = _lerp_matrix(sb, Nb, inside_b)  # (K, Nb, U)

    xc = ec + vg[None, :] * delta  # (K, V)
    inside_c = ((xc >= wc0) & (xc < wc1)).astype(jnp.float32)
    sc = (xc - wc0) / (wc1 - wc0) * Nc - 0.5
    Mc = _lerp_matrix(sc, Nc, inside_c)  # (K, Nc, V)

    # Per-ray opacity-correction exponent: Euclidean step dz·√(1+u²+v²)
    # relative to the reference step (alpha_correction semantics,
    # GLRaycastRenderer.cpp:75 / fragRaycast.glsl:104-111).
    length = jnp.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)  # (V, U)
    corr = params.max_samples_per_ray * dz * length / 1.0

    slabs = []
    for ch in chans:
        vs = jnp.einsum(  # (K, Nc, Nb): virtual plane stack
            "ka,acb->kcb", A, ch, preferred_element_type=jnp.float32,
            precision=HP,
        )
        s1 = jnp.einsum(  # resample b → u
            "kcb,kbu->kcu", vs, Mb, preferred_element_type=jnp.float32,
            precision=HP,
        )
        s2 = jnp.einsum(  # resample c → v
            "kcu,kcv->kvu", s1, Mc, preferred_element_type=jnp.float32,
            precision=HP,
        )
        slabs.append(s2)  # (K, V, U)

    if swp.classification != "pre":
        # Interpolation matrices zero OUTSIDE-box samples; for "pre"
        # that zeroes the alpha directly, for "post" tf(0) may be
        # opaque, so mask alpha with the inside indicator explicitly.
        rgba = tf_ops.lookup(tf, slabs[0])  # (K, V, U, 4)
        inside = inside_c[:, :, None] * inside_b[:, None, :]  # (K, V, U)
        slabs = [
            rgba[..., 0], rgba[..., 1], rgba[..., 2],
            rgba[..., 3] * inside,
        ]

    out_r, out_g, out_b, out_a = _composite_planes(
        slabs[0], slabs[1], slabs[2], slabs[3], corr, params.early_exit
    )
    img = jnp.stack([out_r, out_g, out_b, out_a], axis=-1)  # (V, U, 4)
    return img, ug, vg


def warp_to_screen(
    inter: jnp.ndarray,  # (V, U, 4) slope-space image
    ug: jnp.ndarray,
    vg: jnp.ndarray,
    u: jnp.ndarray,  # (H, W) per-pixel slopes
    v: jnp.ndarray,
    valid: jnp.ndarray,  # (H, W) forward-marching mask
) -> jnp.ndarray:
    """Final 2-D bilinear warp slope-space → screen (the only gather)."""
    V, U, _ = inter.shape
    du = (ug[-1] - ug[0]) / (U - 1)
    dv = (vg[-1] - vg[0]) / (V - 1)
    gu = jnp.clip((u - ug[0]) / du, 0.0, U - 1.0)
    gv = jnp.clip((v - vg[0]) / dv, 0.0, V - 1.0)
    iu0 = jnp.floor(gu).astype(jnp.int32)
    iv0 = jnp.floor(gv).astype(jnp.int32)
    iu1 = jnp.minimum(iu0 + 1, U - 1)
    iv1 = jnp.minimum(iv0 + 1, V - 1)
    wu = (gu - iu0)[..., None]
    wv = (gv - iv0)[..., None]
    flat = inter.reshape(V * U, 4)
    g = lambda iv, iu: jnp.take(flat, iv * U + iu, axis=0)  # (H, W, 4)
    top = g(iv0, iu0) * (1 - wu) + g(iv0, iu1) * wu
    bot = g(iv1, iu0) * (1 - wu) + g(iv1, iu1) * wu
    out = top * (1 - wv) + bot * wv
    return out * valid[..., None]


def warp_frame_device(
    inter: jnp.ndarray,  # (V, U, 4) slope-space image
    inv_proj: jnp.ndarray,
    inv_mv: jnp.ndarray,
    u0, du, dv, v0, sign,  # runtime view scalars
    *,
    axis: int,
    viewport: Tuple[int, int, int, int],
    v_size: int,
    u_size: int,
) -> jnp.ndarray:
    """Device-side camera→screen warp for single-dispatch frames:
    per-pixel slopes from the 4×4 matrices (rays.make_rays math,
    sample 0), then a bilinear warp as ONE 2×2-patch row gather
    (4 takes → 1).  Shared by the pre-classified and bricked fused
    frame paths."""
    b_axis, c_axis = _BC_AXES[axis]
    vx, vy, vw, vh = viewport
    px = jnp.arange(vw, dtype=jnp.float32) + 0.5 + vx
    py = jnp.arange(vh, dtype=jnp.float32) + 0.5 + vy
    fx, fy = jnp.meshgrid(px, py, indexing="xy")
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = jnp.ones_like(ndc_x)
    ndc = jnp.stack([ndc_x, ndc_y, ones, ones], axis=-1)
    eye_space = jnp.matmul(ndc, inv_proj.T, precision=HP)
    eye_space = eye_space / eye_space[..., 3:4]
    world = jnp.matmul(eye_space, inv_mv.T, precision=HP)
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    d_a = dirs[..., axis]
    safe = jnp.where(jnp.abs(d_a) < 1e-6, 1e-6, d_a)
    u = dirs[..., b_axis] / safe
    v = dirs[..., c_axis] / safe
    valid = (jnp.sign(d_a) == sign).astype(jnp.float32)

    gu = jnp.clip((u - u0) / du, 0.0, u_size - 1.0)
    gv = jnp.clip((v - v0) / dv, 0.0, v_size - 1.0)
    iu0 = jnp.floor(gu).astype(jnp.int32)
    iv0 = jnp.floor(gv).astype(jnp.int32)
    wu = (gu - iu0)[..., None]
    wv = (gv - iv0)[..., None]
    right = jnp.concatenate([inter[:, 1:], inter[:, -1:]], axis=1)
    down = jnp.concatenate([inter[1:], inter[-1:]], axis=0)
    diag = jnp.concatenate([right[1:], right[-1:]], axis=0)
    quad = jnp.concatenate(
        [inter, right, down, diag], axis=-1
    ).reshape(v_size * u_size, 16)
    g = jnp.take(quad, iv0 * u_size + iu0, axis=0)  # (H, W, 16)
    top = g[..., 0:4] * (1 - wu) + g[..., 4:8] * wu
    bot = g[..., 8:12] * (1 - wu) + g[..., 12:16] * wu
    return (top * (1 - wv) + bot * wv) * valid[..., None]


@dataclasses.dataclass(frozen=True)
class ShearWarpPlan:
    """Host-computed per-view plan (build OUTSIDE jit: the slope bounds
    are static shapes/constants of the compiled render)."""

    axis: int
    sign: float
    bounds: Tuple[float, float, float, float]
    eye: np.ndarray  # (3,)
    u: np.ndarray  # (H, W) per-pixel slopes
    v: np.ndarray
    valid: np.ndarray  # (H, W) forward-marching mask


def make_plan(camera: Camera, margin: float = 0.02) -> ShearWarpPlan:
    axis, sign = choose_major_axis(camera)
    u, v, d_a = _pixel_slopes_np(camera, axis)  # host-only, per frame
    return ShearWarpPlan(
        axis=axis,
        sign=sign,
        bounds=_slope_bounds(u, v, d_a, sign, margin),
        eye=np.asarray(camera.inv_mv)[:3, 3].astype(np.float32),
        u=u,
        v=v,
        valid=(np.sign(d_a) == sign),
    )


def render(
    volume_zyx: jnp.ndarray,
    tf: jnp.ndarray,
    camera: Camera,
    params: RenderParams,
    world_min,
    world_max,
    swp: Optional[ShearWarpParams] = None,
    plan: Optional[ShearWarpPlan] = None,
) -> jnp.ndarray:
    """Full shear-warp render → (H, W, 4) (bottom-up rows, like GL).

    Under jit, pass a host-built ``plan`` (make_plan) — the slope bounds
    and axis choice are compile-time constants of the view.
    """
    if swp is None:
        swp = ShearWarpParams(n_planes=params.n_samples_per_ray)
    if plan is None:
        plan = make_plan(camera, swp.slope_margin)
    inter, ug, vg = render_slope_grid(
        volume_zyx,
        tf,
        plan.eye,
        plan.axis,
        plan.sign,
        plan.bounds,
        world_min,
        world_max,
        params,
        swp,
    )
    return warp_to_screen(
        inter, ug, vg, jnp.asarray(plan.u), jnp.asarray(plan.v),
        jnp.asarray(plan.valid),
    )


# --------------------------------------------------------------- oracle
def plane_oracle(
    volume_zyx: jnp.ndarray,
    tf: jnp.ndarray,
    eye: np.ndarray,
    axis: int,
    sign: float,
    slopes_uv: Tuple[jnp.ndarray, jnp.ndarray],  # (R,), (R,) slope rays
    world_min,
    world_max,
    params: RenderParams,
    n_planes: int,
    classification: str = "pre",
    clip_planes_world=None,
    sentinel_mask: bool = False,
) -> jnp.ndarray:
    """Gather-based marcher over the IDENTICAL sample set (ray∩plane
    points, trilinear, same opacity correction, same early exit) →
    (R, 4).  Slow; exactness oracle for the matmul pipeline.

    ``clip_planes_world``: optional (N, 4) rows [nx, ny, nz, d]; samples
    where n·x + d < 0 are dropped (the per-sample form of the
    fragRaycast.glsl:162-174 ray-interval clamp — equal for convex
    sets).  ``sentinel_mask``: in post mode, drop samples whose
    interpolated density is < -0.5 (the bricked path's uncovered-voxel
    SENTINEL semantics, ops/shearwarp_bricked.py)."""
    from libre.ops.reference import sample_density

    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = _BC_AXES[axis]
    u, v = slopes_uv
    K = n_planes
    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    dz = (wa1 - wa0) / K
    j = jnp.arange(K, dtype=jnp.float32)
    z = jnp.where(sign > 0, wa0 + (j + 0.5) * dz, wa1 - (j + 0.5) * dz)

    if classification == "pre":
        chans = precompute_classified_volume(
            volume_zyx, tf, params.data_source_range
        )
        rgba_vol = jnp.stack(chans, axis=-1)  # (Z, Y, X, 4)
    else:
        lo, hi = params.data_source_range
        dens_vol = (volume_zyx.astype(jnp.float32) - lo) / (hi - lo)

    length = jnp.sqrt(1.0 + u ** 2 + v ** 2)  # (R,)
    corr = params.max_samples_per_ray * dz * length

    delta = z[None, :] - eye[axis]  # (R broadcast, K)
    pb = eye[b_axis] + u[:, None] * delta  # (R, K)
    pc = eye[c_axis] + v[:, None] * delta

    inside = (
        (pb >= wmin[b_axis]) & (pb < wmax[b_axis])
        & (pc >= wmin[c_axis]) & (pc < wmax[c_axis])
    )
    if clip_planes_world is not None and len(clip_planes_world):
        cp = np.asarray(clip_planes_world, np.float32).reshape(-1, 4)
        pa = jnp.broadcast_to(z[None, :], pb.shape)
        world = {axis: pa, b_axis: pb, c_axis: pc}
        for row in cp:
            expr = (
                row[0] * world[0] + row[1] * world[1] + row[2] * world[2]
                + row[3]
            )
            inside = inside & (expr >= 0.0)

    # world → tex (whole volume, no padding); world axes (0,1,2) = (x,y,z).
    def tex(p, lo, hi):
        return (p - lo) / (hi - lo)

    coords = {}
    coords[axis] = jnp.broadcast_to(
        tex(z, wa0, wa1)[None, :], pb.shape
    )
    coords[b_axis] = tex(pb, wmin[b_axis], wmax[b_axis])
    coords[c_axis] = tex(pc, wmin[c_axis], wmax[c_axis])
    tex_pos = jnp.stack([coords[0], coords[1], coords[2]], axis=-1)

    if classification == "pre":
        rgba = jnp.stack(
            [
                sample_density(rgba_vol[..., ch], tex_pos, "trilinear")
                for ch in range(4)
            ],
            axis=-1,
        )  # (R, K, 4)
    else:
        dens = sample_density(dens_vol, tex_pos, "trilinear")  # (R, K)
        rgba = tf_ops.lookup(tf, dens)  # outside masked via a_v below
        if sentinel_mask:
            inside = inside & (dens > -0.5)

    a_corr = 1.0 - jnp.power(
        1.0 - jnp.minimum(rgba[..., 3], ALPHA_CLAMP), corr[:, None]
    )
    a_v = a_corr * inside.astype(jnp.float32)
    t_excl_u = _exclusive_cumprod(1.0 - a_v, axis=1)
    m = ((1.0 - t_excl_u) <= params.early_exit).astype(jnp.float32)
    a_eff = a_v * m
    t_excl = _exclusive_cumprod(1.0 - a_eff, axis=1)
    w = a_eff * t_excl
    out_rgb = jnp.einsum("rk,rkc->rc", w, rgba[..., :3], precision=HP)
    out_a = 1.0 - jnp.prod(1.0 - a_eff, axis=1)
    return jnp.concatenate([out_rgb, out_a[:, None]], axis=-1)
