"""Reference jnp marcher tests: scalar ground truth, brick-decomposition
invariance (the step-grid-alignment property), and differentiability."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libre.ops import rays as ray_ops
from libre.ops import transfer_function as tf_ops
from libre.ops.reference import (
    BrickSet,
    Camera,
    RenderParams,
    render_reference,
    single_brick_set,
)

# Golden-test camera: eye at (0,0,1) looking down -z, near 0.1
# (tests/lib/lodSelection.cpp matrices).
PROJ = np.array(
    [2.0, 0, 0, 0, 0, 2.0, 0, 0, 0, 0, -1.01342285, -1, 0, 0, -0.201342285, 0],
    dtype=np.float32,
).reshape(4, 4).T
MV = np.array(
    [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, -1.0, 1], dtype=np.float32
).reshape(4, 4).T
NEAR = 0.1

W = H = 24
CAMERA = Camera(
    inv_proj=np.linalg.inv(PROJ.astype(np.float64)).astype(np.float32),
    inv_mv=np.linalg.inv(MV.astype(np.float64)).astype(np.float32),
    viewport=(0, 0, W, H),
    near=NEAR,
)

GLOBAL_MIN = np.float32([-0.5, -0.5, -0.5])
GLOBAL_MAX = np.float32([0.5, 0.5, 0.5])


def make_volume(n=32, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((n, n, n)).astype(np.float32)
    # Smooth it so trilinear vs nearest differences stay moderate.
    for axis in range(3):
        base = (base + np.roll(base, 1, axis) + np.roll(base, -1, axis)) / 3.0
    return base


def scalar_march(volume, tf, px, py, params):
    """Literal scalar transcription of fragRaycast.glsl:113-215 for one pixel
    of the single-brick whole-volume case, computed in float32 with the same
    operation order as the jnp marcher (nearest-voxel floor() decisions are
    float32 knife-edges)."""
    f = np.float32
    inv_proj = np.asarray(CAMERA.inv_proj, f)
    inv_mv = np.asarray(CAMERA.inv_mv, f)
    frag = np.array([px + 0.5, py + 0.5], f)
    ndc = np.array(
        [2 * (frag[0] - W / 2) / W, 2 * (frag[1] - H / 2) / H, 1.0, 1.0], f
    )
    eye_sp = (inv_proj @ ndc).astype(f)
    eye_sp = (eye_sp / eye_sp[3]).astype(f)
    world = (inv_mv @ eye_sp).astype(f)[:3]
    eye = inv_mv[:3, 3]
    d = world - eye
    d = (d / f(np.sqrt(np.sum(d * d, dtype=f)))).astype(f)

    def slab(bmin, bmax):
        dd = np.where(d == 0, f(1e-10), d).astype(f)
        inv = (f(1.0) / dd).astype(f)
        tbot = (inv * (bmin - eye)).astype(f)
        ttop = (inv * (bmax - eye)).astype(f)
        tmin = np.minimum(tbot, ttop)
        tmax = np.maximum(tbot, ttop)
        return tmin.max(), tmax.min()

    t0, t1 = slab(GLOBAL_MIN, GLOBAL_MAX)
    if t0 > t1:
        return np.zeros(4)
    tn_global = t0
    eye_dir = eye_sp[:3] / f(np.sqrt(np.sum(eye_sp[:3] ** 2, dtype=f)))
    t_near_plane = f(-f(NEAR) / eye_dir[2])
    step = f(params.step_size)
    # Exact global grid: t_n = tnGlobal + n*step; near-plane excluded via
    # the first admissible index (mirrors _march_one_brick).
    tnear = max(t0, t_near_plane)
    n0 = int(np.floor(f(tnear - tn_global) / step)) - 1
    n_start = int(np.ceil(f(max(t_near_plane - tn_global, f(0.0))) / step))

    corr = f(params.alpha_correction)
    lo, hi = params.data_source_range
    mult = f(1.0 / (hi - lo))
    add = f(-lo / (hi - lo))
    rgb = np.zeros(3, f)
    a = f(0.0)
    nz, ny, nx = volume.shape
    dims = np.array([nx, ny, nz], f)
    for n in range(n0, n0 + 100000):
        t = f(tn_global + f(f(n) * step))
        if a > f(params.early_exit):
            break
        pos = (eye + d * t).astype(f)
        # Slab-interval sample ownership (reference._march_one_brick).
        if not (t > t0 and t <= t1):
            if t > t1 + 2 * step:
                break
            continue
        if n < n_start:
            continue
        u = ((pos - GLOBAL_MIN) / (GLOBAL_MAX - GLOBAL_MIN)).astype(f)
        # single_brick_set: tex range is [0,1] so tex_pos == u * 1 + 0.
        idx = np.clip(
            np.floor(u * dims).astype(int), 0, [nx - 1, ny - 1, nz - 1]
        )
        raw = f(volume[idx[2], idx[1], idx[0]])
        dens = np.clip(f(raw * mult + add), f(0), f(1))
        # TF linear lookup (float32)
        n_tf = tf.shape[0]
        s = f(np.clip(dens, 0, 1) * n_tf - 0.5)
        s = f(np.clip(s, 0, n_tf - 1))
        i0 = int(np.floor(s))
        i1 = min(i0 + 1, n_tf - 1)
        w = f(s - np.floor(s))
        src = (tf[i0].astype(f) * (f(1) - w) + tf[i1].astype(f) * w).astype(f)
        alpha = f(1) - f(
            np.power(f(1) - min(src[3], f(1 - 1 / 256)), corr, dtype=f)
        )
        one_minus = f(1) - a
        rgb = (rgb + src[:3] * f(alpha * one_minus)).astype(f)
        a = f(a + alpha * one_minus)
    return np.concatenate([rgb, [a]])


@pytest.fixture(scope="module")
def scene():
    volume = make_volume(32)
    tf = tf_ops.default_color_map(64)
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="nearest"
    )
    return volume, tf, params


def test_matches_scalar_ground_truth(scene):
    volume, tf, params = scene
    bricks = single_brick_set(volume)
    img = np.asarray(
        render_reference(bricks, jnp.asarray(tf), CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    )
    for px, py in [(12, 12), (3, 20), (20, 5), (0, 0), (12, 3)]:
        expected = scalar_march(volume, tf, px, py, params)
        got = img[py, px]
        np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)


def test_empty_tf_gives_empty_image(scene):
    volume, _, params = scene
    tf = jnp.zeros((64, 4), jnp.float32)
    bricks = single_brick_set(volume)
    img = render_reference(bricks, tf, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    assert float(jnp.abs(img).max()) == 0.0


def test_opaque_tf_saturates(scene):
    volume, _, params = scene
    tf = jnp.ones((64, 4), jnp.float32)
    bricks = single_brick_set(volume)
    img = render_reference(bricks, tf, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    center_alpha = float(img[H // 2, W // 2, 3])
    assert center_alpha > 0.999


def _split_into_bricks(volume, n_split, overlap):
    """Split a (Z,Y,X) volume into n_split³ padded bricks, ghost voxels
    clamped at the border — mirrors lod_store._extract_padded_brick."""
    nz, ny, nx = volume.shape
    bs = nx // n_split
    padded = np.pad(volume, overlap, mode="edge")
    data, wmin, wmax, tmin, tmax = [], [], [], [], []
    pdim = bs + 2 * overlap
    for bx in range(n_split):
        for by in range(n_split):
            for bz in range(n_split):
                z0, y0, x0 = bz * bs, by * bs, bx * bs
                brick = padded[z0 : z0 + pdim, y0 : y0 + pdim, x0 : x0 + pdim]
                data.append(brick)
                lo = np.float32([x0, y0, z0]) / nx - 0.5
                hi = np.float32([x0 + bs, y0 + bs, z0 + bs]) / nx - 0.5
                wmin.append(lo)
                wmax.append(hi)
                tmin.append(np.full(3, overlap / pdim, np.float32))
                tmax.append(np.full(3, (overlap + bs) / pdim, np.float32))
    return BrickSet(
        data=jnp.asarray(np.stack(data), jnp.float32),
        world_min=jnp.asarray(np.stack(wmin)),
        world_max=jnp.asarray(np.stack(wmax)),
        tex_min=jnp.asarray(np.stack(tmin)),
        tex_max=jnp.asarray(np.stack(tmax)),
    )


@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
def test_brick_decomposition_invariance(scene, filter_mode):
    """Rendering the volume as 8 bricks must match the single-brick render:
    the global step-grid alignment property (fragRaycast.glsl:152-158)."""
    volume, tf, _ = scene
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode=filter_mode
    )
    whole = render_reference(
        single_brick_set(volume), jnp.asarray(tf), CAMERA, params, GLOBAL_MIN, GLOBAL_MAX
    )
    bricked = render_reference(
        _split_into_bricks(volume, 2, overlap=2),
        jnp.asarray(tf),
        CAMERA,
        params,
        GLOBAL_MIN,
        GLOBAL_MAX,
    )
    diff = np.abs(np.asarray(whole) - np.asarray(bricked))
    if filter_mode == "trilinear":
        # Trilinear is continuous across voxel boundaries, so float knife
        # edges barely matter.
        np.testing.assert_allclose(np.asarray(whole), np.asarray(bricked), atol=2e-3)
    else:
        # Nearest filtering: the brick-local voxel-coordinate arithmetic
        # ((pos-wmin)*scale+off vs (pos-gmin)*scale') rounds differently at
        # the last ulp, flipping floor() for the rare sample that lands
        # within ~1e-6 of a voxel face.  Sample *ownership* is exact (see
        # test_sample_ownership_partition); values may flip on knife edges.
        assert np.mean(diff > 1e-5) < 0.05, (diff.max(), np.mean(diff > 1e-5))
        np.testing.assert_allclose(np.asarray(whole), np.asarray(bricked), atol=0.07)


def test_sample_ownership_partition(scene):
    """The semantic invariant behind decomposition invariance: every global
    grid sample inside the volume is claimed by exactly one brick, and the
    voxel it reads matches the whole-volume read (pure numpy, no XLA
    rounding in the comparison)."""
    volume, _, params = scene
    bricks = _split_into_bricks(volume, 2, overlap=2)
    bw_min = np.asarray(bricks.world_min)
    bw_max = np.asarray(bricks.world_max)
    data = np.asarray(bricks.data)
    tex_min = np.asarray(bricks.tex_min)
    tex_max = np.asarray(bricks.tex_max)

    rng = np.random.default_rng(7)
    f = np.float32
    step = f(params.step_size)
    eye = np.array([0, 0, 1], f)
    n_checked = 0
    for _ in range(50):
        d = rng.normal(size=3).astype(f)
        d[2] = -abs(d[2]) - 0.5
        d = (d / np.linalg.norm(d)).astype(f)
        for n in range(0, 256):
            t = f(f(0.5) + f(n) * step)  # march from before the volume
            pos = (eye + d * t).astype(f)
            inside_global = np.all((pos >= GLOBAL_MIN) & (pos < GLOBAL_MAX))
            owners = [
                b
                for b in range(8)
                if np.all((pos >= bw_min[b]) & (pos < bw_max[b]))
            ]
            assert len(owners) == (1 if inside_global else 0), (pos, owners)
            if owners:
                b = owners[0]
                u = ((pos - bw_min[b]) / (bw_max[b] - bw_min[b])).astype(f)
                texpos = (u * (tex_max[b] - tex_min[b]) + tex_min[b]).astype(f)
                idx = np.clip(np.floor(texpos * f(20)).astype(int), 0, 19)
                got = data[b][idx[2], idx[1], idx[0]]
                ug = ((pos - GLOBAL_MIN) / (GLOBAL_MAX - GLOBAL_MIN)).astype(f)
                gidx = np.clip(np.floor(ug * f(32)).astype(int), 0, 31)
                want = volume[gidx[2], gidx[1], gidx[0]]
                # identical unless the sample sits on a float knife edge
                if not np.isclose(got, want):
                    frac = texpos * 20 - np.floor(texpos * 20)
                    assert np.any(np.minimum(frac, 1 - frac) < 1e-4), (
                        pos, got, want, frac,
                    )
                n_checked += 1
    assert n_checked > 500


def test_gradients_flow(scene):
    volume, tf, _ = scene
    params = RenderParams(
        n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode="trilinear"
    )

    def loss(vol, tf_arr):
        bricks = single_brick_set(vol)
        img = render_reference(bricks, tf_arr, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
        return jnp.sum(img**2)

    g_vol, g_tf = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(volume), jnp.asarray(tf)
    )
    assert np.isfinite(np.asarray(g_vol)).all()
    assert np.isfinite(np.asarray(g_tf)).all()
    assert float(jnp.abs(g_vol).max()) > 0
    assert float(jnp.abs(g_tf).max()) > 0


def test_early_exit_matches_masked_semantics(scene):
    """With an opaque TF, increasing sample count must not change the
    saturated result (early termination is respected)."""
    volume, _, _ = scene
    tf = jnp.ones((64, 4), jnp.float32)
    imgs = []
    for n in (32, 64):
        params = RenderParams(n_samples_per_ray=n, data_source_range=(0.0, 1.0))
        imgs.append(
            render_reference(
                single_brick_set(volume), tf, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX
            )
        )
    a0 = np.asarray(imgs[0][..., 3])
    a1 = np.asarray(imgs[1][..., 3])
    hit = a0 > 0.5
    np.testing.assert_allclose(a0[hit], a1[hit], atol=1e-3)
