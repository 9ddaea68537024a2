"""Shear-warp renderer: the matmul pipeline must match the gather-based
plane oracle on the identical sample set (exactness), the full render
must converge to the arc-length reference marcher (quality), and axis
selection / warp plumbing must behave."""

import jax.numpy as jnp
import numpy as np
import pytest

from libre.core.frustum import look_at, perspective
from libre.ops import raycast, shearwarp, transfer_function as tf_ops
from libre.ops.reference import Camera, RenderParams, single_brick_set
from tests.test_reference_marcher import make_volume

W = H = 32


def make_camera(eye, center=(0, 0, 0), near=0.1):
    proj = perspective(50.0, W / H, near, 15.0)
    mv = look_at(eye, center, [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, W, H),
        near=near,
    )


GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)


@pytest.fixture(scope="module")
def scene():
    volume = jnp.asarray(make_volume(32, seed=3))
    tf = jnp.asarray(tf_ops.default_color_map(64))
    return volume, tf


PARAMS = RenderParams(
    n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="trilinear"
)


def test_major_axis_selection(scene):
    cam_z = make_camera([0, 0, 1.5])
    assert shearwarp.choose_major_axis(cam_z) == (2, -1.0)
    cam_x = make_camera([-1.5, 0.1, 0.0])
    axis, sign = shearwarp.choose_major_axis(cam_x)
    assert axis == 0 and sign == 1.0


def test_slope_grid_matches_plane_oracle(scene):
    """The matmul shear pipeline == gather oracle on the same rays."""
    volume, tf = scene
    cam = make_camera([0.2, 0.1, 1.4])
    axis, sign = shearwarp.choose_major_axis(cam)
    u, v, d_a = shearwarp.pixel_slopes(cam, axis)
    bounds = shearwarp._slope_bounds(u, v, d_a, sign, 0.02)
    eye = np.asarray(cam.inv_mv)[:3, 3]

    swp = shearwarp.ShearWarpParams(n_planes=48, inter_size=(24, 20))
    inter, ug, vg = shearwarp.render_slope_grid(
        volume, tf, eye, axis, sign, bounds, GMIN, GMAX, PARAMS, swp
    )
    # Oracle on exactly the slope-grid rays.
    uu, vv = jnp.meshgrid(ug, vg, indexing="xy")
    oracle = shearwarp.plane_oracle(
        volume, tf, eye, axis, sign,
        (uu.reshape(-1), vv.reshape(-1)),
        GMIN, GMAX, PARAMS, 48,
    ).reshape(*inter.shape)
    np.testing.assert_allclose(
        np.asarray(inter), np.asarray(oracle), atol=2e-5
    )


@pytest.mark.parametrize("eye", [[0, 0, 1.5], [1.4, 0.2, 0.1], [0.1, -1.5, 0.2]])
def test_full_render_converges_to_reference(scene, eye):
    """At high sampling rates the shear-warp image approaches the
    arc-length-sampled reference marcher (different sample placement ⇒
    loose tolerance, tight enough to catch geometry/compositing bugs)."""
    volume, tf = scene
    cam = make_camera(eye)
    params = RenderParams(
        n_samples_per_ray=128, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    ref = raycast.render(
        single_brick_set(volume), tf, cam, params, GMIN, GMAX, chunk=32
    )
    sw = shearwarp.render(
        volume, tf, cam, params, GMIN, GMAX,
        shearwarp.ShearWarpParams(n_planes=128, inter_size=(64, 64)),
    )
    diff = np.abs(np.asarray(sw) - np.asarray(ref))
    assert diff.mean() < 0.015, diff.mean()
    assert np.quantile(diff, 0.95) < 0.08, np.quantile(diff, 0.95)


def test_opaque_early_exit(scene):
    volume, _ = scene
    tf = jnp.ones((64, 4), jnp.float32) * 0.98
    cam = make_camera([0, 0, 1.5])
    sw = shearwarp.render(
        volume, tf, cam, PARAMS, GMIN, GMAX,
        shearwarp.ShearWarpParams(n_planes=64, inter_size=(48, 48)),
    )
    # Center rays hit the box and saturate.
    assert float(np.asarray(sw)[H // 2, W // 2, 3]) > 0.99
    # An opaque box renders close to the reference even at modest
    # sampling (saturation hides sample-placement differences).
    ref = raycast.render(
        single_brick_set(volume), tf, cam, PARAMS, GMIN, GMAX, chunk=32
    )
    diff = np.abs(np.asarray(sw) - np.asarray(ref))
    assert diff.mean() < 0.02, diff.mean()


def test_engine_shearwarp_path():
    """RenderEngine.render_shearwarp assembles the LOD level and renders
    close to the exact engine path."""
    from libre.core.frustum import Frustum
    from libre.data.datasource import DataSource, load_plugins
    from libre.render.engine import RenderEngine

    load_plugins()
    engine = RenderEngine(
        DataSource("mem://#32,32,32,16?pattern=gradient&datatype=uint8"),
        max_gpu_cache_mb=64,
        filter_mode="trilinear",
    )
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, 48, 48),
        near=frustum.near,
    )
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 255.0),
        filter_mode="trilinear",
    )
    exact, _, _ = engine.render(
        cam, frustum, params=params, screen_space_error=1.0
    )
    sw = engine.render_shearwarp(cam, n_planes=64, params=params)
    assert sw.shape == exact.shape
    diff = np.abs(np.asarray(sw) - np.asarray(exact))
    assert diff.mean() < 0.03, diff.mean()


def test_shearwarp_gradients_match_oracle(scene):
    """Shear-warp is pure jnp ⇒ differentiable; volume/TF gradients must
    match autodiff of the gather oracle over the same sample set."""
    import jax

    volume, tf = scene
    cam = make_camera([0.2, 0.1, 1.4])
    plan = shearwarp.make_plan(cam)
    swp = shearwarp.ShearWarpParams(n_planes=24, inter_size=(16, 16))
    params = RenderParams(
        n_samples_per_ray=24, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", early_exit=1.1,
    )

    def loss_sw(vol, tf_arr):
        inter, _, _ = shearwarp.render_slope_grid(
            vol, tf_arr, plan.eye, plan.axis, plan.sign, plan.bounds,
            GMIN, GMAX, params, swp,
        )
        return jnp.mean(inter ** 2)

    ug = jnp.linspace(plan.bounds[0], plan.bounds[1], 16)
    vg = jnp.linspace(plan.bounds[2], plan.bounds[3], 16)
    uu, vv = jnp.meshgrid(ug, vg, indexing="xy")

    def loss_oracle(vol, tf_arr):
        out = shearwarp.plane_oracle(
            vol, tf_arr, plan.eye, plan.axis, plan.sign,
            (uu.reshape(-1), vv.reshape(-1)), GMIN, GMAX, params, 24,
        )
        return jnp.mean(out.reshape(16, 16, 4) ** 2)

    g_sw = jax.grad(loss_sw, argnums=(0, 1))(volume, tf)
    g_or = jax.grad(loss_oracle, argnums=(0, 1))(volume, tf)
    np.testing.assert_allclose(
        np.asarray(g_sw[0]), np.asarray(g_or[0]), atol=1e-6, rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(g_sw[1]), np.asarray(g_or[1]), atol=1e-6, rtol=1e-3
    )
    assert float(jnp.abs(g_sw[0]).sum()) > 0
    assert float(jnp.abs(g_sw[1]).sum()) > 0


def test_post_classification_matches_oracle(scene):
    """Post-classification pipeline (interpolate density, classify per
    sample — fragRaycast.glsl:188-205 semantics) == gather oracle."""
    volume, tf = scene
    cam = make_camera([0.2, 0.1, 1.4])
    axis, sign = shearwarp.choose_major_axis(cam)
    u, v, d_a = shearwarp.pixel_slopes(cam, axis)
    bounds = shearwarp._slope_bounds(u, v, d_a, sign, 0.02)
    eye = np.asarray(cam.inv_mv)[:3, 3]

    swp = shearwarp.ShearWarpParams(
        n_planes=48, inter_size=(24, 20), classification="post"
    )
    inter, ug, vg = shearwarp.render_slope_grid(
        volume, tf, eye, axis, sign, bounds, GMIN, GMAX, PARAMS, swp
    )
    uu, vv = jnp.meshgrid(ug, vg, indexing="xy")
    oracle = shearwarp.plane_oracle(
        volume, tf, eye, axis, sign,
        (uu.reshape(-1), vv.reshape(-1)),
        GMIN, GMAX, PARAMS, 48, classification="post",
    ).reshape(*inter.shape)
    np.testing.assert_allclose(
        np.asarray(inter), np.asarray(oracle), atol=2e-5
    )


def test_post_equals_pre_for_affine_tf(scene):
    """With a TF affine in density, interpolate-then-classify equals
    classify-then-interpolate (the classic shear-warp equivalence)."""
    from libre.ops.transfer_function import grayscale_ramp

    volume, _ = scene
    # keep densities inside the clamp-free TF interior
    volume = 0.2 + 0.6 * volume
    tf = jnp.asarray(grayscale_ramp(256) * 0.5)
    cam = make_camera([0.2, 0.1, 1.4])
    axis, sign = shearwarp.choose_major_axis(cam)
    u, v, d_a = shearwarp.pixel_slopes(cam, axis)
    bounds = shearwarp._slope_bounds(u, v, d_a, sign, 0.02)
    eye = np.asarray(cam.inv_mv)[:3, 3]

    imgs = []
    for mode in ("pre", "post"):
        swp = shearwarp.ShearWarpParams(
            n_planes=32, inter_size=(24, 20), classification=mode
        )
        img, _, _ = shearwarp.render_slope_grid(
            volume, tf, eye, axis, sign, bounds, GMIN, GMAX, PARAMS, swp
        )
        imgs.append(np.asarray(img))
    # texel-center discretization of the 256-entry table bounds the gap
    np.testing.assert_allclose(imgs[0], imgs[1], atol=5e-3)
