"""Sharded-render parity on a virtual 8-device CPU mesh: sort-first (ray
axis), sort-last (brick axis), the combined 2-D mesh, and gradient flow
through shard_map must all match the single-device marcher (SURVEY.md §4
implication (c); decompositions of §2.12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libre.ops import raycast, rays as ray_ops, transfer_function as tf_ops
from libre.ops.reference import RenderParams, max_steps_for_bricks
from libre.parallel import (
    make_mesh,
    render_rays_sharded,
    shard_bricks_front_to_back,
)
from tests.test_reference_marcher import (
    CAMERA,
    GLOBAL_MAX,
    GLOBAL_MIN,
    _split_into_bricks,
    make_volume,
)

PARAMS = RenderParams(
    n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="trilinear"
)


@pytest.fixture(scope="module")
def scene():
    volume = make_volume(32, seed=3)
    tf = jnp.asarray(tf_ops.default_color_map(64))
    bricks = _split_into_bricks(volume, 2, overlap=2)
    eye, dirs, cos_z, _ = ray_ops.make_rays(
        CAMERA.inv_proj, CAMERA.inv_mv, CAMERA.viewport
    )
    dirs = dirs.reshape(-1, 3)
    tnp = ray_ops.near_plane_t(cos_z.reshape(-1), CAMERA.near)
    return bricks, tf, eye, dirs, tnp


@pytest.fixture(scope="module")
def single_device_image(scene):
    """One single-device oracle render shared by every mesh-shape
    parametrization (the oracle compile dominates the file's wall)."""
    bricks, tf, eye, dirs, tnp = scene
    max_steps = max_steps_for_bricks(
        bricks.world_min, bricks.world_max, PARAMS.step_size
    )
    return _single_device(bricks, tf, eye, dirs, tnp, max_steps), max_steps


def _single_device(bricks, tf, eye, dirs, tnp, max_steps):
    order = raycast.sort_bricks_front_to_back(
        np.asarray(bricks.world_min), np.asarray(bricks.world_max), np.asarray(eye)
    )
    return raycast.render_rays(
        bricks, tf, eye, dirs, tnp, PARAMS, GLOBAL_MIN, GLOBAL_MAX,
        brick_order=order, max_steps=max_steps,
    )


@pytest.mark.parametrize("n_brick", [1, 2, 4])
def test_sharded_matches_single_device(scene, single_device_image, n_brick):
    bricks, tf, eye, dirs, tnp = scene
    expected, max_steps = single_device_image

    mesh = make_mesh(n_brick=n_brick)
    sharded_bricks, _ = shard_bricks_front_to_back(
        bricks, np.asarray(eye), n_brick
    )
    got = render_rays_sharded(
        mesh, sharded_bricks, tf, eye, dirs, tnp, PARAMS,
        GLOBAL_MIN, GLOBAL_MAX, max_steps,
    )
    # Early termination is per-device on the brick axis (as per-channel in
    # the reference's DB mode) — residual transmittance bounds the drift.
    atol = 1e-5 if n_brick == 1 else 2e-3
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=atol)


def test_brick_padding(scene):
    """A brick count not divisible by the axis pads with degenerate boxes."""
    bricks, tf, eye, dirs, tnp = scene
    sub = jax.tree.map(lambda x: x[:7], bricks)
    max_steps = max_steps_for_bricks(sub.world_min, sub.world_max, PARAMS.step_size)
    expected = _single_device(sub, tf, eye, dirs, tnp, max_steps)

    mesh = make_mesh(n_brick=4)
    sharded, slot_map = shard_bricks_front_to_back(sub, np.asarray(eye), 4)
    assert sharded.num_bricks == 8 and (slot_map == -1).sum() == 1
    got = render_rays_sharded(
        mesh, sharded, tf, eye, dirs, tnp, PARAMS, GLOBAL_MIN, GLOBAL_MAX, max_steps
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=2e-3)


def test_gradients_through_shard_map(scene):
    """Density grads stay brick-sharded; replicated-input (TF) cotangents
    are psum-reduced by shard_map's transpose — values must match the
    single-device gradients."""
    bricks, tf, eye, dirs, tnp = scene
    max_steps = max_steps_for_bricks(
        bricks.world_min, bricks.world_max, PARAMS.step_size
    )
    order = raycast.sort_bricks_front_to_back(
        np.asarray(bricks.world_min), np.asarray(bricks.world_max), np.asarray(eye)
    )
    mesh = make_mesh(n_brick=2)
    sharded_bricks, slot_map = shard_bricks_front_to_back(bricks, np.asarray(eye), 2)
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", early_exit=1.1,  # exact: no early-exit drift
    )

    def loss_single(data, tf_arr):
        out = raycast.render_rays(
            bricks._replace(data=data), tf_arr, eye, dirs, tnp, params,
            GLOBAL_MIN, GLOBAL_MAX, brick_order=order, max_steps=max_steps,
        )
        return jnp.mean(out ** 2)

    def loss_sharded(data, tf_arr):
        out = render_rays_sharded(
            mesh, sharded_bricks._replace(data=data), tf_arr, eye, dirs, tnp,
            params, GLOBAL_MIN, GLOBAL_MAX, max_steps,
        )
        return jnp.mean(out ** 2)

    g_single = jax.grad(loss_single, argnums=(0, 1))(bricks.data, tf)
    # Sharded grads must run under jit with explicit input shardings (the
    # training-step path); the eager-grad tracer hits an XLA sharding
    # inference conflict on the shard_map transpose.
    from jax.sharding import NamedSharding

    g_fn = jax.jit(
        jax.grad(loss_sharded, argnums=(0, 1)),
        in_shardings=(
            NamedSharding(mesh, jax.sharding.PartitionSpec("brick")),
            NamedSharding(mesh, jax.sharding.PartitionSpec()),
        ),
    )
    g_sharded = g_fn(sharded_bricks.data, tf)

    # Map sharded brick grads back through the front-to-back permutation.
    g_data = np.zeros_like(np.asarray(g_single[0]))
    for slot, orig in enumerate(slot_map):
        if orig >= 0:
            g_data[orig] += np.asarray(g_sharded[0][slot])
    np.testing.assert_allclose(g_data, np.asarray(g_single[0]), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g_sharded[1]), np.asarray(g_single[1]), atol=1e-6, rtol=1e-4
    )


def test_shearwarp_sharded_matches_single_device():
    """Sharded shear-warp (slope rows x plane ranges) == single-device
    slope grid up to the per-range early-exit caveat."""
    from libre.ops import shearwarp, transfer_function as tf_ops
    from libre.ops.reference import RenderParams
    from libre.parallel.shearwarp_sharded import render_slope_grid_sharded
    from tests.test_shearwarp import GMIN, GMAX, make_camera
    from tests.test_reference_marcher import make_volume

    volume = jnp.asarray(make_volume(32, seed=3))
    tf = jnp.asarray(tf_ops.default_color_map(64))
    cam = make_camera([0.2, 0.1, 1.4])
    plan = shearwarp.make_plan(cam)
    params = RenderParams(
        n_samples_per_ray=32, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    swp = shearwarp.ShearWarpParams(n_planes=32, inter_size=(32, 32))
    single, _, _ = shearwarp.render_slope_grid(
        volume, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
        GMIN, GMAX, params, swp,
    )
    mesh = make_mesh(n_brick=2)
    sharded = render_slope_grid_sharded(
        mesh, volume, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
        GMIN, GMAX, params, swp,
    )
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), atol=2e-3
    )


def test_composite_along_axis_matches_gather_fold():
    """The O(R·log D) premultiplied-psum reduce equals the
    all_gather+fold reference (and plain fold_over) on random segments,
    and differentiates."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from libre.parallel.compositing import (
        composite_along_axis,
        composite_along_axis_gather,
        fold_over,
    )
    from libre.parallel.mesh import BRICK_AXIS, make_mesh

    mesh = make_mesh(n_brick=8, n_ray=1)
    rng = np.random.default_rng(3)
    rgb = jnp.asarray(rng.random((8, 16, 3), dtype=np.float32))
    a = jnp.asarray(rng.random((8, 16), dtype=np.float32) * 0.6)

    def body(rgb_l, a_l):
        r, al = composite_along_axis(rgb_l[0], a_l[0], BRICK_AXIS)
        rg, ag = composite_along_axis_gather(rgb_l[0], a_l[0], BRICK_AXIS)
        return (r - rg)[None], (al - ag)[None], r[None], al[None]

    dr, da, r_out, a_out = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(BRICK_AXIS), P(BRICK_AXIS)),
        out_specs=(P(BRICK_AXIS), P(BRICK_AXIS), P(BRICK_AXIS), P(BRICK_AXIS)),
    )(rgb, a)
    assert float(jnp.abs(dr).max()) < 1e-6
    assert float(jnp.abs(da).max()) < 1e-6
    ref_rgb, ref_a = fold_over(rgb, a)
    np.testing.assert_allclose(np.asarray(r_out[0]), np.asarray(ref_rgb),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(a_out[0]), np.asarray(ref_a),
                               atol=1e-6)

    # Differentiability: grads of a scalar through the psum form exist
    # and match the fold_over path.
    def loss_psum(rgb, a):
        def body(rgb_l, a_l):
            r, al = composite_along_axis(rgb_l[0], a_l[0], BRICK_AXIS)
            return jnp.sum(r ** 2) + jnp.sum(al ** 2)

        per = shard_map(
            lambda rl, al: body(rl, al)[None],
            mesh=mesh, in_specs=(P(BRICK_AXIS), P(BRICK_AXIS)),
            out_specs=P(BRICK_AXIS),
        )(rgb, a)
        return per[0]

    def loss_fold(rgb, a):
        r, al = fold_over(rgb, a)
        return jnp.sum(r ** 2) + jnp.sum(al ** 2)

    g1 = jax.grad(loss_psum, argnums=(0, 1))(rgb, a)
    g2 = jax.grad(loss_fold, argnums=(0, 1))(rgb, a)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               atol=1e-5)


def test_composite_direct_send_matches_gather_fold():
    """Direct-send (all_to_all, tile-owned) compositing reassembles to
    the same image as the replicated gather+fold, and differentiates."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from libre.parallel.compositing import (
        composite_direct_send,
        fold_over,
    )
    from libre.parallel.mesh import BRICK_AXIS, make_mesh

    mesh = make_mesh(n_brick=8, n_ray=1)
    rng = np.random.default_rng(5)
    # 8 segments x 32 rays (each device owns a 4-ray subtile).
    rgb = jnp.asarray(rng.random((8, 32, 3), dtype=np.float32))
    a = jnp.asarray(rng.random((8, 32), dtype=np.float32) * 0.6)

    def body(rgb_l, a_l):
        r, al = composite_direct_send(rgb_l[0], a_l[0], BRICK_AXIS)
        return jnp.concatenate([r, al[..., None]], axis=-1)

    out = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(BRICK_AXIS), P(BRICK_AXIS)),
        out_specs=P(BRICK_AXIS),  # tile-owned rows reassemble in rank order
    )(rgb, a)  # (32, 4)
    ref_rgb, ref_a = fold_over(rgb, a)
    np.testing.assert_allclose(np.asarray(out[..., :3]), np.asarray(ref_rgb),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[..., 3]), np.asarray(ref_a),
                               atol=1e-6)

    # Differentiability (all_to_all transposes to the reverse exchange).
    def loss_ds(rgb, a):
        per = shard_map(
            body, mesh=mesh, in_specs=(P(BRICK_AXIS), P(BRICK_AXIS)),
            out_specs=P(BRICK_AXIS),
        )(rgb, a)
        return jnp.sum(per ** 2)

    def loss_fold(rgb, a):
        r, al = fold_over(rgb, a)
        return jnp.sum(r ** 2) + jnp.sum(al ** 2)

    g1 = jax.grad(loss_ds, argnums=(0, 1))(rgb, a)
    g2 = jax.grad(loss_fold, argnums=(0, 1))(rgb, a)
    np.testing.assert_allclose(np.asarray(g1[0]), np.asarray(g2[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g1[1]), np.asarray(g2[1]),
                               atol=1e-5)
