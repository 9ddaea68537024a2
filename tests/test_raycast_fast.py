"""Parity of the production renderer (ops/raycast.py) vs the reference
marcher (ops/reference.py): same sample grid, same compositing, same early
exit — images must agree to float tolerance, gradients must match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libre.ops import raycast, transfer_function as tf_ops
from libre.ops.reference import RenderParams, render_reference, single_brick_set
from tests.test_reference_marcher import (
    CAMERA,
    GLOBAL_MAX,
    GLOBAL_MIN,
    H,
    W,
    _split_into_bricks,
    make_volume,
)


@pytest.fixture(scope="module")
def scene():
    volume = make_volume(32, seed=3)
    tf = tf_ops.default_color_map(64)
    return volume, tf


@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("chunk", [16, 32])
def test_matches_reference_single_brick(scene, filter_mode, chunk):
    volume, tf = scene
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode=filter_mode
    )
    bricks = single_brick_set(volume)
    ref = render_reference(bricks, jnp.asarray(tf), CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    fast = raycast.render(
        bricks, jnp.asarray(tf), CAMERA, params, GLOBAL_MIN, GLOBAL_MAX, chunk=chunk
    )
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_matches_reference_multi_brick(scene):
    volume, tf = scene
    params = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="trilinear"
    )
    bricks = _split_into_bricks(volume, 2, overlap=2)
    order = raycast.sort_bricks_front_to_back(
        np.asarray(bricks.world_min), np.asarray(bricks.world_max), np.array([0, 0, 1.0])
    )
    ref = render_reference(
        bricks,
        jnp.asarray(tf),
        CAMERA,
        params,
        GLOBAL_MIN,
        GLOBAL_MAX,
        brick_order=jnp.asarray(order),
    )
    fast = raycast.render(
        bricks, jnp.asarray(tf), CAMERA, params, GLOBAL_MIN, GLOBAL_MAX,
        brick_order=order,
    )
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_early_exit_parity(scene):
    """Opaque TF exercises the closed-form early-exit masking."""
    volume, _ = scene
    tf = jnp.ones((64, 4), jnp.float32) * 0.98
    params = RenderParams(n_samples_per_ray=64, data_source_range=(0.0, 1.0))
    bricks = single_brick_set(volume)
    ref = render_reference(bricks, tf, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    fast = raycast.render(bricks, tf, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_parity(scene, remat):
    volume, tf = scene
    params = RenderParams(
        n_samples_per_ray=32,
        data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
        remat=remat,
    )
    target = jnp.zeros((H, W, 4), jnp.float32)

    def loss_ref(vol, tf_arr):
        img = render_reference(
            single_brick_set(vol), tf_arr, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX
        )
        return jnp.mean((img - target) ** 2)

    def loss_fast(vol, tf_arr):
        img = raycast.render(
            single_brick_set(vol), tf_arr, CAMERA, params, GLOBAL_MIN, GLOBAL_MAX
        )
        return jnp.mean((img - target) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(volume), jnp.asarray(tf))
    g_fast = jax.grad(loss_fast, argnums=(0, 1))(jnp.asarray(volume), jnp.asarray(tf))
    for gr, gf in zip(g_ref, g_fast):
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gr), atol=1e-6, rtol=2e-3)
