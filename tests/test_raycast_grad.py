"""Exact-path gradients: jax.grad through the gather marcher
(ops/raycast.py) equals jax.grad through the reference marcher
(ops/reference.py) in the cases test_raycast_fast's single-brick
trilinear check does not reach — nearest filtering, several bricks,
clip planes, a side view and early-exit saturation.  The gather marcher
is the only exact path, so its gradients are what the exact trainer
(train/trainer.make_train_step) descends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libre.core.frustum import look_at, perspective
from libre.ops import raycast, transfer_function as tf_ops
from libre.ops.reference import (
    Camera,
    RenderParams,
    render_reference,
    single_brick_set,
)
from tests.test_reference_marcher import (
    CAMERA,
    GLOBAL_MAX,
    GLOBAL_MIN,
    _split_into_bricks,
    make_volume,
)

N = 16


def side_camera(img=16):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([1.5, 0.3, 0.2], [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=0.1,
    )


CASES = {
    # case: (filter_mode, bricks per axis, clip planes, camera, tf scale)
    "nearest": ("nearest", 1, None, CAMERA, 1.0),
    "multi-brick": ("trilinear", 2, None, CAMERA, 1.0),
    "clip-planes": (
        "trilinear", 1,
        np.float32([[0.0, 0.0, 1.0, 0.2], [1.0, 0.0, 0.0, 0.3]]),
        CAMERA, 1.0,
    ),
    "side-view": ("trilinear", 1, None, side_camera(), 1.0),
    "saturated": ("trilinear", 1, None, CAMERA, 6.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_parity_cases(case):
    filter_mode, n_split, clip, camera, tf_scale = CASES[case]
    volume = make_volume(N, seed=5)
    tf = jnp.asarray(
        np.clip(np.asarray(tf_ops.default_color_map(64)) * tf_scale, 0, 1)
    )
    params = RenderParams(
        n_samples_per_ray=24, data_source_range=(0.0, 1.0),
        filter_mode=filter_mode,
    )
    bricks = (
        single_brick_set(volume) if n_split == 1
        else _split_into_bricks(volume, n_split, overlap=1)
    )
    order = raycast.sort_bricks_front_to_back(
        np.asarray(bricks.world_min), np.asarray(bricks.world_max),
        np.asarray(camera.inv_mv, np.float32)[:3, 3],
    )
    vw, vh = camera.viewport[2], camera.viewport[3]
    target = jnp.asarray(
        np.random.default_rng(1).random((vh, vw, 4)).astype(np.float32)
    ) * 0.5

    def loss(render):
        def f(data, tf_arr):
            img = render(
                bricks._replace(data=data), tf_arr, camera, params,
                GLOBAL_MIN, GLOBAL_MAX, clip_planes=clip, brick_order=order,
            )
            return jnp.mean((img - target) ** 2)

        return jax.grad(f, argnums=(0, 1))(bricks.data, tf)

    g_ref = loss(render_reference)
    g_fast = loss(raycast.render)
    assert float(jnp.abs(g_ref[0]).max()) > 1e-9  # a gradient to compare
    for gr, gf in zip(g_ref, g_fast):
        np.testing.assert_allclose(
            np.asarray(gf), np.asarray(gr), atol=1e-6, rtol=2e-3
        )
