"""Inverse rendering through the sharded shear-warp fast path
(BASELINE config 5 at dense-level granularity)."""

import numpy as np
import jax
import jax.numpy as jnp

from libre.core.frustum import look_at, perspective
from libre.ops import shearwarp as sw
from libre.ops import transfer_function as tf_ops
from libre.ops.reference import Camera, RenderParams
from libre.parallel import make_mesh
from libre.train import shearwarp_trainer as swt


def _camera(eye, img=32, near=0.1):
    proj = perspective(50.0, 1.0, near, 15.0)
    mv = look_at(eye, [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=near,
    )


def _problem(n_views=2):
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    params = RenderParams(
        n_samples_per_ray=16, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    swp = sw.ShearWarpParams(n_planes=16, inter_size=(16, 16))
    cams = [_camera([0.2, 0.1, 1.4]), _camera([1.4, 0.1, 0.2])][:n_views]
    return swt.ShearWarpProblem.from_cameras(cams, gmin, gmax, params, swp)


def test_gradients_sharded_match_single_device():
    # One view: the multi-view loss is a plain sum (tested by the fit
    # test); grad-of-shard_map compile time dominates this file.
    problem = _problem(n_views=1)
    mesh = make_mesh(n_brick=2, n_ray=4)
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random((12,) * 3, dtype=np.float32))
    tf = jnp.asarray(tf_ops.default_color_map(32))
    targets = [jnp.zeros((16, 16, 4), jnp.float32)]

    def loss(mesh_):
        def f(v, t):
            imgs = problem.render_views(mesh_, v, t)
            return sum(jnp.mean((i - g) ** 2) for i, g in zip(imgs, targets))
        return f

    gv1, gt1 = jax.grad(loss(None), argnums=(0, 1))(vol, tf)
    gv2, gt2 = jax.grad(loss(mesh), argnums=(0, 1))(vol, tf)
    np.testing.assert_allclose(
        np.asarray(gv1), np.asarray(gv2), atol=1e-6, rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(gt1), np.asarray(gt2), atol=1e-6, rtol=1e-4
    )


def test_fit_recovers_target_views():
    """Optimizing a flat init toward frames of a known volume must cut
    the loss by >10x (both density grid and TF are free parameters)."""
    problem = _problem()
    mesh = make_mesh(n_brick=2, n_ray=4)
    rng = np.random.default_rng(1)
    true_vol = jnp.asarray(rng.random((12,) * 3, dtype=np.float32))
    true_tf = jnp.asarray(tf_ops.default_color_map(32))
    targets = problem.render_views(None, true_vol, true_tf)

    params, losses = swt.fit(
        problem,
        targets,
        init_volume=jnp.full((12,) * 3, 0.5, jnp.float32),
        init_tf=jnp.asarray(tf_ops.grayscale_ramp(32)),
        mesh=mesh,
        steps=60,
    )
    assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
    assert params["volume"].shape == (12, 12, 12)
