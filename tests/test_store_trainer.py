"""Sharded inverse rendering through the differentiable store core
(train/store_trainer.py) — BASELINE config 5 on the fast path.

The sharded loss/gradients (views × slope-rows over the 8-device CPU
mesh, psum-reduced by shard_map's transpose) must equal the
single-device custom-vjp path, and optimization must converge: recover
a density store (and transfer function) from multi-view targets through
the fused Pallas forward + batched-recompute backward."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from libre.ops import shearwarp as sw
from libre.ops import shearwarp_grad as swg
from libre.ops import transfer_function as tf_ops
from libre.ops.shearwarp_bricked import SENTINEL
from libre.parallel.mesh import make_mesh
from libre.train import store_trainer as st
from tests.test_reference_marcher import make_volume

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)
AXIS, SIGN = 2, -1.0
V_SIZE, U_SIZE = 16, 12
K, N = 32, 16


def make_problem(n_views=2, diff_tf=True):
    eyes = [
        np.float32([0.1, 0.05, 1.4]),
        np.float32([-0.15, 0.1, 1.3]),
        np.float32([0.02, -0.12, 1.5]),
        np.float32([-0.05, -0.02, 1.2]),
    ][:n_views]
    bounds = (-0.45, 0.45, -0.4, 0.4)
    views = np.stack(
        [
            swg.view_vector(
                world_min=GMIN, world_max=GMAX, axis=AXIS, eye=e,
                sign=SIGN, slope_bounds=bounds,
                inter_size=(V_SIZE, U_SIZE), max_samples_per_ray=K,
            )
            for e in eyes
        ]
    )
    vol = make_volume(N, seed=5).astype(np.float32)
    real = np.transpose(vol, sw._PERM[AXIS])
    na, nc, nb = real.shape
    store = np.ascontiguousarray(real, np.float32)
    problem = st.StoreProblem(
        views=views,
        na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=K, inter_size=(V_SIZE, U_SIZE),
        world_min=GMIN, world_max=GMAX, axis=AXIS,
        diff_tf=diff_tf, kc=16,
    )
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    return problem, jnp.asarray(store), tf


def test_sharded_loss_and_grads_match_single_device():
    """value_and_grad of the (views × rows)-sharded loss equals the
    single-device custom-vjp loss — shard_map transpose psums the
    replicated store/TF cotangents exactly."""
    problem, store, tf = make_problem(n_views=2)
    targets = st.render_views(problem, store * 0.0 + 0.3, tf)
    single = jax.value_and_grad(
        lambda s, t: st.make_loss_fn(problem, None)(s, t, targets),
        argnums=(0, 1),
    )
    mesh = make_mesh(n_brick=2, n_ray=4)
    sharded = jax.jit(
        jax.value_and_grad(
            lambda s, t: st.make_loss_fn(problem, mesh)(s, t, targets),
            argnums=(0, 1),
        )
    )
    l0, (gs0, gt0) = single(store, tf)
    l1, (gs1, gt1) = sharded(store, tf)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(gs0), np.asarray(gs1), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gt0), np.asarray(gt1), atol=1e-6
    )


def test_store_recovery_converges_on_mesh():
    """Recover the density store from 2 views on the 8-device mesh:
    loss must drop by >10x from a flat-density init (TF frozen)."""
    problem, store_gt, tf = make_problem(n_views=2, diff_tf=False)
    targets = st.render_views(problem, store_gt, tf)
    covered = np.asarray(store_gt) > -0.5
    init = np.where(covered, 0.5, SENTINEL).astype(np.float32)
    mesh = make_mesh(n_brick=2, n_ray=4)
    params, losses = st.fit(
        problem, targets, init, tf, mesh=mesh,
        optimizer=optax.adam(5e-2), steps=25,
    )
    assert losses[-1] < losses[0] / 10.0, losses
    # SENTINEL pinning: uncovered voxels never move.
    assert np.all(np.asarray(params["store"])[~covered] == SENTINEL)


def test_joint_tf_and_store_optimization_decreases_loss():
    problem, store_gt, tf_gt = make_problem(n_views=2, diff_tf=True)
    targets = st.render_views(problem, store_gt, tf_gt)
    rng = np.random.default_rng(0)
    covered = np.asarray(store_gt) > -0.5
    init_store = np.where(
        covered,
        np.clip(np.asarray(store_gt) + rng.normal(0, 0.2, store_gt.shape), 0, 1),
        SENTINEL,
    ).astype(np.float32)
    init_tf = np.clip(
        np.asarray(tf_gt) * 0.7 + 0.05, 0.0, 1.0
    ).astype(np.float32)
    mesh = make_mesh(n_brick=2, n_ray=4)
    params, losses = st.fit(
        problem, targets, init_store, init_tf, mesh=mesh,
        optimizer=optax.adam(2e-2), steps=20,
    )
    assert losses[-1] < losses[0] / 4.0, losses
