"""Inverse rendering on the 8-device CPU mesh (BASELINE config 5 in
miniature): optimizing brick densities + transfer function from a target
image must reduce the loss by orders of magnitude, with density grads
sharded along the brick axis; checkpoints round-trip through orbax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from libre.ops import rays as ray_ops, transfer_function as tf_ops
from libre.ops.reference import RenderParams, max_steps_for_bricks
from libre.parallel import make_mesh, shard_bricks_front_to_back
from libre.train import (
    InverseRenderProblem,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from libre.train.trainer import init_state
from tests.test_reference_marcher import (
    CAMERA,
    GLOBAL_MAX,
    GLOBAL_MIN,
    _split_into_bricks,
    make_volume,
)


@pytest.fixture(scope="module")
def setup():
    volume = make_volume(16, seed=5)
    true_tf = jnp.asarray(tf_ops.default_color_map(32))
    bricks = _split_into_bricks(volume, 2, overlap=2)

    mesh = make_mesh(n_brick=2)
    eye_np = np.zeros(3, np.float32)
    eye, dirs, cos_z, _ = ray_ops.make_rays(
        CAMERA.inv_proj, CAMERA.inv_mv, CAMERA.viewport
    )
    eye_np = np.asarray(eye)
    sharded, _ = shard_bricks_front_to_back(bricks, eye_np, 2)

    params = RenderParams(
        n_samples_per_ray=24,
        data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
        early_exit=1.1,
        remat=True,
    )
    problem = InverseRenderProblem(
        bricks=sharded,
        global_min=GLOBAL_MIN,
        global_max=GLOBAL_MAX,
        params=params,
        max_steps=max_steps_for_bricks(
            sharded.world_min, sharded.world_max, params.step_size
        ),
    )
    dirs = dirs.reshape(-1, 3)
    tnp = ray_ops.near_plane_t(cos_z.reshape(-1), CAMERA.near)
    target = problem.render(mesh, sharded.data, true_tf, eye, dirs, tnp)
    return mesh, problem, true_tf, eye, dirs, tnp, target


def test_loss_decreases(setup):
    mesh, problem, true_tf, eye, dirs, tnp, target = setup
    optimizer = optax.adam(3e-2)
    # Start from a uniform density + grayscale TF.
    problem0 = InverseRenderProblem(
        bricks=problem.bricks._replace(
            data=jnp.full_like(problem.bricks.data, 0.3)
        ),
        global_min=problem.global_min,
        global_max=problem.global_max,
        params=problem.params,
        max_steps=problem.max_steps,
    )
    state = init_state(
        problem0, tf_ops.grayscale_ramp(32), optimizer, mesh=mesh
    )
    step = make_train_step(problem0, optimizer, mesh)

    state, loss0 = step(state, eye, dirs, tnp, target)
    losses = [float(loss0)]
    for _ in range(35):
        state, loss = step(state, eye, dirs, tnp, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, losses[::10]
    assert int(state.step) == 36

    # Density gradients/params stay sharded along the brick axis.
    sharding = state.params["density"].sharding
    assert "brick" in str(sharding.spec)


def test_checkpoint_roundtrip(setup, tmp_path):
    """Orbax round-trip of the sharded train state (params only — the
    train step itself is covered by test_loss_decreases; compiling a
    second step graph here would double the file's wall for no extra
    coverage)."""
    mesh, problem, true_tf, eye, dirs, tnp, target = setup
    optimizer = optax.adam(1e-2)
    state = init_state(problem, true_tf, optimizer, mesh=mesh)

    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state.params)
    restored = restore_checkpoint(path)
    np.testing.assert_allclose(
        np.asarray(restored["density"]), np.asarray(state.params["density"])
    )
    np.testing.assert_allclose(
        np.asarray(restored["tf"]), np.asarray(state.params["tf"])
    )
