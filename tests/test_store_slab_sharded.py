"""Slab-sharded (model-parallel) store training — config 5 across devices.

The density store lives 1/d_k per device on the mesh brick axis; each
device sweeps its global plane range against its slab (+2 ppermute halo
slices) with a fresh carry, and the segments fold with the over
operator.  Loss AND gradients must equal the replicated single-device
custom-vjp path (early exit disabled under grad makes the fold
bit-exact), and optimization must converge with the sharded store.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from libre.parallel.mesh import BRICK_AXIS, make_mesh
from libre.train import store_trainer as st
from tests.test_store_trainer import make_problem


def _mesh():
    return make_mesh(n_brick=4, n_ray=2)


def test_slab_loss_and_grads_match_replicated():
    problem, store, tf = make_problem(n_views=2)
    mesh = _mesh()
    d_k = mesh.shape[BRICK_AXIS]

    targets = st.render_views(problem, store, tf) * 0.8 + 0.05

    loss_rep = st.make_loss_fn(problem, None)
    loss_slab = st.make_slab_loss_fn(problem, mesh)

    store_sh = st.shard_store_slabs_uniform(store, d_k)
    store_sh = jax.device_put(
        store_sh, NamedSharding(mesh, P(BRICK_AXIS))
    )

    l_rep, (gs_rep, gtf_rep) = jax.value_and_grad(loss_rep, argnums=(0, 1))(
        store, tf, targets
    )
    l_sl, (gs_sl, gtf_sl) = jax.jit(
        jax.value_and_grad(loss_slab, argnums=(0, 1))
    )(store_sh, tf, targets)

    np.testing.assert_allclose(float(l_sl), float(l_rep), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(gs_sl).reshape(np.asarray(gs_rep).shape),
        np.asarray(gs_rep),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(gtf_sl), np.asarray(gtf_rep), atol=1e-5
    )


def test_slab_render_matches_monolith():
    """Forward only: folded slab segments == the monolithic sweep."""
    problem, store, tf = make_problem(n_views=1)
    mesh = _mesh()
    d_k = mesh.shape[BRICK_AXIS]
    loss_slab = st.make_slab_loss_fn(problem, mesh)
    store_sh = st.shard_store_slabs_uniform(store, d_k)
    # Zero targets: the loss IS the mean-square of the rendered image;
    # compare against the replicated loss on the same zero targets.
    targets = jnp.zeros(
        (1, problem.inter_size[0], problem.inter_size[1], 4), jnp.float32
    )
    l_sl = float(jax.jit(loss_slab)(store_sh, tf, targets))
    l_rep = float(st.make_loss_fn(problem, None)(store, tf, targets))
    np.testing.assert_allclose(l_sl, l_rep, rtol=1e-6)


def test_slab_training_converges():
    problem, store, tf = make_problem(n_views=2)
    mesh = _mesh()
    d_k = mesh.shape[BRICK_AXIS]
    targets = st.render_views(problem, store, tf)

    rng = np.random.default_rng(0)
    init = np.asarray(store).copy()
    covered = init > -0.5
    init[covered] = np.clip(
        init[covered] + rng.normal(0, 0.25, covered.sum()), 0, 1
    ).astype(np.float32)

    loss_slab = st.make_slab_loss_fn(problem, mesh)
    opt = optax.adam(5e-2)
    params = {
        "store": st.shard_store_slabs_uniform(jnp.asarray(init), d_k),
        "tf": tf,
    }
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def f(p):
            return loss_slab(p["store"], p["tf"], targets)

        loss, grads = jax.value_and_grad(f)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        covered = params["store"] > -0.5
        params = optax.apply_updates(params, updates)
        params = {
            "store": jnp.where(
                covered,
                jnp.clip(params["store"], 0.0, 1.0),
                params["store"],
            ),
            "tf": jnp.clip(params["tf"], 0.0, 1.0),
        }
        return params, opt_state, loss

    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses
