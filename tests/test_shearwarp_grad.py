"""Differentiable store rendering (ops/shearwarp_grad.py): the custom
backward (batched recompute sweeps) must match jax.grad of the
post-classification plane oracle on the identical sample set, for both
density-store and transfer-function gradients — the framework's
north-star addition (the reference has no autodiff; SURVEY.md §7
stage 2)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libre.ops import shearwarp as sw
from libre.ops import shearwarp_grad as swg
from libre.ops import transfer_function as tf_ops
from libre.ops.reference import RenderParams
from tests.test_reference_marcher import make_volume

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)
AXIS, SIGN = 2, -1.0
EYE = np.float32([0.1, 0.05, 1.4])
BOUNDS = (-0.45, 0.45, -0.4, 0.4)
V_SIZE, U_SIZE = 16, 12
K = 40
N = 24

PARAMS = RenderParams(
    n_samples_per_ray=K, data_source_range=(0.0, 1.0),
    filter_mode="trilinear",
)


def setup(seed=3, tf_scale=1.0):
    vol = make_volume(N, seed=seed).astype(np.float32)
    perm = sw._PERM[AXIS]
    store_real = np.transpose(vol, perm)
    na, nc, nb = store_real.shape
    store = np.ascontiguousarray(store_real, np.float32)
    tf = np.asarray(tf_ops.default_color_map(256)) * tf_scale
    static = swg.static_view(
        na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=K, v_size=V_SIZE, u_size=U_SIZE,
        world_min=GMIN, world_max=GMAX, axis=AXIS,
        early_exit=PARAMS.early_exit, kc=16,
    )
    vs = swg.view_vector(
        world_min=GMIN, world_max=GMAX, axis=AXIS, eye=EYE, sign=SIGN,
        slope_bounds=BOUNDS, inter_size=(V_SIZE, U_SIZE),
        max_samples_per_ray=PARAMS.max_samples_per_ray,
    )
    return vol, jnp.asarray(store), jnp.asarray(tf), jnp.asarray(vs), static


def oracle_fn(vol_shape):
    """plane_oracle(post) over the dense volume on the slope-grid rays,
    as a function of (volume, tf)."""
    u0, u1, v0, v1 = BOUNDS
    ug = np.linspace(u0, u1, U_SIZE, dtype=np.float32)
    vg = np.linspace(v0, v1, V_SIZE, dtype=np.float32)
    uu, vv = np.meshgrid(ug, vg, indexing="xy")
    uu = jnp.asarray(uu.reshape(-1))
    vv = jnp.asarray(vv.reshape(-1))

    def f(volume, tf):
        return sw.plane_oracle(
            volume, tf, EYE, AXIS, SIGN, (uu, vv), GMIN, GMAX, PARAMS, K,
            classification="post",
        ).reshape(V_SIZE, U_SIZE, 4)

    return f


def test_forward_matches_oracle():
    vol, store, tf, vs, static = setup()
    got = np.asarray(swg.render_store_grid_diff(store, tf, vs, static))
    want = np.asarray(oracle_fn(vol.shape)(jnp.asarray(vol), tf))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("tf_scale", [1.0, 3.0])
def test_gradients_match_oracle_autodiff(tf_scale):
    """d(loss)/d(store) and d(loss)/d(tf) == jax.grad through the jnp
    oracle.  tf_scale=3 drives rays into early-exit saturation, covering
    the masked-gradient path."""
    vol, store, tf, vs, static = setup(tf_scale=tf_scale)
    na, nc, nb = vol.shape[0], vol.shape[1], vol.shape[2]
    perm = sw._PERM[AXIS]

    rng = np.random.default_rng(0)
    g_img = jnp.asarray(
        rng.standard_normal((V_SIZE, U_SIZE, 4)).astype(np.float32)
    )

    def loss_fast(store_, tf_):
        out = swg.render_store_grid_diff(store_, tf_, vs, static)
        return jnp.sum(out * g_img)

    d_store, d_tf = jax.grad(loss_fast, argnums=(0, 1))(store, tf)

    f = oracle_fn(vol.shape)

    def loss_oracle(volume_, tf_):
        return jnp.sum(f(volume_, tf_) * g_img)

    d_vol, d_tf_o = jax.grad(loss_oracle, argnums=(0, 1))(
        jnp.asarray(vol), tf
    )
    # volume (Z, Y, X) grad → permuted store layout
    d_vol_p = np.transpose(np.asarray(d_vol), perm)
    got_store = np.asarray(d_store)[
        : d_vol_p.shape[0], : d_vol_p.shape[1], : d_vol_p.shape[2]
    ]
    scale = max(np.abs(d_vol_p).max(), 1e-6)
    np.testing.assert_allclose(
        got_store / scale, d_vol_p / scale, atol=3e-4
    )
    tf_scale_n = max(np.abs(np.asarray(d_tf_o)).max(), 1e-6)
    np.testing.assert_allclose(
        np.asarray(d_tf) / tf_scale_n,
        np.asarray(d_tf_o) / tf_scale_n,
        atol=3e-4,
    )


def test_value_and_grad_through_screen_warp():
    """The custom-vjp core composes with the differentiable jnp screen
    warp (training against screen-space targets)."""
    vol, store, tf, vs, static = setup()
    u0, u1, v0, v1 = BOUNDS
    ug = jnp.linspace(u0, u1, U_SIZE, dtype=jnp.float32)
    vg = jnp.linspace(v0, v1, V_SIZE, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(
        jnp.linspace(u0 + 0.05, u1 - 0.05, 8),
        jnp.linspace(v0 + 0.05, v1 - 0.05, 8),
        indexing="xy",
    )
    valid = jnp.ones_like(uu)

    def loss(store_, tf_):
        inter = swg.render_store_grid_diff(store_, tf_, vs, static)
        img = sw.warp_to_screen(inter, ug, vg, uu, vv, valid)
        return jnp.mean(img ** 2)

    val, (d_store, d_tf) = jax.value_and_grad(loss, argnums=(0, 1))(
        store, tf
    )
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(d_store)).all()
    assert float(jnp.abs(d_store).max()) > 0
    assert float(jnp.abs(d_tf).max()) > 0
