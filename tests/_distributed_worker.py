"""Worker for the 2-process jax.distributed test (run by
tests/test_distributed.py, NOT collected by pytest).

Each process owns 4 virtual CPU devices; together they form an
8-device (ray × brick) mesh spanning a process boundary — the DCN path
of the reference's multi-node deployment (livre/eq/Node.cpp:43-160):
FrameData broadcast (Collage commit/sync ≙ broadcast_frame_state), a
frame-lifecycle barrier, and a sharded render + gradient step whose
results must equal the local single-device computation on every
process.
"""

import os
import sys

PID = int(sys.argv[1])
PORT = sys.argv[2]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from libre.parallel.distributed import (  # noqa: E402
    broadcast_frame_state,
    initialize,
    is_controller,
    sync_global_devices,
)


def main():
    initialize(f"127.0.0.1:{PORT}", num_processes=2, process_id=PID)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 8
    assert is_controller() == (PID == 0)

    # --- FrameData commit/sync: controller → all hosts ---------------
    if PID == 0:
        state = {
            "camera_mv": np.linspace(0, 1, 16, dtype=np.float32),
            "uri": "mem://#8,8,8,8",
            "frame": 7,
            "clip": [(1.0, 0.0, 0.0, 0.25)],
        }
    else:
        state = None
    got = broadcast_frame_state(state)
    assert got["frame"] == 7 and got["uri"] == "mem://#8,8,8,8"
    np.testing.assert_allclose(
        got["camera_mv"], np.linspace(0, 1, 16, dtype=np.float32)
    )
    sync_global_devices("framedata")

    # --- sharded render + gradient across the process boundary -------
    from libre.ops import shearwarp as sw
    from libre.ops import transfer_function as tf_ops
    from libre.ops.reference import RenderParams
    from libre.parallel.mesh import make_mesh
    from libre.parallel.shearwarp_sharded import (
        render_slope_grid_sharded,
    )

    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random((16,) * 3, dtype=np.float32))
    tf_np = np.asarray(tf_ops.default_color_map(256), np.float32)
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    eye = np.float32([0.1, 0.05, 1.4])
    bounds = (-0.45, 0.45, -0.4, 0.4)
    params = RenderParams(
        n_samples_per_ray=16, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", early_exit=1.1,
    )
    swp = sw.ShearWarpParams(n_planes=16, inter_size=(8, 8))
    mesh = make_mesh(n_brick=2, n_ray=4)  # spans both processes

    tf_g = multihost_utils.host_local_array_to_global_array(
        tf_np, mesh, P()
    )

    def forward(tf):
        return render_slope_grid_sharded(
            mesh, vol, tf, eye, 2, -1.0, bounds, gmin, gmax, params, swp
        )

    def loss(tf):
        return jnp.mean(forward(tf) ** 2)

    img, grad = jax.jit(
        lambda t: jax.value_and_grad(
            lambda tt: loss(tt)
        )(t)
    )(tf_g)
    img_l = float(img)
    grad_l = multihost_utils.global_array_to_host_local_array(
        grad, mesh, P()
    )
    grad_l = np.asarray(grad_l)

    # Local single-device reference on this process.
    tf_local = jnp.asarray(tf_np)

    def loss_local(tf):
        out, _, _ = sw.render_slope_grid(
            vol, tf, eye, 2, -1.0, bounds, gmin, gmax, params, swp
        )
        return jnp.mean(out ** 2)

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_local))(tf_local)
    np.testing.assert_allclose(img_l, float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(grad_l, np.asarray(g_ref), atol=1e-6)

    sync_global_devices("dense")

    # --- FLAGSHIP bricked path across the process boundary -----------
    # (r3 weak 5: the dense test proves the bootstrap, not the
    # centerpiece.)  Sharded bricked render + a slab-sharded store
    # trainer step, both equal to the local single-device results.
    from libre.ops import shearwarp_grad as swg
    from libre.parallel.bricked_sharded import (
        render_store_grid_sharded,
    )
    from libre.train import store_trainer as st

    axis, sign = 2, -1.0
    k_planes, v_size, u_size = 16, 8, 8
    real = np.transpose(np.asarray(vol), sw._PERM[axis])
    na, nc, nb = real.shape
    store_np = np.ascontiguousarray(real, np.float32)
    fv = swg.view_vector(
        world_min=gmin, world_max=gmax, axis=axis, eye=eye, sign=sign,
        slope_bounds=bounds, inter_size=(v_size, u_size),
        max_samples_per_ray=k_planes,
    )
    b_axis, c_axis = sw._BC_AXES[axis]
    store_g = multihost_utils.host_local_array_to_global_array(
        store_np, mesh, P()
    )
    fv_g = multihost_utils.host_local_array_to_global_array(
        np.asarray(fv, np.float32), mesh, P()
    )

    static = swg.static_view(
        na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=k_planes, v_size=v_size, u_size=u_size,
        world_min=gmin, world_max=gmax, axis=axis,
        early_exit=1.1, kc=8,
    )
    ref_img = swg.render_store_grid_diff(
        jnp.asarray(store_np), tf_local, jnp.asarray(fv), static
    )  # local single-device monolith

    def bricked_err(store, tf, fv_op, ref):
        img = render_store_grid_sharded(
            mesh, store, tf, fv_op,
            na_real=na, nc_real=nc, nb_real=nb, k_planes=k_planes,
            inter_size=(v_size, u_size),
            wb0=float(gmin[b_axis]), wb1=float(gmax[b_axis]),
            wc0=float(gmin[c_axis]), wc1=float(gmax[c_axis]),
            early_exit=1.1,
        )
        return jnp.max(jnp.abs(img - ref))

    ref_g = multihost_utils.host_local_array_to_global_array(
        np.asarray(ref_img), mesh, P()
    )
    err = float(jax.jit(bricked_err)(store_g, tf_g, fv_g, ref_g))
    assert err < 1e-5, err
    sync_global_devices("bricked")

    # --- slab-sharded store trainer step over DCN ---------------------
    problem = st.StoreProblem(
        views=np.stack([fv]),
        na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=k_planes, inter_size=(v_size, u_size),
        world_min=gmin, world_max=gmax, axis=axis,
        diff_tf=True, kc=8,
    )
    targets_np = np.asarray(
        st.render_views(problem, jnp.asarray(store_np), tf_local)
    ) * 0.9
    loss_rep = st.make_loss_fn(problem, None)
    l_ref, (gs_ref, gtf_ref) = jax.value_and_grad(
        loss_rep, argnums=(0, 1)
    )(jnp.asarray(store_np), tf_local, jnp.asarray(targets_np))

    loss_slab = st.make_slab_loss_fn(problem, mesh)
    d_k = mesh.shape["brick"]
    store_sh_g = multihost_utils.host_local_array_to_global_array(
        np.asarray(
            st.shard_store_slabs_uniform(jnp.asarray(store_np), d_k)
        ),
        mesh,
        P(),
    )
    tgt_g = multihost_utils.host_local_array_to_global_array(
        targets_np, mesh, P()
    )
    gs_ref_g = multihost_utils.host_local_array_to_global_array(
        np.asarray(gs_ref), mesh, P()
    )
    gtf_ref_g = multihost_utils.host_local_array_to_global_array(
        np.asarray(gtf_ref), mesh, P()
    )

    def slab_step_err(store_sh, tf, targets, gs_r, gtf_r):
        loss, (g_s, g_t) = jax.value_and_grad(
            loss_slab, argnums=(0, 1)
        )(store_sh, tf, targets)
        e1 = jnp.max(jnp.abs(g_s.reshape(gs_r.shape) - gs_r))
        e2 = jnp.max(jnp.abs(g_t - gtf_r))
        return loss, jnp.maximum(e1, e2)

    loss_v, gerr = jax.jit(slab_step_err)(
        store_sh_g, tf_g, tgt_g, gs_ref_g, gtf_ref_g
    )
    loss_v, gerr = float(loss_v), float(gerr)
    np.testing.assert_allclose(loss_v, float(l_ref), rtol=1e-6)
    assert gerr < 1e-5, gerr

    sync_global_devices("done")
    print(
        f"OK pid={PID} loss={img_l:.6f} bricked_err={err:.2e} "
        f"slab_gerr={gerr:.2e}"
    )


if __name__ == "__main__":
    main()
