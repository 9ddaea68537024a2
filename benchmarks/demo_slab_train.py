"""Config 5 across cards: slab-sharded (model-parallel) store training.

Prints (a) the per-device memory table for replicated vs slab-sharded
training — the store and its Adam moments replicate in the replicated
trainer (~12 GB at 1024³ f32), the slab trainer divides them by D — and
(b) a FUNCTIONAL run of the slab trainer on the mesh available to this
process (8-device virtual CPU mesh under
XLA_FLAGS=--xla_force_host_platform_device_count=8, or real cards),
verifying the loss decreases with the store sharded P(brick).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/demo_slab_train.py [--vox 32] [--steps 6]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def memory_table(d_values=(1, 4, 8, 16, 64), device_gb=80.0):
    """Per-device training memory (GB) for an Na³ f32 store + Adam
    moments (3× store) + one halo slice pair; ray-axis terms omitted
    (small).  ``device_gb``: the card's memory (an H100 has 80 GB)."""
    rows = []
    for na in (256, 512, 1024, 2048):
        store_gb = na ** 3 * 4 / 2**30
        for d in d_values:
            per_dev = store_gb * 3 / d + 2 * na * na * 4 / 2**30
            rows.append(
                {
                    "na": na,
                    "devices": d,
                    "store_plus_adam_gb_per_dev": round(per_dev, 3),
                    "fits_device": bool(per_dev < device_gb),
                }
            )
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vox", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()

    print(json.dumps({"memory_model": memory_table()}, indent=None))

    import jax

    from libre import backend

    backend.setup_compile_cache()
    if jax.device_count() < 8:
        print(json.dumps({"functional": "skipped (need 8 devices)"}))
        return

    import jax.numpy as jnp
    import optax

    from libre.ops import shearwarp as sw
    from libre.ops import shearwarp_grad as swg
    from libre.ops import transfer_function as tf_ops
    from libre.parallel.mesh import make_mesh
    from libre.train import store_trainer as st

    axis, sign = 2, -1.0
    n = args.vox
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    rng = np.random.default_rng(0)
    vol = rng.random((n, n, n)).astype(np.float32)
    real = np.transpose(vol, sw._PERM[axis])
    na, nc, nb = real.shape
    store = np.ascontiguousarray(real, np.float32)
    store = jnp.asarray(store)
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    bounds = (-0.45, 0.45, -0.4, 0.4)
    k_planes, v_size, u_size = 2 * n, 16, 16
    views = np.stack(
        [
            swg.view_vector(
                world_min=gmin, world_max=gmax, axis=axis, eye=e,
                sign=sign, slope_bounds=bounds,
                inter_size=(v_size, u_size), max_samples_per_ray=k_planes,
            )
            for e in (
                np.float32([0.1, 0.05, 1.4]),
                np.float32([-0.15, 0.1, 1.3]),
            )
        ]
    )
    problem = st.StoreProblem(
        views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=k_planes, inter_size=(v_size, u_size),
        world_min=gmin, world_max=gmax, axis=axis,
        diff_tf=False, kc=16,
    )
    mesh = make_mesh(n_brick=4, n_ray=2)
    d_k = mesh.shape["brick"]
    targets = st.render_views(problem, store, tf)

    init = np.asarray(store).copy()
    cov = init > -0.5
    init[cov] = np.clip(
        init[cov] + rng.normal(0, 0.2, cov.sum()), 0, 1
    ).astype(np.float32)

    loss_fn = st.make_slab_loss_fn(problem, mesh)
    opt = optax.adam(5e-2)
    params = {
        "store": st.shard_store_slabs_uniform(jnp.asarray(init), d_k),
        "tf": tf,
    }
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p["store"], p["tf"], targets)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        covered = params["store"] > -0.5
        params = optax.apply_updates(params, updates)
        params = {
            "store": jnp.where(
                covered, jnp.clip(params["store"], 0.0, 1.0),
                params["store"],
            ),
            "tf": params["tf"],
        }
        return params, opt_state, loss

    losses = []
    for _ in range(args.steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(round(float(loss), 6))
    shard_bytes = int(np.prod(params["store"].shape[1:])) * 4 * (
        params["store"].shape[0] // d_k
    )
    print(
        json.dumps(
            {
                "functional": {
                    "mesh": dict(mesh.shape),
                    "store_shape_sharded": list(params["store"].shape),
                    "bytes_per_device_store": shard_bytes,
                    "losses": losses,
                    "converging": losses[-1] < losses[0],
                }
            }
        )
    )
    assert losses[-1] < losses[0], losses


if __name__ == "__main__":
    main()
