"""Scaling-efficiency benchmark: rays/s vs device count (BASELINE
config 4 — multi-brick volume, sort-first tiles across the mesh).

Renders the same frame sharded over 1, 2, 4, ... N devices (sort-first
slope rows x optional sort-last plane ranges) and reports throughput
and parallel efficiency vs the 1-device run:

    python benchmarks/bench_scaling.py [--devices N] [--brick 2] \
        [--img 256] [--planes 512] [--vox 64] [--cpu-mesh]

On a multi-GPU host this measures real scaling.  With --cpu-mesh it runs
on a virtual CPU mesh (xla_force_host_platform_device_count) — useful to
validate the sharding compiles and the decomposition is load-balanced,
but CPU timings are NOT hardware efficiency numbers and are flagged as
such.

Prints one JSON line per device count:
  {"devices": n, "mrays_per_s": x, "efficiency": e, "backend": "..."}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0, help="max devices (0 = all)")
    ap.add_argument("--brick", type=int, default=1, help="sort-last factor per run")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--planes", type=int, default=512)
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="force a virtual CPU mesh (validation, not perf)")
    ap.add_argument("--path", default="bricked", choices=["dense", "bricked"],
                    help="dense = pre-classified shear-warp "
                    "(parallel/shearwarp_sharded.py); bricked = the "
                    "post-classification store march "
                    "(parallel/bricked_sharded.py)")
    args = ap.parse_args()

    if args.cpu_mesh:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np

    from libre import backend as be
    from libre.core.frustum import look_at, perspective
    from libre.ops import shearwarp as sw
    from libre.ops import transfer_function as tf_ops
    from libre.ops.reference import Camera, RenderParams
    from libre.parallel import make_mesh

    be.setup_compile_cache()
    n_avail = len(jax.devices())
    backend = be.platform()
    n_max = min(args.devices or n_avail, n_avail)
    log(f"{n_avail} {backend} devices available, scaling to {n_max}")

    img, spr, nv = args.img, args.planes, args.vox
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random((nv,) * 3, dtype=np.float32))
    tf = jnp.asarray(tf_ops.default_color_map(256))
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=0.1,
    )
    plan = sw.make_plan(cam)
    params = RenderParams(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    if args.path == "bricked":
        # The post-classification store sweep sharded sort-first rows ×
        # sort-last plane slabs (the round-2+ fast path).
        from libre.ops import shearwarp_grad as swg
        from libre.parallel.bricked_sharded import (
            render_store_grid_sharded,
        )

        axis = plan.axis
        real = np.transpose(np.asarray(vol), sw._PERM[axis])
        na, nc_r, nb_r = real.shape
        store = jnp.asarray(real)
        b_axis, c_axis = sw._BC_AXES[axis]
        fv_j = jnp.asarray(swg.view_vector(
            world_min=gmin, world_max=gmax, axis=axis, eye=plan.eye,
            sign=plan.sign, slope_bounds=plan.bounds,
            inter_size=(img, img), max_samples_per_ray=spr,
        ))

    def timed_marginal(render_one, x):
        def chain(m):
            def f(a):
                s = jnp.float32(0.0)
                for _ in range(m):
                    s = render_one(a + s * 1e-30).sum()
                return s
            return jax.jit(f)

        f2, f10 = chain(2), chain(10)
        float(f2(x)); float(f10(x))
        t2s, t10s = [], []
        for _ in range(3):
            t0 = time.perf_counter(); float(f2(x)); t2s.append(time.perf_counter() - t0)
            t0 = time.perf_counter(); float(f10(x)); t10s.append(time.perf_counter() - t0)
        return (min(t10s) - min(t2s)) / 8

    base = None
    n = 1
    while n <= n_max:
        n_brick = args.brick if n % args.brick == 0 and n >= args.brick else 1
        n_ray = n // n_brick
        mesh = make_mesh(n_brick=n_brick, n_ray=n_ray,
                         devices=jax.devices()[:n])
        swp = sw.ShearWarpParams(n_planes=spr, inter_size=(img, img))

        if args.path == "bricked":
            render_one = lambda st, mesh=mesh: render_store_grid_sharded(
                mesh, st, tf, fv_j,
                na_real=na, nc_real=nc_r, nb_real=nb_r,
                k_planes=spr, inter_size=(img, img),
                wb0=float(gmin[b_axis]), wb1=float(gmax[b_axis]),
                wc0=float(gmin[c_axis]), wc1=float(gmax[c_axis]),
                early_exit=0.999,
            )
        else:
            from libre.parallel.shearwarp_sharded import (
                render_slope_grid_sharded,
            )

            render_one = lambda v, mesh=mesh: render_slope_grid_sharded(
                mesh, v, tf, plan.eye, plan.axis,
                plan.sign, plan.bounds, gmin, gmax, params, swp,
            )

        dt = timed_marginal(
            render_one, store if args.path == "bricked" else vol
        )
        mrays = img * img / dt / 1e6
        if base is None:
            base = mrays
        eff = mrays / (base * n)
        # On the virtual CPU mesh the ratio checks shard SHAPES, not
        # hardware scaling — name it so it cannot be quoted as
        # efficiency.
        eff_key = (
            "cpu_virtual_scaling_shape_check" if args.cpu_mesh
            else "efficiency"
        )
        print(json.dumps({
            "devices": n,
            "mrays_per_s": round(mrays, 2),
            eff_key: round(eff, 3),
            "backend": backend + ("/virtual" if args.cpu_mesh else ""),
        }), flush=True)
        n *= 2

    if args.cpu_mesh:
        log("NOTE: virtual CPU mesh — numbers validate sharding, not hardware")


if __name__ == "__main__":
    main()
