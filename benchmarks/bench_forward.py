"""Forward/backward throughput of the exact gather marcher vs the reference."""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from libre.core.frustum import look_at, perspective
from libre.ops import raycast, transfer_function as tf_ops
from libre.ops.reference import (
    Camera,
    RenderParams,
    render_reference,
    single_brick_set,
)


def make_camera(w, h, near=0.1, far=15.0):
    proj = perspective(50.0, w / h, near, far)
    mv = look_at([0, 0, 1.0], [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w, h),
        near=near,
    )


def timed(fn, *args, iters=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def bench(n_vox, img, spr, filter_mode, chunk, mode, which):
    rng = np.random.default_rng(0)
    vol = rng.random((n_vox,) * 3, dtype=np.float32)
    tf = jnp.asarray(tf_ops.default_color_map(256))
    cam = make_camera(img, img)
    import math
    max_steps = int(math.ceil(math.sqrt(3.0) * spr)) + 4
    params = RenderParams(
        n_samples_per_ray=spr,
        data_source_range=(0.0, 1.0),
        filter_mode=filter_mode,
        remat=(mode == "bwd"),
        max_steps_per_brick=max_steps,
    )
    bricks = single_brick_set(jnp.asarray(vol))
    gmin = np.float32([-0.5] * 3)
    gmax = np.float32([0.5] * 3)

    if which == "fast":
        render_fn = lambda b, t: raycast.render(
            b, t, cam, params, gmin, gmax, chunk=chunk, max_steps=max_steps)
    else:
        render_fn = lambda b, t: render_reference(b, t, cam, params, gmin, gmax)

    if mode == "fwd":
        f = jax.jit(lambda b, t: render_fn(b, t))
        dt, out = timed(f, bricks, tf)
    else:
        def loss(data, t):
            b = bricks._replace(data=data)
            return jnp.mean(render_fn(b, t) ** 2)

        f = jax.jit(jax.grad(loss, argnums=(0, 1)))
        dt, out = timed(f, bricks.data, tf)

    rays = img * img
    print(
        f"{which:5s} {mode} vol={n_vox}^3 img={img}^2 spr={spr} {filter_mode:9s} "
        f"chunk={chunk:3d}: {dt*1e3:8.2f} ms  {rays/dt/1e6:8.2f} Mrays/s  "
        f"{rays*spr*1.75/dt/1e9:7.2f} Gsamples/s"
    )


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()
    print("devices:", jax.devices())
    for which in ("fast", "ref"):
        bench(64, 256, 512, "nearest", 32, "fwd", which)
    for chunk in (16, 32, 64, 128):
        bench(64, 256, 512, "nearest", chunk, "fwd", "fast")
    bench(64, 256, 512, "trilinear", 32, "fwd", "fast")
    bench(64, 256, 512, "trilinear", 64, "fwd", "fast")
    if not args.quick:
        bench(128, 512, 1024, "nearest", 64, "fwd", "fast")
        bench(128, 512, 1024, "trilinear", 64, "fwd", "fast")
        bench(64, 256, 512, "trilinear", 32, "bwd", "fast")
        bench(64, 256, 512, "trilinear", 64, "bwd", "fast")
