"""Render + train throughput on one card.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.
Every number in it is measured in this run, on the device it names; the
run fails when JAX finds no GPU.

Headline = the bricked store fast path (ops/shearwarp_bricked.py):
256³ density store → 256² image × 512 planes with post-classification
and early termination.

``extra`` carries the other workloads:
  * store_fwd_bwd_mrays — forward + FULL backward (density + TF
    gradients) through ops/shearwarp_grad.render_store_grid_diff
    (early exit disabled under grad, trainer semantics);
  * engine_frame_ms — steady-state end-to-end RenderEngine.render_bricked
    (select → cache → dispatch → block), the host-side frame-time guard
    (the reference's FPS log, livre/eq/Client.cpp:239-243);
  * exact_xla_fwd_mrays — the exact gather marcher (ops/raycast.py).

Kernel timings use CHAINED frames inside one jit call (each frame
consumes a zero-scaled summary of the previous one, defeating CSE) and
report the marginal per-frame cost between a short and a long chain,
which cancels the per-call dispatch overhead.  Diagnostics go to stderr;
stdout carries only the JSON line.
"""

import json
import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_scalar(fn, *args, iters=3):
    """Min wall time of fn(*args) forced to a host scalar each call."""
    float(fn(*args))  # compile + warm
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def marginal(make_chain, x, m_lo=2, m_hi=10):
    t_lo = timed_scalar(make_chain(m_lo), x)
    t_hi = timed_scalar(make_chain(m_hi), x)
    return (t_hi - t_lo) / (m_hi - m_lo), t_lo, t_hi


def make_camera(eye, img, near=0.1, far=15.0):
    from libre.core.frustum import look_at, perspective
    from libre.ops.reference import Camera

    proj = perspective(50.0, 1.0, near, far)
    mv = look_at(eye, [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=near,
    )


def smooth_volume(n, seed=0):
    """Smooth multi-blob density (~test_reference_marcher.make_volume):
    realistic transparency so early termination is exercised but not
    instant (a uniform-noise volume saturates in a few planes)."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        s = rng.uniform(0.15, 0.4)
        a = rng.uniform(0.4, 1.0)
        vol += a * np.exp(
            -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
            / (2 * s * s)
        )
    return np.clip(vol / vol.max(), 0.0, 1.0)


def bench_bricked_store(img, n_vox, spr, tf):
    """Headline: steady-state store frames (camera as runtime operand),
    4 eyes sharing the major axis so one store serves every frame."""
    from libre.ops import shearwarp as sw
    from libre.ops import shearwarp_bricked as swb
    from libre.ops.reference import RenderParams

    vol = smooth_volume(n_vox)
    axis = 2
    real = np.transpose(vol, sw._PERM[axis])
    na, nc, nb = real.shape
    store = jnp.asarray(real)
    content = swb.store_content(store, na)

    eyes = [
        [0.2, 0.1, 1.4], [-0.1, 0.15, 1.35],
        [0.1, -0.2, 1.45], [-0.15, -0.1, 1.3],
    ]
    cams = [make_camera(e, img) for e in eyes]
    params = RenderParams(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    swp = sw.ShearWarpParams(
        n_planes=spr, inter_size=(img, img), classification="post"
    )
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    plans = [sw.make_view_plan(c) for c in cams]
    assert all(p.axis == axis for p in plans)

    def frame(st, i):
        return swb.render_store_frame(
            st, _AssemblyStub(axis, (na, nc, nb)), tf, cams[i],
            params=params, swp=swp, world_min=gmin, world_max=gmax,
            content=content,
        )

    def chain(m):
        def f(st):
            s = jnp.float32(0.0)
            for i in range(m):
                s = frame(st + s * 1e-30, i % 4).sum()
            return s
        return jax.jit(f)

    dt, t2, t10 = marginal(chain, store, m_hi=22)
    rays = img * img
    log(f"bricked store fwd: {dt*1e3:.2f} ms/frame marginal, "
        f"{rays/dt/1e6:.2f} Mrays/s (t2={t2*1e3:.1f} t10={t10*1e3:.1f})")
    return rays / dt / 1e6, dt, store, (na, nc, nb), params, swp


class _AssemblyStub:
    """Minimal AssemblyPlan stand-in for render_store_frame (it reads
    only .axis and .fine_dims)."""

    def __init__(self, axis, fine_dims):
        self.axis = axis
        self.fine_dims = fine_dims


def bench_store_bwd(img, spr, store, dims, tf):
    """Forward + full backward (density + TF grads) per frame — the
    BASELINE "Mrays/s/chip fwd+bwd" metric (trainer semantics: early
    exit disabled)."""
    from libre.ops import shearwarp_grad as swg

    na, nc, nb = dims
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    static = swg.static_view(
        na_store=store.shape[0], na_real=na, nc_real=nc, nb_real=nb,
        k_planes=spr, v_size=img, u_size=img,
        world_min=gmin, world_max=gmax, axis=2,
        early_exit=1.1, kc=32,
    )
    bounds = (-0.55, 0.35, -0.45, 0.42)
    vs = swg.view_vector(
        world_min=gmin, world_max=gmax, axis=2,
        eye=np.float32([0.1, 0.05, 1.4]), sign=-1.0, slope_bounds=bounds,
        inter_size=(img, img), max_samples_per_ray=spr,
    )
    vs = jnp.asarray(vs)

    def chain(m):
        def f(st):
            s = jnp.float32(0.0)
            for _ in range(m):
                def loss(x):
                    out = swg.render_store_grid_diff(x, tf, vs, static)
                    return jnp.sum(out * out)
                l, g = jax.value_and_grad(loss)(st + s * 1e-30)
                s = l + g.sum() * 1e-30
            return s
        return jax.jit(f)

    dt, t2, t10 = marginal(chain, store, m_lo=1, m_hi=9)
    rays = img * img
    log(f"store fwd+bwd: {dt*1e3:.2f} ms/step marginal, "
        f"{rays/dt/1e6:.2f} Mrays/s (t1={t2*1e3:.1f} t5={t10*1e3:.1f})")
    return rays / dt / 1e6


def bench_exact_xla(img, n_vox, spr):
    """The exact perspective path: the gather marcher ops/raycast.py."""
    from libre.ops import raycast, transfer_function as tf_ops
    from libre.ops.reference import RenderParams, single_brick_set

    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random((n_vox,) * 3, dtype=np.float32))
    tf = jnp.asarray(tf_ops.default_color_map(256))
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    max_steps = int(math.ceil(math.sqrt(3.0) * spr)) + 4
    params = RenderParams(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", max_steps_per_brick=max_steps,
    )
    cam = make_camera([0.2, 0.1, 1.4], img)
    bricks = single_brick_set(vol)
    f = jax.jit(
        lambda b, t: raycast.render(
            b, t, cam, params, gmin, gmax, chunk=64, max_steps=max_steps
        ).sum()
    )
    dt = timed_scalar(f, bricks, tf, iters=3)
    mrays = img * img / dt / 1e6
    log(f"exact xla fwd: {dt*1e3:.2f} ms/frame, {mrays:.4f} Mrays/s")
    return mrays


def bench_engine_frame(img=256):
    """Steady-state end-to-end engine frame: select → caches → single
    dispatch (Client.cpp FPS log analog).

    Two numbers: ``pipelined`` is the marginal per-frame cost of a
    back-to-back frame stream (dispatches enqueue without blocking —
    how an interactive loop actually runs, and what bounds FPS);
    ``blocking`` is the median latency when every frame round-trips to
    the host."""
    from libre.core.frustum import Frustum
    from libre.data.datasource import DataSource, load_plugins
    from libre.render.engine import RenderEngine

    load_plugins()
    ds = DataSource("mem://#64,64,64,32")
    eng = RenderEngine(ds, max_gpu_cache_mb=512)
    cam = make_camera([0.2, 0.1, 1.4], img)
    proj = np.linalg.inv(np.asarray(cam.inv_proj, np.float64))
    mv = np.linalg.inv(np.asarray(cam.inv_mv, np.float64))
    frustum = Frustum(mv.astype(np.float32), proj.astype(np.float32))
    # Warm: assembly + compile.
    for _ in range(2):
        imgout, _ = eng.render_bricked(cam, frustum, n_planes=256)
        jax.block_until_ready(imgout)
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        imgout, _ = eng.render_bricked(cam, frustum, n_planes=256)
        jax.block_until_ready(imgout)
        ts.append(time.perf_counter() - t0)
    blocking_ms = float(np.median(ts)) * 1e3

    def stream(m):
        outs = []
        t0 = time.perf_counter()
        for _ in range(m):
            imgout, _ = eng.render_bricked(cam, frustum, n_planes=256)
            outs.append(imgout)
        jax.block_until_ready(outs[-1])
        return time.perf_counter() - t0

    stream(2)
    t_lo = min(stream(2) for _ in range(3))
    t_hi = min(stream(12) for _ in range(3))
    pipelined_ms = (t_hi - t_lo) / 10 * 1e3
    log(
        f"engine bricked frame: {pipelined_ms:.2f} ms/frame pipelined, "
        f"{blocking_ms:.2f} ms blocking median"
    )
    return pipelined_ms, blocking_ms


def main():
    from libre import backend
    from libre.ops import transfer_function as tf_ops

    if backend.platform() != "gpu":
        sys.exit("bench.py measures the GPU; JAX found no GPU")
    backend.setup_compile_cache()
    dev = jax.devices()[0]
    log("devices:", jax.devices())

    img, spr = 256, 512
    tf = jnp.asarray(tf_ops.default_color_map(256))

    store_mrays, store_dt, store, dims, params, swp = bench_bricked_store(
        img, 256, spr, tf
    )
    bwd_mrays = bench_store_bwd(img, spr, store, dims, tf)
    engine_ms, engine_blocking_ms = bench_engine_frame(img)
    exact_xla_mrays = bench_exact_xla(img, 64, spr)

    print(
        json.dumps(
            {
                "metric": "bricked_store_fwd_throughput_1chip",
                "value": store_mrays,
                "unit": "Mrays/s",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "extra": {
                    "bricked_store_ms_per_frame": store_dt * 1e3,
                    "store_fwd_bwd_mrays": bwd_mrays,
                    "engine_frame_ms": engine_ms,
                    "engine_blocking_frame_ms": engine_blocking_ms,
                    "exact_xla_fwd_mrays": exact_xla_mrays,
                    "workloads": "store 256^3 -> 256^2 x 512 planes "
                    "(post-TF, early exit); fwd+bwd same shape (no early "
                    "exit); engine mem:// 64^3 end-to-end; exact_xla = "
                    "gather marcher, 64^3 noise -> 256^2 x 512",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
