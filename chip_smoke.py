#!/usr/bin/env python3
"""Proof that the main path runs compiled on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded phases only

Phases (each raises on failure; any failure exits non-zero):

1. device   — JAX's default device is a GPU; prints the card's name and
              power limit as nvidia-smi reports them.
2. served   — apps/serve.RenderService on mem://#1024,1024,1024,64
              ?pattern=gradient (uint8) at the upstream defaults
              (1920×1200, SSE 4.0, 3072 MB device cache), driven over
              HTTP like apps/steering_client.py: camera poses, a TF edit,
              /image-jpeg grabs.  Checks frames are not blank, that an
              A-slab multipass frame equals the one-pass frame (1e-5),
              and that the bricked march matches shearwarp.plane_oracle
              on 4096 sampled slope-grid rays (atol 1e-4).  The volume
              is 1024³, not mem://'s 4096³ default: mem:// data is
              generated on the host, and 64 GiB of it would not be
              ready within the run's time limit.
3. exact    — one render_cli --renderer xla frame at the same size, and
              ops/raycast.py against ops/reference.py at 256³ → 512².
4. training — train/store_trainer.fit on a 256³ store, 4 views at 512²,
              K = 512 (the loss must fall), and the store gradients
              against jax.grad of the oracle at 64³ → 128².
5. choice   — steady-state engine.render_bricked frames with the Triton
              kernel and with the plain-XLA march, median of 20 warm
              frames each, at the smoke size and at 960×600.

``--four-cards`` runs only what exists across cards: the sharded bricked
frame through render_cli --mesh 2x2 against the one-device frame, and
the slab-sharded training step (make_slab_loss_fn) against one device.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_URI = "mem://#1024,1024,1024,64?pattern=gradient"
WIDTH, HEIGHT = 1920, 1200
POSES = ([0.0, 0.0, 1.5], [0.55, 0.35, 1.3], [1.45, 0.25, 0.3])
FWD_ATOL = 1e-4  # f32 gathers summed in another order, FMA contraction
GRAD_RTOL = 1e-3  # of the largest oracle gradient magnitude
N_ORACLE_RAYS = 4096
N_TIMED = 20
EXACT_SIZE = (256, 512)  # raycast vs reference: volume n³ → image n²
TRAIN_SIZE = (256, 512, 512)  # store n³, views at s², K planes
GRAD_SIZE = (64, 128, 128)  # gradient check: store n³, s², K


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out[0]


def median_ms(fn, n=N_TIMED):
    import jax
    import numpy as np

    jax.block_until_ready(fn())  # warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def camera_at(position, width=None, height=None):
    from libre.apps.render_cli import build_camera

    return build_camera(width or WIDTH, height or HEIGHT, list(position),
                        [0.0, 0.0, 0.0])


def engine_params(engine, render_nodes):
    """The RenderParams render_bricked derives for a rendering set."""
    from libre.ops.reference import RenderParams, nyquist_samples_per_ray

    info = engine.info
    spr = nyquist_samples_per_ray(
        info.voxels, info.root_node.depth, max(n.level for n in render_nodes)
    )
    return RenderParams(
        n_samples_per_ray=spr, data_source_range=engine.data_source_range,
        filter_mode="trilinear",
    )


def assert_not_blank(img, what):
    import numpy as np

    img = np.asarray(img)
    if not np.isfinite(img).all():
        raise AssertionError(f"{what}: non-finite pixels")
    if img[..., 3].max() < 0.1 or img[..., :3].std() < 1e-3:
        raise AssertionError(f"{what}: blank frame")


# ------------------------------------------------------------------ phases
def phase_served(card):
    """Served frames over HTTP, multipass, and kernel vs oracle."""
    import jax.numpy as jnp
    import numpy as np

    from libre.apps.serve import RenderService
    from libre.apps.steering_client import _call
    from libre.ops import shearwarp as sw
    from libre.ops import shearwarp_bricked as swb

    t0 = time.perf_counter()
    svc = RenderService(SMOKE_URI, WIDTH, HEIGHT, port=0)
    svc.server.start()
    host, port = svc.server.address
    base = f"http://{host}:{port}"
    engine = svc.engine
    try:
        grabs = []
        for i, pos in enumerate(POSES):
            _call(f"{base}/camera", "PUT",
                  {"position": pos, "lookat": [0.0, 0.0, 0.0]})
            t1 = time.perf_counter()
            jpeg = _call(f"{base}/image-jpeg", "POST", {})
            grabs.append(time.perf_counter() - t1)
            if not (isinstance(jpeg, bytes) and jpeg[:2] == b"\xff\xd8"):
                raise AssertionError(f"pose {i}: /image-jpeg is not a JPEG")
            assert_not_blank(svc.render_frame(), f"served pose {i}")
        log(f"served: first grabs (s, compile + assembly included) "
            f"{[round(g, 3) for g in grabs]}; set-up "
            f"{time.perf_counter() - t0:.1f} s")

        # TF edit over HTTP: the same store re-renders with a new table.
        before = np.asarray(svc.render_frame())
        table = np.asarray(engine.transfer_function)
        edited = np.roll(table, 48, axis=0)
        edited[:, 3] = np.clip(edited[:, 3] * 1.5, 0.0, 1.0)
        _call(f"{base}/colormap", "PUT", {"rgba": edited.tolist()})
        jpeg = _call(f"{base}/image-jpeg", "POST", {})
        after = np.asarray(svc.render_frame())
        assert_not_blank(after, "after TF edit")
        if np.abs(after - before).max() < 1e-3:
            raise AssertionError("TF edit did not change the frame")

        warm = []
        for _ in range(5):
            t1 = time.perf_counter()
            _call(f"{base}/image-jpeg", "POST", {})
            warm.append((time.perf_counter() - t1) * 1e3)
        log(f"served: warm /image-jpeg grab {np.median(warm):.1f} ms median "
            f"of 5 (HTTP + render + JPEG) on {card}")
    finally:
        svc.server.stop()

    # Engine-level checks at the last pose (the served view): the frame
    # as served, the whole store in one pass, and A-slab multipass.
    camera, frustum = camera_at(POSES[-1])
    visibles = engine.select(frustum, HEIGHT, 4.0)
    params = engine_params(engine, visibles)
    img, stats = engine.render_bricked(
        camera, frustum, params=params, screen_space_error=4.0
    )
    assert_not_blank(img, "engine frame")
    level = max(n.level for n in visibles)
    log(f"served: {len(visibles)} bricks at level {level}, "
        f"{params.n_samples_per_ray} planes, {stats.n_passes} pass(es) at "
        f"the served budget")
    whole, wstats = engine.render_bricked(
        camera, frustum, params=params, screen_space_error=4.0,
        max_store_mb=1 << 20,
    )
    if wstats.n_passes != 1:
        raise AssertionError("the whole store did not render in one pass")
    # The frame just rendered is the store cache's newest entry.
    store_entry = engine._store_cache.get(list(engine._store_cache)[-1])
    store = store_entry[0]
    budget_mb = int(store.nbytes) / 2**20 / 3
    paged, pstats = engine.render_bricked(
        camera, frustum, params=params, screen_space_error=4.0,
        max_store_mb=budget_mb,
    )
    diff = float(jnp.abs(paged - whole).max())
    log(f"multipass: {pstats.n_passes} A-slab passes at max_store_mb="
        f"{budget_mb:.4g}, max |multipass - one pass| = {diff:.3g}")
    if pstats.n_passes < 2 or diff > 1e-5:
        raise AssertionError("A-slab multipass differs from one pass")

    # Kernel (the default march on the card) vs the gather oracle on the
    # same assembled store and the same slope-grid rays.
    store, _content, plan = store_entry
    swp = sw.ShearWarpParams(
        n_planes=params.n_samples_per_ray, inter_size=(HEIGHT, WIDTH),
        classification="post",
    )
    half = np.asarray(engine.info.world_size, np.float32) * 0.5
    sw_plan = sw.make_view_plan(camera, swp.slope_margin)
    runner = swb.StoreFrameRunner(
        store, plan, params=params, swp=swp, world_min=-half,
        world_max=half,
    )
    inter = np.asarray(runner(store, engine.transfer_function, camera, sw_plan))
    check_oracle(inter, store, plan, engine.transfer_function, sw_plan,
                 params, swp, half, "bricked kernel")
    return engine, camera, frustum, params


def check_oracle(inter, store, plan, tf, sw_plan, params, swp, half, what):
    """``inter`` (V, U, 4) against plane_oracle(post) on sampled rays."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from libre.ops import shearwarp as sw

    v_size, u_size = swp.inter_size
    u0, u1, v0, v1 = sw_plan.bounds
    rng = np.random.default_rng(0)
    pick = rng.choice(v_size * u_size, N_ORACLE_RAYS, replace=False)
    rows, cols = pick // u_size, pick % u_size
    u = np.float32(u0) + np.float32((u1 - u0) / (u_size - 1)) * cols.astype(np.float32)
    v = np.float32(v0) + np.float32((v1 - v0) / (v_size - 1)) * rows.astype(np.float32)
    dense = jnp.transpose(store, np.argsort(sw._PERM[plan.axis]))
    oparams = dataclasses.replace(params, data_source_range=(0.0, 1.0))
    with jax.default_matmul_precision("highest"):
        want = sw.plane_oracle(
            dense, tf, sw_plan.eye, plan.axis, sw_plan.sign,
            (jnp.asarray(u), jnp.asarray(v)), -half, half, oparams,
            swp.n_planes, classification="post", sentinel_mask=True,
        )
    want = np.asarray(want)
    got = inter[rows, cols]
    err = float(np.abs(got - want).max())
    log(f"oracle: {what} vs plane_oracle on {N_ORACLE_RAYS} rays: max "
        f"|diff| {err:.3g} (atol {FWD_ATOL}), mean alpha "
        f"{want[:, 3].mean():.3f}")
    if err > FWD_ATOL:
        raise AssertionError(f"{what} differs from the oracle by {err}")


def phase_exact(card):
    """The exact gather marcher: one CLI frame, then raycast vs reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libre.apps import render_cli
    from libre.ops import raycast, transfer_function as tf_ops
    from libre.ops.reference import (
        RenderParams, render_reference, single_brick_set,
    )
    from libre.utils.image import read_image

    with tempfile.TemporaryDirectory(dir=HERE) as out:
        t0 = time.perf_counter()
        rc = render_cli.main([
            "--volume", SMOKE_URI, "--width", str(WIDTH),
            "--height", str(HEIGHT), "--renderer", "xla",
            "--output-dir", out,
        ])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"render_cli --renderer xla exited {rc}")
        frame = read_image(os.path.join(out, "frame_000000.png"))
        if frame[..., 3].max() < 25 or frame[..., :3].std() < 0.5:
            raise AssertionError("render_cli --renderer xla: blank frame")
    log(f"exact: render_cli --renderer xla {WIDTH}x{HEIGHT} frame in "
        f"{dt:.1f} s (compile and set-up included) on {card}")

    from libre.core.frustum import look_at, perspective
    from libre.ops.reference import Camera

    n, img = EXACT_SIZE
    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    vol = 0.5 + 0.5 * np.sin(3.0 * x + 2.0 * y * y - 1.5 * z)
    vol *= np.exp(-(x * x + y * y + z * z))
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.3, 0.2, 1.6], [0, 0, 0], [0, 1, 0])
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img), near=0.1,
    )
    params = RenderParams(
        n_samples_per_ray=n, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    bricks = single_brick_set(vol.astype(np.float32))
    tf = jnp.asarray(tf_ops.default_color_map(256))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(render_reference(bricks, tf, cam, params, gmin, gmax))
        fast = np.asarray(raycast.render(bricks, tf, cam, params, gmin, gmax))
    # A ray that saturates stops at the early-exit threshold; one more or
    # one fewer sample there (an ulp decides) moves it by at most the
    # transmittance left, 1 - early_exit.  Other rays meet FWD_ATOL.
    diff = np.abs(fast - ref).max(-1)
    sat = np.maximum(fast[..., 3], ref[..., 3]) >= params.early_exit - 1e-5
    err = float(diff[~sat].max())
    err_sat = float(diff[sat].max()) if sat.any() else 0.0
    sat_tol = 1.0 - params.early_exit
    log(f"exact: ops/raycast vs ops/reference at {n}^3 -> {img}^2: max "
        f"|diff| {err:.3g} (atol {FWD_ATOL}) on {int((~sat).sum())} rays, "
        f"{err_sat:.3g} (atol {sat_tol:.3g}) on {int(sat.sum())} saturated "
        f"rays; mean alpha {ref[..., 3].mean():.3f}")
    assert_not_blank(ref.reshape(img, img, 4), "reference frame")
    if err > FWD_ATOL or err_sat > sat_tol:
        raise AssertionError(f"raycast differs from reference by {err}, "
                             f"{err_sat} on saturated rays")


def smooth_store(n, axis=2, seed=5):
    import numpy as np

    from libre.ops import shearwarp as sw

    rng = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(6):
        c = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        s = rng.uniform(0.15, 0.4)
        vol += rng.uniform(0.4, 1.0) * np.exp(
            -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s)
        )
    # Densities stay inside (0, 1): at exactly 0 or 1 the clamp before
    # the TF lookup has a kink, where autodiff and the custom backward
    # may pick different one-sided derivatives.
    vol = 0.02 + 0.96 * vol / vol.max()
    return vol, np.ascontiguousarray(np.transpose(vol, sw._PERM[axis]))


def store_views(eyes, size, k_planes):
    import numpy as np

    from libre.ops import shearwarp_grad as swg

    return np.stack([
        swg.view_vector(
            world_min=np.float32([-0.5] * 3), world_max=np.float32([0.5] * 3),
            axis=2, eye=np.float32(e), sign=-1.0,
            slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(size, size),
            max_samples_per_ray=k_planes,
        )
        for e in eyes
    ])


TRAIN_EYES = ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3], [0.02, -0.12, 1.5],
              [-0.05, -0.02, 1.2])


def store_problem(n, size, k_planes, n_views, **kw):
    import numpy as np

    from libre.train import store_trainer as st

    return st.StoreProblem(
        views=store_views(TRAIN_EYES[:n_views], size, k_planes),
        na_store=n, na_real=n, nc_real=n, nb_real=n,
        k_planes=k_planes, inter_size=(size, size),
        world_min=np.float32([-0.5] * 3), world_max=np.float32([0.5] * 3),
        axis=2, **kw,
    )


def phase_training(card):
    """store_trainer.fit steps, and gradients vs jax.grad of the oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from libre.ops import shearwarp as sw
    from libre.ops import shearwarp_grad as swg
    from libre.ops import transfer_function as tf_ops
    from libre.ops.reference import RenderParams
    from libre.train import store_trainer as st

    n, size, k = TRAIN_SIZE
    _vol, real = smooth_store(n)
    problem = store_problem(n, size, k, 4, diff_tf=True, kc=32)
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    store_gt = jnp.asarray(real)
    targets = st.render_views(problem, store_gt, tf)
    init = jnp.full_like(store_gt, 0.5)
    t0 = time.perf_counter()
    _params, losses = st.fit(
        problem, targets, init, tf, optimizer=optax.adam(3e-2), steps=6,
    )
    fit_s = time.perf_counter() - t0
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"store training loss did not fall: {losses}")
    step = st.make_train_step(problem, optax.adam(3e-2))
    params = {"store": init, "tf": tf}
    opt_state = optax.adam(3e-2).init(params)
    state = [params, opt_state]

    def one():
        state[0], state[1], loss = step(state[0], state[1], targets)
        return loss

    step_ms = median_ms(one, n=5)
    log(f"training: fit {n}^3 store, 4 views at {size}^2, K={k}: loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} in 6 steps ({fit_s:.1f} s "
        f"incl. compile); warm step {step_ms:.1f} ms median of 5 on {card}")

    # Gradients vs jax.grad of the oracle (64^3 -> 128^2).
    n, size, k = GRAD_SIZE
    vol, real = smooth_store(n, seed=3)
    static = swg.static_view(
        na_store=n, na_real=n, nc_real=n, nb_real=n, k_planes=k,
        v_size=size, u_size=size, world_min=np.float32([-0.5] * 3),
        world_max=np.float32([0.5] * 3), axis=2, early_exit=0.999, kc=16,
    )
    vs = jnp.asarray(store_views(TRAIN_EYES[:1], size, k)[0])
    g_img = jnp.asarray(
        np.random.default_rng(0).standard_normal((size, size, 4)), jnp.float32
    )
    d_store, d_tf = jax.grad(
        lambda s, t: jnp.sum(swg.render_store_grid_diff(s, t, vs, static) * g_img),
        argnums=(0, 1),
    )(jnp.asarray(real), tf)
    u0, u1, v0, v1 = -0.45, 0.45, -0.4, 0.4
    uu, vv = np.meshgrid(np.linspace(u0, u1, size, dtype=np.float32),
                         np.linspace(v0, v1, size, dtype=np.float32),
                         indexing="xy")
    oparams = RenderParams(
        n_samples_per_ray=k, max_samples_per_ray=k,  # as store_views
        data_source_range=(0.0, 1.0), filter_mode="trilinear",
    )

    def oracle_loss(volume, table):
        img = sw.plane_oracle(
            volume, table, np.float32(TRAIN_EYES[0]), 2, -1.0,
            (jnp.asarray(uu.reshape(-1)), jnp.asarray(vv.reshape(-1))),
            np.float32([-0.5] * 3), np.float32([0.5] * 3), oparams, k,
            classification="post",
        ).reshape(size, size, 4)
        return jnp.sum(img * g_img)

    with jax.default_matmul_precision("highest"):
        d_vol, d_tf_o = jax.grad(oracle_loss, argnums=(0, 1))(
            jnp.asarray(vol), tf
        )
    d_vol_p = np.transpose(np.asarray(d_vol), sw._PERM[2])
    for name, got, want in (("store", np.asarray(d_store), d_vol_p),
                            ("tf", np.asarray(d_tf), np.asarray(d_tf_o))):
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"training: d_{name} vs jax.grad of the oracle at {n}^3 -> "
            f"{size}^2: max |diff| / max |grad| = {rel:.3g} (rtol {GRAD_RTOL})")
        if not rel <= GRAD_RTOL:
            raise AssertionError(f"d_{name} differs from the oracle by {rel}")


def phase_choice(card, engine):
    """Steady-state frames, Triton kernel vs plain-XLA march."""
    from libre.ops import shearwarp_bricked as swb

    results = {}
    for width, height in ((WIDTH, HEIGHT), (WIDTH // 2, HEIGHT // 2)):
        camera, frustum = camera_at(POSES[0], width, height)
        visibles = engine.select(frustum, height, 4.0)
        params = engine_params(engine, visibles)
        for name in ("kernel", "xla", "kernel", "xla"):
            march = swb.march_kernel if name == "kernel" else swb.march_xla
            swb.default_march = lambda march=march: march
            engine._frame_runners.clear()
            ms = median_ms(lambda: engine.render_bricked(
                camera, frustum, params=params, screen_space_error=4.0,
            )[0])
            results.setdefault((width, height, name), []).append(ms)
        k = min(results[(width, height, "kernel")])
        x = min(results[(width, height, "xla")])
        log(f"choice: {width}x{height}, {params.n_samples_per_ray} planes, "
            f"engine.render_bricked warm median of {N_TIMED}: kernel "
            f"{results[(width, height, 'kernel')]} ms, xla "
            f"{results[(width, height, 'xla')]} ms -> "
            f"{'kernel' if k < x else 'xla'} wins ({x / k:.2f}x) on {card}")
    swb.default_march = _DEFAULT_MARCH


def phase_four_cards(card):
    """Sharded bricked frame and slab-sharded training vs one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libre.apps import render_cli
    from libre.ops import transfer_function as tf_ops
    from libre.parallel.mesh import make_mesh
    from libre.train import store_trainer as st
    from libre.utils.image import read_image

    if len(jax.devices()) != 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {jax.devices()}")
    frames = {}
    for mesh in ("", "2x2"):
        with tempfile.TemporaryDirectory(dir=HERE) as out:
            argv = ["--volume", SMOKE_URI, "--width", str(WIDTH),
                    "--height", str(HEIGHT), "--output-dir", out]
            if mesh:
                argv += ["--mesh", mesh]
            t0 = time.perf_counter()
            if render_cli.main(argv) != 0:
                raise AssertionError(f"render_cli --mesh {mesh!r} failed")
            dt = time.perf_counter() - t0
            frames[mesh] = read_image(os.path.join(out, "frame_000000.png"))
        log(f"four-cards: render_cli mesh={mesh or 'none'} frame in {dt:.1f} s"
            " (compile and set-up included)")
    diff = np.abs(frames["2x2"].astype(int) - frames[""].astype(int))
    log(f"four-cards: 2x2 sharded frame vs one card: max |diff| {diff.max()}"
        f"/255, mean {diff.mean():.4f}/255 on {card}")
    if frames["2x2"][..., 3].max() < 25:
        raise AssertionError("sharded frame is blank")
    if diff.max() > 2:
        raise AssertionError("sharded frame differs from the one-card frame")

    n, size, k = TRAIN_SIZE
    _vol, real = smooth_store(n)
    problem = store_problem(n, size, k, 1, diff_tf=True, kc=32)
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    store = jnp.asarray(real)
    targets = st.render_views(problem, store, tf) * 0.9
    mesh = make_mesh(n_brick=4, n_ray=1)
    slab_loss = st.make_slab_loss_fn(problem, mesh)
    one_loss = st.make_loss_fn(problem, None)
    grad_sh = jax.jit(jax.value_and_grad(slab_loss, argnums=(0, 1)))
    grad_one = jax.jit(jax.value_and_grad(one_loss, argnums=(0, 1)))
    store_sh = st.shard_store_slabs_uniform(store, 4)
    (l4, (g4, t4)) = grad_sh(store_sh, tf, targets)
    (l1, (g1, t1)) = grad_one(store, tf, targets)
    g4 = np.asarray(g4).reshape(np.asarray(g1).shape)
    rel_s = float(np.abs(g4 - np.asarray(g1)).max() / np.abs(np.asarray(g1)).max())
    rel_t = float(np.abs(np.asarray(t4) - np.asarray(t1)).max()
                  / np.abs(np.asarray(t1)).max())
    ms4 = median_ms(lambda: grad_sh(store_sh, tf, targets), n=5)
    ms1 = median_ms(lambda: grad_one(store, tf, targets), n=5)
    log(f"four-cards: slab-sharded step {n}^3, {size}^2, K={k}: loss "
        f"{float(l4):.6f} vs {float(l1):.6f}; d_store rel {rel_s:.3g}, d_tf "
        f"rel {rel_t:.3g}; fwd+bwd {ms4:.1f} ms on 4 cards vs {ms1:.1f} ms "
        f"on one, on {card}")
    if rel_s > GRAD_RTOL or rel_t > GRAD_RTOL:
        raise AssertionError("slab-sharded gradients differ from one card")


_DEFAULT_MARCH = None


def main(argv=None) -> int:
    global _DEFAULT_MARCH
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phases, on four GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        from libre import backend
    except ImportError as exc:
        print(f"chip_smoke.py: the libre package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    try:
        platform = backend.platform()
    except ValueError as exc:
        print(f"chip_smoke.py: {exc}", file=sys.stderr)
        return 1
    if platform != "gpu":
        print(f"chip_smoke.py: JAX found no GPU (platform {platform!r})",
              file=sys.stderr)
        return 1
    log(f"compile cache: {backend.setup_compile_cache()}")

    import jax

    from libre.ops import shearwarp_bricked as swb

    _DEFAULT_MARCH = swb.default_march
    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()
    if args.four_cards:
        phases = [lambda: phase_four_cards(card)]
    else:
        state = {}
        phases = [
            lambda: state.setdefault("engine", phase_served(card)[0]),
            lambda: phase_exact(card),
            lambda: phase_training(card),
            lambda: phase_choice(card, state["engine"]),
        ]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"phase done in {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - t_start:.1f} s)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
