"""Inverse-rendering demo on real hardware (BASELINE config 5).

Recovers a density store from multi-view target images through the
plane-march forward + batched recompute backward
(ops/shearwarp_grad.render_store_grid_diff) with the flagship trainer
(train/store_trainer.py):

    python benchmarks/demo_inverse_render.py [--vox 64] [--img 64] \
        [--planes 96] [--steps 50] [--views 4]

Runs on the CPU too (use tiny sizes).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from libre import backend
from libre.ops import shearwarp as sw
from libre.ops import shearwarp_grad as swg
from libre.ops import transfer_function as tf_ops
from libre.ops.shearwarp_bricked import SENTINEL
from libre.train import store_trainer as st

GMIN, GMAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)
AXIS, SIGN = 2, -1.0
EYES = [
    [0.1, 0.05, 1.4], [-0.15, 0.1, 1.3],
    [0.02, -0.12, 1.5], [-0.05, -0.02, 1.2],
]
BOUNDS = (-0.45, 0.45, -0.4, 0.4)


def smooth_volume(n, seed=7):
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--planes", type=int, default=96)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-2)
    args = ap.parse_args()

    backend.setup_compile_cache()
    print("devices:", jax.devices(), file=sys.stderr)
    V = U = args.img
    views = np.stack([
        swg.view_vector(
            world_min=GMIN, world_max=GMAX, axis=AXIS,
            eye=np.float32(e), sign=SIGN, slope_bounds=BOUNDS,
            inter_size=(V, U), max_samples_per_ray=args.planes,
        )
        for e in EYES[: args.views]
    ])
    vol = smooth_volume(args.vox)
    real = np.transpose(vol, sw._PERM[AXIS])
    na, nc, nb = real.shape
    store_gt = jnp.asarray(real)
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    problem = st.StoreProblem(
        views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=args.planes, inter_size=(V, U),
        world_min=GMIN, world_max=GMAX, axis=AXIS,
        diff_tf=True, kc=32,
    )
    targets = st.render_views(problem, store_gt, tf)
    covered = np.asarray(store_gt) > -0.5
    init = np.where(covered, 0.5, SENTINEL).astype(np.float32)
    t0 = time.perf_counter()
    params, losses = st.fit(
        problem, targets, init, tf, mesh=None,
        optimizer=optax.adam(args.lr), steps=args.steps,
    )
    dt = time.perf_counter() - t0
    print(
        f"loss {losses[0]:.5f} -> {losses[-1]:.6f} in {args.steps} steps, "
        f"{dt:.1f}s wall ({dt / args.steps * 1e3:.0f} ms/step incl "
        f"compile+host)"
    )


if __name__ == "__main__":
    main()
