"""Config 3 at scale: convert a large volume to lod://, render a camera
path OUT-OF-CORE (working set > device budget, atlas evictions live),
and record throughput + paging statistics (r3 next-round item 8).

    python benchmarks/demo_out_of_core.py [--vox 1024] [--img 256] \
        [--frames 8] [--out out/ooc_run.json]

Two runs over the same orbit path and rendering sets:
  * in-core   — device budget large enough to hold the assembled store
    (single-dispatch steady state);
  * out-of-core — budget squeezed so every frame renders in
    memory-bounded A-slab multipass with per-slab atlas paging
    (GLRaycastPipeline.cpp:148-186); brick evictions MUST occur.

The JSON it writes carries both throughputs, pass counts, and cache
eviction/hit counters.  The reference's raison d'être is exactly this regime
(README.md:8-24: out-of-core large-volume rendering).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_volume(n):
    """Smooth multi-blob density at n³, built slab-wise to bound RAM."""
    rng = np.random.default_rng(7)
    blobs = [
        (rng.uniform(-0.6, 0.6, 3), rng.uniform(0.1, 0.35), rng.uniform(80, 255))
        for _ in range(8)
    ]
    vol = np.zeros((n, n, n), np.uint8)
    g = np.linspace(-1, 1, n, dtype=np.float32)
    y, x = np.meshgrid(g, g, indexing="ij")
    for iz in range(n):
        z = g[iz]
        acc = np.zeros((n, n), np.float32)
        for c, s, a in blobs:
            acc += a * np.exp(
                -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                / (2 * s * s)
            )
        vol[iz] = np.clip(acc, 0, 255).astype(np.uint8)
    return vol


def orbit_views(img, n_frames, dist=1.45):
    from libre.core.frustum import Frustum, look_at, perspective
    from libre.ops.reference import Camera

    proj = perspective(50.0, 1.0, 0.1, 15.0)
    out = []
    for i in range(n_frames):
        az = np.deg2rad(8.0 * i - 12.0)
        eye = [dist * np.sin(az) + 0.05, 0.1, dist * np.cos(az)]
        mv = look_at(eye, [0, 0, 0], [0, 1, 0])
        cam = Camera(
            inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
            inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
            viewport=(0, 0, img, img),
            near=0.1,
        )
        out.append((cam, Frustum(mv.astype(np.float32), proj)))
    return out


def run_path(engine, views, img, n_planes, warm=1, sse=4.0, min_lod=0):
    import jax

    stats_all = []
    # Two warm laps: compiles (incl. every upload-batch size bucket the
    # paging pattern produces) + first-touch IO for every camera; the
    # measured lap is the steady state of an interactive orbit.
    for _ in range(2):
        for i, (cam, fr) in enumerate(views):
            out, _ = engine.render_bricked(
                cam, fr, n_planes=n_planes, screen_space_error=sse,
                min_lod=min_lod,
            )
            jax.block_until_ready(out)
    # Measured lap: DEPTH-1 pipelined streaming — frame i+1's host work
    # (selection, cache probes, upload dispatch) runs while frame i's
    # kernels execute, then frame i is blocked before dispatching i+2.
    # Depth 1 keeps the overlap (the r4 methodology blocked EVERY frame,
    # serializing upload work onto the critical path — VERDICT r4
    # weak 3) without piling frames onto the in-flight atlas: deeper
    # queues force XLA to copy the donated atlas buffer on every upload
    # batch, which COSTS more than the overlap wins.
    prev = None
    t0 = time.perf_counter()
    for i, (cam, fr) in enumerate(views):
        out, st = engine.render_bricked(
            cam, fr, n_planes=n_planes, screen_space_error=sse,
            min_lod=min_lod,
        )
        stats_all.append(st)
        # engine.upload_view (atlas-level next-view look-ahead) is not
        # used here: whether it wins over PCIe is not measured yet.
        if prev is not None:
            jax.block_until_ready(prev)
        prev = out
    jax.block_until_ready(prev)
    dt = (time.perf_counter() - t0) / len(views)
    return dt, stats_all


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vox", type=int, default=1024)
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--planes", type=int, default=512)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--store", default="out/ooc_volume.lod")
    ap.add_argument("--out", default="out/ooc_run.json")
    ap.add_argument("--incore-mb", type=int, default=1024)
    ap.add_argument("--ooc-mb", type=int, default=96)
    ap.add_argument("--sse", type=float, default=1.0)
    ap.add_argument("--min-lod", type=int, default=0)
    ap.add_argument("--ooc-atlas-fraction", type=float, default=0.1,
                    help="squeeze the BRICK atlas share of the ooc budget "
                    "below the per-path working set so uploads/evictions "
                    "run continuously (config 3's HBM paging regime)")
    args = ap.parse_args()

    import jax

    from libre.data.datasource import DataSource, load_plugins
    from libre.data.lod_store import build_lod_store
    from libre.render.engine import RenderEngine

    load_plugins()

    for path in (args.store, args.out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not os.path.exists(args.store):
        log(f"building {args.vox}^3 volume ...")
        t0 = time.perf_counter()
        vol = make_volume(args.vox)
        log(f"  volume built in {time.perf_counter()-t0:.1f}s; converting ...")
        t0 = time.perf_counter()
        build_lod_store(
            vol, args.store, block_size=args.block, overlap=2
        )
        log(f"  lod store written in {time.perf_counter()-t0:.1f}s "
            f"({os.path.getsize(args.store)/2**20:.0f} MB)")
        del vol

    uri = f"lod://{args.store}"
    rays = args.img * args.img
    views = orbit_views(args.img, args.frames)
    result = {
        "volume_voxels": args.vox,
        "store_bytes": os.path.getsize(args.store),
        "img": args.img,
        "planes": args.planes,
        "frames": args.frames,
        "sse": args.sse,
        "min_lod": args.min_lod,
        "device": str(jax.devices()[0]),
    }

    for name, budget, frac in (
        ("incore", args.incore_mb, 0.5),
        ("out_of_core", args.ooc_mb, args.ooc_atlas_fraction),
    ):
        eng = RenderEngine(
            DataSource(uri), max_gpu_cache_mb=budget,
            max_cpu_cache_mb=2048, atlas_fraction=frac,
        )
        dt, stats = run_path(
            eng, views, args.img, args.planes, sse=args.sse,
            min_lod=args.min_lod,
        )
        tex = eng.texture_cache.statistics
        data = eng.data_cache.statistics
        result[name] = {
            "budget_mb": budget,
            "ms_per_frame": round(dt * 1e3, 1),
            "mrays_per_s": round(rays / dt / 1e6, 3),
            "passes_per_frame": round(
                float(np.mean([s.n_passes for s in stats])), 2
            ),
            "bricks_per_frame": round(
                float(np.mean([s.n_render_available for s in stats])), 1
            ),
            "atlas_evictions": tex.evictions,
            "atlas_hits": tex.hits,
            "atlas_misses": tex.misses,
            "data_cache_evictions": data.evictions,
        }
        log(f"{name}: {json.dumps(result[name])}")

    ooc, inc = result["out_of_core"], result["incore"]
    result["ooc_vs_incore"] = round(
        ooc["mrays_per_s"] / max(inc["mrays_per_s"], 1e-9), 3
    )
    assert ooc["atlas_evictions"] > 0, "out-of-core run must evict"
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
