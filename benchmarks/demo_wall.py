"""Multi-view wall throughput: batched single-dispatch walls vs the
sequential per-view loop (VERDICT r4 missing 5; the r3 criterion asks
per-view rate >= half the single-view rate).

Renders the serve layouts (1x2, 2x2) of a mem:// volume through
RenderEngine.render_wall (ONE jitted dispatch per wall) and compares
against N sequential render_bricked dispatches of the same views.

    python benchmarks/demo_wall.py [--img 256] [--vox 64] [--out WALL_RUN_r05.json]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="WALL_RUN_r05.json")
    args = ap.parse_args()

    import jax

    from libre.core.frustum import Frustum, look_at, perspective
    from libre.data.datasource import DataSource, load_plugins
    from libre.ops.reference import Camera
    from libre.render.engine import RenderEngine

    load_plugins()
    eng = RenderEngine(
        DataSource(f"mem://#{args.vox},{args.vox},{args.vox},32"),
        max_gpu_cache_mb=1024, filter_mode="trilinear",
    )
    W = H = args.img

    def make_view(vw, vh, az_deg):
        rad = np.deg2rad(az_deg)
        c, s = np.cos(rad), np.sin(rad)
        rot = np.array(
            [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
            np.float32,
        )
        mv0 = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
        mv = (mv0.astype(np.float64) @ rot.astype(np.float64)).astype(
            np.float32
        )
        proj = perspective(50.0, vw / vh, 0.1, 15.0)
        fr = Frustum(mv, proj)
        cam = Camera(
            inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(
                np.float32
            ),
            inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
            viewport=(0, 0, vw, vh),
            near=fr.near,
        )
        return cam, fr

    result = {"img": args.img, "vox": args.vox,
              "device": str(jax.devices()[0])}

    # Single full-res view baseline (pipelined marginal).
    cam1, fr1 = make_view(W, H, 15.0)

    def run_single(m):
        outs = []
        t0 = time.perf_counter()
        for _ in range(m):
            out, _ = eng.render_bricked(cam1, fr1, n_planes=256)
            outs.append(out)
        jax.block_until_ready(outs[-1])
        return time.perf_counter() - t0

    run_single(3)
    t_lo = min(run_single(2) for _ in range(3))
    t_hi = min(run_single(2 + args.frames) for _ in range(3))
    single_ms = (t_hi - t_lo) / args.frames * 1e3
    log(f"single view: {single_ms:.2f} ms/frame")
    result["single_view_ms"] = round(single_ms, 3)

    for name, tiles in (
        ("1x2", [(0, 0, W // 2, H, 0.0), (W // 2, 0, W - W // 2, H, 90.0)]),
        ("2x2", [
            (0, 0, W // 2, H // 2, 0.0),
            (W // 2, 0, W - W // 2, H // 2, 90.0),
            (0, H // 2, W // 2, H - H // 2, 180.0),
            (W // 2, H // 2, W - W // 2, H - H // 2, 270.0),
        ]),
    ):
        views = []
        for dx, dy, vw, vh, az in tiles:
            cam, fr = make_view(vw, vh, az)
            views.append((cam, fr, (dx, dy)))

        def run_wall(m):
            outs = []
            t0 = time.perf_counter()
            for _ in range(m):
                canvas, _ = eng.render_wall(views, (H, W), n_planes=256)
                outs.append(canvas)
            jax.block_until_ready(outs[-1])
            return time.perf_counter() - t0

        def run_seq(m):
            outs = []
            t0 = time.perf_counter()
            for _ in range(m):
                for cam, fr, _off in views:
                    out, _ = eng.render_bricked(cam, fr, n_planes=256)
                    outs.append(out)
            jax.block_until_ready(outs[-1])
            return time.perf_counter() - t0

        run_wall(2)
        run_seq(2)
        t_lo = min(run_wall(2) for _ in range(3))
        t_hi = min(run_wall(2 + args.frames) for _ in range(3))
        wall_ms = (t_hi - t_lo) / args.frames * 1e3
        t_lo = min(run_seq(2) for _ in range(3))
        t_hi = min(run_seq(2 + args.frames) for _ in range(3))
        seq_ms = (t_hi - t_lo) / args.frames * 1e3
        n = len(views)
        per_view_ms = wall_ms / n
        # r3 criterion: per-view rate >= half the single-view rate,
        # i.e. per-view time <= 2x the single full-res view's time —
        # conservative here since wall views are QUARTER resolution.
        result[name] = {
            "views": n,
            "wall_ms_per_frame": round(wall_ms, 3),
            "sequential_ms_per_frame": round(seq_ms, 3),
            "per_view_ms": round(per_view_ms, 3),
            "per_view_rate_vs_single": round(single_ms / per_view_ms, 3),
            "speedup_vs_sequential": round(seq_ms / max(wall_ms, 1e-9), 3),
        }
        log(f"{name}: wall {wall_ms:.2f} ms vs sequential {seq_ms:.2f} ms "
            f"({result[name]['speedup_vs_sequential']}x); per-view "
            f"{per_view_ms:.2f} ms vs single {single_ms:.2f} ms")
        # Parity: the wall canvas tile equals the sequential view image.
        canvas, _ = eng.render_wall(views, (H, W), n_planes=256)
        cam0, fr0, (dx0, dy0) = views[0]
        ref0, _ = eng.render_bricked(cam0, fr0, n_planes=256)
        vh0, vw0 = cam0.viewport[3], cam0.viewport[2]
        d = np.abs(
            np.asarray(canvas[dy0:dy0 + vh0, dx0:dx0 + vw0])
            - np.asarray(ref0)
        ).max()
        result[name]["tile_parity_max_abs"] = float(d)
        assert d < 1e-5, f"wall tile mismatch: {d}"

    crit = all(
        result[k]["per_view_rate_vs_single"] >= 0.5 for k in ("1x2", "2x2")
    )
    result["criterion_per_view_rate_ge_half_single"] = bool(crit)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
