"""`livre` CLI equivalent: render frames of a volume URI to image files.

Reference: apps/livre/livre.cpp:56-96 (argument parsing + client frame
loop), with the animation/frame-range semantics of Config::frame
(livre/eq/Config.cpp:329-372) driven by FrameUtils.

    python -m libre.apps.render_cli --volume mem://#64,64,64,16 \\
        --frames 0 4 --sse 1 --camera-position 0 0 1.5 -o out --width 512

Exits with the frames-per-second summary the reference logs at client
exit (Client.cpp:239-243).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np


def build_camera(width, height, position, look_at_point, near=0.1, far=15.0):
    from libre.core.frustum import Frustum, look_at, perspective
    from libre.core.settings import CameraSettings
    from libre.ops.reference import Camera

    cam_settings = CameraSettings()
    cam_settings.set_camera_position(position)
    cam_settings.set_camera_look_at(look_at_point)
    mv = cam_settings.get_modelview_matrix()
    proj = perspective(50.0, width / height, near, far)
    frustum = Frustum(mv, proj)
    camera = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, width, height),
        near=frustum.near,
    )
    return camera, frustum


def main(argv: Optional[List[str]] = None) -> int:
    from libre.core.config import ApplicationParameters, RendererParameters
    from libre.core.frame_utils import FrameUtils
    from libre.core.frustum import Frustum
    from libre.data.datasource import DataSource, load_plugins
    from libre.ops.reference import RenderParams, nyquist_samples_per_ray
    from libre.ops.transfer_function import load_1dt
    from libre.render.engine import RenderEngine
    from libre.utils.image import write_image

    argv = list(sys.argv[1:] if argv is None else argv)
    extra = [
        ("width", "Image width", 512),
        ("height", "Image height", 512),
        ("output-dir", "Output directory for frames", "."),
        ("format", "Image format [png|jpg]", "png"),
        ("mesh", "Device mesh RxB (ray x brick axes, e.g. 4x2) or "
         "'auto' for all devices; routes bricked frames through the "
         "sharded renderer", ""),
    ]
    app = ApplicationParameters()
    vr = RendererParameters()
    for name, desc, default in extra:
        app.configuration.add_option(name, desc, default, group="Output")
    rest = app.initialize(argv)
    rest = vr.initialize(rest)
    if rest and ("--help" in rest or "-h" in rest):
        print(app.configuration.help_text())
        print(vr.configuration.help_text())
        return 0
    if rest:
        print(f"unknown arguments: {rest}", file=sys.stderr)
        return 2
    if not app.data_file_name:
        print("--volume URI is required (e.g. mem://#64,64,64,16)", file=sys.stderr)
        return 2

    width = app.configuration.get("width")
    height = app.configuration.get("height")
    out_dir = app.configuration.get("output-dir")
    fmt = app.configuration.get("format")
    os.makedirs(out_dir, exist_ok=True)

    from libre import backend

    backend.setup_compile_cache()
    load_plugins()

    # Device mesh (the reference's app IS the distributed deployment —
    # livre.cpp:56-96 launches render nodes through the eq server; here
    # --mesh RxB shards frames over the jax device mesh, auto = all
    # devices on the ray axis).
    mesh = None
    mesh_arg = str(app.configuration.get("mesh") or "")
    if mesh_arg:
        import jax

        from libre.parallel import make_mesh

        if mesh_arg == "auto":
            n = len(jax.devices())
            n_brick = 2 if n % 2 == 0 and n > 1 else 1
            mesh = make_mesh(n_brick=n_brick, n_ray=n // n_brick)
        else:
            r, b = (int(x) for x in mesh_arg.lower().split("x"))
            mesh = make_mesh(n_brick=b, n_ray=r)
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    engine = RenderEngine(
        DataSource(app.data_file_name),
        max_gpu_cache_mb=vr.max_gpu_cache_memory_mb,
        max_cpu_cache_mb=vr.max_cpu_cache_memory_mb,
        filter_mode="trilinear",
        mesh=mesh,
    )
    info = engine.info

    camera, frustum = build_camera(
        width, height, app.camera_position, app.camera_look_at
    )

    # Multi-host launches: every process parses the same CLI, but the
    # camera/frame state is committed by the controller and synced to
    # all hosts — the FrameData commit/sync cycle (FrameData.h:32-147).
    import jax as _jax

    if _jax.process_count() > 1:
        from libre.parallel.distributed import broadcast_frame_state

        camera, frustum = broadcast_frame_state((camera, frustum))

    if app.color_map_file:
        import jax.numpy as jnp

        engine.transfer_function = jnp.asarray(load_1dt(app.color_map_file))

    params = None
    if vr.samples_per_ray > 0:
        params = RenderParams(
            n_samples_per_ray=vr.samples_per_ray,
            samples_per_pixel=vr.samples_per_pixel,
            data_source_range=engine.data_source_range,
            filter_mode="trilinear",
        )

    fu = FrameUtils(app.frames, tuple(info.frame_range))
    frame = fu.get_current(app.frames[0])
    delta = app.animation if app.animation else 1
    n_frames = min(
        app.max_frames,
        (fu.frame_range[1] - fu.frame_range[0]) if fu.is_valid else 1,
    )
    if not app.animation:
        n_frames = min(n_frames, 1)

    t0 = time.perf_counter()
    rendered = 0
    from libre.render.registry import create_renderer

    renderer = create_renderer(app.renderer)
    for i in range(n_frames):
        ts = int(frame) if fu.is_valid else 0
        if app.renderer == "shearwarp":
            # Shear-warp over a dense LOD level (ops/shearwarp.py).
            level = min(vr.max_lod, info.root_node.depth - 1)
            img = renderer.render(
                engine,
                camera,
                frustum,
                params=params,
                level=level,
                time_step=ts,
                n_planes=vr.samples_per_ray or None,
            )
            detail = f"shearwarp level {level}"
        else:
            img = renderer.render(
                engine,
                camera,
                frustum,
                params=params,
                screen_space_error=vr.screen_space_error,
                min_lod=vr.min_lod,
                max_lod=vr.max_lod,
                time_step=ts,
                synchronous=True,
            )
            detail = f"{app.renderer} renderer"
        path = os.path.join(out_dir, f"frame_{frame:06d}.{fmt}")
        write_image(path, np.asarray(img))
        rendered += 1
        print(f"frame {frame}: {detail} -> {path}")
        if fu.is_valid:
            frame = fu.get_next(frame, delta)

    dt = time.perf_counter() - t0
    # FPS summary at exit (Client.cpp:239-243).
    print(f"{rendered} frames in {dt:.2f} s = {rendered / dt:.2f} FPS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
