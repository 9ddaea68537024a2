"""End-to-end RenderEngine tests: selection → cache → atlas → multipass
raycast must equal a direct raycast over the same bricks, multipass must be
exact, async mode must converge to the sync image, and the rendering-set
ancestor fallback must degrade gracefully (GLRaycastPipeline.cpp semantics)."""

import numpy as np
import jax.numpy as jnp
import pytest

from libre.core.frustum import Frustum, look_at, perspective
from libre.core.nodeid import NodeId
from libre.data.datasource import DataSource, load_plugins
from libre.ops import raycast
from libre.ops.reference import BrickSet, Camera, RenderParams
from libre.render.engine import RenderEngine, compute_rendering_set

load_plugins()

W = H = 64
URI = "mem://#32,32,32,16?pattern=gradient&datatype=uint8"
PARAMS = RenderParams(
    n_samples_per_ray=64, data_source_range=(0.0, 255.0), filter_mode="trilinear"
)


@pytest.fixture(scope="module")
def view():
    proj = perspective(50.0, W / H, 0.1, 15.0)
    mv = look_at([0.3, 0.2, 1.5], [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    camera = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, W, H),
        near=frustum.near,
    )
    return camera, frustum


@pytest.fixture()
def engine():
    return RenderEngine(DataSource(URI), max_gpu_cache_mb=64)


def _direct_image(engine, camera, frustum, sse):
    """Reference result: raycast all selected bricks straight from the
    datasource, bypassing the cache/atlas/multipass machinery."""
    nodes = engine.select(frustum, H, sse)
    eye = np.asarray(camera.inv_mv)[:3, 3]
    nodes = engine._sort_nodes(nodes, eye)
    ds = engine.datasource
    data = jnp.stack(
        [jnp.asarray(ds.get_data(n), jnp.float32) for n in nodes]
    )
    n = len(nodes)
    bricks = BrickSet(
        data=data,
        world_min=jnp.asarray(
            np.stack([ds.get_node(x).world_box_min for x in nodes]), jnp.float32
        ),
        world_max=jnp.asarray(
            np.stack([ds.get_node(x).world_box_max for x in nodes]), jnp.float32
        ),
        tex_min=jnp.asarray(np.tile(engine._tex_min, (n, 1))),
        tex_max=jnp.asarray(np.tile(engine._tex_max, (n, 1))),
    )
    half = np.asarray(engine.info.world_size, np.float32) * 0.5
    img = raycast.render(
        bricks, engine.transfer_function, camera, PARAMS, -half, half
    )
    return np.asarray(img), len(nodes)


def test_sync_render_matches_direct(engine, view):
    camera, frustum = view
    sse = 1.0  # fine LOD → several bricks
    direct, n_bricks = _direct_image(engine, camera, frustum, sse)
    assert n_bricks > 1, "test scene should select multiple bricks"
    img, stats, _ = engine.render(
        camera, frustum, params=PARAMS, screen_space_error=sse, synchronous=True
    )
    assert stats.rendering_done
    assert stats.n_available == n_bricks
    assert np.asarray(img)[..., 3].max() > 0.1, "image should not be empty"
    np.testing.assert_allclose(np.asarray(img), direct, atol=1e-5, rtol=1e-4)


def test_multipass_exact(view):
    """A starved atlas forces multiple passes; the carried (rgb, a) makes
    them compose exactly like a single pass (GLRaycastPipeline.cpp:148-186)."""
    camera, frustum = view
    big = RenderEngine(DataSource(URI), max_gpu_cache_mb=64)
    # Budget sized so the ATLAS (atlas_fraction = 0.5 of the total, in
    # the dataset's native dtype) holds ~3 bricks of the 8-brick scene.
    starved_mb = 3 * big.atlas.slot_bytes * 2 / 2**20
    starved = RenderEngine(DataSource(URI), max_gpu_cache_mb=starved_mb)
    assert starved.atlas.n_slots < 8
    img1, stats1, _ = big.render(
        camera, frustum, params=PARAMS, screen_space_error=1.0, synchronous=True
    )
    imgN, statsN, _ = starved.render(
        camera, frustum, params=PARAMS, screen_space_error=1.0, synchronous=True
    )
    assert statsN.n_passes > stats1.n_passes >= 1
    np.testing.assert_allclose(np.asarray(imgN), np.asarray(img1), atol=1e-6)


def test_async_progressive_refinement(engine, view):
    camera, frustum = view
    img_sync, _, _ = engine.render(
        camera, frustum, params=PARAMS, screen_space_error=1.0, synchronous=True
    )
    cold = RenderEngine(DataSource(URI), max_gpu_cache_mb=64)
    img, stats, _ = cold.render(
        camera, frustum, params=PARAMS, screen_space_error=1.0, synchronous=False
    )
    assert not stats.rendering_done  # nothing resident yet
    for _ in range(100):
        img, stats, _ = cold.render(
            camera, frustum, params=PARAMS, screen_space_error=1.0, synchronous=False
        )
        if stats.rendering_done:
            break
    assert stats.rendering_done
    np.testing.assert_allclose(np.asarray(img), np.asarray(img_sync), atol=1e-6)


def test_rendering_set_ancestor_fallback(engine, view):
    """Missing bricks substitute their nearest loaded ancestor, deduped
    (RenderingSetGeneratorFilter.ipp:27-134)."""
    camera, frustum = view
    visibles = engine.select(frustum, H, 1.0)
    assert len(visibles) > 1
    root = visibles[0].root()

    # Nothing loaded → empty set, not done.
    chosen, done = compute_rendering_set(visibles, lambda n: False)
    assert chosen == [] and not done

    # Only the root loaded → every visible falls back to it, deduped to one.
    chosen, done = compute_rendering_set(visibles, lambda n: n.id == root.id)
    assert [c.id for c in chosen] == [root.id] and not done

    # Everything loaded → identity.
    chosen, done = compute_rendering_set(visibles, lambda n: True)
    assert [c.id for c in chosen] == [v.id for v in visibles] and done


def test_histogram_accumulates_interior_voxels(engine, view):
    camera, frustum = view
    _, stats, hist = engine.render(
        camera,
        frustum,
        params=PARAMS,
        screen_space_error=1.0,
        synchronous=True,
        collect_histogram=True,
    )
    assert hist is not None
    block = engine.info.maximum_block_size
    overlap = engine.info.overlap
    interior = int(np.prod([b - 2 * o for b, o in zip(block, overlap)]))
    assert hist.sum == stats.n_available * interior


def test_texture_cache_eviction_returns_slots(view):
    camera, frustum = view
    brick_mb = 40 * 40 * 40 * 4 / 2**20
    eng = RenderEngine(
        DataSource(URI), max_gpu_cache_mb=max(1, int(np.ceil(brick_mb * 3)))
    )
    eng.render(camera, frustum, params=PARAMS, screen_space_error=1.0)
    # All slots either free or tracked by the texture cache — none leaked.
    assert eng.atlas.free_slots + len(eng.texture_cache) == eng.atlas.n_slots


def test_bricked_histogram_and_channel_dedupe(engine, view):
    """The fast path emits a histogram from its own rendering set, and
    the HistogramFilter brick-center dedupe counts each brick exactly
    once across sort-first tiles (HistogramFilter.cpp:44-129)."""
    eng = engine
    cam, frustum = view
    img, stats = eng.render_bricked(
        cam, frustum, n_planes=32, collect_histogram=True,
        data_range=(0.0, 255.0),
    )
    assert stats.histogram is not None
    full_nodes = eng.select(
        frustum, H, 4.0, 0, 15, (0.0, 255.0), None, 0
    )
    full = eng.accumulate_histogram(full_nodes)
    assert stats.histogram.sum == full.sum > 0

    # Two sort-first tiles: per-tile asymmetric frusta + relative
    # viewports.  glFrustum-style split of the full projection.
    f = frustum
    n, fa = f.near, f.far
    l, r, b, t = f.left, f.right, f.bottom, f.top
    mid = (l + r) / 2.0

    def make_proj(l_, r_, b_, t_):
        p = np.zeros((4, 4), np.float32)
        p[0, 0] = 2 * n / (r_ - l_)
        p[0, 2] = (r_ + l_) / (r_ - l_)
        p[1, 1] = 2 * n / (t_ - b_)
        p[1, 2] = (t_ + b_) / (t_ - b_)
        p[2, 2] = -(fa + n) / (fa - n)
        p[2, 3] = -2 * fa * n / (fa - n)
        p[3, 2] = -1.0
        return p

    mv = np.linalg.inv(np.asarray(cam.inv_mv, np.float64)).astype(np.float32)
    tiles = [
        (Frustum(mv, make_proj(l, mid, b, t)), (0.0, 0.0, 0.5, 1.0)),
        (Frustum(mv, make_proj(mid, r, b, t)), (0.5, 0.0, 0.5, 1.0)),
    ]
    owners = []
    for node in full_nodes:
        own = [
            i
            for i, (fr, vp) in enumerate(tiles)
            if eng._center_in_viewport(fr, node, vp)
        ]
        assert len(own) == 1, (node, own)
        owners.append(own[0])
    parts = [
        eng.accumulate_histogram(full_nodes, fr, vp) for fr, vp in tiles
    ]
    merged = sum(
        int(p.sum) if p is not None else 0 for p in parts
    )
    assert merged == full.sum


def test_render_samples_per_pixel(engine, view):
    """engine.render honors samples_per_pixel: the jitter-averaged image
    matches the reference's multi-sample loop semantics (distinct from
    spp=1, same everywhere the jitter cannot move a ray off content)."""
    cam, frustum = view
    p2 = RenderParams(
        n_samples_per_ray=64, data_source_range=(0.0, 255.0),
        filter_mode="trilinear", samples_per_pixel=2,
    )
    img1, _, _ = engine.render(
        cam, frustum, params=PARAMS, screen_space_error=2.0
    )
    img2, _, _ = engine.render(
        cam, frustum, params=p2, screen_space_error=2.0
    )
    d = np.abs(np.asarray(img1) - np.asarray(img2))
    # Jitter moves silhouette pixels by up to the half-pixel offset
    # (large local diffs) but the image barely changes on average.
    assert d.max() > 0
    assert d.mean() < 0.01, d.mean()


def test_camera_path_lookahead_prefetch_and_upload(engine, view):
    """prefetch_view warms the host cache and upload_view pushes the
    view's bricks into the atlas ahead of rendering (the async texture
    uploader pattern, GLRenderUploadFilter.cpp:79-107)."""
    cam, frustum = view
    futs = engine.prefetch_view(frustum, cam.viewport[3],
                                screen_space_error=2.0)
    for f in futs:
        f.result()
    visibles = engine.select(frustum, cam.viewport[3], 2.0, 0, 15,
                             (0.0, 1.0), None, 0)
    assert visibles and all(n.id in engine.data_cache for n in visibles)
    n_up = engine.upload_view(frustum, cam.viewport[3],
                              screen_space_error=2.0)
    assert n_up == len(visibles)
    assert all(engine.is_resident(n) for n in visibles)
    # Second call: everything resident -> no work.
    assert engine.upload_view(frustum, cam.viewport[3],
                              screen_space_error=2.0) == 0
