"""Multi-device bricked fast path (parallel/bricked_sharded.py).

The round-2 fused post-classification sweep gets both reference
decompositions (SURVEY.md §2.12) on the 8-device CPU mesh:

  * sort-first — slope-grid rows sharded over the ray axis
    (livre/eq/Channel.cpp:444-533 2D/viewport path);
  * sort-last/DB — the GLOBAL plane grid split into contiguous
    front-to-back ranges over the brick axis, per-device segments folded
    with the over operator in rank order (eq::Compositor::blendFrames +
    orderFrames, Channel.cpp:444-533,535-586), with each device holding
    only the store SLICES its planes bracket (slab mode — the memory
    scaling of the channel Range split, SelectVisibles.cpp:120-142).

Parity oracle: the identical single-device kernel.  With early exit
disabled the decompositions are exact (the global plane grid is the
generalized step-grid alignment of fragRaycast.glsl:152-158); with the
default threshold the deviation is bounded by (1 − threshold).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libre.ops import shearwarp as sw
from libre.ops import shearwarp_bricked as swb
from libre.ops import shearwarp_grad as swg
from libre.ops import transfer_function as tf_ops
from libre.ops.reference import RenderParams
from libre.parallel.bricked_sharded import (
    build_sharded_slabs,
    render_store_grid_sharded,
    slab_ranges,
)
from libre.parallel.mesh import make_mesh
from tests.test_bricked import fine_nodes, make_scene, upload_nodes
from tests.test_reference_marcher import make_volume

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)
AXIS, SIGN = 2, -1.0
EYE = np.float32([0.1, 0.05, 1.4])
BOUNDS = (-0.45, 0.45, -0.4, 0.4)
V_SIZE, U_SIZE = 16, 12
K, N = 40, 24
B_AXIS, C_AXIS = sw._BC_AXES[AXIS]
NO_EXIT = 1.1  # disable early termination → exact decomposition parity


def dense_store(seed=3):
    vol = make_volume(N, seed=seed).astype(np.float32)
    real = np.transpose(vol, sw._PERM[AXIS])
    na, nc, nb = real.shape
    store = np.ascontiguousarray(real, np.float32)
    return jnp.asarray(store), na, nc, nb


def view_vec():
    return swg.view_vector(
        world_min=GMIN, world_max=GMAX, axis=AXIS, eye=EYE, sign=SIGN,
        slope_bounds=BOUNDS, inter_size=(V_SIZE, U_SIZE),
        max_samples_per_ray=K,
    )


def single_device(store, tf, na, nc, nb, early_exit=NO_EXIT):
    static = swg.static_view(
        na_store=store.shape[0], na_real=na, nc_real=nc, nb_real=nb,
        k_planes=K, v_size=V_SIZE, u_size=U_SIZE,
        world_min=GMIN, world_max=GMAX, axis=AXIS,
        early_exit=early_exit,
    )
    out, _t = swg._forward(store, tf, jnp.asarray(view_vec()), static)
    return np.asarray(out)


def sharded(mesh, store, tf, na, nc, nb, early_exit=NO_EXIT, **kw):
    return np.asarray(
        render_store_grid_sharded(
            mesh, store, tf, jnp.asarray(view_vec()),
            na_real=na, nc_real=nc, nb_real=nb, k_planes=K,
            inter_size=(V_SIZE, U_SIZE),
            wb0=float(GMIN[B_AXIS]), wb1=float(GMAX[B_AXIS]),
            wc0=float(GMIN[C_AXIS]), wc1=float(GMAX[C_AXIS]),
            early_exit=early_exit, **kw,
        )
    )


@pytest.fixture(scope="module")
def setup():
    store, na, nc, nb = dense_store()
    tf = jnp.asarray(np.asarray(tf_ops.default_color_map(256)))
    ref = single_device(store, tf, na, nc, nb)
    return store, tf, na, nc, nb, ref


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (1, 8), (2, 4)])
def test_sharded_parity_mesh_shapes(setup, shape):
    """Every (brick × ray) factorization of 8 devices reproduces the
    single-device kernel exactly when early exit is off."""
    store, tf, na, nc, nb, ref = setup
    n_brick, n_ray = shape
    mesh = make_mesh(n_brick=n_brick, n_ray=n_ray)
    img = sharded(mesh, store, tf, na, nc, nb)
    np.testing.assert_allclose(img, ref, atol=2e-5)


def test_sharded_slab_mode_parity(setup):
    """Slab mode: each brick-axis device holds ONLY the store slices its
    plane range brackets; the folded image is unchanged."""
    store, tf, na, nc, nb, ref = setup
    d_k = 4
    mesh = make_mesh(n_brick=d_k, n_ray=2)
    lo, hi, slab_na = slab_ranges(view_vec(), na, K, d_k)
    # Each slab strictly smaller than the store (the memory win is real).
    assert slab_na < na
    slabs = np.full(
        (d_k, slab_na, store.shape[1], store.shape[2]), swb.SENTINEL,
        np.float32,
    )
    for d in range(d_k):
        cnt = hi[d] - lo[d] + 1
        slabs[d, :cnt] = np.asarray(store)[lo[d] : hi[d] + 1]
    img = sharded(
        mesh, jnp.asarray(slabs), tf, na, nc, nb,
        a_base=jnp.asarray(lo, jnp.int32),
    )
    np.testing.assert_allclose(img, ref, atol=2e-5)


def test_sharded_early_exit_bounded(setup):
    """With the default 0.999 threshold, early termination is local to a
    device's segment (the reference's per-channel DB semantics); the
    deviation is bounded by the threshold's transmittance."""
    store, tf, na, nc, nb, _ = setup
    ref = single_device(store, tf, na, nc, nb, early_exit=0.999)
    mesh = make_mesh(n_brick=4, n_ray=2)
    img = sharded(mesh, store, tf, na, nc, nb, early_exit=0.999)
    assert np.abs(img - ref).max() < 2e-3


def test_sharded_from_atlas_end_to_end(tmp_path):
    """Full path: lod:// datasource → device atlas → per-device assembled
    slabs (build_sharded_slabs) → sharded sweep, vs the single-device
    bricked renderer over the same atlas."""
    vol, ds = make_scene(tmp_path, n=32, block=16)
    nodes, _ = fine_nodes(ds)
    atlas, slot_of = upload_nodes(ds, nodes)
    plan = swb.build_assembly_plan(ds, nodes, AXIS, slot_of, (0.0, 1.0))
    tf = jnp.asarray(tf_ops.default_color_map(256))
    na, nc, nb = plan.fine_dims
    k_planes = 48
    params = RenderParams(
        n_samples_per_ray=k_planes, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", early_exit=NO_EXIT,
    )
    swp = sw.ShearWarpParams(
        n_planes=k_planes, inter_size=(V_SIZE, U_SIZE),
        classification="post",
    )
    ref = np.asarray(
        swb.render_bricked_slope_grid(
            atlas.data, plan, tf,
            eye=EYE, sign=SIGN, slope_bounds=BOUNDS,
            world_min=GMIN, world_max=GMAX, params=params, swp=swp,
        )
    )
    fv = swg.view_vector(
        world_min=GMIN, world_max=GMAX, axis=AXIS, eye=EYE, sign=SIGN,
        slope_bounds=BOUNDS, inter_size=(V_SIZE, U_SIZE),
        max_samples_per_ray=params.max_samples_per_ray,
    )
    d_k = 4
    mesh = make_mesh(n_brick=d_k, n_ray=2)
    slabs, a_base = build_sharded_slabs(atlas.data, plan, fv, k_planes, d_k)
    assert slabs.shape[1] < na  # per-device HBM is a strict subset
    img = np.asarray(
        render_store_grid_sharded(
            mesh, slabs, tf, jnp.asarray(fv),
            na_real=na, nc_real=nc, nb_real=nb, k_planes=k_planes,
            inter_size=(V_SIZE, U_SIZE),
            wb0=float(GMIN[B_AXIS]), wb1=float(GMAX[B_AXIS]),
            wc0=float(GMIN[C_AXIS]), wc1=float(GMAX[C_AXIS]),
            early_exit=NO_EXIT, a_base=a_base,
        )
    )
    np.testing.assert_allclose(img, ref, atol=2e-5)


def test_engine_render_bricked_sharded_parity(tmp_path):
    """Engine-level multi-device frame (BASELINE config 4): the mesh
    render over per-device slabs equals the single-device bricked frame
    up to device-local early termination (< 1 - threshold)."""
    from libre.core.frustum import Frustum, look_at, perspective
    from libre.ops.reference import Camera
    from libre.render.engine import RenderEngine

    _vol, ds = make_scene(tmp_path)
    engine = RenderEngine(ds, max_gpu_cache_mb=64, filter_mode="trilinear")
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, 48, 48),
        near=frustum.near,
    )
    params = RenderParams(
        n_samples_per_ray=48, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    single, s1 = engine.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48
    )
    mesh = make_mesh(n_brick=2, n_ray=4)
    multi, s2 = engine.render_bricked_sharded(
        cam, frustum, mesh, params=params, screen_space_error=1.0,
        n_planes=48,
    )
    assert s2.n_passes == 2
    assert multi.shape == single.shape
    assert np.abs(np.asarray(multi) - np.asarray(single)).max() < 2e-3
    # Steady state: the sharded path shares the single-device
    # assembled-store cache (replicated mode) — one entry, no
    # reassembly on the next frame from either path.
    assert len(engine._store_cache) == 1
    again, _ = engine.render_bricked_sharded(
        cam, frustum, mesh, params=params, screen_space_error=1.0,
        n_planes=48,
    )
    assert len(engine._store_cache) == 1
    np.testing.assert_array_equal(np.asarray(again), np.asarray(multi))


def test_engine_sharded_progressive_refinement(tmp_path):
    """Async sharded frames refine: first frame renders the resident
    rendering set (ancestor fallback) with rendering_done=False, and
    once the kicked uploads land the re-render equals the synchronous
    sharded image (r3 missing 3: progressive refinement on the sharded
    path)."""
    from tests.test_bricked import _engine_scene
    from libre.parallel.mesh import make_mesh

    vol, engine, cam, frustum = _engine_scene(tmp_path)
    mesh = make_mesh(n_brick=2, n_ray=4)
    kw = dict(screen_space_error=1.0, n_planes=32)
    sync_img, s0 = engine.render_bricked_sharded(
        cam, frustum, mesh, **kw
    )
    assert s0.rendering_done

    fresh = _engine_scene(tmp_path)[1]
    img1, s1 = fresh.render_bricked_sharded(
        cam, frustum, mesh, synchronous=False, **kw
    )
    # Nothing resident yet: the set may be empty or ancestors only.
    assert not s1.rendering_done and s1.pending_uploads
    for f in s1.pending_uploads:
        f.result()
    img2, s2 = fresh.render_bricked_sharded(
        cam, frustum, mesh, synchronous=False, **kw
    )
    assert s2.rendering_done
    np.testing.assert_allclose(
        np.asarray(img2), np.asarray(sync_img), atol=1e-6
    )
