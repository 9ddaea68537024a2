"""Device-memory governance: native-dtype atlas + shared byte-budget LRU.

VERDICT r2 items 6/7: (a) the atlas stores bricks in the dataset's
NATIVE dtype (livre/core/render/TexturePool.cpp:42-84 chooses the GL
internal format per dtype) with render paths casting/dequantizing on
gather — 4× capacity for uint8 datasets at identical images; (b) the
engine's derived device arrays (assembled stores, classified stacks)
are byte-accounted against ONE explicit budget shared with the atlas
(max_gpu_cache_mb is the TOTAL; TexturePool.cu:101-153 sizing), evicted
least-recently-used across pools; (c) under real atlas pressure (working
set > slots) the slab multipass pages bricks through the atlas with
observed evictions, and the image is unchanged."""

import numpy as np
import pytest

import jax.numpy as jnp

from libre.core.frustum import Frustum, look_at, perspective
from libre.data.datasource import DataSource, load_plugins
from libre.ops.reference import Camera, RenderParams
from libre.render.engine import (
    RenderEngine,
    _ByteLRU,
    _SharedByteBudget,
)
from tests.test_bricked import make_scene

load_plugins()

URI = "mem://#32,32,32,16?pattern=gradient&datatype=uint8"
PARAMS = RenderParams(
    n_samples_per_ray=64, data_source_range=(0.0, 255.0),
    filter_mode="trilinear",
)


def make_view(w=48, h=48, eye=(0.3, 0.2, 1.5)):
    proj = perspective(50.0, w / h, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    camera = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w, h),
        near=frustum.near,
    )
    return camera, frustum


def test_native_dtype_atlas_capacity_and_parity():
    """A uint8 dataset defaults to a uint8 atlas: 4× the slots of the
    f32 atlas at the same budget, bit-identical render (values are
    integers either way; normalization uses dataSourceRange)."""
    cam, frustum = make_view()
    native = RenderEngine(DataSource(URI), max_gpu_cache_mb=64)
    f32 = RenderEngine(
        DataSource(URI), max_gpu_cache_mb=64, dtype=jnp.float32
    )
    assert native.atlas_dtype == jnp.dtype(jnp.uint8)
    assert native.atlas.slot_bytes * 4 == f32.atlas.slot_bytes
    assert native.atlas.n_slots >= 4 * f32.atlas.n_slots  # ±floor rounding
    img_n, _, _ = native.render(
        cam, frustum, params=PARAMS, screen_space_error=1.0
    )
    img_f, _, _ = f32.render(
        cam, frustum, params=PARAMS, screen_space_error=1.0
    )
    np.testing.assert_array_equal(np.asarray(img_n), np.asarray(img_f))


def test_shared_budget_lru_eviction_order():
    """Cross-pool LRU: inserting past the budget evicts the globally
    least-recently-used entry, whichever pool holds it."""
    shared = _SharedByteBudget(100)
    a = _ByteLRU(shared)
    b = _ByteLRU(shared)
    a.put("a1", 1, 40)
    b.put("b1", 2, 40)
    assert shared.used == 80
    assert a.get("a1") == 1  # refresh a1: b1 is now oldest
    b.put("b2", 3, 40)  # needs eviction
    assert "b1" not in b and "a1" in a and "b2" in b
    assert shared.used == 80
    # Re-putting an existing key replaces, not duplicates.
    a.put("a1", 9, 50)
    assert shared.used <= 100 and a.get("a1") == 9


def test_store_cache_byte_budget_and_hbm_accounting(tmp_path):
    """The assembled-store cache is byte-accounted against the device
    budget (total = atlas + derived caches ≤ max_gpu_cache_mb), and a
    second frame hits the cache instead of re-assembling."""
    _vol, ds = make_scene(tmp_path)
    eng = RenderEngine(ds, max_gpu_cache_mb=64, filter_mode="trilinear")
    total = 64 * 2**20
    atlas_bytes = eng.atlas.n_slots * eng.atlas.slot_bytes
    assert atlas_bytes + eng.device_budget.budget <= total
    cam, frustum = make_view(eye=(0.2, 0.1, 1.4))
    params = RenderParams(
        n_samples_per_ray=48, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    eng.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48
    )
    assert len(eng._store_cache) == 1
    assert 0 < eng._store_cache.used <= eng.device_budget.budget
    eng.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48
    )
    assert len(eng._store_cache) == 1  # steady state: cache hit


def test_atlas_pressure_slab_paging_evicts_and_matches(tmp_path):
    """Working set exceeds the atlas: slab multipass pages bricks
    through the atlas mid-frame (evictions > 0) and the image equals
    the unpressured render (VERDICT r2 weak 5 — previous 'out-of-core'
    tests never filled the atlas)."""
    _vol, ds = make_scene(tmp_path, n=32, block=8)
    big = RenderEngine(ds, max_gpu_cache_mb=64, filter_mode="trilinear")
    cam, frustum = make_view(eye=(0.2, 0.1, 1.4))
    params = RenderParams(
        n_samples_per_ray=48, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    ref, s_big = big.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48
    )
    n_visible = s_big.n_available
    # Atlas big enough for any one slab's bricks but far smaller than
    # the visible working set → paging must evict mid-frame.
    slot = RenderEngine(ds, max_gpu_cache_mb=1).atlas.slot_bytes
    n_slots_target = max(8, n_visible // 2)
    budget_mb = n_slots_target * slot * 2 / 2**20  # atlas_fraction=0.5
    small = RenderEngine(
        ds, max_gpu_cache_mb=budget_mb, filter_mode="trilinear"
    )
    assert small.atlas.n_slots < n_visible
    paged, s_small = small.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48,
        max_store_mb=0,  # force per-slab assembly
    )
    assert s_small.n_passes > 1
    assert small.texture_cache.statistics.evictions > 0
    np.testing.assert_allclose(
        np.asarray(paged), np.asarray(ref), atol=1e-6
    )


def test_slab_larger_than_atlas_chunks_and_matches(tmp_path):
    """A single slab needing MORE bricks than the atlas has slots pages
    in atlas-sized chunks (max-union of disjoint assemblies) instead of
    raising AtlasFullError (r5: hit by the 1024^3 OOC config where a
    dense block layer exceeded a 32-slot atlas)."""
    _vol, ds = make_scene(tmp_path, n=32, block=8)
    big = RenderEngine(ds, max_gpu_cache_mb=64, filter_mode="trilinear")
    cam, frustum = make_view(eye=(0.2, 0.1, 1.4))
    params = RenderParams(
        n_samples_per_ray=48, data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
    )
    ref, s_big = big.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48
    )
    # Tiny atlas: fewer slots than one block layer of the rendering set.
    slot = RenderEngine(ds, max_gpu_cache_mb=1).atlas.slot_bytes
    tiny = RenderEngine(
        ds, max_gpu_cache_mb=1, filter_mode="trilinear",
        atlas_fraction=(6.4 * slot) / 2**20,  # ~6 slots
    )
    assert tiny.atlas.n_slots <= 8
    paged, s_tiny = tiny.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=48,
        max_store_mb=0,
    )
    assert tiny.texture_cache.statistics.evictions > 0
    np.testing.assert_allclose(
        np.asarray(paged), np.asarray(ref), atol=1e-6
    )
