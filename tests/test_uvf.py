"""UVF reader against the reference's own fixture + golden values
(tests/uvf/uvf.cpp: depth 2, uint8, overlap 2, 75×75×138 voxels, first
child voxel box 28³, padded brick 32³)."""

import os

import numpy as np
import pytest

from libre.core.nodeid import NodeId
from libre.data.datasource import DataSource, load_plugins

UVF_FILE = "/root/reference/tests/uvf/mouse_reduced.uvf"

pytestmark = pytest.mark.skipif(
    not os.path.exists(UVF_FILE), reason="reference UVF fixture unavailable"
)

load_plugins()


@pytest.fixture(scope="module")
def source():
    return DataSource(f"uvf://{UVF_FILE}")


def test_golden_metadata(source):
    """tests/uvf/uvf.cpp:42-52 golden values."""
    info = source.volume_info
    assert info.root_node.depth == 2
    assert info.component_count == 1
    assert info.data_type.numpy_dtype == np.uint8
    assert info.voxels == (75, 75, 138)
    assert info.overlap == (2, 2, 2)
    assert info.root_node.block_count == (2, 2, 3)


def test_golden_first_child(source):
    """tests/uvf/uvf.cpp:54-75: first child of the root-grid origin has a
    28³ voxel box and a 32³ (block + 2·overlap) data brick."""
    info = source.volume_info
    parent = NodeId.from_coords(0, (0, 0, 0))
    child = parent.children()[0]
    node = source.get_node(child)
    assert node.block_size == (28, 28, 28)
    block = tuple(
        b + 2 * o for b, o in zip(node.block_size, info.overlap)
    )
    assert block == info.maximum_block_size
    data = source.get_data(child)
    assert data.nbytes == 32 * 32 * 32 * 1
    assert data.shape == (32, 32, 32)


def test_ghost_voxels_consistent(source):
    """Neighbouring bricks must agree on their shared overlap voxels —
    validates brick ordering, offsets, and decompression end to end."""
    b0 = source.get_data(NodeId.from_coords(1, (0, 0, 0)))
    b1 = source.get_data(NodeId.from_coords(1, (1, 0, 0)))
    # brick x-range [pos*28 - 2, pos*28 + 30): columns 28.. of b0 overlap
    # columns 0.. of b1
    np.testing.assert_array_equal(b0[:, :, 28:32], b1[:, :, 0:4])
    b2 = source.get_data(NodeId.from_coords(1, (0, 1, 0)))
    np.testing.assert_array_equal(b0[:, 28:32, :], b2[:, 0:4, :])


def test_edge_brick_padded_to_atlas_shape(source):
    """Edge bricks (native extent < 32) come back edge-replicated to the
    uniform atlas shape."""
    data = source.get_data(NodeId.from_coords(1, (2, 2, 4)))
    assert data.shape == (32, 32, 32)
    # x inner = 75 - 2*28 = 19 -> native 23 wide; replicated beyond
    np.testing.assert_array_equal(data[:, :, 22], data[:, :, 23])


def test_invalid_out_of_grid_child(source):
    """Children outside the UVF brick grid (the non-perfect-octree
    subset, UVFDataSource.cpp:311-318) are invalid nodes."""
    node = source.get_node(NodeId.from_coords(1, (3, 3, 5)))
    assert node.block_size == (0, 0, 0)


def test_lod_consistency(source):
    """A coarse brick downsamples the fine level approximately: means
    over the shared world region should agree."""
    coarse = source.get_data(NodeId.from_coords(0, (0, 0, 0)))
    fine = source.get_data(NodeId.from_coords(1, (0, 0, 0)))
    c = coarse[2:16, 2:16, 2:16].astype(np.float64)
    f = fine[2:30, 2:30, 2:30].astype(np.float64)
    assert abs(c.mean() - f.mean()) < 3.0


def test_world_boxes_nest(source):
    """Child world boxes lie inside the parent's, up to one coarse voxel
    — UVF LODs ceil-halve the grid (75 → 38), so fine levels can
    genuinely extend past the coarse box by the rounding slack (the same
    geometry Tuvok produces)."""
    info = source.volume_info
    parent = source.get_node(NodeId.from_coords(0, (0, 0, 0)))
    coarse_voxel = [
        ws / (v // 2) for ws, v in zip(info.world_size, info.voxels)
    ]
    for child_id in NodeId.from_coords(0, (0, 0, 0)).children():
        child = source.get_node(child_id)
        if child.block_size == (0, 0, 0):
            continue
        for d in range(3):
            tol = coarse_voxel[d] + 1e-6
            assert child.world_box_min[d] >= parent.world_box_min[d] - tol
            assert child.world_box_max[d] <= parent.world_box_max[d] + tol


def test_out_of_grid_get_data_raises(source):
    """Reading an out-of-grid child must fail loudly — the flat ToC
    index would otherwise land in another LOD's entries and return a
    wrong-shaped brick silently (found rendering mouse_reduced.uvf at
    SSE 1: selection descended into the non-octree subset)."""
    with pytest.raises(ValueError, match="outside the LOD"):
        source.get_data(NodeId.from_coords(1, (3, 0, 0)))
    with pytest.raises(ValueError, match="outside the LOD"):
        source.get_data(NodeId.from_coords(1, (0, 0, 5)))


def test_selection_skips_invalid_children(source):
    """SelectVisibles culls invalid (out-of-grid) nodes instead of
    selecting their degenerate boxes (UVFDataSource.cpp:311-318)."""
    from libre.core.frustum import Frustum, look_at, perspective
    from libre.core.select_visibles import select_visibles

    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.3, 0.2, 1.6], [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    visibles = select_visibles(source, frustum, 128, 1.0)
    assert len(visibles) > 1
    toc_layout = (3, 3, 5)  # level-1 brick grid of mouse_reduced
    for n in visibles:
        if n.level == 1:
            assert all(p < g for p, g in zip(n.position, toc_layout)), n


def test_engine_renders_uvf_end_to_end(source):
    """The full engine pipeline (selection → native-dtype atlas →
    bricked fast path vs exact marcher) on the real UVF file: both
    paths produce a consistent image of the dataset."""
    import jax.numpy as jnp

    from libre.core.frustum import Frustum, look_at, perspective
    from libre.ops.reference import Camera, RenderParams
    from libre.render.engine import RenderEngine

    eng = RenderEngine(source, max_gpu_cache_mb=64, filter_mode="trilinear")
    assert eng.atlas_dtype == jnp.dtype(jnp.uint8)  # native dtype
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.3, 0.2, 1.6], [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, 48, 48),
        near=frustum.near,
    )
    info = source.volume_info
    params = RenderParams(
        n_samples_per_ray=64,
        data_source_range=info.data_type.default_range,
        filter_mode="trilinear",
    )
    exact, s1, _ = eng.render(
        cam, frustum, params=params, screen_space_error=1.0
    )
    fast, s2 = eng.render_bricked(
        cam, frustum, params=params, screen_space_error=1.0, n_planes=64
    )
    e, f = np.asarray(exact), np.asarray(fast)
    assert s1.n_available > 1 and s2.rendering_done
    assert e[..., 3].max() > 0.9 and f[..., 3].max() > 0.9
    # Different sample parameterizations (ray-uniform vs axis-uniform)
    # bound the pointwise agreement, not bit-exactness.
    assert np.abs(e - f).mean() < 0.05


def test_uvf_native_batch_matches_serial(source):
    """UVF batch reads through the native brickio pool equal the serial
    Python reader brick-for-brick (incl. edge bricks via fallback)."""
    import itertools

    from libre.data import native_io

    if not native_io.available():
        pytest.skip("native brickio unavailable")
    level = source.volume_info.root_node.depth - 1
    nx, ny, nz = source.volume_info.root_node.block_count
    nodes = [
        NodeId.from_coords(level, p)
        for p in itertools.product(range(nx), range(ny), range(nz))
    ]
    serial = [source.get_data(n) for n in nodes]
    batch = source.get_data_batch(nodes)
    assert len(batch) == len(serial)
    for a, b in zip(serial, batch):
        np.testing.assert_array_equal(a, b)
