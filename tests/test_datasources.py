"""Data source tests, modeled on the reference's tests/data/dataSource.cpp,
tests/lib/rawDatasource.cpp, tests/uvf/uvf.cpp and tests/core/volumeInformation.cpp."""

import numpy as np
import pytest

from libre.core.nodeid import NodeId
from libre.core.volume_info import DataType, VolumeInformation, fill_regular_volume_info
from libre.data.datasource import DataSource
from libre.data.lod_store import build_lod_store
import libre.data.memory  # noqa: F401
import libre.data.raw  # noqa: F401
import libre.data.lod_store  # noqa: F401
from libre.data.memory import node_value


class TestFillRegularVolumeInfo:
    # Reference: tests/core/volumeInformation.cpp.
    def test_regular_cube(self):
        info = VolumeInformation(voxels=(4096, 4096, 4096),
                                 maximum_block_size=(264, 264, 264),
                                 overlap=(4, 4, 4))
        fill_regular_volume_info(info)
        assert info.root_node.depth == 5
        assert info.root_node.block_count == (1, 1, 1)
        assert info.world_size == (1.0, 1.0, 1.0)
        assert np.isclose(info.world_space_per_voxel, 1 / 4096)

    def test_anisotropic(self):
        # Depth = min per-axis level count; root covers the rest.
        info = VolumeInformation(voxels=(1024, 512, 256),
                                 maximum_block_size=(32, 32, 32),
                                 overlap=(0, 0, 0))
        fill_regular_volume_info(info)
        # blocks = (32, 16, 8) → levels = (5, 4, 3) → depth = 3 (+1)
        assert info.root_node.depth == 4
        assert info.root_node.block_count == (4, 2, 1)
        assert info.world_size == (1.0, 0.5, 0.25)


class TestMemoryDataSource:
    # Reference: tests/data/dataSource.cpp:38-81.
    def test_metadata(self):
        ds = DataSource("mem://#1024,1024,512,32")
        info = ds.volume_info
        assert info.data_type is DataType.UINT8
        assert info.overlap == (4, 4, 4)
        assert info.maximum_block_size == (40, 40, 40)
        # blocks = (32, 32, 16) → levels = (5, 5, 4) → depth 4 (+1) = 5
        assert info.root_node.depth == 5

    def test_get_data_shape_and_value(self):
        ds = DataSource("mem://#256,256,256,32")
        node = NodeId.from_coords(1, (1, 0, 1))
        data = ds.get_data(node)
        assert data.shape == (40, 40, 40)
        expected = np.uint8(node_value(node.id, 0))
        assert np.all(data == expected)

    def test_datatype_and_children(self):
        ds = DataSource("mem://#256,256,256,32?datatype=float")
        assert ds.volume_info.data_type is DataType.FLOAT
        root = NodeId.from_coords(0, (0, 0, 0))
        lod = ds.get_node(root)
        assert lod.is_valid()
        for child in root.children():
            assert ds.get_node(child).is_valid()

    def test_world_boxes_tile(self):
        ds = DataSource("mem://#256,256,256,32")
        # Children partition the parent's world box.
        root = ds.get_node(NodeId.from_coords(0, (0, 0, 0)))
        assert np.allclose(root.world_box_min, [-0.5] * 3)
        assert np.allclose(root.world_box_max, [0.5] * 3)
        child = ds.get_node(NodeId.from_coords(1, (0, 0, 0)))
        assert np.allclose(child.world_box_min, [-0.5] * 3)
        assert np.allclose(child.world_box_max, [0.0] * 3)


class TestRawDataSource:
    # Reference: tests/lib/rawDatasource.cpp.
    def test_raw_roundtrip(self, tmp_path):
        vol = np.arange(16 * 8 * 4, dtype=np.uint16).reshape(4, 8, 16)  # (Z,Y,X)
        path = tmp_path / "vol.raw"
        vol.tofile(path)
        ds = DataSource(f"raw://{path}#16,8,4,uint16")
        info = ds.volume_info
        assert info.voxels == (16, 8, 4)
        assert info.root_node.depth == 1
        assert info.overlap == (0, 0, 0)
        assert info.maximum_block_size == (16, 8, 4)
        data = ds.get_data(NodeId.from_coords(0, (0, 0, 0)))
        assert np.array_equal(data, vol)

    def test_nrrd(self, tmp_path):
        vol = (np.random.default_rng(0).random((6, 5, 7)) * 255).astype(np.uint8)
        path = tmp_path / "vol.nrrd"
        with open(path, "wb") as f:
            f.write(b"NRRD0001\n")
            f.write(b"type: uchar\n")
            f.write(b"dimension: 3\n")
            f.write(b"sizes: 7 5 6\n")
            f.write(b"encoding: raw\n")
            f.write(b"\n")
            f.write(vol.tobytes())
        ds = DataSource(f"raw://{path}")
        assert ds.volume_info.voxels == (7, 5, 6)
        data = ds.get_data(NodeId.from_coords(0, (0, 0, 0)))
        assert np.array_equal(data, vol)


class TestLODStore:
    # Reference behavior: tests/uvf/uvf.cpp (bricked octree metadata +
    # brick readback) against our own store built from a dense volume.
    def test_build_and_read(self, tmp_path):
        rng = np.random.default_rng(42)
        vol = (rng.random((64, 64, 64)) * 255).astype(np.uint8)
        path = str(tmp_path / "vol.lod")
        build_lod_store(vol, path, block_size=16, overlap=2, compress=True)
        ds = DataSource(f"lod://{path}")
        info = ds.volume_info
        assert info.voxels == (64, 64, 64)
        assert info.overlap == (2, 2, 2)
        assert info.maximum_block_size == (20, 20, 20)
        assert info.root_node.depth == 3
        assert info.data_type is DataType.UINT8

        # Finest-level brick interior must match the source volume.
        node = NodeId.from_coords(2, (1, 2, 3))
        data = ds.get_data(node)
        assert data.shape == (20, 20, 20)
        interior = data[2:-2, 2:-2, 2:-2]
        # brick (x=1, y=2, z=3) → voxels x 16:32, y 32:48, z 48:64
        assert np.array_equal(interior, vol[48:64, 32:48, 16:32])

        # Ghost voxels replicate neighbour data (interior continuity).
        full_pad = np.pad(vol, 2, mode="edge")
        assert np.array_equal(data, full_pad[48:68, 32:52, 16:36])

    def test_coarse_levels_are_downsampled(self, tmp_path):
        vol = np.full((32, 32, 32), 100, dtype=np.uint8)
        path = str(tmp_path / "flat.lod")
        build_lod_store(vol, path, block_size=16, overlap=0, compress=False)
        ds = DataSource(f"lod://{path}")
        assert ds.volume_info.root_node.depth == 2
        coarse = ds.get_data(NodeId.from_coords(0, (0, 0, 0)))
        assert coarse.shape == (16, 16, 16)
        assert np.all(coarse == 100)
