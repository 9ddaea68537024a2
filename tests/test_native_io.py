"""Native brick IO (native/brickio.cpp): batched mmap+zlib reads must be
byte-identical to the Python path (UVFDataSource.cpp:249-301 behavior),
and parallel compression must round-trip."""

import numpy as np
import pytest

from libre.core.nodeid import NodeId
from libre.data import native_io
from libre.data.datasource import DataSource, load_plugins
from libre.data.lod_store import build_lod_store

load_plugins()

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native brickio not built"
)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lod") / "vol.lod")
    rng = np.random.default_rng(7)
    volume = (rng.random((64, 64, 64)) * 255).astype(np.uint8)
    info = build_lod_store(volume, path, block_size=16, overlap=2)
    return path, info


def test_batch_read_matches_serial(store):
    path, info = store
    ds = DataSource(f"lod://{path}")
    depth = info.root_node.depth
    nodes = []
    level = depth - 1
    n = 64 // 16
    for x in range(n):
        for y in range(n):
            for z in range(n):
                nodes.append(NodeId.from_coords(level, (x, y, z)))
    batch = ds.get_data_batch(nodes)
    assert len(batch) == len(nodes)
    for node, brick in zip(nodes, batch):
        np.testing.assert_array_equal(brick, ds.get_data(node))


def test_compress_roundtrip():
    import zlib

    rng = np.random.default_rng(1)
    bricks = (rng.random((5, 1024)) * 50).astype(np.uint8)
    blobs = native_io.compress_bricks(bricks)
    assert len(blobs) == 5
    for i, blob in enumerate(blobs):
        np.testing.assert_array_equal(
            np.frombuffer(zlib.decompress(blob), np.uint8), bricks[i]
        )
