"""NodeId packing/octree arithmetic tests (reference golden values from
tests/lib/lodSelection.cpp identifiers)."""

import numpy as np

from libre.core.nodeid import NodeId, RootNode, pack_ids, unpack_ids


def test_pack_layout_golden():
    # Identifiers from the reference's golden LOD test: level in the low
    # 4 bits, x/y/z in successive 14-bit fields.
    assert NodeId.from_coords(1, (0, 0, 0)).id == 1
    assert NodeId.from_coords(1, (1, 0, 0)).id == 17
    assert NodeId.from_coords(1, (0, 1, 0)).id == 262145
    assert NodeId.from_coords(1, (1, 1, 0)).id == 262161
    assert NodeId.from_coords(2, (0, 0, 2)).id == 8589934594
    assert NodeId.from_coords(0, (0, 0, 0)).id == 0


def test_roundtrip():
    n = NodeId.from_coords(5, (123, 45, 6789), time_step=777)
    assert n.level == 5
    assert n.position == (123, 45, 6789)
    assert n.time_step == 777


def test_parent_children():
    n = NodeId.from_coords(3, (4, 5, 6))
    p = n.parent()
    assert p.level == 2 and p.position == (2, 2, 3)
    kids = p.children()
    assert len(kids) == 8
    assert n in kids
    for k in kids:
        assert k.parent() == p
        assert k.is_ancestor(p)
    assert not p.is_ancestor(n)
    root = n.root()
    assert root.level == 0 and root.position == (0, 0, 0)
    assert n.is_ancestor(root)
    assert len(n.parents()) == 3


def test_children_at_level():
    n = NodeId.from_coords(1, (1, 0, 0))
    kids = n.children_at_level(3)
    assert len(kids) == 64
    for k in kids:
        assert k.level == 3
        assert k.is_ancestor(n)


def test_range():
    # NodeId::getRange (NodeId.cpp:128-137): z-minor linearization.
    assert NodeId.from_coords(0, (0, 0, 0)).range() == (0.0, 1.0)
    lo, hi = NodeId.from_coords(1, (0, 0, 1)).range()
    assert np.isclose(lo, 1 / 8) and np.isclose(hi, 2 / 8)
    lo, hi = NodeId.from_coords(1, (1, 1, 1)).range()
    assert np.isclose(lo, 7 / 8) and np.isclose(hi, 1.0)


def test_invalid():
    assert not NodeId().is_valid()
    assert NodeId.from_coords(0, (0, 0, 0)).parent() == NodeId()


def test_root_node():
    rn = RootNode(5, (1, 2, 1))
    assert rn.block_size(0) == (1, 2, 1)
    assert rn.block_size(3) == (8, 16, 8)
    assert len(list(rn.iter_roots())) == 2


def test_vectorized_pack_unpack():
    ids = np.array([1, 17, 262145, 8589934594], dtype=np.uint64)
    level, pos, t = unpack_ids(ids)
    assert list(level) == [1, 1, 1, 2]
    assert list(pos[1]) == [1, 0, 0]
    assert list(pos[3]) == [0, 0, 2]
    repacked = pack_ids(level, pos, t)
    assert np.array_equal(repacked, ids)
