"""The device brick atlas (ops/atlas.py): flat unpadded slots, batched
uploads, and reads that dispatch under the data lock (uploads donate the
old buffer, so an unlocked reader can see a deleted array)."""

import threading

import jax.numpy as jnp
import numpy as np

from libre.ops.atlas import BrickAtlas, atlas_capacity

SHAPE = (3, 4, 5)  # (BZ, BY, BX): 60 voxels, not a multiple of anything


def test_flat_slots_are_unpadded():
    atlas = BrickAtlas(4, SHAPE, jnp.uint8)
    assert atlas.data.shape == (4, 60)
    assert atlas.slot_bytes == 60
    assert atlas_capacity(600, SHAPE, jnp.uint8) == 10
    assert atlas_capacity(600, SHAPE, jnp.float32) == 2


def test_upload_many_and_gather_roundtrip():
    atlas = BrickAtlas(8, SHAPE, jnp.float32)
    rng = np.random.default_rng(0)
    bricks = rng.random((3,) + SHAPE).astype(np.float32)
    slots = [atlas.acquire() for _ in range(3)]
    atlas.upload_many(slots, bricks)  # padded to 4 by repeating the last
    np.testing.assert_array_equal(np.asarray(atlas.gather(slots)), bricks)
    np.testing.assert_array_equal(
        np.asarray(atlas.read(lambda data, s: data[s], slots[1])),
        bricks[1].reshape(-1),
    )


def test_read_holds_the_data_lock():
    """``read`` runs its function under the lock an upload takes, so an
    upload from another thread waits until the read has dispatched."""
    atlas = BrickAtlas(2, SHAPE, jnp.float32)
    inside = threading.Event()
    release = threading.Event()
    uploaded = threading.Event()

    def slow_reader(data):
        inside.set()
        release.wait(5.0)
        return data.sum()

    reader = threading.Thread(target=lambda: atlas.read(slow_reader))
    reader.start()
    assert inside.wait(5.0)
    writer = threading.Thread(target=lambda: (
        atlas.upload(0, np.ones(SHAPE, np.float32)), uploaded.set()))
    writer.start()
    assert not uploaded.wait(0.2)  # blocked behind the read
    release.set()
    reader.join(5.0)
    writer.join(5.0)
    assert uploaded.is_set()
    np.testing.assert_array_equal(np.asarray(atlas.gather([0]))[0], 1.0)
