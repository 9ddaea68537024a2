"""Device-resident brick atlas: one big device array of equally-sized slots.

Reference: the CUDA texture-pool atlas (renderers/cudaRaycaster/cuda/
TexturePool.cu:101-214) — a single 3-D cudaArray carved into brick slots
with a free-list allocator, filled by async host→device copies; and the GL
TexturePool free-list (livre/core/render/TexturePool.cpp:89-127).

Slots are stored FLAT — the atlas is a ``(n_slots, voxels)`` array with
each brick's voxels flattened.  Slot uploads are donated functional
updates compiled once, so XLA writes in place; the per-pass working set
is gathered and reshaped to (N, BZ, BY, BX) for the render kernels.
Because uploads donate the old buffer, every reader dispatches under
the data lock (:meth:`BrickAtlas.read`, :meth:`BrickAtlas.gather`).
"""

from __future__ import annotations

import threading
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

class AtlasFullError(RuntimeError):
    pass


class BrickAtlas:
    """Fixed-capacity device brick pool with a host-side free-list."""

    def __init__(
        self,
        n_slots: int,
        brick_shape_zyx: Tuple[int, int, int],
        dtype=jnp.float32,
        device=None,
    ):
        self.n_slots = int(n_slots)
        self.brick_shape = tuple(brick_shape_zyx)
        self.dtype = dtype
        self._device = device
        self._voxels = int(np.prod(self.brick_shape))
        with jax.default_device(device) if device is not None else _nullcontext():
            self._data = jnp.zeros((self.n_slots, self._voxels), dtype)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._lock = threading.Lock()
        # Serializes the functional read-modify-write of ``_data``: uploads
        # from concurrent pool threads would otherwise lose updates (both
        # read the same old array, each writes its own slot).
        self._data_lock = threading.Lock()

        # Donated in-place slot write, compiled once per atlas shape (the
        # cudaMemcpy3DAsync into an atlas slot, TexturePool.cu:175-203).
        # Donation lets XLA write the slot in place instead of copying the
        # whole atlas; where donation is unsupported (CPU) jax falls back
        # to a copy.
        @partial(jax.jit, donate_argnums=(0,))
        def _upload(atlas, slot, brick):
            return atlas.at[slot].set(brick)

        self._upload = _upload

        @partial(jax.jit, donate_argnums=(0,))
        def _upload_many(atlas, slots, bricks):
            return atlas.at[slots].set(bricks)

        self._upload_many = _upload_many

    @property
    def data(self) -> jnp.ndarray:
        """(n_slots, voxels) device array (flat slots).  Another thread's
        upload may donate it at any time: dispatch through :meth:`read`."""
        return self._data

    def read(self, fn, *args, **kwargs):
        """``fn(data, *args, **kwargs)`` dispatched under the data lock, so
        a donating upload cannot invalidate ``data`` between the read and
        the dispatch (once enqueued, the runtime keeps it alive)."""
        with self._data_lock:
            return fn(self._data, *args, **kwargs)

    @property
    def slot_bytes(self) -> int:
        return self._voxels * jnp.dtype(self.dtype).itemsize

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        """Pop a free slot (TexturePool.cu:175-186)."""
        with self._lock:
            if not self._free:
                raise AtlasFullError(
                    f"atlas exhausted ({self.n_slots} slots of {self.brick_shape})"
                )
            return self._free.pop()

    def release(self, slot: int) -> None:
        """Return a slot to the pool (TexturePool.cu:210-214)."""
        with self._lock:
            self._free.append(int(slot))

    def _flatten(self, brick_zyx: np.ndarray) -> np.ndarray:
        brick = np.asarray(brick_zyx)
        if brick.shape[-3:] != self.brick_shape:
            raise ValueError(
                f"brick shape {brick.shape} != slot {self.brick_shape}"
            )
        return brick.reshape(*brick.shape[:-3], self._voxels)

    def upload(self, slot: int, brick_zyx: np.ndarray) -> None:
        """Write a (BZ, BY, BX) brick into ``slot`` (async dispatch)."""
        flat = jnp.asarray(self._flatten(brick_zyx), self.dtype)
        with self._data_lock:
            self._data = self._upload(self._data, jnp.int32(slot), flat)

    def upload_many(self, slots, bricks_zyx: np.ndarray) -> None:
        """Write a batch of bricks ((N, BZ, BY, BX)) in one device call.

        The batch is padded to the next power of two by REPEATING the
        last (slot, brick) pair (an idempotent rewrite): out-of-core
        paging produces a different batch size every frame, and an
        unpadded jit would recompile the scatter for every new size."""
        slots = np.asarray(slots, np.int32)
        n = len(slots)
        cap = 1 << max(0, (n - 1)).bit_length()
        if cap != n:
            pad = cap - n
            slots = np.concatenate([slots, np.repeat(slots[-1:], pad)])
            bricks_zyx = np.concatenate(
                [bricks_zyx, np.repeat(bricks_zyx[-1:], pad, axis=0)]
            )
        flat = jnp.asarray(self._flatten(bricks_zyx), self.dtype)
        with self._data_lock:
            self._data = self._upload_many(
                self._data, jnp.asarray(slots), flat
            )

    def gather(self, slots) -> jnp.ndarray:
        """The given slots as a stacked (N, BZ, BY, BX) array (one device
        gather; the per-pass working set handed to the raycast kernel).

        Dispatches under the data lock: once the gather is enqueued the
        runtime keeps the buffer alive, but a donating upload must not
        invalidate the Python handle between our read of ``_data`` and
        the dispatch."""
        with self._data_lock:
            rows = jnp.take(
                self._data, jnp.asarray(slots, jnp.int32), axis=0
            )
        return rows.reshape(len(slots), *self.brick_shape)


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def atlas_capacity(max_bytes: int, brick_shape_zyx, dtype=jnp.float32) -> int:
    """Slots fitting a memory budget (TexturePool.cu:101-153 sizing)."""
    per = int(np.prod(brick_shape_zyx)) * jnp.dtype(dtype).itemsize
    return max(1, max_bytes // per)
