"""Multi-host runtime bootstrap + replicated-state broadcast.

Reference stack being replaced (SURVEY.md §5.8): Equalizer/Collage process
lifecycle (server launches render clients, Client.cpp:260-277) becomes
``jax.distributed.initialize``; versioned FrameData commit/sync
(Config.cpp:346, Node.cpp:79-83) becomes a host-broadcast of the settings
pytree from the controller process before each frame; eq::Compositor
becomes the in-mesh over-reduce (libre/parallel/render.py).
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host process group (no-op on a single process).

    With no arguments, jax auto-detects the cluster environment (e.g.
    SLURM variables); elsewhere pass all three.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_controller() -> bool:
    """True on the process that mutates settings (the app node of the
    reference; process 0 here)."""
    return jax.process_index() == 0


def broadcast_frame_state(tree: Any, is_source: Optional[bool] = None) -> Any:
    """Broadcast a small settings pytree from the controller to all hosts —
    the FrameData commit/sync cycle (FrameData.h:32-147) without Collage.

    Arbitrary picklable state is shipped as uint8 so it rides the same
    device collectives (multihost_utils) as array state.
    """
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return tree
    if is_source is None:
        is_source = is_controller()
    payload = pickle.dumps(tree)
    # Fixed-size header (8 bytes length) + body padded to the max length
    # across hosts is unnecessary: broadcast_one_to_all requires equal
    # shapes, so broadcast the length first.
    n = np.asarray([len(payload)], np.int64)
    n = multihost_utils.broadcast_one_to_all(n, is_source=is_source)
    buf = np.zeros(int(n[0]), np.uint8)
    if is_source:
        buf[:] = np.frombuffer(payload, np.uint8)
    buf = multihost_utils.broadcast_one_to_all(buf, is_source=is_source)
    return pickle.loads(buf.tobytes())


def sync_global_devices(tag: str) -> None:
    """Barrier across hosts (frame lifecycle sync points)."""
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(tag)
