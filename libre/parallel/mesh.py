"""Device-mesh construction for the render/train decomposition axes.

The two first-class axes mirror the reference's decompositions
(SURVEY.md §2.12):

  * ``ray``  — sort-first: each device owns a contiguous slab of rays
    (the Equalizer per-channel viewport, Channel.cpp:444-533 2D path);
  * ``brick`` — sort-last/DB: each device owns a contiguous range of the
    front-to-back brick list (the channel ``Range`` slicing the visible
    set, SelectVisibles.cpp:120-142) and composites a partial image.

Only the brick axis communicates (the over-compositing reduce moves
per-ray (rgb, a) states every frame); the ray axis needs none.  The mesh
assumes no topology: on cards joined all to all (NVLink) every pair
talks at the same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

RAY_AXIS = "ray"
BRICK_AXIS = "brick"


def make_mesh(
    n_brick: int = 1,
    n_ray: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(brick, ray)`` mesh over the available devices.

    ``n_ray`` defaults to ``len(devices) // n_brick``.  The brick axis is
    the trailing (fastest-varying) axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_ray is None:
        if n % n_brick:
            raise ValueError(f"{n} devices not divisible by n_brick={n_brick}")
        n_ray = n // n_brick
    if n_brick * n_ray > n:
        raise ValueError(
            f"mesh {n_brick}x{n_ray} needs {n_brick * n_ray} devices, have {n}"
        )
    grid = np.asarray(devices[: n_brick * n_ray]).reshape(n_ray, n_brick)
    return Mesh(grid, (RAY_AXIS, BRICK_AXIS))
