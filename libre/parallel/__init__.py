"""Multi-device decomposition: sort-first (ray tiles) and sort-last (brick
ranges), expressed as jax.sharding meshes + shard_map collectives.

The replacement for the Equalizer/Collage distributed layer
(livre/eq/, SURVEY.md §2.8, §2.12): screen-space and data-range
decompositions become mesh axes; image compositing becomes an ordered
associative over-reduce along the brick axis.
"""

from libre.parallel.mesh import make_mesh
from libre.parallel.compositing import over, fold_over
from libre.parallel.render import (
    render_rays_sharded,
    shard_bricks_front_to_back,
)
from libre.parallel.bricked_sharded import (
    build_sharded_slabs,
    render_store_grid_sharded,
)

__all__ = [
    "make_mesh",
    "over",
    "fold_over",
    "render_rays_sharded",
    "shard_bricks_front_to_back",
    "build_sharded_slabs",
    "render_store_grid_sharded",
]
