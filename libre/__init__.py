"""libre — a differentiable out-of-core volume raymarching framework in JAX.

A ground-up reimplementation of the capability surface of Libre (the Livre
fork — Large-scale Interactive Volume Rendering Engine): octree/LOD bricked
volumes, pluggable data sources, LRU brick caches, a device brick atlas,
sort-first/sort-last distributed rendering, histogram computation, and remote
steering — redesigned for JAX on an accelerator:

  * the per-ray raycast loop (reference: renderers/glRaycaster/shaders/
    fragRaycast.glsl, renderers/cudaRaycaster/cuda/Renderer.cu) becomes a
    gather marcher in plain XLA and, for the bricked fast path, a plane
    march kernel over slope-grid tiles (Pallas through Triton),
  * multi-GPU sort-first / sort-last decompositions (reference: livre/eq/)
    become shardings over a jax.sharding.Mesh with XLA collectives,
  * and — beyond the reference — the whole pipeline is differentiable with
    respect to voxel densities and transfer-function weights for inverse
    rendering.

Subpackages
-----------
core      octree data model, LOD selection, frustum, caches, config
data      data sources (mem://, raw://, NRRD, bricked LOD store)
ops       compute: reference jnp marcher, gather marcher, plane march, atlas
parallel  mesh/shardings, sort-first tiles, sort-last ordered compositing
render    camera/settings/frame state, render engine
models    differentiable scene models (density grid + transfer function)
train     inverse-rendering optimization, checkpointing
apps      CLI renderer, batch renderer, steering server
"""

__version__ = "0.1.0"

from libre.core.nodeid import NodeId, RootNode
from libre.core.volume_info import DataType, VolumeInformation, fill_regular_volume_info
from libre.core.lodnode import LODNode

__all__ = [
    "NodeId",
    "RootNode",
    "DataType",
    "VolumeInformation",
    "fill_regular_volume_info",
    "LODNode",
]
