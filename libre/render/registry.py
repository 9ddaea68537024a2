"""Renderer plugin registry — the RenderPipeline/RendererPlugin pair.

Reference: renderer plugins are DSOs discovered by name ("gl"/"cuda",
livre/core/render/RenderPipeline.cpp:65-70, RendererPlugin registered via
PluginRegisterer).  Here renderers are registered classes dispatched by
name; the built-ins are ``xla`` (the exact gather-based marcher through
the cache/atlas/multipass engine), ``shearwarp`` (dense shear-warp) and
``bricked`` (the plane march over the brick atlas, the default).
The reference's RENDER_BEGIN/FRAME/END stage mask (Renderer.cpp:42-54)
maps onto the engine's multipass accumulation (first/last pass flags are
implicit in the carried per-ray state).
"""

from __future__ import annotations

from typing import Dict, Optional, Type

_RENDERERS: Dict[str, Type["RendererPlugin"]] = {}


def register_renderer(name: str):
    def deco(cls: Type["RendererPlugin"]):
        cls.name = name
        _RENDERERS[name] = cls
        return cls

    return deco


def create_renderer(name: str) -> "RendererPlugin":
    """Instantiate a renderer by name (RenderPipeline ctor semantics:
    unknown name raises)."""
    try:
        return _RENDERERS[name]()
    except KeyError:
        raise ValueError(
            f"no renderer plugin named {name!r} "
            f"(available: {sorted(_RENDERERS)})"
        ) from None


def available_renderers():
    return sorted(_RENDERERS)


class RendererPlugin:
    """Renderer interface: produce an (H, W, 4) frame for a view."""

    name = "?"

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        raise NotImplementedError


@register_renderer("xla")
class XlaRaycastRenderer(RendererPlugin):
    """Exact gather-based marcher via the full cache/atlas/multipass
    engine path (the glRaycaster/cudaRaycaster equivalent)."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        img, stats, hist = engine.render(
            camera, frustum, params=params, **kwargs
        )
        return img


@register_renderer("shearwarp")
class ShearWarpRenderer(RendererPlugin):
    """Shear-warp over a dense pre-classified LOD level."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        allowed = {"level", "time_step", "n_planes"}
        kw = {k: v for k, v in kwargs.items() if k in allowed}
        return engine.render_shearwarp(camera, params=params, **kw)


@register_renderer("bricked")
class BrickedRenderer(RendererPlugin):
    """Fused post-classification fast path over the mixed-LOD rendering
    set streamed through the device brick atlas (the cudaRaycaster
    equivalent, cuda/Renderer.cu:95-230 + TexturePool.cu:101-214) —
    out-of-core via A-slab multipass, single dispatch steady-state."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        allowed = {
            "screen_space_error", "min_lod", "max_lod", "clip_planes",
            "time_step", "synchronous", "data_range", "n_planes",
            "max_store_mb",
        }
        kw = {k: v for k, v in kwargs.items() if k in allowed}
        img, _stats = engine.render_bricked(
            camera, frustum, params=params, **kw
        )
        return img
