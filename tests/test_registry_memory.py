"""Renderer plugin registry + memory-unit handles (RenderPipeline plugin
dispatch, RenderPipeline.cpp:65-70; MemoryUnit.h semantics)."""

import numpy as np
import pytest

from libre.data.memory_unit import (
    AllocMemoryUnit,
    ConstMemoryUnit,
    NoMemoryUnit,
)
from libre.render.registry import (
    RendererPlugin,
    available_renderers,
    create_renderer,
    register_renderer,
)


def test_registry_dispatch():
    assert "xla" in available_renderers()
    assert "shearwarp" in available_renderers()
    assert "bricked" in available_renderers()
    r = create_renderer("xla")
    assert r.name == "xla"
    with pytest.raises(ValueError, match="no renderer plugin"):
        create_renderer("cuda")  # the reference's name; not ours


def test_registry_custom_plugin():
    @register_renderer("test-null")
    class NullRenderer(RendererPlugin):
        def render(self, engine, camera, frustum, *, params=None, **kw):
            return None

    assert create_renderer("test-null").render(None, None, None) is None


def test_memory_units():
    assert NoMemoryUnit().mem_size == 0

    backing = np.arange(16, dtype=np.uint8)
    view = ConstMemoryUnit(backing)
    assert view.mem_size == 16
    np.testing.assert_array_equal(view.get_data(), backing)

    own = AllocMemoryUnit(backing)
    backing[0] = 99
    assert own.get_data()[0] == 0  # owning copy unaffected
    assert AllocMemoryUnit(8).mem_size == 8
    assert own.get_data(np.uint32).dtype == np.uint32
