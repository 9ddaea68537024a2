"""Control-point ColorMap model: editing, sampling, file round-trips
(the TransferFunctionEditor/HoverPoints logic,
apps/livreGUI/transferFunctionEditor/)."""

import numpy as np
import pytest

from libre.ops import colormap as cm_ops
from libre.ops.transfer_function import default_color_map


def test_sample_piecewise_linear():
    cm = cm_ops.ColorMap(
        {"red": [(0.0, 0.0), (1.0, 1.0)], "alpha": [(0.0, 1.0), (0.5, 0.0), (1.0, 1.0)]}
    )
    t = cm.sample(5)
    np.testing.assert_allclose(t[:, 0], [0, 0.25, 0.5, 0.75, 1.0], atol=1e-6)
    np.testing.assert_allclose(t[:, 3], [1.0, 0.5, 0.0, 0.5, 1.0], atol=1e-6)
    np.testing.assert_allclose(t[:, 1], 0.0)  # empty channel


def test_hoverpoints_editing_semantics():
    cm = cm_ops.ColorMap({"alpha": [(0.0, 0.0), (0.375, 0.5), (1.0, 1.0)]})
    # endpoints are x-locked
    cm.move_point("alpha", 0, 0.3, 0.25)
    assert cm.points["alpha"][0] == (0.0, 0.25)
    # interior x clamps between neighbours
    cm.move_point("alpha", 1, 2.0, 0.5)
    assert cm.points["alpha"][1] == (1.0, 0.5)
    # endpoints cannot be removed
    with pytest.raises(ValueError):
        cm.remove_point("alpha", 0)
    i = cm.add_point("alpha", 0.25, 0.875)
    assert cm.points["alpha"][i] == (0.25, 0.875)
    cm.remove_point("alpha", i)
    assert len(cm.points["alpha"]) == 3


def test_lba_lbb_roundtrip(tmp_path):
    cm = cm_ops.ColorMap.default()
    a, b = str(tmp_path / "t.lba"), str(tmp_path / "t.lbb")
    cm.save_lba(a)
    cm.save_lbb(b)
    assert cm_ops.ColorMap.load_lba(a) == cm
    assert cm_ops.ColorMap.load_lbb(b) == cm
    np.testing.assert_allclose(
        cm_ops.load(a), cm.sample(), atol=1e-7
    )


def test_from_table_fit():
    table = default_color_map(256)
    cm = cm_ops.ColorMap.from_table(table, n_points=64)
    err = np.max(np.abs(cm.sample(256) - table))
    assert err < 0.03  # smooth ramps refit closely


def test_load_1dt(tmp_path):
    from libre.ops.transfer_function import save_1dt

    p = str(tmp_path / "t.1dt")
    save_1dt(p, default_color_map(64))
    t = cm_ops.load(p)
    assert t.shape == (64, 4)
