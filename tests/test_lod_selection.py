"""Golden-value LOD-selection tests, ported verbatim from the reference's
tests/lib/lodSelection.cpp:32-195 — same matrices, same mem:// source, same
expected NodeId lists."""

import numpy as np
import pytest

from libre.core.frustum import Frustum
from libre.core.select_visibles import select_visibles
from libre.data.datasource import DataSource
import libre.data.memory  # noqa: F401  (register mem://)

# Column-major arrays as in the reference (vmmlib fills column-major);
# numpy wants row-major, so reshape(4,4).T gives the math-convention matrix.
PROJ = np.array(
    [2.0, 0, 0, 0,
     0, 2.0, 0, 0,
     0, 0, -1.01342285, -1,
     0, 0, -0.201342285, 0],
    dtype=np.float64,
).reshape(4, 4).T

MV = np.array(
    [1, 0, 0, 0,
     0, 1, 0, 0,
     0, 0, 1, 0,
     0, 0, -1.0, 1],
    dtype=np.float64,
).reshape(4, 4).T


@pytest.fixture(scope="module")
def datasource():
    return DataSource("mem://#4096,4096,4096,256")


def get_visibles(datasource, window_height, sse, min_lod, max_lod):
    frustum = Frustum(MV, PROJ)
    visibles = select_visibles(
        datasource, frustum, window_height, sse, min_lod, max_lod
    )
    return sorted(v.id for v in visibles)


def test_projection_limits():
    f = Frustum(MV, PROJ)
    assert np.isclose(f.near, 0.1)
    assert np.isclose(f.far, 15.0, atol=1e-3)
    assert np.isclose(f.top, 0.05)
    assert np.isclose(f.bottom, -0.05)
    assert np.allclose(f.eye_pos, [0, 0, 1])


def test_wh256_sse1(datasource):
    expected = [1, 17, 262145, 262161, 8589934594, 8589934610,
                8589934626, 8589934642, 8590196738, 8590196754,
                8590196770, 8590196786, 8590458882, 8590458898,
                8590458914, 8590458930, 8590721026, 8590721042,
                8590721058, 8590721074, 12884901890, 12884901906,
                12884901922, 12884901938, 12885164034, 12885164050,
                12885164066, 12885164082, 12885426178, 12885426194,
                12885426210, 12885426226, 12885688322, 12885688338,
                12885688354, 12885688370]
    assert get_visibles(datasource, 256, 1.0, 0, 100) == expected


def test_wh256_sse2(datasource):
    expected = [1, 17, 262145, 262161, 4294967297, 4294967313,
                4295229441, 4295229457]
    assert get_visibles(datasource, 256, 2.0, 0, 100) == expected


def test_wh256_sse8(datasource):
    assert get_visibles(datasource, 256, 8.0, 0, 100) == [0]


def test_wh512_sse1(datasource):
    expected = [1, 17, 262145, 262161, 8589934594, 8589934610, 8589934626,
                8589934642, 8590196738, 8590196754, 8590196770, 8590196786,
                8590458882, 8590458898, 8590458914, 8590458930, 8590721026,
                8590721042, 8590721058, 8590721074, 25769803779, 25769803795,
                25769803811, 25769803827, 25769803843, 25769803859, 25769803875,
                25769803891, 25770065923, 25770065939, 25770065955, 25770065971,
                25770065987, 25770066003, 25770066019, 25770066035, 25770328067,
                25770328083, 25770328099, 25770328115, 25770328131, 25770328147,
                25770328163, 25770328179, 25770590211, 25770590227, 25770590243,
                25770590259, 25770590275, 25770590291, 25770590307, 25770590323,
                25770852355, 25770852371, 25770852387, 25770852403, 25770852419,
                25770852435, 25770852451, 25770852467, 25771114499, 25771114515,
                25771114531, 25771114547, 25771114563, 25771114579, 25771114595,
                25771114611, 25771376643, 25771376659, 25771376675, 25771376691,
                25771376707, 25771376723, 25771376739, 25771376755, 25771638787,
                25771638803, 25771638819, 25771638835, 25771638851, 25771638867,
                25771638883, 25771638899, 30065033235, 30065033251, 30065033267,
                30065033283, 30065033299, 30065033315, 30065295379, 30065295395,
                30065295411, 30065295427, 30065295443, 30065295459, 30065557523,
                30065557539, 30065557555, 30065557571, 30065557587, 30065557603,
                30065819667, 30065819683, 30065819699, 30065819715, 30065819731,
                30065819747, 30066081811, 30066081827, 30066081843, 30066081859,
                30066081875, 30066081891, 30066343955, 30066343971, 30066343987,
                30066344003, 30066344019, 30066344035]
    assert get_visibles(datasource, 512, 1.0, 0, 100) == expected


def test_wh512_sse2(datasource):
    expected = [1, 17, 262145, 262161, 8589934594, 8589934610, 8589934626,
                8589934642, 8590196738, 8590196754, 8590196770, 8590196786,
                8590458882, 8590458898, 8590458914, 8590458930, 8590721026,
                8590721042, 8590721058, 8590721074, 12884901890, 12884901906,
                12884901922, 12884901938, 12885164034, 12885164050, 12885164066,
                12885164082, 12885426178, 12885426194, 12885426210, 12885426226,
                12885688322, 12885688338, 12885688354, 12885688370]
    assert get_visibles(datasource, 512, 2.0, 0, 100) == expected


def test_wh512_sse8(datasource):
    assert get_visibles(datasource, 512, 8.0, 0, 100) == [0]


def test_min_max_lod_pinning(datasource):
    # min == max == 0 pins selection to the root.
    assert get_visibles(datasource, 512, 1.0, 0, 0) == [0]
    # min == max == 1 pins to level 1 (8 nodes).
    expected = [1, 17, 262145, 262161, 4294967297, 4294967313,
                4295229441, 4295229457]
    visibles = get_visibles(datasource, 512, 1.0, 1, 1)
    assert visibles == expected


def test_range_split(datasource):
    # Sort-last index-interval split: the two halves partition the full set.
    frustum = Frustum(MV, PROJ)
    full = select_visibles(datasource, frustum, 256, 1.0, 0, 100)
    lo = select_visibles(datasource, frustum, 256, 1.0, 0, 100, data_range=(0.0, 0.5))
    hi = select_visibles(datasource, frustum, 256, 1.0, 0, 100, data_range=(0.5, 1.0))
    assert [v.id for v in lo] + [v.id for v in hi] == [v.id for v in full]
    assert len(lo) == len(full) // 2
