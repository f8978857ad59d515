"""quality2's ORB and LoFTR rows in the port against mlis_tpu, split from
test_torch_quality_matchers.py (whose module docstring gives the scene,
the protocol, the RANSAC draws and the bands) so that two test workers
share the matcher rows.
"""

import pytest

pytest.importorskip("jax")
from test_torch_quality_matchers import hold_row, scene  # noqa: E402,F401 - scene is a fixture


@pytest.mark.parametrize("family,float32", [("orb", False), ("loftr", False)])
def test_matcher_row_matches_jax(scene, family, float32):
    """quality2's row for ``family``: the same weights label, candidates,
    floor rejections and verified pairs as mlis_tpu, decisions within the
    family's band."""
    hold_row(scene, family, float32)
