"""One short run of each configuration on the card (run there with
``python -m pytest -m gpu gatebench/tests``; skips without a card)."""

import pytest

from gatebench import run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["crica_lg512.floors2", "fullres_mixvpr_lg2048.floors8"])
def test_short_run_on_the_card_is_correct(cell, cuda_card):
    result, lines = run.run_cell(cell, 3_900_000_001, 3.0, False, device=str(cuda_card))
    assert result["correct"] is True, lines
    assert result["device"]["platform"] == "gpu" and result["metrics"]["pairs_per_s"]["value"] > 0
