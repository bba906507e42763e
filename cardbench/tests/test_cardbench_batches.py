"""The batch pool: the same for the same seed, different across seeds, in
the lazy-load row layout."""

from __future__ import annotations

import numpy as np
import pytest

from cardbench.batches import JOINER_POST, JOINER_PRE, VIDEO_TOKEN_ID, Geometry, make_pool
from cardbench.harness import derive
from conftest import TINY_GEOMETRY, cell_files


def _pool(seed: int, geometry=TINY_GEOMETRY, n: int = 3, batch: int = 3):
    return make_pool(Geometry(geometry), np.random.default_rng(derive(seed, "batches")), n, batch, 1000, 8,
                     (2, 64), 4)


def test_same_seed_same_pool_and_seeds_differ():
    big = 2**40 + 17
    a, b, c = _pool(big), _pool(big), _pool(big + 1)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["language"], c[0]["language"])
    assert not np.array_equal(a[0]["vision"], c[0]["vision"])
    assert derive(big, "weights", 63) != derive(big + 1, "weights", 63)


def test_rows_follow_the_layout():
    g = Geometry(TINY_GEOMETRY)
    pool = _pool(5, n=4)
    rows = np.concatenate([b["language"] for b in pool])
    assert len({r.tobytes() for r in rows}) == len(rows)          # every row differs
    for b in pool:
        assert b["vision"].shape == (3, g.num_frames, 3, g.image_size, g.image_size)
        assert b["vision"].dtype == np.float32 and b["language"].dtype == np.int32
        for ids, (pad, inst, diag) in zip(b["language"], b["padvals"]):
            assert len(ids) == g.max_lang_tokens and (ids == VIDEO_TOKEN_ID).sum() == 1
            assert 2 <= diag <= g.onsets_width and inst == 4
            assert (ids[len(ids) - pad:] == 0).all() and (ids[:len(ids) - pad] != 0).all()
            prefix = int(np.flatnonzero(ids == VIDEO_TOKEN_ID)[0])
            assert prefix + 1 + JOINER_PRE + inst + diag + JOINER_POST + pad == len(ids) and prefix >= 1


@pytest.mark.parametrize("cell", ["lora-frames-b3", "baseline-frames-b5"])
def test_full_geometry(cell):
    config, traffic = cell_files(cell)
    g = Geometry(config["model"]["geometry"])
    assert (g.num_frames, g.num_vis_tokens, g.max_lang_tokens, g.feature_len) == (12, 1183, 866, 2048)
    assert traffic["dialogue_tokens"] == [2, 64]
