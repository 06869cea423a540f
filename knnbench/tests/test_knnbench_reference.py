"""The reference against brute force, and the comparison's numbers."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from knnbench import compare, data, reference
from knnbench.tests.conftest import tiny


def brute(x: np.ndarray, q: np.ndarray, k: int):
    """Every distance in float64 directly, sorted by (distance, id)."""
    d = ((q[:, None, :].astype(np.float64) - x[None, :, :].astype(np.float64)) ** 2).sum(-1)
    ids = np.stack([np.lexsort((np.arange(x.shape[0]), row))[:k] for row in d])
    return np.take_along_axis(d, ids, 1), ids, d


@pytest.mark.parametrize("noise, ip", [(0.0, False), (0.5, False), (0.5, True)])
def test_exact_matches_brute_force_with_ties(noise, ip):
    cfg = tiny(n=1500, d=8, noise=noise, block_rows=256, ip_as_l2=ip)
    x = data.dataset(cfg, 11, "cpu").numpy()
    q = data.queries(cfg, 11, 9, "cpu")
    if noise == 0.0:
        assert len(np.unique(x, axis=0)) <= 7  # rows repeat: distances tie
        q = torch.as_tensor(x[[0, 5, 17]])
    k = 40
    want_d, want_i, full = brute(x, q.numpy(), k)
    judge = torch.as_tensor(want_i[:, ::-1].copy())
    got = reference.exact(cfg, 11, q, k, judge)
    assert np.array_equal(got["ids"].numpy(), want_i)
    np.testing.assert_allclose(got["dist"].numpy(), want_d, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["judged"].numpy(), want_d[:, ::-1], rtol=0, atol=1e-9)
    if noise == 0.0:
        assert (got["dist"].numpy()[:, :-1] == got["dist"].numpy()[:, 1:]).any()


def test_the_reference_refuses_a_metric_it_does_not_compute():
    cfg = dict(tiny(n=300, d=4), metric="cos")
    q = data.queries(cfg, 3, 2, "cpu")
    with pytest.raises(ValueError):
        reference.exact(cfg, 3, q, 5)
    with pytest.raises(ValueError):
        reference.lower_precision(cfg, 3, q, 5)


def test_judged_is_nan_outside_the_rows():
    cfg = tiny(n=600, d=4)
    q = data.queries(cfg, 3, 2, "cpu")
    got = reference.exact(cfg, 3, q, 5, torch.tensor([[0, 599], [600, -1]]))
    j = got["judged"].numpy()
    assert np.isfinite(j[0]).all() and np.isnan(j[1]).all()


def test_lower_precision_is_the_search_in_tf32():
    cfg = tiny(n=2000, d=64, block_rows=512)
    q = data.queries(cfg, 5, 16, "cpu")
    s, i = reference.lower_precision(cfg, 5, q, 10)
    ref = reference.exact(cfg, 5, q, 10, i)
    err = np.abs(s.numpy() - ref["judged"].numpy()) / ref["scale"].numpy()[:, None]
    assert 1e-6 < err.max() < 1e-2  # TF32's 10-bit products, not f32's rounding
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 3.0])
    assert reference._tf32(t).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


def _answers(cfg, seed, k, m=6):
    q = data.queries(cfg, seed, m, "cpu")
    ref = reference.exact(cfg, seed, q, k, None)
    ids = ref["ids"].numpy()
    scores = ref["dist"].numpy().astype(np.float32)
    return q, ids, scores


def _numbers(cfg, seed, q, scores, ids, unanswered=0):
    k = ids.shape[1]
    ref = reference.exact(cfg, seed, q, k, torch.as_tensor(ids))
    ref = {key: v.numpy() for key, v in ref.items() if key != "ids"}
    return compare.numbers(scores, ids, cfg["n"], ref, unanswered)


def test_numbers_of_a_right_answer_are_rounding():
    cfg = tiny(n=2000, d=32)
    q, ids, scores = _answers(cfg, 8, 20)
    nums = _numbers(cfg, 8, q, scores, ids)
    assert nums["malformed"] == 0 and nums["unanswered"] == 0
    assert nums["score_err"] < 1e-6 and nums["rank_err"] == 0.0


@pytest.mark.parametrize("fault", ["swap_id", "drop_neighbour", "out_of_order", "repeat",
                                   "tie_order", "nan"])
def test_numbers_catch_a_wrong_answer(fault):
    cfg = tiny(n=2000, d=32)
    q, ids, scores = _answers(cfg, 8, 20)
    ids, scores = ids.copy(), scores.copy()
    if fault == "swap_id":
        ids[0, 3] = (ids[0, 3] + 1000) % cfg["n"]
    elif fault == "drop_neighbour":  # the 21st row in place of the 1st, all shifted
        ref = reference.exact(cfg, 8, q, 21, None)
        ids[0] = ref["ids"].numpy()[0, 1:]
        scores[0] = ref["dist"].numpy()[0, 1:]
    elif fault == "out_of_order":
        ids[1, [0, 1]] = ids[1, [1, 0]]
        scores[1, [0, 1]] = scores[1, [1, 0]]
    elif fault == "repeat":
        ids[2, 5] = ids[2, 4]
    elif fault == "tie_order":
        scores[3, 1] = scores[3, 0]
        ids[3, [0, 1]] = np.sort(ids[3, [0, 1]])[::-1]
    else:
        scores[4, 2] = np.nan
    nums = _numbers(cfg, 8, q, scores, ids)
    ok, checks = compare.judge(nums, {"unanswered": 0, "malformed": 0,
                                      "score_err": 1e-5, "rank_err": 1e-5})
    assert not ok, checks
