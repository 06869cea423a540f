"""The comparison that decides ``correct``.

Each answered request of the sample is judged row by row against the
reference (reference.py): the program's distances against the exact
distances of the ids it returned, and its ids against the true k nearest.

    unanswered  requests of the window that never got an answer or failed
    malformed   rows with an id outside the rows or repeated, a distance
                that is not finite or out of ascending order, or equal
                distances whose ids are not ascending (ties go to the
                smaller id)
    score_err   the largest |returned distance - exact distance of the
                returned id|, over |q|^2 + mean |x|^2
    rank_err    the largest |exact distance of the j-th returned id - the
                j-th smallest exact distance|, on the same scale: a row that
                is missed or a worse row returned shows here

The first two are exact (limit 0). The last two are rounding: an f32
expanded-form distance is off by about 1e-7 of the scale; the limits come
from readings of the program and of the TF32 control (PERF.md).
"""
from __future__ import annotations

import numpy as np


def malformed_rows(scores: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """(R,) bool: the rows of (R, k) answers that break the answer's form."""
    bad = ~np.isfinite(scores).all(1)
    bad |= ((ids < 0) | (ids >= n)).any(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    ds = np.diff(scores, axis=1)
    bad |= (ds < 0).any(1)
    bad |= ((ds == 0) & (np.diff(ids, axis=1) < 0)).any(1)
    return bad


def numbers(scores: np.ndarray, ids: np.ndarray, n: int, ref: dict,
            unanswered: int) -> dict:
    """The compared numbers for answer rows (R, k) and the reference's
    ``dist`` / ``judged`` / ``scale`` of the same rows (numpy)."""
    bad = malformed_rows(scores, ids, n)
    good = ~bad
    scale = ref["scale"][:, None]
    if good.any():
        judged = ref["judged"][good]
        score_err = float(np.max(np.abs(scores[good] - judged) / scale[good]))
        rank_err = float(np.max(np.abs(judged - ref["dist"][good]) / scale[good]))
    else:
        score_err = rank_err = float("nan")
    return {"unanswered": int(unanswered), "malformed": int(bad.sum()),
            "score_err": score_err, "rank_err": rank_err}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or below its limit (a NaN is not)."""
    checks = {name: {"value": nums[name], "limit": limits[name]} for name in nums}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
