"""Port vs reference on the fused kNN kernel module.

``repro_torch.kernels.knn.ops.knn`` on CPU tensors runs the kernel's plain
version (``knn_fused_plain``); ``repro.kernels.knn.ops.knn`` runs the Pallas
kernel in interpret mode. Integer-valued inputs in [-4, 4] with d <= 64
make every product and sum exact in f32, so values, indices, tie order
and (with equal blocks) the pruning skip count must be bit-identical.
Gaussian inputs agree within the reference's kernel tolerance (rtol=1e-5,
atol=1e-4), with indices equal wherever neighbouring scores are further
apart than that.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn import ops as jops
from repro.kernels.knn.kernel import knn_pallas
from repro_torch.kernels import build
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.knn import ops as tops
from repro_torch.kernels.knn.ref import knn_ref

RTOL, ATOL = 1e-5, 1e-4


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _pow2_rows(rng, n, d):
    """Rows of +-1 entries whose counts are powers of 4: their L2 norms are
    powers of two, so normalised rows and their dot products are exact."""
    x = np.zeros((n, d), np.float32)
    counts = rng.choice([1, 4, 16], n)
    for r, c in enumerate(counts):
        cols = rng.choice(d, c, replace=False)
        x[r, cols] = rng.choice([-1.0, 1.0], c)
    return x


def _inf_norms(x, rows):
    xn = (x.astype(np.float32) ** 2).sum(-1).astype(np.float32)
    xn[list(rows)] = np.inf
    return xn


def _port(q, x, k, metric, xn=None, **kw):
    out, sr = tops.knn(torch.from_numpy(q), torch.from_numpy(x), k, metric,
                       x_norms=None if xn is None else torch.from_numpy(xn),
                       return_stats=True, **kw)
    return out.scores.numpy(), out.indices.numpy(), float(sr)


def _jax(q, x, k, metric, xn=None, **kw):
    out, sr = jops.knn(jnp.asarray(q), jnp.asarray(x), k, metric,
                       x_norms=None if xn is None else jnp.asarray(xn),
                       return_stats=True, **kw)
    return np.asarray(out.scores), np.asarray(out.indices), float(sr)


def _assert_close_topk(v, i, rv, ri):
    """Scores within tolerance; indices equal where both neighbours of a
    slot are separated from it by more than the tolerance."""
    np.testing.assert_allclose(v, rv, rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(rv)
    gap = np.diff(rv, axis=-1)
    sep = np.ones(rv.shape, bool)
    sep[:, 1:] &= gap > 2 * tol[:, 1:]
    sep[:, :-1] &= gap > 2 * tol[:, :-1]
    assert sep.any()
    np.testing.assert_array_equal(i[sep], ri[sep])


# ----------------------------------------------- port vs reference kernel
# Five shapes at most: each new shape costs the reference an interpret-mode
# compile of a few seconds.
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_bit_identical_on_integer_data(metric):
    rng = np.random.default_rng(11)
    q, x = _ints(rng, (3, 40)), _ints(rng, (1100, 40))  # N ragged against bn
    x[600], x[900] = x[17], x[17]  # planted duplicates: exact score ties
    q[1] = x[17]
    xn = _inf_norms(x, (5, 17, 1099) if metric == "ip" else (5, 1099))
    blocks = dict(block_m=4, block_n=512, block_d=128)
    got = _port(q, x, 7, metric, xn, **blocks)
    want = _jax(q, x, 7, metric, xn, **blocks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 17 not in got[1] if metric == "ip" else 17 in got[1]


def test_knn_cos_bit_identical_on_pow2_rows():
    rng = np.random.default_rng(12)
    x, q = _pow2_rows(rng, 700, 64), _pow2_rows(rng, 2, 64)
    x[300] = x[40]
    x[10] = 0.0  # zero row: distance 1
    blocks = dict(block_m=2, block_n=512, block_d=128)
    got = _port(q, x, 64, "cos", **blocks)
    want = _jax(q, x, 64, "cos", **blocks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_knn_skip_count_matches_reference():
    """k=1 over 16 tiles with the query planted at row 3 and tied again at
    row 3000: the queue holds 0 after the first tile, tiles whose minimum
    is > 0 are pruned, and the tying tile is not (strict >)."""
    rng = np.random.default_rng(13)
    x = _ints(rng, (4000, 32))
    q = x[3:4].copy()
    x[3000] = q[0]
    blocks = dict(block_m=1, block_n=256, block_d=128)
    got = _port(q, x, 1, "l2", **blocks)
    want = _jax(q, x, 1, "l2", **blocks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].tolist() == [[3]]
    assert got[2] == pytest.approx(14 / 16)


def test_knn_gaussian_within_tolerance():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((900, 48)).astype(np.float32)
    q = (x[[1, 50, 400, 800, 899]] + 0.3 * rng.standard_normal((5, 48))).astype(np.float32)
    blocks = dict(block_m=8, block_n=512, block_d=128)
    v, i, sr = _port(q, x, 64, "l2", **blocks)
    rv, ri, rsr = _jax(q, x, 64, "l2", **blocks)
    _assert_close_topk(v, i, rv, ri)
    assert sr == rsr


# ------------------------------------------------- port vs its own oracle
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_knn_matches_dense_oracle(metric, k):
    rng = np.random.default_rng(k)
    make = _pow2_rows if metric == "cos" else (lambda r, n, d: _ints(r, (n, d)))
    x, q = make(rng, 1100, 40), make(rng, 5, 40)
    x[700] = x[3]
    dead = [3, 64, 1099]
    xn = _inf_norms(x, dead)
    v, i, _ = _port(q, x, k, metric, xn, block_n=512)
    live = np.setdiff1d(np.arange(1100), dead)
    rv, ri = knn_ref(torch.from_numpy(q), torch.from_numpy(x[live]), k, metric)
    np.testing.assert_array_equal(v, rv.numpy())
    np.testing.assert_array_equal(i, live[ri.numpy()])


def test_knn_bf16_and_small_n():
    rng = np.random.default_rng(15)
    x, q = _ints(rng, (300, 24)), _ints(rng, (4, 24))
    out = tops.knn(torch.from_numpy(q).bfloat16(), torch.from_numpy(x).bfloat16(), 7)
    rv, ri = knn_ref(torch.from_numpy(q), torch.from_numpy(x), 7)
    np.testing.assert_array_equal(out.scores.numpy(), rv.numpy())
    np.testing.assert_array_equal(out.indices.numpy(), ri.numpy())
    # fewer valid rows than k: the tail is (+inf, -1)
    out = tops.knn(torch.from_numpy(q), torch.from_numpy(x[:5]), 8)
    assert np.isinf(out.scores[:, 5:].numpy()).all()
    assert (out.indices[:, 5:] == -1).all()


# --------------------------------------- the split scan and the merge
@pytest.mark.parametrize("splits", [2, 3, 7])
def test_split_scan_and_merge_equal_one_sequential_queue(splits):
    """The card's design: S contiguous ranges of n-tiles, each with its own
    queue, then a merge. The result equals one sequential queue exactly."""
    rng = np.random.default_rng(splits)
    q = torch.from_numpy(_ints(rng, (8, 64)))
    x = torch.from_numpy(_ints(rng, (256 * 9, 64)))
    x[1000] = x[5]
    xn = torch.from_numpy(_inf_norms(x.numpy(), (7, 2000)))
    qn = torch.sum(q * q, dim=-1)
    want = K.knn_fused_plain(q, x, xn, 16, "l2", 4, 256, 64)
    sv, si, sk = K.knn_scan(q, x, qn, xn, 16, "l2", 4, 256, splits=splits)
    assert sv.shape == (8, splits, 16) and sk.shape == (2, splits)
    v, i = K.knn_merge(sv, si)
    assert torch.equal(v, want[0]) and torch.equal(i, want[1])
    unpruned = K.knn_scan(q, x, qn, xn, 16, "l2", 4, 256, prune=False, splits=splits)
    assert torch.equal(unpruned[0], sv) and torch.equal(unpruned[1], si)
    assert int(unpruned[2].sum()) == 0


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_plain_matches_pallas_at_the_card_blocks(metric):
    """The blocks the card's f32 scan takes at GIST (bm = 16 whatever k,
    k_eff = 1024, bn = 1024): the plain scan (S = 1) is the TPU kernel bit
    for bit on integer data, skip counts included, and its split queues
    (S = 2 and 4) merge to the same queue. Rows nearest the queries come
    first, so that later tiles prune."""
    rng = np.random.default_rng(21)
    n, d, m, bm, bn, k = 4096, 32, 16, 16, 1024, 1024
    x = _ints(rng, (n, d))
    q = x[5] + _ints(rng, (m, d), -1, 2)
    key = ((x - x[5]) ** 2).sum(-1) if metric == "l2" else -(x @ x[5])
    x = x[np.argsort(key, kind="stable")]
    x[3000] = x[2]  # an exact tie across tiles
    xn = _inf_norms(x, (7, 2500))
    jv, ji, jsk = knn_pallas(jnp.asarray(q), jnp.asarray(x), jnp.asarray(xn)[None], k,
                                  metric, bm, bn, d, True, True)
    t = [torch.from_numpy(a) for a in (q, x, (q * q).sum(-1).astype(np.float32), xn)]
    v, i, sk = K.knn_scan_plain(*t, k, metric, bm, bn, True, 1)
    np.testing.assert_array_equal(v[:, 0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i[:, 0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    assert int(sk.sum()) > 0
    for splits in (2, 4):
        sv, si, _ = K.knn_scan_plain(*t, k, metric, bm, bn, True, splits)
        mv, mi = K.knn_merge(sv, si)
        assert torch.equal(mv, v[:, 0]) and torch.equal(mi, i[:, 0])


def test_wrappers_reject_what_the_kernel_does_not_take():
    q, x = torch.zeros(4, 128), torch.zeros(512, 128)
    xn = torch.zeros(512)
    K.knn_fused(q, x, xn, 8, "l2", 4, 512, 128)  # the legal call
    bad = [
        dict(q=torch.zeros(4, 128, dtype=torch.float64)),
        dict(q=torch.zeros(4, 128).bfloat16()),
        dict(xn=torch.zeros(511)),
        dict(k_eff=6),
        dict(k_eff=1024),
        dict(metric="cos"),
        dict(bm=3),
        dict(bn=384),
        dict(bd=96),
    ]
    base = dict(q=q, x=x, xn=xn, k_eff=8, metric="l2", bm=4, bn=512, bd=128)
    for change in bad:
        with pytest.raises(ValueError):
            K.knn_fused(**{**base, **change})
    with pytest.raises(ValueError):
        K.knn_merge(torch.zeros(2, 3, 6), torch.zeros(2, 3, 6, dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version_and_never_build():
    K.reset_launch_counts()
    rng = np.random.default_rng(16)
    tops.knn(torch.from_numpy(_ints(rng, (2, 16))), torch.from_numpy(_ints(rng, (50, 16))), 3)
    assert K.LAUNCHES == dict.fromkeys(("knn_scan", "knn_merge", "knn_int8_scan", "topk",
                                        "l2dist"), 0)
    assert build._lib is None


def test_resolved_blocks():
    # bn grows to the queue, bd divides the padded dim, bm follows the batch
    assert tops.resolved_blocks(1024, 960, m=16) == (16, 1024, 512)
    assert tops.resolved_blocks(72, 769, m=1) == (1, 512, 128)
    assert tops.resolved_blocks(10, 100, m=128) == (16, 512, 128)
    assert tops.resolved_blocks(10, 100, block_m=4, m=3) == (4, 512, 128)
    assert tops.DEFAULT_BLOCKS == jops.DEFAULT_BLOCKS
    # the queues live in device memory: bm is the scoring's 16 at every k,
    # and two blocks of bm = 16 share an SM with 256 survivor lanes a row
    assert K.max_block_m() == 16
    assert 2 * (K.scan_smem_bytes(16, 256) + 1024) <= 233_472
    assert 2 * (K.scan_smem_bytes(16, 512) + 1024) > 233_472
