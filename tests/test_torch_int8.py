"""Port vs reference on the certified int8 tier.

Inputs are made with numpy from a seed and handed to both packages. The
reference's Pallas int8 scan runs in interpret mode. Where the port must
scan the reference's own codes, ``repro_torch.convert.quantized_from_numpy``
carries them over. "Integer data" is integer queries against integer rows
whose largest entry is ±127: each row's scale is exactly 1 and its codes
are the row, so every dot product, norm and distance is an exact integer
and the only roundings left (sqrt, the square of the bound) are single IEEE
operations in both packages. There the scan's lower bounds, indices, skip
counts and certificates must be bit-identical. (With an inexact scale the
reference's CPU compiler may fuse ``qn - 2·acc·scale`` into an FMA, one ulp
away from separately rounded operations.) Gaussian inputs agree within the
reference's kernel tolerance (rtol=1e-5, atol=1e-4).

Every ``QUANT_CASES`` entry goes through ``ExactKNN(..., device="cpu")`` on
both int8 executors and must come back bit-identical to the port's own
``knn_exact_direct`` oracle (certified rows through the rescore, the others
through the fallback), with the reference's indices.
"""
from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_cases import QUANT_CASES as CASES
from repro.api.types import SearchRequest as JRequest
from repro.core import ExactKNN as JExactKNN
from repro.core import planner as jplanner
from repro.core.quantized import int8_lower_bounds as jint8_lower_bounds
from repro.core.quantized import knn_quantized as jknn_quantized
from repro.core.quantized import quantize_dataset as jquantize
from repro.kernels.knn import ops as jops
from repro.kernels.knn.kernel_int8 import knn_pallas_int8
from repro_torch import ExactKNN, SearchRequest
from repro_torch.convert import engine_state_from_jax, quantized_from_numpy
from repro_torch.core import executors as tex
from repro_torch.core import planner as tplanner
from repro_torch.core.quantized import int8_lower_bounds, knn_quantized, quantize_dataset
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.knn import ops as tops
from repro_torch.store import DatasetStore

RTOL, ATOL = 1e-5, 1e-4


def _np(t):
    return np.asarray(t)


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _unit_scale_rows(rng, n, d):
    """Integer rows in [-127, 127] with one entry at ±127: scale 1, error 0."""
    x = _ints(rng, (n, d), -127, 128)
    x[np.arange(n), rng.integers(0, d, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


def _both_quantized(x):
    """The reference's quantisation of x, and the same arrays in the port."""
    jq = jquantize(jnp.asarray(x))
    return jq, quantized_from_numpy(*jq, device="cpu")


def _engine_oracle(eng: ExactKNN, q):
    """The port's direct-form full-sort oracle over the engine's padded
    state (the shapes the executors scan, so bitwise comparable)."""
    qv = eng._pad_queries(q)
    ds = eng._ds
    return tops.knn_exact_direct(qv, ds.vectors, ds.norms, eng.k, int(ds.vectors.shape[0]))


# ------------------------------------------------------------ quantisation
@pytest.mark.parametrize("data", ["gaussian", "wide_range"])
def test_quantize_matches_reference(data):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4096, 96)).astype(np.float32)
    if data == "wide_range":
        x *= 10.0 ** rng.uniform(-4, 4, (4096, 1)).astype(np.float32)
    x[7] = 0.0  # an all-zero row: scale 1, codes 0
    jq = jquantize(jnp.asarray(x))
    tq = quantize_dataset(torch.from_numpy(x), chunk_rows=1000)  # ragged chunks
    for name in ("q", "scales", "qnorm_sq"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), _np(getattr(jq, name)))
    for name in ("err", "norms_sq"):
        np.testing.assert_allclose(getattr(tq, name).numpy(), _np(getattr(jq, name)),
                                   rtol=1e-6)
    whole = quantize_dataset(torch.from_numpy(x), chunk_rows=1 << 16)
    assert all(torch.equal(a, b) for a, b in zip(tq, whole))  # rows are independent


def test_store_int8_tier():
    rng = np.random.default_rng(12)
    store = DatasetStore.from_array(rng.standard_normal((300, 40)).astype(np.float32))
    assert not store.has_tier("int8") and store.has_tier("f32")
    with pytest.raises(RuntimeError, match="ensure_tier"):
        store.int8_resident()
    with pytest.raises(ValueError, match="tier"):
        store.ensure_tier("int4")
    store.ensure_tier("int8")
    i8 = store.int8_resident()
    assert store.has_tier("int8") and i8.q.dtype == torch.int8
    assert i8.q.shape == (store.rows_per_shard, store.padded_dim)
    assert torch.isinf(i8.norms_sq[300:]).all() and torch.isfinite(i8.norms_sq[:300]).all()
    assert (i8.scales[300:] == 1).all() and (i8.err[300:] == 0).all()
    store.ensure_tier("int8")  # idempotent
    assert store.int8_resident() is i8
    assert store.int8_resident_norms() is i8.norms_sq


# ------------------------------------------------------------ int8 scan
def _scan_inputs(rng, n, n_rows, d, m, near_first=False, q0_row=5):
    x = _unit_scale_rows(rng, n, d)
    x[n // 2] = x[5]  # exact ties
    q = _ints(rng, (m, d), -40, 41)
    if near_first:  # queries close together, rows nearest to them first: tiles prune
        q = x[5] + _ints(rng, (m, d), -2, 3)
        x = x[np.argsort(((x - x[5]) ** 2).sum(-1), kind="stable")]
    q[0] = x[q0_row]  # near_first, q0_row 0: the old x[5] (row 1 is its duplicate)
    jq = jquantize(jnp.asarray(x))
    hn = np.where(np.isfinite(_np(jq.norms_sq)), _np(jq.qnorm_sq), np.inf).astype(np.float32)
    hn[[3, n - 1]] = np.inf  # invalid rows
    pad = n_rows - n
    chan = (np.pad(_np(jq.scales), (0, pad), constant_values=1.0),
            np.pad(_np(jq.err), (0, pad)), np.pad(hn, (0, pad), constant_values=np.inf))
    return q, _np(jq.q), (q.astype(np.float32) ** 2).sum(-1).astype(np.float32), chan


@pytest.mark.parametrize("n,m,bm,bn,q_len,q0_row", [
    (1900, 8, 4, 512, 64, 5),
    # the blocks the card's int8 kernel takes at m = 16 (bm = 16 whatever
    # q_len), with every query near the first rows, so that all 16 prune
    (1900, 16, 16, 512, 64, 0),  # small k
    (3000, 16, 16, 1024, 1024, 0),  # MS-MARCO: k = 72
    (20_000, 16, 16, 8192, 8192, 0),  # GIST: k = 1024, the widest queue
])
def test_int8_scan_plain_matches_pallas_bitwise(n, m, bm, bn, q_len, q0_row):
    """Integer queries, int8 codes: the plain scan (S = 1) is the TPU
    kernel bit for bit — bounds, indices and skip counts — also over codes
    whose row count is not a multiple of bn (the port never pads them)."""
    rng = np.random.default_rng(13)
    n_rows, d = -(-n // bn) * bn, 64
    q, x8, qn, (sc, er, hn) = _scan_inputs(rng, n, n_rows, d, m, near_first=True,
                                           q0_row=q0_row)
    x8p = np.pad(x8, ((0, n_rows - n), (0, 0)))
    jv, ji, jsk = knn_pallas_int8(
        jnp.asarray(q), jnp.asarray(x8p), jnp.asarray(qn)[:, None], jnp.asarray(sc)[None],
        jnp.asarray(er)[None], jnp.asarray(hn)[None], q_len, bm, bn, d, True, True)
    t = [torch.from_numpy(np.array(a)) for a in (q, x8, qn, sc, er, hn)]
    v, i, sk = K.knn_int8_scan_plain(*t, q_len, bm, bn, True, 1)
    np.testing.assert_array_equal(v[:, 0].numpy(), _np(jv))
    np.testing.assert_array_equal(i[:, 0].numpy(), _np(ji))
    np.testing.assert_array_equal(sk.numpy(), _np(jsk))
    assert int(sk.sum()) > 0
    # the split scan's merged queues are the sequential queue (entry r too)
    sv, si, _ = K.knn_int8_scan_plain(*t, q_len, bm, bn, True, 3)
    mv, mi = K.knn_merge(sv, si)
    assert torch.equal(mv, v[:, 0]) and torch.equal(mi, i[:, 0])


def test_int8_block_rule_follows_the_scoring_not_the_queue():
    """The card's int8 kernel keeps its queues in device memory, so bm is
    its scoring's 16 at every q_len (GIST: q_len 8192; MS-MARCO: 1024), as
    the f32 kernel does at every k."""
    assert K.int8_max_block_m() == 16
    assert tops.resolved_blocks(1024, 960, m=16, rescore_factor=4) == (16, 8192, 512)
    assert tops.resolved_blocks(72, 769, m=16, rescore_factor=4) == (16, 1024, 128)
    assert tops.resolved_blocks(10, 64, m=3, rescore_factor=4) == (4, 512, 128)
    assert tops.resolved_blocks(1024, 960, m=16) == (16, 1024, 512)
    # two blocks of bm = 16 share an SM with 256 survivor lanes a row; a
    # grid of at most one block per SM takes the largest buffer, 1024
    assert 2 * (K.int8_scan_smem_bytes(16, 256) + 1024) <= 233_472
    assert 2 * (K.int8_scan_smem_bytes(16, 512) + 1024) > 233_472
    assert K.int8_survivor_cap(16, 264, 132) == 256
    assert K.int8_survivor_cap(16, 123, 132) == 1024
    assert K.int8_scan_smem_bytes(16, 1024) <= 232_448
    assert K.int8_survivor_cap(1, 10, 132) == 1024


def test_int8_scan_wrapper_checks():
    rng = np.random.default_rng(14)
    q, x8, qn, chan = _scan_inputs(rng, 600, 1024, 32, 4)
    t = dict(zip(("q", "x8", "qn", "scales", "err", "hn"),
                 (torch.from_numpy(np.array(a)) for a in (q, x8, qn, *chan))))
    base = dict(t, q_len=64, bm=4, bn=512)
    K.reset_launch_counts()
    K.knn_int8_scan(**base)
    assert sum(K.LAUNCHES.values()) == 0  # CPU tensors: the plain version
    for change in ({"bm": 3}, {"bn": 384}, {"q_len": 1024}, {"q_len": 48},
                   {"hn": t["hn"][:600]}, {"x8": t["x8"].to(torch.int16)},
                   {"q": t["q"].to(torch.bfloat16)}):
        with pytest.raises(ValueError):
            K.knn_int8_scan(**{**base, **change})


# --------------------------------------------------------- int8 wrappers
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "gaussian"])
def test_knn_int8_matches_reference(integer):
    rng = np.random.default_rng(15)
    if integer:
        x, q = _unit_scale_rows(rng, 1500, 64), _ints(rng, (8, 64), -40, 41)
    else:
        x = rng.standard_normal((1500, 64)).astype(np.float32)
        q = rng.standard_normal((8, 64)).astype(np.float32)
    x[900] = x[12]
    jq, tq = _both_quantized(x)
    jout, jcert, jsr = jops.knn_int8(jnp.asarray(q), jq, jnp.asarray(x), 10, block_m=8,
                                     return_stats=True, interpret=True)
    out, cert, sr = tops.knn_int8(torch.from_numpy(q), tq, torch.from_numpy(x), 10,
                                  block_m=8, return_stats=True)
    assert tops.resolved_blocks(10, 64, block_m=8, m=8, rescore_factor=4) == (8, 512, 128)
    if integer:
        np.testing.assert_array_equal(out.scores.numpy(), _np(jout.scores))
        np.testing.assert_array_equal(out.indices.numpy(), _np(jout.indices))
        np.testing.assert_array_equal(cert.numpy(), _np(jcert))
        assert float(sr) == float(jsr)
    else:
        np.testing.assert_allclose(out.scores.numpy(), _np(jout.scores), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(out.indices.numpy(), _np(jout.indices))


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "gaussian"])
def test_knn_quantized_matches_reference(integer):
    rng = np.random.default_rng(16)
    if integer:
        x, q = _unit_scale_rows(rng, 700, 48), _ints(rng, (5, 48), -40, 41)
    else:
        x = rng.standard_normal((700, 48)).astype(np.float32)
        q = rng.standard_normal((5, 48)).astype(np.float32)
    x[:3] = x[100]  # ties
    jq, tq = _both_quantized(x)
    jout, jcert = jknn_quantized(jnp.asarray(q), jq, jnp.asarray(x), 7)
    out, cert = knn_quantized(torch.from_numpy(q), tq, torch.from_numpy(x), 7)
    np.testing.assert_array_equal(cert.numpy(), _np(jcert))
    np.testing.assert_array_equal(out.indices.numpy(), _np(jout.indices))
    if integer:
        np.testing.assert_array_equal(out.scores.numpy(), _np(jout.scores))
    else:
        np.testing.assert_allclose(out.scores.numpy(), _np(jout.scores), rtol=RTOL, atol=ATOL)


def test_int8_lower_bounds_match_reference():
    rng = np.random.default_rng(21)
    x, q = _unit_scale_rows(rng, 300, 40), _ints(rng, (4, 40), -40, 41)
    jq, tq = _both_quantized(x)
    qnorm = np.array(jq.qnorm_sq)
    qnorm[[7, 299]] = np.inf  # invalid rows: +inf bound, index -1
    jl, ji = jint8_lower_bounds(jnp.asarray(q), jq.q, jq.scales, jq.err, jnp.asarray(qnorm), 50)
    tl, ti = int8_lower_bounds(torch.from_numpy(q), tq.q, tq.scales, tq.err,
                               torch.from_numpy(qnorm), 50)
    np.testing.assert_array_equal(tl.numpy(), _np(jl))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    assert ti[7] == -1 and torch.isinf(tl[:, 7]).all()


def test_knn_int8_prune_is_bit_identical():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    x = x[np.argsort(((x - x[0]) ** 2).sum(-1))]  # near rows first: the queue warms early
    q = x[:4] + 0.01
    _, tq = _both_quantized(x)
    args = (torch.from_numpy(q), tq, torch.from_numpy(x), 5)
    r1, c1, sr = tops.knn_int8(*args, block_n=256, return_stats=True)
    r0, c0 = tops.knn_int8(*args, block_n=256, prune=False)
    assert torch.equal(r1.scores, r0.scores) and torch.equal(r1.indices, r0.indices)
    assert torch.equal(c1, c0) and 0.0 < float(sr) <= 1.0


def test_aligned_quantization_error_keeps_true_neighbour():
    q, x, k = CASES["aligned_quantization_error"]()
    _, tq = _both_quantized(x)
    out, cert = tops.knn_int8(torch.from_numpy(q), tq, torch.from_numpy(x), k)
    assert bool(cert.all()) and int(out.indices[0, 0]) == 0
    assert abs(float(out.scores[0, 0])) <= 1e-3
    out, cert = knn_quantized(torch.from_numpy(q), tq, torch.from_numpy(x), k)
    assert bool(cert.all()) and int(out.indices[0, 0]) == 0


# ------------------------------------------------------ engine, executors
@functools.lru_cache(maxsize=None)
def _reference_indices(name):
    """The reference's answer: its direct-form oracle over its own padded
    engine state (its int8 executors are held bit-identical to that oracle
    by tests/test_int8_pallas.py; the oracle skips their interpret-mode
    compile)."""
    q, x, k = CASES[name]()
    eng = JExactKNN(k=k).fit(x)
    vec = eng._ds.vectors
    out = jops.knn_exact_direct(eng._pad_queries(q), vec, eng._ds.norms, k, int(vec.shape[0]))
    return _np(out.indices)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_int8_exact_on_quant_cases(name, backend):
    q, x, k = CASES[name]()
    eng = ExactKNN(k=k, backend=backend, device="cpu").fit(x).enable_int8()
    res = eng.search(SearchRequest(queries=q, tier="int8"))
    assert res.plan.executor == f"fqsd-int8-{backend}" and res.tier == "int8"
    oracle = _engine_oracle(eng, q)
    assert torch.equal(res.topk.scores, oracle.scores)
    assert torch.equal(res.topk.indices, oracle.indices)
    np.testing.assert_array_equal(res.topk.indices.numpy(), _reference_indices(name))
    cert = eng.last_certificate
    assert cert.shape == (q.shape[0],) and cert.dtype == torch.bool
    assert res.certified is cert
    if backend == "cuda":
        assert res.kernel_stats["blocks"][1] >= tops.int8_queue(k, 4)[1]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_uncertified_rows_fall_back_to_the_exact_scan(backend):
    """Query 0 sits on a tight cluster of exactly k rows: it certifies.
    Query 1 sits at the centre of a shell of 30 rows at one radius: its
    k-th and (r+1)-th neighbours are too close for the bounds to separate,
    so it does not, and the executor recomputes it. Every row still has the
    oracle's bits."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1024, 96)).astype(np.float32)
    q = rng.standard_normal((4, 96)).astype(np.float32)
    x[:10] = q[0] + 1e-3 * x[:10]
    u = rng.standard_normal((30, 96))
    x[10:40] = q[1] + 2.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    eng = ExactKNN(k=10, backend=backend, device="cpu", rescore_factor=1).fit(x).enable_int8()
    res = eng.search(SearchRequest(queries=q, tier="int8"))
    assert bool(res.certified[0]) and not bool(res.certified[1])
    assert res.plan.rescore_factor == 1
    oracle = _engine_oracle(eng, q)
    assert torch.equal(res.topk.scores, oracle.scores)
    assert torch.equal(res.topk.indices, oracle.indices)


def test_int8_filter_mask_and_shim():
    rng = np.random.default_rng(18)
    x = rng.standard_normal((900, 40)).astype(np.float32)
    q = rng.standard_normal((5, 40)).astype(np.float32)
    mask = rng.random(900) > 0.5
    eng = ExactKNN(k=6, backend="cuda", device="cpu").fit(x).enable_int8()
    res = eng.search(SearchRequest(queries=q, tier="int8", filter_mask=mask))
    assert mask[res.topk.indices.numpy()].all()
    ds = eng._ds
    norms = ds.norms.clone()
    norms[: 900][~torch.from_numpy(mask)] = torch.inf
    want = tops.knn_exact_direct(eng._pad_queries(q), ds.vectors, norms, 6,
                                 int(ds.vectors.shape[0]))
    assert torch.equal(res.topk.scores, want.scores)
    assert torch.equal(res.topk.indices, want.indices)
    with pytest.warns(DeprecationWarning):
        got = eng.query_batch_int8(q)
    assert torch.equal(got.indices, eng.search(SearchRequest(queries=q, tier="int8")).indices)


def test_int8_tier_rules():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    eng = ExactKNN(k=3, device="cpu").fit(x)
    with pytest.raises(RuntimeError, match="enable_int8"):
        eng.search(SearchRequest(queries=q, tier="int8"))
    assert not eng.has_int8 and eng.enable_int8() is eng and eng.has_int8
    with pytest.raises(ValueError, match="fdsq"):
        eng.search(SearchRequest(queries=q, tier="int8", mode_hint="fdsq"))
    with pytest.raises(ValueError, match="l2"):
        eng.search(SearchRequest(queries=q, tier="int8", metric="ip"))
    with pytest.raises(ValueError, match="l2"):
        ExactKNN(k=3, metric="ip", device="cpu").fit(x).enable_int8()
    with pytest.raises(ValueError, match="rescore_factor"):
        ExactKNN(k=3, device="cpu", rescore_factor=0)
    # a tiny batch still takes the FQ-SD int8 plan; an f32 search after it
    # reports no certificate
    assert eng.search(SearchRequest(queries=q[:1], tier="int8")).plan.mode == "fqsd-int8"
    eng.search(SearchRequest(queries=q))
    assert eng.last_certificate is None
    jeng = JExactKNN(k=3).fit(x)
    with pytest.raises(RuntimeError, match="DatasetStore"):
        engine_state_from_jax(jeng, device="cpu").enable_int8()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_int8_plan_matches_reference(backend):
    kw = dict(padded_rows=1000448, padded_dim=1024, n_valid=1000000, tier="int8",
              rows_per_shard=1000448)
    tp = tplanner.plan((16, 1024), tplanner.DatasetStoreMeta(**kw),
                       tplanner.EngineConfig(k=10, backend=backend), "fqsd", k=12)
    jp = jplanner.plan((16, 1024), jplanner.DatasetStoreMeta(**kw),
                       jplanner.EngineConfig(k=10, backend={"torch": "xla",
                                                            "cuda": "pallas"}[backend]),
                       "fqsd", k=12)
    names = {"fqsd-int8-torch": "fqsd-int8", "fqsd-int8-cuda": "fqsd-int8-pallas"}
    got = dataclasses.asdict(tp)
    got["executor"], got["backend"] = names[got["executor"]], jp.backend
    assert got == dataclasses.asdict(jp)
    assert tp.executor in tplanner.PLANNABLE_EXECUTORS
    assert tp.executor in tex.list_executors()
    fdsq = tplanner.plan((16, 1024), tplanner.DatasetStoreMeta(**kw),
                         tplanner.EngineConfig(k=10, backend=backend), "fdsq")
    assert fdsq.tier == "f32"  # int8 serves FQ-SD only


def test_engine_state_from_jax_carries_int8():
    rng = np.random.default_rng(20)
    x, q = _unit_scale_rows(rng, 1100, 48), _ints(rng, (6, 48), -40, 41)
    x[700] = x[3]
    jeng = JExactKNN(k=9, rescore_factor=2).fit(x).enable_int8()
    eng = engine_state_from_jax(jeng, device="cpu")
    assert eng.has_int8 and eng.rescore_factor == 2
    for a, b in zip(eng._int8, jeng._int8):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    got = eng.search(SearchRequest(queries=q, tier="int8"))
    want = jeng.search(JRequest(queries=q, tier="int8"))
    np.testing.assert_array_equal(got.topk.scores.numpy(), _np(want.topk.scores))
    np.testing.assert_array_equal(got.topk.indices.numpy(), _np(want.topk.indices))
    np.testing.assert_array_equal(got.certified.numpy(), _np(want.certified))


def _rescored_cases():
    """(queries, padded rows, norms, k) where the f32 kernel's candidates
    certify (clustered rows, integer ties, Gaussian, fewer rows than k,
    an excluded row) and where they cannot (every row equal)."""
    from repro_torch.core.partition import make_padded
    from repro_torch.data import query_stream, vector_dataset

    rng = np.random.default_rng(8)
    xc = vector_dataset(20_000, 96, seed=0)
    xi = _ints(rng, (6000, 32))
    qi = _ints(rng, (8, 32))
    xg = rng.standard_normal((5000, 200)).astype(np.float32)
    raw = {"clustered": (query_stream(xc, 16, seed=1), xc, 100, 0),
           "integer_ties": (qi, xi, 50, 0),
           "gaussian": (xg[:5] + np.float32(0.01), xg, 7, 0),
           "fewer_rows_than_k": (qi, xi[:30], 64, 0),
           "all_equal": (xi[:3], np.repeat(xi[:1], 3000, 0), 40, 3)}
    out = {}
    for name, (q, x, k, fallback) in raw.items():
        p = make_padded(torch.from_numpy(x), row_mult=1024)
        norms = p.norms.clone()
        norms[5] = torch.inf  # an excluded row
        qv = torch.nn.functional.pad(torch.from_numpy(q), (0, p.vectors.shape[1] - q.shape[1]))
        out[name] = (qv, p.vectors, norms, k, fallback)
    return out


RESCORED = _rescored_cases()


@pytest.mark.parametrize("name", sorted(RESCORED))
def test_rescored_fallback_has_the_direct_oracles_bits(name, monkeypatch):
    """knn_exact_rescored (the f32 kernel's 2·k_eff candidates in the
    cancellation form, rescored in the direct form and certified by the
    rounding bound) gives knn_exact_direct's answer bit for bit; only rows
    the bound cannot separate (every row equal) take knn_exact_direct."""
    qv, x, norms, k, fallback = RESCORED[name]
    want = tops.knn_exact_direct(qv, x, norms, k, 1024)
    direct = tops.knn_exact_direct
    rows = []

    def counted(q, *a, **kw):
        rows.append(q.shape[0])
        return direct(q, *a, **kw)

    monkeypatch.setattr(tops, "knn_exact_direct", counted)
    got = tops.knn_exact_rescored(qv, x, norms, k, 1024)
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)
    assert sum(rows) == fallback


def test_rescored_fallback_matches_the_reference_oracle():
    """On integer rows the port's rescored fallback equals the reference's
    direct-form oracle in values and indices."""
    qv, x, norms, k, _ = RESCORED["integer_ties"]
    got = tops.knn_exact_rescored(qv, x, norms, k, 1024)
    want = jops.knn_exact_direct(jnp.asarray(qv.numpy()), jnp.asarray(x.numpy()),
                                 jnp.asarray(norms.numpy()), k, 1024)
    np.testing.assert_array_equal(got.scores.numpy(), _np(want.scores))
    np.testing.assert_array_equal(got.indices.numpy(), _np(want.indices))


def test_cuda_int8_executor_recomputes_clustered_rows_exactly():
    """Clustered rows, d = 960, k = 64: clusters hold more rows than the
    rescore budget r = 256 and their distances concentrate, so the int8
    certificate fails for some rows (the quantisation error exceeds the gap
    between the k-th and the (r+1)-th neighbour); fqsd-int8-cuda recomputes
    them through knn_exact_rescored, and every row has the direct oracle's
    bits."""
    from repro_torch.data import query_stream, vector_dataset

    x = vector_dataset(40_000, 960, seed=0)
    q = query_stream(x, 16, seed=1)
    eng = ExactKNN(k=64, backend="cuda", device="cpu").fit(x).enable_int8()
    res = eng.search(SearchRequest(queries=q, tier="int8"))
    assert res.plan.executor == "fqsd-int8-cuda"
    assert not bool(res.certified.all())
    oracle = _engine_oracle(eng, q)
    assert torch.equal(res.topk.scores, oracle.scores)
    assert torch.equal(res.topk.indices, oracle.indices)
