"""Port vs reference on the standalone l2dist and topk kernels.

``repro_torch.kernels.l2dist.ops.l2dist`` and ``...topk.ops.topk`` on CPU
tensors run their kernels' plain versions; the reference's
``l2dist_pallas`` and ``topk_pallas`` run in interpret mode. The
reference's ``topk`` wrapper raises NameError (ROADMAP C), so its kernel is
called directly with the wrapper's padding: N padded with +inf to the
n-block, indices past N mapped to -1. Integer-valued inputs make every
distance exact in f32 (bf16 holds integers up to 256 exactly), so l2dist
is bit-identical there; Gaussian inputs agree within the reference's
kernel tolerance (rtol=1e-5, atol=1e-4). topk moves values without
arithmetic, so it is bit-identical on every input, ties and -0.0/+0.0
included (no subnormal scores: ROADMAP C).
"""
from __future__ import annotations

import re
from pathlib import Path

import hypothesis
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import strategies as st

from repro.kernels.l2dist.kernel import l2dist_pallas
from repro.kernels.l2dist.ops import l2dist as jl2dist
from repro.kernels.l2dist.ref import l2dist_ref as jl2dist_ref
from repro.kernels.topk.kernel import topk_pallas
from repro.kernels.topk.ref import topk_ref as jtopk_ref
from repro_torch.core.topk import pair_keys, sort_pairs, topk_smallest
from repro_torch.data.merge_cases import KINDS, merge_queues
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.l2dist import kernel as L
from repro_torch.kernels.l2dist.kernel import l2dist_plain
from repro_torch.kernels.l2dist.ops import l2dist
from repro_torch.kernels.l2dist.ref import l2dist_ref
from repro_torch.kernels.topk import kernel as T
from repro_torch.kernels.topk.kernel import topk_scan, topk_scan_plain
from repro_torch.kernels.topk.ops import topk
from repro_torch.kernels.topk.ref import topk_ref

RTOL, ATOL = 1e-5, 1e-4
_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _port_in(a, dtype):
    return torch.from_numpy(np.array(a)).to(_DTYPES[dtype][0])


def _jax_in(a, dtype):
    return jnp.asarray(a, dtype=_DTYPES[dtype][1])


# ------------------------------------------------------------------ l2dist
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,d", [(3, 7, 5), (13, 300, 77), (16, 513, 96)])
def test_l2dist_bit_identical_on_integer_data(m, n, d, dtype):
    rng = np.random.default_rng(m * n + d)
    q = rng.integers(-8, 9, (m, d)).astype(np.float32)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    x[n // 2] = q[0]  # distance 0
    got = l2dist(_port_in(q, dtype), _port_in(x, dtype)).numpy()
    want = np.asarray(jl2dist(_jax_in(q, dtype), _jax_in(x, dtype)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, l2dist_ref(_port_in(q, dtype), _port_in(x, dtype)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jl2dist_ref(_jax_in(q, dtype), _jax_in(x, dtype))))
    assert got[0, n // 2] == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_l2dist_close_on_gaussian_data(dtype):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((9, 130)).astype(np.float32)
    x = rng.standard_normal((260, 130)).astype(np.float32)
    got = l2dist(_port_in(q, dtype), _port_in(x, dtype)).numpy()
    # the TPU kernel itself, on the blocks its wrapper would pick
    qp, xp = np.pad(q, ((0, 7), (0, 126))), np.pad(x, ((0, 252), (0, 126)))
    want = np.asarray(l2dist_pallas(_jax_in(qp, dtype), _jax_in(xp, dtype), 16, 256, 256,
                                    interpret=True))[:9, :260]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jl2dist_ref(_jax_in(q, dtype), _jax_in(x, dtype))),
                               rtol=RTOL, atol=ATOL)


def test_l2dist_plain_rounds_in_the_kernel_order():
    q = torch.tensor([[1.0, 2.0]])
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0]])
    qn, xn = torch.tensor([5.0]), torch.tensor([5.0, 10.0])
    assert torch.equal(l2dist_plain(q, x, qn, xn), torch.tensor([[0.0, 13.0]]))
    with pytest.raises(ValueError):
        l2dist(q, x.to(torch.bfloat16))


# -------------------------------------------------------------------- topk
def _reference_topk(s, k, block_m=8, block_n=256):
    """The reference's topk wrapper, with its padding, around topk_pallas."""
    m, n = s.shape
    k_eff = 1 << max(0, (k - 1).bit_length())
    bn = max(block_n, k_eff)
    mp, np_ = -(-m // block_m) * block_m, -(-n // bn) * bn
    sp = np.pad(s, ((0, mp - m), (0, np_ - n)), constant_values=np.inf)
    v, i = topk_pallas(jnp.asarray(sp), k_eff, block_m, bn, interpret=True)
    v, i = np.asarray(v)[:m, :k], np.asarray(i)[:m, :k]
    return v, np.where(i < n, i, -1)


@pytest.mark.parametrize("m,n,k,data", [
    (1, 1, 1, "gaussian"), (4, 2048, 10, "gaussian"),
    (3, 50, 100, "gaussian"),  # k > N: (+inf, -1) padding
    (5, 777, 33, "ties"),  # integer scores, -0.0 and +0.0 among them
])
def test_topk_matches_reference(m, n, k, data):
    rng = np.random.default_rng(m + n + k)
    s = rng.standard_normal((m, n)).astype(np.float32)
    if data == "ties":
        s = np.round(s * 2).astype(np.float32)
        zeros = s == 0  # -0.0 and +0.0 are one value: ties to the smaller index
        s[zeros] = np.where(rng.integers(0, 2, zeros.sum()) == 1, np.float32(-0.0), 0.0)
        assert np.signbit(s[zeros]).any() and not np.signbit(s[zeros]).all()
    v, i = topk(torch.from_numpy(s), k, block_n=256)  # small tiles: a quick interpret run
    rv, ri = _reference_topk(s, k)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    jv, ji = jtopk_ref(jnp.asarray(s), k)
    pv, pi = topk_ref(torch.from_numpy(s), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), pv.numpy())


def test_topk_split_scan_merges_to_the_sequential_queue():
    rng = np.random.default_rng(9)
    s = torch.from_numpy(np.round(rng.standard_normal((3, 5000)) * 3).astype(np.float32))
    v1, i1 = topk_scan_plain(s, 64, 256, 1)
    vs, is_ = topk_scan(s, 64, 256, 7)  # CPU tensors: the plain version, S = 7
    assert vs.shape == (3, 7, 64)
    mv, mi = K.knn_merge(vs, is_)
    assert torch.equal(mv, v1[:, 0]) and torch.equal(mi, i1[:, 0])
    with pytest.raises(ValueError):
        topk_scan(s, 48, 256)
    with pytest.raises(ValueError):
        topk_scan(s.to(torch.float64), 64, 256)


def test_cpu_tensors_never_launch():
    K.reset_launch_counts()
    l2dist(torch.ones(2, 3), torch.ones(4, 3))
    topk(torch.ones(2, 30), 3)
    assert sum(K.LAUNCHES.values()) == 0


# ------------------------------------------------- shared-memory formulas
CSRC = Path(K.__file__).resolve().parents[1] / "csrc"


def _c_constants(*sources):
    """Every constant ``constexpr int NAME = EXPR;`` of the sources (those
    whose EXPR is arithmetic on earlier ones), evaluated."""
    env = {}
    for src in sources:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([\w\s*+/()-]+);",
                                     (CSRC / src).read_text(), re.M):
            env[name] = eval(expr, {}, dict(env))
    return env


def _c_formula(source, name, env):
    """The host function ``size_t name(...) { return EXPR; }`` of a source
    as a Python function of its arguments."""
    body = re.search(rf"size_t {name}\(([^)]*)\) {{\s*return (.*?);\s*}}",
                     (CSRC / source).read_text(), re.S)
    args = [a.split()[-1] for a in body.group(1).split(",")]
    expr = " ".join(body.group(2).replace("(size_t)", "").replace("rt::", "").split())
    return lambda *vals: eval(expr, {}, {**env, **dict(zip(args, vals))})


@pytest.mark.parametrize("bm,cap", [(1, 128), (8, 128), (16, 128), (16, 512), (16, 1024)])
def test_int8_smem_formula_matches_the_kernel(bm, cap):
    env = _c_constants("select.cuh", "knn_int8.cu")
    c = _c_formula("knn_int8.cu", "int8_smem_bytes", env)
    assert K.int8_scan_smem_bytes(bm, cap) == c(bm, cap)
    assert (env["kChunk"], env["kDepth"]) == (K._INT8_CHUNK, K._INT8_DEPTH)


@pytest.mark.parametrize("k_eff", [1, 64, 1024, 8192])
def test_topk_smem_formula_matches_the_kernel(k_eff):
    env = _c_constants("select.cuh", "topk.cu")
    assert T.topk_smem_bytes(k_eff) == _c_formula("topk.cu", "topk_smem_bytes", env)(
        k_eff, T._CAP)
    assert T.topk_smem_bytes(8192) <= K._BLOCK_SMEM_MAX < T.topk_smem_bytes(16384)


@pytest.mark.parametrize("bm,cap", [(1, 1024), (16, 256), (16, 1024)])
def test_scan_smem_formula_matches_the_kernel(bm, cap):
    env = _c_constants("select.cuh", "knn.cu")
    assert K.scan_smem_bytes(bm, cap) == _c_formula("knn.cu", "scan_smem_bytes", env)(bm, cap)
    assert (env["kStageBytes"], env["kQueryBytes"]) == (K._STAGE_BYTES, K._QUERY_BYTES)


@pytest.mark.parametrize("bm,blocks", [(16, 245), (16, 100), (1, 264), (4, 132)])
def test_scan_survivor_cap_fits_the_grid(bm, blocks):
    """The cap is the largest power of two (128 to 1024) whose block, by
    the kernel's own formula, fits the blocks per SM the grid needs."""
    c = _c_formula("knn.cu", "scan_smem_bytes", _c_constants("select.cuh", "knn.cu"))
    cap = K.scan_survivor_cap(bm, blocks, 132)
    room = 233_472 // 2 - 1024 if blocks > 132 else 232_448
    assert c(bm, cap) <= room and (cap == 1024 or c(bm, 2 * cap) > room)
    assert cap & (cap - 1) == 0 and 128 <= cap <= 1024


@pytest.mark.parametrize("k", [1, 128, 1024, 8192])
def test_merge_smem_formula_matches_the_kernel(k):
    env = _c_constants("select.cuh", "knn.cu")
    c = _c_formula("knn.cu", "merge_smem_bytes", env)
    assert K.merge_smem_bytes(k) == c(k)
    assert (env["kMergeThreads"], env["kPool"]) == (K._MERGE_THREADS, K._MERGE_POOL)
    assert K.merge_smem_bytes(8192) <= K._BLOCK_SMEM_MAX < K.merge_smem_bytes(16384)


@pytest.mark.parametrize("m", [1, 2, 5, 16, 300])
def test_l2dist_smem_formula_matches_the_kernel(m):
    env = _c_constants("l2dist.cu")
    c = _c_formula("l2dist.cu", "l2dist_smem_bytes", env)
    for path in ("stream", "tiled"):
        cfg = L.l2dist_config(m, 1000, 96, torch.float32, path=path)
        args = ((env["kStageBytes"], cfg.bm, env["kQueryBytes"] * L.stream_split(cfg.bm))
                if path == "stream" else (env["kTileN"] * env["kLine"], env["kTileM"],
                                          env["kLine"]))
        assert cfg.smem == L.l2dist_smem_bytes(*args) == c(*args)
    assert (env["kStages"], env["kStageBytes"], env["kQueryBytes"], env["kTileM"],
            env["kTileN"], env["kLine"]) == (L._STAGES, L._STAGE_BYTES, L._QUERY_BYTES,
                                             L._TILE_M, L._TILE_N, L._LINE)
    split = re.search(r"int split_of\(int bm\) \{ return bm <= (\d+) \? (\d+) : 1; \}",
                      (CSRC / "l2dist.cu").read_text())
    assert (int(split.group(1)), int(split.group(2))) == (L._SPLIT_BM, L._SPLIT)


@pytest.mark.parametrize("n", [1, 300, 1_000_000])
@pytest.mark.parametrize("m", [1, 3, 16, L.STREAM_MAX_M, L.STREAM_MAX_M + 1, 256,
                               2 * 65535 * 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2dist_config_is_a_legal_launch(m, n, dtype):
    """Both sides of the crossover and twice the old 65535·16-row limit: a
    grid the card takes, shared memory a block may take (two stream blocks
    an SM), every output element covered by exactly one block."""
    cfg = L.l2dist_config(m, n, 960, dtype)
    gx, gy = cfg.grid
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535
    assert L.l2dist_config(m, n, 960, dtype, path="tiled").smem <= 232_448
    if m <= L.STREAM_MAX_M:
        assert 2 * (cfg.smem + 1024) <= 233_472
        assert cfg.path == "stream" and cfg.bm == min(16, 1 << (m - 1).bit_length())
        assert gy == -(-m // cfg.bm) and gx * gy <= 2 * 132  # one wave
        assert cfg.span % 32 == 0 and (gx - 1) * cfg.span < n <= gx * cfg.span
    else:
        assert cfg.path == "tiled" and (cfg.bm, cfg.span) == (128, 128)
        assert gy == 1 and gx == -(-m // 128) * -(-n // 128)


def test_l2dist_config_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of 32"):
        L.l2dist_config(4, 10, 48)
    with pytest.raises(ValueError, match="dtype"):
        L.l2dist_config(4, 10, 64, torch.float16)
    with pytest.raises(ValueError, match="path"):
        L.l2dist_config(4, 10, 64, path="gemm")


# ---------------------------------------------------------------- merge
def _threshold_merge(v, i):
    """knn_merge's three steps in torch ops: tau, the (k / stride)-th
    smallest of the samples at places (j+1)·stride - 1; each queue's pairs
    strictly below tau; their k smallest, then copies of tau. Checks the
    two bounds the design rests on: at least k pairs at or below tau, fewer
    than k + S·stride strictly below."""
    m, s, k = v.shape
    stride = K.merge_stride(k)
    ks = k // stride
    tv, ti = topk_smallest(v[:, :, stride - 1::stride].reshape(m, -1),
                           i[:, :, stride - 1::stride].reshape(m, -1), ks)
    tau = pair_keys(tv[:, -1], ti[:, -1])[:, None, None]
    keys = pair_keys(v, i)
    assert bool(((keys <= tau).sum(dim=(1, 2)) >= k).all())
    below = keys < tau
    assert bool((below.sum(dim=(1, 2)) < k + s * stride).all())
    out_v, out_i = [], []
    for r in range(m):
        cv, ci = topk_smallest(v[r][below[r]], i[r][below[r]], k)
        fill = min(k, int(below[r].sum()))
        out_v.append(torch.cat([cv[:fill], tv[r, -1].expand(k - fill)]))
        out_i.append(torch.cat([ci[:fill], ti[r, -1].expand(k - fill)]))
    return torch.stack(out_v), torch.stack(out_i)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,s,k", [(3, 7, 1), (2, 5, 64), (2, 37, 16), (1, 3, 1024)])
def test_merge_plain_equals_a_full_sort(kind, m, s, k):
    """knn_merge_plain, and the kernel's threshold steps, against one full
    sort of each row's S·k pairs, on queues built to stress the threshold."""
    v, i = merge_queues(kind, m, s, k, seed=m + s + k)
    want_v, want_i = sort_pairs(v.reshape(m, -1), i.reshape(m, -1))
    pv, pi = K.knn_merge_plain(v, i)
    assert torch.equal(pv, want_v[:, :k]) and torch.equal(pi, want_i[:, :k])
    tv, ti = _threshold_merge(v, i)
    assert torch.equal(tv, pv) and torch.equal(ti, pi)
    mv, mi = K.knn_merge(v, i)  # CPU tensors: the plain version
    assert torch.equal(mv, pv) and torch.equal(mi, pi)


@pytest.mark.parametrize("k", [1, 2, 8, 128, 1024, 8192])
def test_merge_stride_is_near_sqrt_k(k):
    stride = K.merge_stride(k)
    assert stride & (stride - 1) == 0 and k <= stride * stride <= 2 * k


# ------------------------------------------------- the scan's pilot bound
def _pilot_operands(order, metric, k, m, n=16_384, d=32, seed=0):
    """Rows and queries whose every score is exact in f32 whatever the
    batch (integers; for cos, rows of four ±1 and queries of sixteen, whose
    normalised forms are exact), arranged by ``order``: random; all rows
    equal (every score ties, the bound's index decides); farthest from
    query 0 first; a tenth of the norms +inf; or every pilot row excluded
    but k_eff - 1, so the pilot has fewer than k_eff finite pairs.
    Returns (call, qn, rows): the prepared call, its query norms and the
    pilot's rows (a multiple of bn, 16 rows of the scan a pilot row)."""
    from repro_torch.core.distance import query_norms_sq
    from repro_torch.kernels.knn import ops

    g = torch.Generator().manual_seed(seed)
    if metric == "cos":
        def signs(rows, nnz):
            ranks = torch.rand(rows, d, generator=g).argsort(1).argsort(1)
            sign = torch.randint(0, 2, (rows, d), generator=g) * 2 - 1
            return ((ranks < nnz) * sign).to(torch.float32)

        x, q = signs(n, 4), signs(m, 16)
    else:
        x = torch.randint(-8, 9, (n, d), generator=g).to(torch.float32)
        q = torch.randint(-8, 9, (m, d), generator=g).to(torch.float32)
    if order == "equal":
        x = x[9].expand_as(x).contiguous()
    elif order == "farthest_first":
        key = {"l2": torch.sum((x - q[0]) ** 2, -1), "ip": -(x @ q[0]),
               "cos": -(x @ q[0])}[metric]
        x = x[torch.argsort(key, descending=True, stable=True)]
    xn = torch.sum(x * x, dim=-1)
    rows = 2048
    if order == "inf_norms":
        xn[torch.rand(n, generator=g) < 0.1] = torch.inf
    elif order == "sparse_pilot":
        k_eff = 1 << (k - 1).bit_length()
        xn[(k_eff - 1) * (n // rows)::n // rows] = torch.inf
    call = ops.prepare(q, x, k, metric, xn)
    return call, query_norms_sq(call.q), rows


_PILOT_CASES = [
    ("random", "l2", 1, 1), ("random", "l2", 72, 16), ("random", "l2", 1024, 32),
    ("random", "ip", 72, 1), ("random", "ip", 1024, 16), ("random", "cos", 1, 16),
    ("random", "cos", 72, 32), ("random", "cos", 1024, 1),
    ("equal", "l2", 72, 16), ("equal", "ip", 1024, 1), ("equal", "cos", 1, 32),
    ("farthest_first", "l2", 1024, 16), ("farthest_first", "ip", 72, 32),
    ("farthest_first", "cos", 72, 1),
    ("inf_norms", "l2", 72, 16), ("inf_norms", "ip", 1024, 32), ("inf_norms", "cos", 1, 1),
    ("sparse_pilot", "l2", 1024, 16), ("sparse_pilot", "ip", 72, 1),
    ("sparse_pilot", "cos", 1, 32),
]


@pytest.mark.parametrize("order,metric,k,m", _PILOT_CASES)
def test_pilot_bound_leaves_the_answer_bit_identical(order, metric, k, m):
    """The plain knn_scan + knn_merge with the pilot's bound give the
    unbounded answer bit for bit, at a split of 4 tiles a block; the
    bounded queues hold no pair past the bound; all-equal rows bound at
    the pilot's k_eff-th row, mid-range; a pilot with fewer than k_eff
    finite pairs bounds nothing."""
    from repro_torch.core.topk import pair_keys

    call, qn, rows = _pilot_operands(order, metric, k, m)
    bm, bn, _ = call.blocks
    n = call.x.shape[0]
    bound_v, bound_i = K.pilot_bound(call.q, call.x, qn, call.xn, call.k_eff, call.metric,
                                     bm, bn, rows)
    assert bound_v.shape == bound_i.shape == (call.q.shape[0],)
    args = (call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn, True, 4)
    sv, si, _ = K.knn_scan(*args)
    bv, bi, _ = K.knn_scan(*args, bound_v=bound_v, bound_i=bound_i)
    want_v, want_i = K.knn_merge(sv, si)
    got_v, got_i = K.knn_merge(bv, bi)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    finite = torch.isfinite(bv)
    past = pair_keys(bv, bi) > pair_keys(bound_v, bound_i)[:, None, None]
    assert not bool((finite & past).any())
    if order == "equal":
        assert bool((bound_i == (call.k_eff - 1) * (n // rows)).all())
    if order == "sparse_pilot":
        assert bool(torch.isinf(bound_v).all()) and bool((bound_i == -1).all())
        assert torch.equal(bv, sv) and torch.equal(bi, si)
    else:
        assert bool(torch.isfinite(bound_v).all())


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), k=st.sampled_from([1, 5, 64, 300]),
                  metric=st.sampled_from(["l2", "ip", "cos"]),
                  m=st.integers(1, 20), stride=st.integers(1, 6),
                  excluded=st.sampled_from([0.0, 0.5, 0.95]))
def test_pilot_bound_has_k_eff_pairs_at_or_below_it(seed, k, metric, m, stride, excluded):
    """At least k_eff pairs of the scan lie at or below the bound (the
    unbounded answer's k_eff-th pair does), and the bound is (+inf, -1)
    only where the pilot held fewer than k_eff finite pairs."""
    from repro_torch.core.distance import query_norms_sq
    from repro_torch.core.topk import pair_keys
    from repro_torch.kernels.knn import ops

    g = torch.Generator().manual_seed(seed)
    k_eff = 1 << (k - 1).bit_length()
    rows = max(512, k_eff)
    n = rows * stride + int(torch.randint(0, rows, (1,), generator=g))
    x = torch.randint(-6, 7, (n, 32), generator=g).to(torch.float32)
    q = torch.randint(-6, 7, (m, 32), generator=g).to(torch.float32)
    xn = torch.sum(x * x, dim=-1)
    xn[torch.rand(n, generator=g) < excluded] = torch.inf
    call = ops.prepare(q, x, k, metric, xn)
    qn = query_norms_sq(call.q)
    bm, bn, _ = call.blocks
    bound_v, bound_i = K.pilot_bound(call.q, call.x[:n], qn, call.xn[:n], call.k_eff,
                                     call.metric, bm, bn, rows)
    sv, si, _ = K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn)
    last_v, last_i = K.knn_merge(sv, si)
    last = pair_keys(last_v[:, -1], last_i[:, -1])
    bound = pair_keys(bound_v, bound_i)
    inf = torch.isinf(bound_v)
    assert bool((last[~inf] <= bound[~inf]).all())
    assert bool((bound_i[inf] == -1).all())
    pick = torch.arange(rows) * (n // rows)
    finite_pilot = int(torch.isfinite(xn[pick]).sum())
    assert bool(inf.all()) == (finite_pilot < k_eff)


@pytest.mark.parametrize("what,m,k,n,bn,splits,engages", [
    ("gist_fqsd", 16, 1024, 1_000_000, 1024, 245, True),
    ("gist_fqsd_m64", 64, 1024, 1_000_000, 1024, 66, True),
    ("gist_int8_fallback_m16", 16, 2048, 1_000_000, 2048, 245, True),
    ("gist_fdsq_m1", 1, 1024, 1_000_000, 1024, 245, False),
    ("gist_int8_fallback_m4", 4, 2048, 1_000_000, 2048, 245, False),
    *[("msmarco_fdsq_k72", m, 72, 8_841_823, 512, None, False) for m in (1, 2, 5, 16, 17, 32)],
    ("retrieval_k100", 2, 100, 50_000, 512, 98, False),
    ("small_n", 16, 1024, 200_000, 1024, 196, False),
    ("resident_small_n", 16, 64, 20_000, 512, 40, False),
])
def test_pilot_rule_engages_where_the_filter_cannot_filter(what, m, k, n, bn, splits,
                                                           engages):
    """The pilot engages at GIST's FQ-SD shape (a split scans 4,096 rows
    against k = 1,024), at m = 64 and for the int8 fallback's queue of
    2,048 at m = 16; it bypasses a block of fewer than 16 queries (m = 1,
    4), MS-MARCO at k = 72 for every m up to 32 (the card's S: two blocks
    an SM of 132), two-tower retrieval at k = 100, and n below
    PILOT² · k_eff or PILOT_MIN_ROWS."""
    from repro_torch.core.partition import next_pow2, round_up

    k_eff = next_pow2(k)
    bm = min(next_pow2(m), 16)
    n_tiles = round_up(n, bn) // bn
    if splits is None:
        splits = min(n_tiles, 2 * 132 // (round_up(m, bm) // bm))
    tps = K.tiles_per_split(n_tiles, splits)
    rows = K.pilot_rows(round_up(n, bn), k_eff, tps * bn, bm)
    assert bool(rows) == engages
    if engages:
        assert rows == K.PILOT * k_eff and rows % bn == 0 and n // rows >= K.PILOT
