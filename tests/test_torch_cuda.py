"""The CUDA kernels on the card, against their plain versions: knn_scan,
knn_merge, knn_int8_scan, l2dist and topk; the LM decode path
(repro_torch.models, DecodeServer) on the card against itself and the CPU;
two-tower retrieval on the kernel, and recommender and GNN train steps on
the card against the CPU; the substrate on a mesh of logical positions on
the card (the kNN and retrieval cells, the row-sharded table, the MoE and
flash-decode islands, the elastic round trip); on two cards or more, each
kernel launched for a card that is not current and the mesh over distinct
cards (these skip on one card).

These tests need an NVIDIA card with ``nvcc`` (the library is built on
first launch); elsewhere they skip. They import neither JAX nor the JAX
package, so a machine with only PyTorch runs them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer-valued data keeps every sum exact in f32, so the kernel and its
plain version must agree bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import ExactKNN, SearchRequest
from repro_torch.data.merge_cases import KINDS, merge_queues
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.knn import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pilots(n: int, d: int, m: int, k: int) -> int:
    """The pilots (one ``knn_scan`` and one ``knn_merge`` each) that
    ``ops.knn`` runs for m queries at k over n rows of d columns at the
    default blocks: 1 where ``K.pilot_rows`` engages at the scan's split."""
    from repro_torch.core.partition import next_pow2, round_up

    bm, bn, _ = ops.resolved_blocks(k, d, m=m)
    rows = round_up(n, bn)
    tps = K.scan_config(round_up(m, bm) // bm, rows // bn, bm, "cuda")[1]
    return int(K.pilot_rows(rows, next_pow2(k), tps * bn, bm) > 0)


def _ints(shape, g, dev):
    return torch.randint(-8, 9, shape, generator=g, device=dev).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,m", [(1, 1), (7, 16), (72, 3), (1024, 2)])
def test_fused_kernel_bit_identical_to_plain(dev, dtype, metric, k, m):
    g = torch.Generator(device=dev).manual_seed(k + m)
    x = _ints((5000, 256), g, dev)
    x[4000] = x[9]
    q = _ints((m, 256), g, dev)
    q[0] = x[9]
    xn = torch.sum(x * x, dim=-1)
    xn[[100, 4999]] = torch.inf
    call = ops.prepare(q.to(dtype), x.to(dtype), k, metric, xn)
    bm, bn, bd = call.blocks
    K.reset_launch_counts()
    v, i, sk = K.knn_fused(call.q, call.x, call.xn, call.k_eff, call.metric, bm, bn, bd)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_scan"] == 1 and K.LAUNCHES["knn_merge"] == 1
    pv, pi, _ = K.knn_fused_plain(call.q, call.x, call.xn, call.k_eff, call.metric, bm, bn, bd)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert int(sk.sum()) <= (call.q.shape[0] // bm) * (call.x.shape[0] // bn)


def test_engine_searches_through_the_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x = _ints((20_000, 100), g, dev)
    q = _ints((6, 100), g, dev)
    fused = ExactKNN(k=10, backend="cuda").fit(x)
    plain = ExactKNN(k=10, backend="torch").fit(x)
    for mode in ("fdsq", "fqsd"):
        K.reset_launch_counts()
        got = fused.search(SearchRequest(queries=q, mode_hint=mode))
        torch.cuda.synchronize()
        assert got.plan.executor == "fdsq-cuda"
        assert K.LAUNCHES["knn_scan"] == 1 and K.LAUNCHES["knn_merge"] >= 1
        want = plain.search(SearchRequest(queries=q, mode_hint=mode))
        assert torch.equal(got.topk.scores, want.topk.scores)
        assert torch.equal(got.topk.indices, want.topk.indices)


def _unit_scale_rows(n, d, g, dev):
    """Integer rows in [-127, 127] with one entry at 127: every row's int8
    scale is 1, so the int8 scan's arithmetic is exact but for sqrt and
    the final square, single IEEE operations on both sides."""
    x = torch.randint(-127, 128, (n, d), generator=g, device=dev).to(torch.float32)
    x[torch.arange(n, device=dev), torch.randint(0, d, (n,), generator=g, device=dev)] = 127.0
    return x


@pytest.mark.parametrize("k,m", [(1, 1), (7, 16), (72, 3), (1024, 2)])
def test_int8_scan_bit_identical_to_plain(dev, k, m):
    from repro_torch.core.quantized import quantize_dataset

    g = torch.Generator(device=dev).manual_seed(k + m)
    x = _unit_scale_rows(5000, 256, g, dev)
    x[4000] = x[9]
    q = torch.randint(-40, 41, (m, 256), generator=g, device=dev).to(torch.float32)
    q[0] = x[9]
    ds = quantize_dataset(x)
    ds.norms_sq[[100, 4999]] = torch.inf
    call = ops.prepare_int8(q, ds, k)
    bm, bn, _ = call.blocks
    args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn, call.q_len, bm, bn)
    K.reset_launch_counts()
    got = K.knn_int8_scan(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_int8_scan"] == 1
    splits = got[0].shape[1]
    want = K.knn_int8_scan_plain(*args, True, splits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    v, i = K.knn_merge(got[0], got[1])
    v1, i1, _ = K.knn_int8_scan_plain(*args, True, 1)
    assert torch.equal(v, v1[:, 0]) and torch.equal(i, i1[:, 0])


def test_int8_engine_matches_its_oracle(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(30_000, 200, generator=g, device=dev)
    q = x[:16] + 0.1 * torch.randn(16, 200, generator=g, device=dev)
    eng = ExactKNN(k=20, backend="cuda").fit(x).enable_int8()
    K.reset_launch_counts()
    res = eng.search(SearchRequest(queries=q, tier="int8"))
    torch.cuda.synchronize()
    assert res.plan.executor == "fqsd-int8-cuda" and K.LAUNCHES["knn_int8_scan"] == 1
    ds = eng._ds
    want = ops.knn_exact_direct(eng._pad_queries(q), ds.vectors, ds.norms, 20,
                                res.plan.chunk_rows)
    assert torch.equal(res.topk.scores, want.scores)
    assert torch.equal(res.topk.indices, want.indices)


def _l2dist_operands(m, n, d, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(m + n)
    q = _ints((m, d), g, dev).to(dtype)
    x = _ints((n, d), g, dev).to(dtype)
    return q, x, torch.sum(q.float() ** 2, -1), torch.sum(x.float() ** 2, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,d", [(1, 1000, 64), (16, 5003, 96), (37, 300, 32),
                                   (17, 1000, 32), (130, 5003, 96), (257, 300, 960)])
def test_l2dist_bit_identical_to_plain(dev, dtype, m, n, d):
    from repro_torch.kernels.l2dist import kernel as L

    q, x, qn, xn = _l2dist_operands(m, n, d, dtype, dev)
    K.reset_launch_counts()
    got = L.l2dist_tiles(q, x, qn, xn)
    torch.cuda.synchronize()
    assert K.LAUNCHES["l2dist"] == 1
    assert torch.equal(got, L.l2dist_plain(q, x, qn, xn))


@pytest.mark.parametrize("path", ["stream", "tiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,d", [(1, 33, 32), (3, 4097, 64), (16, 1000, 96),
                                   (33, 700, 32), (128, 129, 64), (200, 2000, 160)])
def test_l2dist_each_kernel_bit_identical_to_plain(dev, path, dtype, m, n, d):
    """Both kernels at the edges of their tiles and spans, whichever M the
    wrapper would give them; one launch each."""
    from repro_torch.kernels.l2dist import kernel as L

    q, x, qn, xn = _l2dist_operands(m, n, d, dtype, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K.reset_launch_counts()
    got = L.l2dist_launch(q, x, qn, xn, L.l2dist_config(m, n, d, dtype, sms, path))
    torch.cuda.synchronize()
    assert K.LAUNCHES["l2dist"] == 1
    assert torch.equal(got, L.l2dist_plain(q, x, qn, xn))


@pytest.mark.parametrize("k,m,n", [(1, 1, 300), (72, 16, 100_000), (1024, 5, 70_001)])
def test_topk_bit_identical_to_plain(dev, k, m, n):
    from repro_torch.kernels.topk import ops as T
    from repro_torch.kernels.topk.ref import topk_ref

    g = torch.Generator(device=dev).manual_seed(k + m)
    s = torch.randint(-500, 500, (m, n), generator=g, device=dev).to(torch.float32)
    K.reset_launch_counts()
    v, i = T.topk(s, k)
    torch.cuda.synchronize()
    assert K.LAUNCHES["topk"] == 1 and K.LAUNCHES["knn_merge"] >= 1
    rv, ri = topk_ref(s, k)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def _topk_scores(kind, m, n, g, dev):
    """Score matrices where the survivor filter is at its worst or its
    subtlest: integer scores with ties and a mix of -0.0 and +0.0; scores
    descending along N (every lane beats the queue: the survivor buffer
    overflows); all equal (only index ties decide); +inf lanes."""
    if kind == "descending":
        return torch.arange(n, 0, -1, device=dev, dtype=torch.float32).expand(m, n).contiguous()
    if kind == "equal":
        return torch.full((m, n), 3.0, device=dev)
    s = torch.randint(-300, 301, (m, n), generator=g, device=dev).to(torch.float32)
    zero = s == 0
    s[zero] = torch.where(torch.rand(int(zero.sum()), generator=g, device=dev) < 0.5, -0.0, 0.0)
    if kind == "inf_lanes":
        s[torch.rand(m, n, generator=g, device=dev) < 0.3] = torch.inf
    return s


@pytest.mark.parametrize("kind", ["ints", "descending", "equal", "inf_lanes"])
@pytest.mark.parametrize("k,m,n", [(72, 5, 12_345), (1024, 16, 70_001)])
def test_topk_filter_edge_cases_bit_identical(dev, kind, k, m, n):
    from repro_torch.kernels.topk import kernel as T
    from repro_torch.kernels.topk import ops as TO
    from repro_torch.kernels.topk.ref import topk_ref

    g = torch.Generator(device=dev).manual_seed(k + m)
    s = _topk_scores(kind, m, n, g, dev)
    k_eff = 1 << (k - 1).bit_length()
    bn = max(1024, k_eff)
    for splits in (None, 1):
        sv, si = T.topk_scan(s, k_eff, bn, splits)
        pv, pi = T.topk_scan_plain(s, k_eff, bn, sv.shape[1])
        assert torch.equal(sv, pv) and torch.equal(si, pi)
    v, i = TO.topk(s, k)
    rv, ri = topk_ref(s, k)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("order", ["random", "farthest_first", "equal"])
@pytest.mark.parametrize("k", [72, 1024])  # q_len 1024 and 8192
def test_int8_scan_filter_edge_cases_bit_identical(dev, order, k):
    """Rows farthest from query 0 first (every lane of every tile survives
    for it: the multi-pass path) and all rows equal (index ties), at the
    card's S and at S = 1; bounds, indices and skip counts."""
    from repro_torch.core.quantized import quantize_dataset

    g = torch.Generator(device=dev).manual_seed(k)
    x = _unit_scale_rows(12_345, 256, g, dev)
    q = torch.randint(-40, 41, (16, 256), generator=g, device=dev).to(torch.float32)
    q[0] = x[9]
    if order == "farthest_first":
        x = x[torch.argsort(torch.sum((x - q[0]) ** 2, -1), descending=True, stable=True)]
    elif order == "equal":
        x = x[9].expand_as(x).contiguous()
    ds = quantize_dataset(x)
    ds.norms_sq[[100, 12_344]] = torch.inf
    call = ops.prepare_int8(q, ds, k)
    bm, bn, _ = call.blocks
    assert bm == 16
    args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn, call.q_len, bm, bn)
    m_tiles, n_tiles = 1, call.hn.shape[0] // bn
    for splits in (K.int8_scan_config(m_tiles, n_tiles, bm, dev)[0], 1):
        for prune in (True, False):
            got = K.knn_int8_scan(*args, prune, splits)
            want = K.knn_int8_scan_plain(*args, prune, splits)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,s,k", [(3, 7, 1), (1, 264, 128), (16, 245, 1024), (2, 123, 8192)])
def test_merge_one_launch_on_adversarial_queues(dev, kind, m, s, k):
    """The one-launch merge against knn_merge_plain on queues built to
    stress its threshold (``repro_torch.data.merge_cases``), at the main
    path's widths."""
    v, i = merge_queues(kind, m, s, k, seed=m + s + k, device=dev)
    K.reset_launch_counts()
    got = K.knn_merge(v, i)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_merge"] == 1
    want = K.knn_merge_plain(v, i)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _scan_filter_case(dev, dtype, metric, order, k, m):
    """The scan filter's edge cases: (call, qn) of 12,288 integer rows."""
    g = torch.Generator(device=dev).manual_seed(k + m)
    x = _ints((12_288, 256), g, dev)
    q = _ints((m, 256), g, dev)
    q[0] = x[9]
    if order == "farthest_first":
        key = torch.sum((x - q[0]) ** 2, -1) if metric == "l2" else -(x @ q[0])
        x = x[torch.argsort(key, descending=True, stable=True)]
    elif order == "equal":
        x = x[9].expand_as(x).contiguous()
    xn = torch.sum(x * x, dim=-1)
    xn[[100, 12_287]] = torch.inf
    call = ops.prepare(q.to(dtype), x.to(dtype), k, metric, xn)
    return call, torch.sum(call.q.float() ** 2, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("order", ["random", "farthest_first", "equal"])
@pytest.mark.parametrize("k,m", [(72, 16), (1024, 1)])
def test_scan_filter_edge_cases_bit_identical(dev, dtype, metric, order, k, m):
    """Rows farthest from query 0 first (every lane survives for it: the
    multi-pass path) and all rows equal (index ties), at the card's S and
    at S = 1: values, indices and skip counts, with the selection
    counters of every block."""
    call, qn = _scan_filter_case(dev, dtype, metric, order, k, m)
    bm, bn, _ = call.blocks
    args = (call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn)
    m_tiles, n_tiles = call.q.shape[0] // bm, call.x.shape[0] // bn
    for splits in (K.scan_config(m_tiles, n_tiles, bm, dev)[0], 1):
        for prune in (True, False):
            *got, stats = K.knn_scan(*args, prune, splits, return_stats=True)
            want = K.knn_scan_plain(*args, prune, splits)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert stats.shape == (m_tiles, splits, 4) and int(stats[..., 1].min()) >= 1


def _bounded_scan_matches(call, qn, bound, splits_list):
    """At each S: the bounded kernel's per-split queues and skips equal the
    bounded plain version's, and its merged answer equals the unbounded
    kernel's, bit for bit. Returns the bounded scans' survivors and the
    unbounded ones'."""
    bm, bn, _ = call.blocks
    args = (call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn, True)
    kept = [0, 0]
    for splits in splits_list:
        *got, st = K.knn_scan(*args, splits, return_stats=True, bound_v=bound[0],
                              bound_i=bound[1])
        want = K.knn_scan_plain(*args, splits, bound_v=bound[0], bound_i=bound[1])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        *free, st_free = K.knn_scan(*args, splits, return_stats=True)
        gv, gi = K.knn_merge(got[0], got[1])
        fv, fi = K.knn_merge(free[0], free[1])
        assert torch.equal(gv, fv) and torch.equal(gi, fi)
        kept[0] += int(st[..., 0].sum())
        kept[1] += int(st_free[..., 0].sum())
    return kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("order", ["random", "farthest_first", "equal"])
@pytest.mark.parametrize("k,m", [(72, 16), (1024, 1)])
def test_scan_pilot_bound_bit_identical(dev, dtype, metric, order, k, m):
    """The filter's edge cases with a pilot's bound (2,048 rows at a
    stride of 6, read in place as the pilot reads them: its scan equals
    the plain version's on the same strided views), at the card's S and at
    S = 1."""
    call, qn = _scan_filter_case(dev, dtype, metric, order, k, m)
    bm, bn, _ = call.blocks
    pbm, stride = max(1, bm // 8), call.x.shape[0] // 2048
    rows = (call.q, call.x[::stride][:2048], qn, call.xn[::stride][:2048], call.k_eff,
            call.metric, pbm, bn, True, K.scan_config(call.q.shape[0] // pbm, 2048 // bn, pbm,
                                                      dev)[0])
    for a, b in zip(K.knn_scan(*rows), K.knn_scan_plain(*rows)):
        assert torch.equal(a, b)
    bound = K.pilot_bound(call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn, 2048)
    m_tiles, n_tiles = call.q.shape[0] // bm, call.x.shape[0] // bn
    kept, free = _bounded_scan_matches(
        call, qn, bound, (K.scan_config(m_tiles, n_tiles, bm, dev)[0], 1))
    assert kept <= free


def test_scan_pilot_bound_at_gist_shape(dev):
    """GIST's FQ-SD shape (16 × 1,000,000 × 960, k = 1,024, integer rows in
    random order): the pilot engages at the card's S, the bounded scan
    matches its plain version and the unbounded answer, admits under a
    tenth of the lanes, and ``ops.knn`` launches the pilot's scan and
    merge beside the main ones for the same answer."""
    g = torch.Generator(device=dev).manual_seed(33)
    x = _ints((1_000_000, 960), g, dev)
    q = _ints((16, 960), g, dev)
    xn = torch.sum(x * x, dim=-1)
    call = ops.prepare(q, x, 1024, "l2", xn)
    bm, bn, _ = call.blocks
    qn = torch.sum(call.q ** 2, dim=-1)
    splits, tps, _ = K.scan_config(1, call.x.shape[0] // bn, bm, dev)
    rows = K.pilot_rows(call.x.shape[0], call.k_eff, tps * bn, bm)
    assert (bm, bn, splits, rows) == (16, 1024, 245, K.PILOT * 1024)
    bound = K.pilot_bound(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, rows)
    kept, free = _bounded_scan_matches(call, qn, bound, (splits,))
    assert kept < 0.1 * 16 * x.shape[0] < free
    K.reset_launch_counts()
    got = ops.knn(q, x, 1024, "l2", xn)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_scan"] == 2 and K.LAUNCHES["knn_merge"] == 2
    sv, si, _ = K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, True, splits)
    want = ops.finish(call, *K.knn_merge(sv, si))
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_shard_step_bit_identical_to_plain(dev, metric):
    """One shard through knn_scan + knn_merge equals the plain step
    (knn_scan_plain + knn_merge_plain) on the same running queue. For cos
    the rows have 4 (queries: 16) entries of ±1, so their normalised form
    is exact and so is every score."""
    g = torch.Generator(device=dev).manual_seed(11)
    if metric == "cos":
        def signs(n, nnz):
            ranks = torch.rand(n, 256, generator=g, device=dev).argsort(1).argsort(1)
            sign = torch.randint(0, 2, (n, 256), generator=g, device=dev) * 2 - 1
            return ((ranks < nnz) * sign).to(torch.float32)

        x, q = signs(8192, 4), signs(16, 16)
    else:
        x, q = _ints((8192, 256), g, dev), _ints((16, 256), g, dev)
    q[0] = x[9]
    xn = torch.sum(x * x, dim=-1)
    xn[[100, 8191]] = torch.inf
    v, i = torch.full((16, 128), torch.inf, device=dev), torch.full(
        (16, 128), -1, dtype=torch.int32, device=dev)
    v[:, :64], i[:, :64] = torch.sort(torch.rand(16, 64, generator=g, device=dev) * 50)[0], 7
    K.reset_launch_counts()
    got = ops.knn_shard(v, i, q, x, xn, 100, metric, 40_960)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_scan"] == 1 and K.LAUNCHES["knn_merge"] == 1
    call = ops.prepare(q, x, 100, metric, xn)
    bm, bn, _ = call.blocks
    pv, pi, _ = K.knn_scan_plain(call.q, call.x, torch.sum(call.q ** 2, -1), call.xn,
                                 call.k_eff, call.metric, bm, bn, True, 1)
    want = ops.merge_shard(v, i, pv[:16], pi[:16], 40_960, merge=K.knn_merge_plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_int8_shard_step_bit_identical_to_plain(dev):
    from repro_torch.core.quantized import quantize_dataset

    g = torch.Generator(device=dev).manual_seed(12)
    x = _unit_scale_rows(8192, 256, g, dev)
    q = torch.randint(-40, 41, (16, 256), generator=g, device=dev).to(torch.float32)
    q[0] = x[9]
    ds = quantize_dataset(x)
    qnorm = ds.qnorm_sq.clone()
    qnorm[[100, 8191]] = torch.inf
    r = 4096  # q_len 8192, as at GIST k=1024
    lb = torch.full((16, r + 1), torch.inf, device=dev)
    li = torch.full((16, r + 1), -1, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    got = ops.knn_int8_shard(lb, li, q, ds.q, ds.scales, ds.err, qnorm, 65_536, r)
    torch.cuda.synchronize()
    assert K.LAUNCHES["knn_int8_scan"] == 1 and K.LAUNCHES["knn_merge"] == 1
    args = ops.int8_shard_operands(q, ds.q, ds.scales, ds.err, qnorm, r)
    pv, pi, _ = K.knn_int8_scan_plain(*args, True, 1)
    wv, wi = ops.merge_shard(lb, li, pv[:16], pi[:16], 65_536, merge=K.knn_merge_plain)
    assert torch.equal(got[0], wv[:, : r + 1]) and torch.equal(got[1], wi[:, : r + 1])


@pytest.mark.parametrize("depth", [1, 2])
def test_pinned_store_streams_the_resident_answer(dev, depth):
    from repro_torch.core.streaming import DoubleBufferedStream
    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(50_000, 200, generator=g, device=dev)
    q = x[:16] + 0.1 * torch.randn(16, 200, generator=g, device=dev)
    store = DatasetStore.from_array(x, rows_per_shard=8192, pin_memory=True)
    assert store.is_pinned and store.read_shard(0).vectors.is_pinned()
    resident = ExactKNN(k=50, backend="cuda").fit_store(store, resident=True)
    streamed = ExactKNN(k=50, backend="cuda", prefetch_depth=depth).fit_store(
        store, resident=False)
    want = resident.search(SearchRequest(queries=q, mode_hint="fqsd"))
    K.reset_launch_counts()
    got = streamed.search(SearchRequest(queries=q))
    torch.cuda.synchronize()
    assert got.plan.executor == "fqsd-mmap-streamed" and got.stats["transfers"] == 7
    assert K.LAUNCHES["knn_scan"] == 7 and K.LAUNCHES["knn_merge"] == 7
    assert torch.equal(got.topk.scores, want.topk.scores)
    assert torch.equal(got.topk.indices, want.topk.indices)
    stream = DoubleBufferedStream(store.shard_source(), depth=depth)
    for p, host in zip(stream, store.shard_source()):
        assert p.vectors.is_cuda and torch.equal(p.vectors.cpu(), host.vectors)
    store.ensure_tier("int8", device=dev)
    streamed.enable_int8()
    K.reset_launch_counts()
    got8 = streamed.search(SearchRequest(queries=q, tier="int8"))
    torch.cuda.synchronize()
    assert got8.plan.executor == "fqsd-int8-streamed" and K.LAUNCHES["knn_int8_scan"] == 7
    oracle = ops.knn_exact_direct(streamed._pad_queries(q), resident._ds.vectors,
                                  resident._ds.norms, 50, 8192)
    assert torch.equal(got8.topk.scores, oracle.scores)
    assert torch.equal(got8.topk.indices, oracle.indices)


@pytest.mark.parametrize("depth", [1, 2])
def test_store_in_files_streams_through_pinned_staging(dev, depth, tmp_path):
    """A store written to files and reopened streams its mapped shards
    through the stream's page-locked banks: never pinned itself, and
    bit-identical to the same rows in a pinned host store."""
    import numpy as np

    from repro_torch.core.streaming import DoubleBufferedStream
    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(50_000, 200, generator=g, device=dev)
    q = x[:16] + 0.1 * torch.randn(16, 200, generator=g, device=dev)
    ram = DatasetStore.from_array(x, rows_per_shard=8192, pin_memory=True)
    DatasetStore.from_array(x, rows_per_shard=8192, directory=str(tmp_path))
    files = DatasetStore.open(str(tmp_path), verify=True)
    for store in (ram, files):
        store.ensure_tier("int8", device=dev)
    engines = [ExactKNN(k=50, backend="cuda", prefetch_depth=depth).fit_store(
        store, resident=False).enable_int8() for store in (ram, files)]
    assert files.is_mmap and not files.is_pinned
    for tier, want_exec in (("f32", "fqsd-mmap-streamed"), ("int8", "fqsd-int8-mmap-streamed")):
        want = engines[0].search(SearchRequest(queries=q, tier=tier))
        K.reset_launch_counts()
        got = engines[1].search(SearchRequest(queries=q, tier=tier))
        torch.cuda.synchronize()
        assert got.plan.executor == want_exec and got.stats["transfers"] == 7
        assert K.LAUNCHES["knn_merge"] == 7
        assert torch.equal(got.topk.scores, want.topk.scores)
        assert torch.equal(got.topk.indices, want.topk.indices)
        assert torch.equal(torch.as_tensor(got.certified), torch.as_tensor(want.certified))
    stream = DoubleBufferedStream(files.shard_source("int8"), depth=depth)
    for p, host in zip(stream, files.shard_source("int8")):
        assert p.q.is_cuda and torch.equal(p.q.cpu(), torch.from_numpy(np.array(host.q)))
        assert torch.equal(p.qnorm.cpu(), host.qnorm)
    banks = next(iter(stream._banks.values()))
    staged = [t for bank in banks.staging for t in bank.values()]
    assert staged and all(t.is_pinned() for t in staged)


def test_speculation_snapshot_equals_a_synchronous_copy(dev):
    from repro_torch.core.streaming import SpeculativeGather
    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(14)
    store = DatasetStore.from_array(torch.randn(20_000, 64, generator=g, device=dev),
                                    rows_per_shard=4096, pin_memory=True)
    ids = torch.randint(-1, 20_000, (16, 4096), generator=g, device=dev, dtype=torch.int32)
    big = torch.randn(4096, 4096, generator=g, device=dev)
    for _ in range(3):  # keep the compute stream busy when the snapshot is taken
        big = big @ big / 64
    ids += torch.isfinite(big[:16, :1]).to(torch.int32) * 0
    expected = ids.clone()
    spec = SpeculativeGather(ids, store)
    ids.fill_(5)  # later writes on the compute stream never reach the snapshot
    got_ids, rows = spec.result()
    want = torch.unique(expected.cpu().to(torch.int64))  # a synchronous copy
    assert torch.equal(got_ids, want)
    assert torch.equal(rows, store.gather_rows(want))


# ------------------------------------------------ the store's write side
def _live_fresh(rows, live, metric, dev):
    """A fresh fdsq-cuda engine fitted on the live rows, in external-id order."""
    return ExactKNN(k=50, metric=metric, backend="cuda").fit(rows[torch.as_tensor(live, device=dev)])


def _same_as_fresh(got, want, live):
    wi = want.topk.indices.cpu().numpy()
    import numpy as np

    mapped = np.where(wi >= 0, np.asarray(live)[np.maximum(wi, 0)], -1)
    return (torch.equal(got.topk.scores, want.topk.scores)
            and bool((got.topk.indices.cpu().numpy() == mapped).all()))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_resident_delta_merge_equals_a_fresh_fit(dev, metric):
    """Upserts (one row, a batch, enough for two full delta shards and a
    partial one) and deletes on a resident engine on the card: each search
    runs knn_scan + knn_merge on every delta shard and finishes the queue
    once, bit-identical to a fresh fit on the live rows, before and after a
    compaction."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(20_000, 96, generator=g, device=dev)
    extra = torch.randn(9_000, 96, generator=g, device=dev)
    q = extra[:16] + 0.1 * torch.randn(16, 96, generator=g, device=dev)
    eng = ExactKNN(k=50, metric=metric, backend="cuda").fit(x)
    ids = np.concatenate([eng.upsert(extra[:1]), eng.upsert(extra[1:127]),
                          eng.upsert(extra[127:])])
    dead = [3, 19_999, int(ids[0]), int(ids[5000])]
    eng.delete(dead)
    rows = torch.cat([x, extra])
    live = np.setdiff1d(np.arange(rows.shape[0]), dead)
    fresh = _live_fresh(rows, live, metric, dev)
    n_delta = len(eng.store.delta_shards())
    assert n_delta == 3 and eng.store.delta_shards()[0].vectors.is_cuda
    for mode, m in (("fdsq", 1), ("fqsd", 16)):
        K.reset_launch_counts()
        got = eng.search(SearchRequest(queries=q[:m], mode_hint=mode))
        torch.cuda.synchronize()
        runs = 1 + _pilots(*eng._ds.vectors.shape, m, 50) + n_delta
        assert K.LAUNCHES["knn_scan"] == K.LAUNCHES["knn_merge"] == runs
        assert _same_as_fresh(got, fresh.search(SearchRequest(queries=q[:m], mode_hint=mode)),
                              live)
    eng.store.compact()
    got = eng.search(SearchRequest(queries=q, mode_hint="fqsd"))
    assert eng.store.generation == 1 and not eng.store.delta_shards()
    assert _same_as_fresh(got, fresh.search(SearchRequest(queries=q, mode_hint="fqsd")), live)


def test_streamed_delta_shards_are_staged_not_pinned(dev, tmp_path, monkeypatch):
    """A store in files is never pinned, nor are its delta blocks: f32 and
    int8 streamed searches copy them through the streams' page-locked banks
    (no pin_memory() a search), and answer as a resident engine does over
    the same live rows."""
    import numpy as np

    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(30_000, 64, generator=g, device=dev)
    extra = torch.randn(5_000, 64, generator=g, device=dev)
    q = extra[:16] + 0.1 * torch.randn(16, 64, generator=g, device=dev)
    DatasetStore.from_array(x, rows_per_shard=8192, directory=str(tmp_path))
    store = DatasetStore.open(str(tmp_path))
    store.ensure_tier("int8", device=dev)
    eng = ExactKNN(k=50, backend="cuda").fit_store(store, resident=False).enable_int8()
    ids = eng.upsert(extra)
    eng.delete([7, int(ids[3])])
    assert not any(p.vectors.is_pinned() for p in store.delta_shards())
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a, **kw: pytest.fail("a search pinned a tensor"))
    live = np.setdiff1d(np.arange(35_000), [7, int(ids[3])])
    rows = torch.cat([x, extra])
    fresh = _live_fresh(rows, live, "l2", dev)
    got = eng.search(SearchRequest(queries=q))
    assert got.stats["transfers"] == 4 + 2  # main shards, then delta shards
    assert _same_as_fresh(got, fresh.search(SearchRequest(queries=q, mode_hint="fqsd")), live)
    got8 = eng.search(SearchRequest(queries=q, tier="int8"))
    oracle = ops.knn_exact_direct(fresh._pad_queries(q), fresh._ds.vectors, fresh._ds.norms,
                                  50, 1024)
    assert torch.equal(got8.topk.scores, oracle.scores)
    assert bool((got8.topk.indices.cpu().numpy()
                 == np.asarray(live)[oracle.indices.cpu().numpy()]).all())


def test_compaction_of_a_device_store_on_a_thread(dev):
    """A store whose one shard lives on the card: tombstones flip its norms
    there, and compact_async gathers the live rows and builds the new
    generation on the card, ordered by an event before the swap; a view
    pinned before keeps its generation."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(10_000, 128, generator=g, device=dev)
    extra = torch.randn(3_000, 128, generator=g, device=dev)
    q = x[:16] + 0.1 * torch.randn(16, 128, generator=g, device=dev)
    eng = ExactKNN(k=50, backend="cuda").fit(x).enable_int8()
    store = eng.store
    ids = eng.upsert(extra)
    eng.delete([0, 5, int(ids[1])])
    assert store.read_shard(0).norms.is_cuda and torch.isinf(store.read_shard(0).norms[5])
    view = store.snapshot()
    t = store.compact_async()
    try:
        t.join(timeout=120)
    finally:
        assert not t.is_alive()
    assert store.compaction_status()["error"] is None and store.generation == 1
    assert store.read_shard(0).vectors.is_cuda and view.generation == 0
    assert view.read_shard(0).vectors.is_cuda
    view.release()
    live = np.setdiff1d(np.arange(13_000), [0, 5, int(ids[1])])
    fresh = _live_fresh(torch.cat([x, extra]), live, "l2", dev)
    got = eng.search(SearchRequest(queries=q, mode_hint="fqsd"))
    assert _same_as_fresh(got, fresh.search(SearchRequest(queries=q, mode_hint="fqsd")), live)
    got8 = eng.search(SearchRequest(queries=q, tier="int8"))
    oracle = ops.knn_exact_direct(fresh._pad_queries(q), fresh._ds.vectors, fresh._ds.norms,
                                  50, 1024)
    assert torch.equal(got8.topk.scores, oracle.scores)


def _pow2_rows(n, d, g, dev):
    """Integer rows whose norms are powers of two (1, 4, 16 or 64 unit
    entries), so their L2-normalised form is exact (cos)."""
    counts = torch.tensor([1, 4, 16, 64], device=dev)[
        torch.randint(0, 4, (n,), generator=g, device=dev)]
    ranks = torch.rand(n, d, generator=g, device=dev).argsort(1).argsort(1)
    signs = torch.randint(0, 2, (n, d), generator=g, device=dev) * 2 - 1
    return ((ranks < counts[:, None]) * signs).to(torch.float32)


@pytest.mark.parametrize("metric,tier", [("l2", "f32"), ("ip", "f32"), ("cos", "f32"),
                                         ("l2", "int8")])
def test_scheduler_padding_rows_leave_real_answers_unchanged(dev, metric, tier):
    """The scheduler pads a batch of 5 to 8 with zero rows (a zero row
    under cos normalises to a zero vector). On fdsq-cuda and fqsd-int8-cuda,
    where knn_scan filters per block of bm queries, each real row's answer
    must equal the plain engine's on the same row and the kernel engine's
    on the unpadded batch."""
    from repro_torch.serving import AdaptiveScheduler

    g = torch.Generator(device=dev).manual_seed(31)
    if tier == "int8":
        x = _unit_scale_rows(8192, 128, g, dev)
    elif metric == "cos":
        x = _pow2_rows(8192, 128, g, dev)
    else:
        x = _ints((8192, 128), g, dev)
    q = x[torch.randint(0, 8192, (5,), generator=g, device=dev)].clone()
    fused = ExactKNN(k=64, metric=metric, backend="cuda").fit(x)
    plain = ExactKNN(k=64, metric=metric, backend="torch").fit(x)
    if tier == "int8":
        fused.enable_int8()
        plain.enable_int8()
    kw = dict(policy="throughput", int8_min_depth=1 if tier == "int8" else None)
    served = {r.rid: r for r in AdaptiveScheduler(fused, **kw).serve(
        iter([SearchRequest(queries=q[i], rid=i) for i in range(5)]))}
    assert fused.plans[-1].m == 8
    assert fused.plans[-1].executor == ("fqsd-int8-cuda" if tier == "int8" else "fdsq-cuda")
    unpadded = fused.search(SearchRequest(queries=q, mode_hint="fqsd", tier=tier))
    want = plain.search(SearchRequest(queries=q, mode_hint="fqsd", tier=tier))
    for i in range(5):
        ws, wi = want.topk.scores[i].cpu(), want.topk.indices[i].cpu()
        assert torch.equal(served[i].topk.scores, ws) and torch.equal(served[i].topk.indices, wi)
        assert torch.equal(unpadded.topk.scores[i].cpu(), ws)
        assert torch.equal(unpadded.topk.indices[i].cpu(), wi)


def test_scheduler_service_time_includes_the_copy_to_the_host(dev):
    """A dispatch's service time ends when its answers are on the host: it is
    at least the CUDA-event time of the same search, which the time to
    enqueue the kernels alone is not."""
    from repro_torch.serving import AdaptiveScheduler

    g = torch.Generator(device=dev).manual_seed(37)
    x = torch.randn(1_000_000, 256, generator=g, device=dev)
    eng = ExactKNN(k=1024, backend="cuda").fit(x)
    del x
    q = torch.randn(64, 256, generator=g, device=dev).cpu().numpy()
    sched = AdaptiveScheduler(eng, policy="throughput")
    reqs = [SearchRequest(queries=q[i], rid=i) for i in range(64)]
    sched._execute(reqs, "fqsd", None)  # warm-up
    event_ms = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        eng.search(SearchRequest(queries=q, mode_hint="fqsd"))
        b.record()
        b.synchronize()
        event_ms.append(a.elapsed_time(b))
    _, dt_s = sched._execute(reqs, "fqsd", None)
    assert dt_s * 1e3 >= min(event_ms), (dt_s * 1e3, event_ms)


def test_int8_fallback_through_the_f32_kernel_has_the_direct_bits(dev):
    """Clustered rows (clusters larger than the rescore budget, distances
    concentrated at d = 960): the int8 certificate leaves rows uncertified,
    fqsd-int8-cuda recomputes them with knn_exact_rescored (one knn_scan and
    one knn_merge more), and every row has knn_exact_direct's bits."""
    from repro_torch.data import query_stream, vector_dataset

    x = vector_dataset(200_000, 960, seed=0)
    q = query_stream(x, 16, seed=1)
    eng = ExactKNN(k=256, backend="cuda").fit(x).enable_int8()
    K.reset_launch_counts()
    res = eng.search(SearchRequest(queries=q, tier="int8"))
    torch.cuda.synchronize()
    assert not bool(res.certified.all())
    # the rescan's queue is 512 wide, over the uncertified rows alone
    pilot = _pilots(*eng._ds.vectors.shape, int((~res.certified).sum()), 512)
    assert K.LAUNCHES["knn_int8_scan"] == 1 and K.LAUNCHES["knn_scan"] == 1 + pilot
    assert K.LAUNCHES["knn_merge"] == 2 + pilot
    ds = eng._ds
    want = ops.knn_exact_direct(eng._pad_queries(q), ds.vectors, ds.norms, 256, 1024)
    assert torch.equal(res.topk.scores, want.scores)
    assert torch.equal(res.topk.indices, want.indices)


@pytest.fixture
def tuning_cache(tmp_path):
    """A cache file under tmp_path as the planner's default, restored after."""
    from repro_torch.tuning import AutotuneCache, set_default_cache

    cache = AutotuneCache(str(tmp_path / "card.json"))
    set_default_cache(cache)
    try:
        yield cache
    finally:
        set_default_cache(None)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_autotune_persists_a_legal_winner_with_the_default_bits(dev, tuning_cache, tier):
    """The sweep on the card persists a legal winner; the tuned plan runs it
    and answers with the default plan's bits."""
    from repro_torch.tuning import AutotuneCache, autotune_knn, candidate_blocks, tuning_key

    g = torch.Generator(device=dev).manual_seed(11)
    x, q = _ints((20_000, 128), g, dev), _ints((16, 128), g, dev)
    eng = ExactKNN(k=10, backend="cuda").fit(x)
    if tier == "int8":
        eng.enable_int8()
    req = SearchRequest(queries=q, mode_hint="fqsd", tier=tier)
    want = eng.search(req)
    p = eng.plan_for("fqsd", 16, tier=tier)
    r = eng.rescore_factor if tier == "int8" else None
    best, timings = autotune_knn(p.m, p.padded_rows, p.padded_dim, k=10, tier=tier,
                                 repeats=1)
    assert len(timings) == len(candidate_blocks(p.m, p.padded_rows, p.padded_dim, 10, r))
    assert best in candidate_blocks(p.m, p.padded_rows, p.padded_dim, 10, r)
    key = tuning_key(p.executor, 16, p.padded_rows, p.padded_dim, "float32", "l2", 10, r)
    assert AutotuneCache(tuning_cache.path).get(key) == best
    got = eng.search(req)
    torch.cuda.synchronize()
    assert (got.plan.block_m, got.plan.block_n, got.plan.block_d) == tuple(best)
    assert got.kernel_stats["blocks"] == tuple(best)
    assert torch.equal(got.topk.scores, want.topk.scores)
    assert torch.equal(got.topk.indices, want.topk.indices)


def test_probe_cuda_capability_on_the_card(dev, tuning_cache):
    from repro_torch.roofline import HwSpec
    from repro_torch.tuning import lookup_cuda_capability, probe_cuda_capability

    assert probe_cuda_capability() is True and lookup_cuda_capability() is True
    hw = HwSpec.from_device(dev, tdp_watts=700.0)
    assert hw.name == torch.cuda.get_device_name(dev)
    assert hw.hbm_bytes == torch.cuda.get_device_properties(dev).total_memory


def _over_the_wire(server, calls):
    """Start the server, send (method, path, body) calls in turn on one
    persistent connection, stop; returns the (status, body) answers. Every
    wait is bounded."""
    import asyncio

    from repro_torch.server.loadgen import Connection, LoadReport

    async def run():
        async with server:
            conn = Connection(*server.address, LoadReport(mode="test", duration_s=0.0))
            try:
                return [await asyncio.wait_for(conn.request(*call), 60) for call in calls]
            finally:
                await conn.close()

    return asyncio.run(asyncio.wait_for(run(), 300))


def _wire_bits(values):
    import numpy as np

    return np.asarray(values, np.float32).view(np.uint32)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_server_answers_as_the_same_batch_dispatched_in_process(dev, tier):
    """A KnnServer on the card answers each search over the wire with the
    bits of the same one-request batch dispatched in process; its dispatches
    run on the server's worker thread, the card its current device, and
    launch the tier's kernels."""
    import threading

    from repro_torch.api import Router
    from repro_torch.server import KnnServer
    from repro_torch.serving import AdaptiveScheduler

    g = torch.Generator(device=dev).manual_seed(31)
    x = _unit_scale_rows(20_000, 256, g, dev) if tier == "int8" else _ints((20_000, 256), g, dev)
    q = _ints((3, 256), g, dev).cpu().numpy()
    router = Router()
    eng = router.create("docs", x, k=72, backend="cuda")
    if tier == "int8":
        eng.enable_int8()
    server = KnnServer(router, port=0)
    sched, seen = server.schedulers["docs"], []
    search = sched._search

    def spy(request):
        K.reset_launch_counts()
        res = search(request)
        seen.append((threading.current_thread().name, torch.cuda.current_device(),
                     dict(K.LAUNCHES)))
        return res

    sched._search = spy
    got = _over_the_wire(server, [("POST", "/v1/collections/docs/search",
                                   {"queries": row.tolist(), "rid": i, "tier": tier})
                                  for i, row in enumerate(q)])
    direct = AdaptiveScheduler(router=router, collection="docs")
    for i, row in enumerate(q):
        [want] = direct.dispatch_batch([SearchRequest(queries=row, rid=i, tier=tier)])
        st, body = got[i]
        assert st == 200 and body["tier"] == tier and body["rid"] == i
        assert (_wire_bits(body["scores"]) == _wire_bits(want.topk.scores.numpy())).all()
        assert body["indices"] == want.topk.indices.tolist()
        assert body["certified"] == bool(want.certified)
    scan = "knn_int8_scan" if tier == "int8" else "knn_scan"
    card = dev.index if dev.index is not None else torch.cuda.current_device()
    assert len(seen) == 3
    for thread, device, launches in seen:
        assert thread.startswith("knn-dispatch") and device == card
        assert launches[scan] >= 1 and launches["knn_merge"] >= 1


def test_searches_over_the_wire_during_a_background_compaction(dev):
    """POST compact {} starts the store's compactor thread on the card while
    searches run on the dispatch worker: every answer, during and after the
    swap, has the bits of a direct search of the live rows."""
    import asyncio

    from repro_torch.api import Router
    from repro_torch.server import KnnServer
    from repro_torch.server.loadgen import Connection, LoadReport

    g = torch.Generator(device=dev).manual_seed(32)
    x = _ints((200_000, 128), g, dev)
    q = _ints((64, 128), g, dev)
    router = Router()
    eng = router.create("docs", x, k=16, backend="cuda")
    eng.upsert(q[:8].cpu().numpy())
    eng.delete([5, 17, 999, 200_003])
    want = eng.search(SearchRequest(queries=q, mode_hint="fqsd"))
    scores, ids = want.topk.scores.cpu().numpy(), want.topk.indices.cpu().tolist()
    rows = q.cpu().numpy()
    server = KnnServer(router, port=0)

    def connection():
        return Connection(*server.address, LoadReport(mode="test", duration_s=0.0))

    async def ask(conn, method, path, body=None):
        return await asyncio.wait_for(conn.request(method, path, body), 60)

    async def searches():
        answers = {}

        async def lane(idx):
            conn = connection()
            try:
                for i in idx:
                    answers[i] = await ask(conn, "POST", "/v1/collections/docs/search",
                                           {"queries": rows[i].tolist(), "rid": i})
            finally:
                await conn.close()

        await asyncio.gather(*(lane(range(j, 64, 8)) for j in range(8)))
        return [answers[i] for i in range(64)]

    async def run():
        async with server:
            admin = connection()
            try:
                started = await ask(admin, "POST", "/v1/collections/docs/compact", {})
                during = await searches()
                for _ in range(1200):
                    st, status = await ask(admin, "GET", "/v1/collections/docs/compact")
                    if status["generation"] == 1 and not status["running"]:
                        break
                    await asyncio.sleep(0.05)
                after = await searches()
            finally:
                await admin.close()
        return started, (st, status), during, after

    started, polled, during, after = asyncio.run(asyncio.wait_for(run(), 300))
    assert started[0] == polled[0] == 200
    assert polled[1]["generation"] == 1 and polled[1]["error"] is None
    for answers in (during, after):
        for i, (st, body) in enumerate(answers):
            assert st == 200
            assert (_wire_bits(body["scores"]) == _wire_bits(scores[i])).all()
            assert body["indices"] == ids[i]
    assert ids[0][0] == 200_000  # the upserted copy of query 0, found first


# ------------------------------------------------------------------- the mesh
def _mesh_engines(dev, metric="l2", int8=False):
    """A (2, 2) mesh of four logical positions on the one card and a
    single-device engine, fitted from one store (the mesh's blocks are views
    of the single engine's rows). 6,000 rows pad to 6,144: blocks of 1,536,
    not a multiple of the scan's row tile at k = 1024, so each block scans
    its aligned rows and its tail."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(5)
    x = _ints((6000, 256), g, dev)
    x[5000] = x[9]
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    meng = ExactKNN(k=1024, metric=metric, backend="cuda", mesh=mesh)
    store = DatasetStore.from_array(x, row_mult=meng._row_mult())
    if int8:
        store.ensure_tier("int8")
    meng.fit_store(store)
    single = ExactKNN(k=1024, metric=metric, backend="cuda", device=dev).fit_store(store)
    q = _ints((16, 256), g, dev)
    q[0] = x[9]
    return meng, single, q


@pytest.mark.parametrize("mode,m", [("fdsq", 1), ("fdsq", 16), ("fqsd", 16)])
@pytest.mark.parametrize("k", [7, 1024])
def test_mesh_of_logical_devices_equals_the_single_device_search(dev, mode, m, k):
    """fdsq-sharded / fqsd-sharded (the ring) on ["cuda:0"] * 4 answer as
    fdsq-cuda does, bit for bit, through the kernels: knn_scan a block (two
    where the block has a tail) and knn_merge a block plus the hierarchical
    merges (2 + 1 on a 2 x 2 mesh; the ring merges once a block and step,
    then once a query block over "model")."""
    meng, single, q = _mesh_engines(dev)
    req = SearchRequest(queries=q[:m], k=k, mode_hint=mode)
    want = single.search(req)
    K.reset_launch_counts()
    got = meng.search(req)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    assert got.plan.executor == ("fdsq-sharded" if mode == "fdsq" else "fqsd-sharded")
    assert want.plan.executor == "fdsq-cuda"
    assert torch.equal(got.topk.scores, want.topk.scores)
    assert torch.equal(got.topk.indices, want.topk.indices)
    parts = len(ops.shard_parts(meng._ds.vectors.rows, k, 256))
    blocks = 4 if mode == "fdsq" else 8  # the ring: every position at both steps
    assert launches["knn_scan"] == blocks * parts
    assert launches["knn_merge"] == blocks + (3 if mode == "fdsq" else 2)


def test_mesh_int8_tier_has_the_direct_bits(dev):
    """fdsq-sharded-int8 on ["cuda:0"] * 4: one knn_int8_scan a block, one
    knn_merge a block and three hierarchical ones, bit-identical to
    knn_exact_direct; four per-device byte counts summing to the scan."""
    meng, single, q = _mesh_engines(dev, int8=True)
    K.reset_launch_counts()
    got = meng.search(SearchRequest(queries=q, tier="int8"))
    torch.cuda.synchronize()
    assert got.plan.executor == "fdsq-sharded-int8"
    assert K.LAUNCHES["knn_int8_scan"] == 4 and K.LAUNCHES["knn_merge"] == 7
    ds = single._ds
    want = ops.knn_exact_direct(single._pad_queries(q), ds.vectors, ds.norms, 1024, 1024)
    assert torch.equal(got.topk.scores, want.scores)
    assert torch.equal(got.topk.indices, want.indices)
    rows = meng._ds.vectors.rows
    assert got.stats["bytes_per_device"] == [rows * 256 + 12 * rows] * 4


def test_mesh_ring_int8_over_pinned_shards(dev):
    """fqsd-sharded-int8: pinned host shards ring-put to four logical
    positions, one knn_int8_scan and knn_merge a shard and one global merge,
    bit-identical to knn_exact_direct."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.store import DatasetStore

    g = torch.Generator(device=dev).manual_seed(6)
    x = _ints((5000, 256), g, dev)
    q = _ints((8, 256), g, dev)
    store = DatasetStore.from_array(x, rows_per_shard=1024, pin_memory=True)
    mesh = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
    eng = ExactKNN(k=100, backend="cuda", mesh=mesh, mesh_axes=("data",)).fit_store(
        store, resident=False).enable_int8()
    K.reset_launch_counts()
    got = eng.search(SearchRequest(queries=q, tier="int8"))
    torch.cuda.synchronize()
    assert got.plan.executor == "fqsd-sharded-int8"
    n = store.n_shards
    assert K.LAUNCHES["knn_int8_scan"] == n and K.LAUNCHES["knn_merge"] == n + 1
    assert got.stats["transfers"] == n and len(got.stats["bytes_per_device"]) == 4
    one = ExactKNN(k=100, backend="cuda", device=dev).fit(x)
    want = ops.knn_exact_direct(one._pad_queries(q), one._ds.vectors, one._ds.norms, 100, 1024)
    assert torch.equal(got.topk.scores, want.scores)
    assert torch.equal(got.topk.indices, want.indices)


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_scores_do_not_depend_on_the_batch(dev, metric):
    """On Gaussian rows (sums that round), a query's fdsq-cuda answer has
    the same bits in a batch of 1, 3, 8, 16 and 40 (the scan's bm 1, 4, 8,
    16): the query norms (and cos's query normalisation) are summed in one
    fixed order, 16 rows at a time, and each pair's score is one FMA chain
    over d whatever bm. So the l2 ring, whose blocks scan 8 queries,
    answers a batch of 16 as fdsq-cuda does."""
    from repro_torch.core.mesh import make_mesh

    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(6000, 200, generator=g, device=dev)
    q = torch.randn(40, 200, generator=g, device=dev)
    single = ExactKNN(k=100, metric=metric, backend="cuda", device=dev).fit(x)
    want = single.search(SearchRequest(queries=q, k=100)).topk
    for m in (1, 3, 8, 16):
        got = single.search(SearchRequest(queries=q[:m], k=100)).topk
        assert torch.equal(got.scores, want.scores[:m])
        assert torch.equal(got.indices, want.indices[:m])
    if metric != "l2":
        return  # a mesh engine keeps raw rows for cos, the single one normalised ones
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    meng = ExactKNN(k=100, metric=metric, backend="cuda", mesh=mesh).fit(x)
    got = meng.search(SearchRequest(queries=q[:16], k=100, mode_hint="fqsd"))
    assert got.plan.executor == "fqsd-sharded"
    assert torch.equal(got.topk.scores, want.scores[:16])
    assert torch.equal(got.topk.indices, want.indices[:16])


def _lm(arch, dev, **overrides):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch).smoke_model, **overrides)
    return cfg, T.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-30b-a3b", "qwen2.5-14b"])
def test_lm_decode_steps_equal_the_forward_on_the_card(dev, arch):
    """Smoke width in f32: decode_step one token at a time from an empty
    cache, and after a prefill, gives apply's logits at each position
    (f32 sums over GEMMs of another shape: rtol 1e-4, atol 1e-4). The MoE
    runs at a capacity factor where neither path drops an assignment."""
    from repro_torch.models import transformer as T

    cfg, p = _lm(arch, dev, capacity_factor=8.0)
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (3, 12), generator=g, device=dev)
    full, _ = T.apply(p, cfg, tok)
    cache = T.init_cache(cfg, 3, 12, device=dev)
    steps = []
    for pos in range(12):
        logits, cache = T.decode_step(p, cfg, cache, tok[:, pos:pos + 1])
        steps.append(logits)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4, atol=1e-4)
    last, cache = T.prefill(p, cfg, tok[:, :7], max_len=12)
    torch.testing.assert_close(last, full[:, 6], rtol=1e-4, atol=1e-4)
    logits, _ = T.decode_step(p, cfg, cache, tok[:, 7:8])
    torch.testing.assert_close(logits, full[:, 7], rtol=1e-4, atol=1e-4)
    assert (full[..., cfg.vocab:] == -torch.inf).all()


def test_lm_on_the_card_equals_the_cpu(dev):
    """The same smoke weights (f32, TF32 off) on the card and on the CPU:
    a prefill and two decode steps within rtol 1e-4, atol 1e-4."""
    import copy

    from repro_torch.models import transformer as T

    cfg, p = _lm("qwen2.5-14b", dev)
    host = copy.deepcopy(p).to("cpu")
    tok = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(2))
    out = []
    for params, device in ((p, dev), (host, torch.device("cpu"))):
        t = tok.to(device)
        last, cache = T.prefill(params, cfg, t[:, :8], max_len=10)
        a, cache = T.decode_step(params, cfg, cache, t[:, 8:9])
        b, _ = T.decode_step(params, cfg, cache, t[:, 9:10])
        out.append([x.cpu() for x in (last, a, b)])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_decode_server_on_the_card_repeats_its_tokens(dev):
    """bf16 at smoke width: every request completes, no pad id, and a second
    server on the same weights gives the same tokens."""
    from repro_torch.serving import DecodeServer

    cfg, p = _lm("minicpm-2b", dev, dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        srv = DecodeServer(p, cfg, n_slots=4, max_len=64)
        for rid in range(10):
            srv.submit(rid, prompt_token=rid + 1, n_tokens=6)
        runs.append({s.rid: s.tokens for s in srv.run_until_drained()})
    assert runs[0] == runs[1]
    assert sorted(runs[0]) == list(range(10))
    assert all(len(t) == 7 and all(0 <= x < cfg.vocab for x in t) for t in runs[0].values())


def test_lm_train_step_on_the_card_equals_the_cpu(dev, tmp_path):
    """The smoke train cell (minicpm, f32, TF32 off) from the same weights
    and batch on the card and on the CPU: the loss within 1e-5, every
    gradient within 1e-4 of its leaf's largest value, and the parameters
    after the step (lr 1e-4) within 1e-6."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import demo
    from repro_torch.models import transformer as T

    arch = get_config("minicpm-2b")
    cell, (p, opt, batch) = demo.materialize(arch, arch.shape("train_4k"), device=dev)
    cpu = lambda t: t.to("cpu", copy=True)  # noqa: E731
    host = (copy.deepcopy(p).to("cpu"),
            type(opt)(cpu(opt.step), {k: cpu(v) for k, v in opt.m.items()},
                      {k: cpu(v) for k, v in opt.v.items()}),
            {k: cpu(v) for k, v in batch.items()})
    cfg = arch.smoke_model
    (loss, _), grads = T.value_and_grad(p, cfg, batch)
    (hloss, _), hgrads = T.value_and_grad(host[0], cfg, host[2])
    assert abs(float(loss) - float(hloss)) <= 1e-5
    for n, g in grads.items():
        want = hgrads[n]
        torch.testing.assert_close(g.cpu(), want, rtol=0, atol=1e-4 * float(want.abs().max()))
    p, _, m = cell.fn(p, opt, batch)
    hp, _, hm = cell.fn(*host)
    assert abs(float(m["loss"]) - float(hm["loss"])) <= 1e-5
    for (n, a), b in zip(p.named_parameters(), hp.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-6)


def test_checkpoint_round_trip_from_the_card(dev, tmp_path):
    """A train state on the card (bf16 weights, int8 moments) saved async and
    restored into a fresh template on the card, bit for bit."""
    import dataclasses

    from repro_torch.checkpoint import ckpt, load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import reference_layout, tree_leaves

    cfg = dataclasses.replace(get_config("qwen2.5-14b").smoke_model, dtype=torch.bfloat16)
    p = T.init(torch.Generator(device=dev).manual_seed(4), cfg, dev)
    opt = adamw_init(p, AdamWConfig(moment_dtype="int8"))
    for v in opt.m.values():
        v.q.random_(-127, 128)
        v.scale.uniform_()
    save_checkpoint(tmp_path, 5, (p, opt), blocking=False)
    ckpt.wait_for_pending()
    fresh = T.init(torch.Generator(device=dev).manual_seed(5), cfg, dev)
    tmpl = (fresh, adamw_init(fresh, AdamWConfig(moment_dtype="int8")))
    got, mani = load_checkpoint(tmp_path, tmpl)
    assert mani["step"] == 5
    for a, b in zip(tree_leaves(reference_layout((p, opt))), tree_leaves(reference_layout(got))):
        for x, y in zip(getattr(a, "parts", [a]), getattr(b, "parts", [b])):
            assert y.device.type == dev.type and torch.equal(x, y)


def test_retrieve_topk_on_the_card_equals_its_plain_version(dev):
    """two-tower retrieval on the card runs knn_scan + knn_merge (metric ip)
    and equals the plain chunk_step on the same user rows: integer-valued
    candidates over 8 and a user vector rounded to 1/8, so every inner
    product is exact and both sides hold the same scores and indices."""
    from repro_torch.configs import get_config
    from repro_torch.core.fqsd import chunk_step
    from repro_torch.core.topk import empty_topk
    from repro_torch.models import recsys as R

    cfg = get_config("two-tower-retrieval").smoke_model
    p = R.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cand = torch.randint(-64, 65, (50_000, cfg.tower_mlp[-1]), generator=g, device=dev) / 8
    users = torch.tensor([3, 500], dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    got = R.retrieve_topk(p, cfg, users, cand, 100)
    torch.cuda.synchronize()
    pilot = _pilots(*cand.shape, 2, 100)
    assert K.LAUNCHES["knn_scan"] == K.LAUNCHES["knn_merge"] == 1 + pilot
    with torch.no_grad():
        u = torch.round(R._two_tower_embed(p, cfg, users, "user_tower") * 8) / 8
    got = R.mips_topk(u, cand, 100)
    want = chunk_step(empty_topk((2,), 100, device=dev), u, cand, None, 0, cand.shape[0], "ip")
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)


@pytest.mark.parametrize("arch_id,shape", [("dlrm-rm2", "train_batch"), ("bst", "train_batch"),
                                           ("meshgraphnet", "full_graph_sm"),
                                           ("meshgraphnet", "molecule")])
def test_recsys_and_gnn_train_steps_on_the_card_equal_the_cpu(dev, arch_id, shape):
    """A smoke train step from the same params, moments and batch on the
    card and on the CPU (TF32 off): the loss within 1e-5 relative, the
    params after the step within 1e-6 plus 1e-5 of each leaf's largest
    value (the card's scatters sum with atomics, in no fixed order)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import demo
    from repro_torch.tree import tree_leaves, tree_map

    arch = get_config(arch_id)
    cell, args = demo.materialize(arch, arch.shape(shape), device=dev)
    host = tree_map(lambda t: t.detach().to("cpu", copy=True).requires_grad_(t.requires_grad),
                    args)
    p, _, m = cell.fn(*args)
    hp, _, hm = cell.fn(*host)
    assert abs(float(m["loss"]) - float(hm["loss"])) <= 1e-5 * abs(float(hm["loss"]))
    for a, b in zip(tree_leaves(p), tree_leaves(hp)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=1e-6 + 1e-5 * float(b.detach().abs().max()))


def _card_mesh(dev, shape):
    from repro_torch.core.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), devices=[dev] * (shape[0] * shape[1]))


@pytest.mark.parametrize("name", ["gist_fqsd", "msmarco_fdsq", "yfcc_ring", "yfcc_ring_q"])
def test_knn_cells_on_a_card_mesh_equal_the_meshless_cells(dev, name):
    """The smoke kNN cells on (2, 2) of one card run the kernels (backend
    "cuda") and answer as the meshless cell, bit for bit on integer data."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import use_mesh
    from repro_torch.launch.steps import build_cell

    arch = get_config("knn-search")
    with use_mesh(_card_mesh(dev, (2, 2))):
        cell = build_cell(arch, arch.shape(name), smoke=True)
        g = torch.Generator(device=dev).manual_seed(2)
        q = _ints(tuple(cell.inputs[0].shape), g, dev)
        x = _ints(tuple(cell.inputs[1].shape), g, dev)
        xn = torch.sum(x * x, dim=-1)
        K.reset_launch_counts()
        got = cell.fn(q, x, xn)
        torch.cuda.synchronize()
    assert K.LAUNCHES["knn_scan"] >= 4 and K.LAUNCHES["knn_merge"] >= 5
    want = build_cell(arch, arch.shape(name), smoke=True).fn(q, x, xn)
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)


def test_mesh_islands_on_the_card_equal_the_cpu_mesh(dev):
    """Smoke qwen3-moe's prefill + decode on (1, 8) of the card and of the
    host CPU: both islands run; the logits within 1e-4 (TF32 off)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh, use_mesh
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-moe-30b-a3b").smoke_model
    p = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(1))
    out = {}
    for mesh in (_card_mesh(dev, (1, 8)), make_mesh((1, 8), ("data", "model"),
                                                    devices=["cpu"] * 8)):
        d = mesh.first
        pd = p.to(d)
        with use_mesh(mesh):
            _, cache = T.prefill(pd, cfg, tok[:, :8].to(d), max_len=16)
            logits, _ = T.decode_step(pd, cfg, cache, tok[:, 8:9].to(d))
        out[d.type] = logits.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-4)


def test_row_sharded_table_and_retrieval_on_the_card(dev):
    """The row-sharded lookup on (1, 8) of the card is the meshless gather
    bit for bit; two-tower retrieval over row-sharded candidates on (1, 4)
    runs the kernels and equals the meshless kernel's answer."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import use_mesh
    from repro_torch.launch import demo
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as R

    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((4096, 16), generator=g, device=dev)
    ids = torch.randint(0, 4096, (64, 5), generator=g, device=dev, dtype=torch.int32)
    with use_mesh(_card_mesh(dev, (1, 8))):
        got = R.embedding_lookup(table, ids)
    assert torch.equal(got, table[ids.long()])
    arch = get_config("two-tower-retrieval")
    shape = arch.shape("retrieval_cand")
    cell, args = demo.materialize(arch, shape, smoke=True, seed=4, device=dev)
    want = cell.fn(*args)
    with use_mesh(_card_mesh(dev, (1, 4))):
        K.reset_launch_counts()
        got = build_cell(arch, shape, smoke=True).fn(*args)
        torch.cuda.synchronize()
    assert K.LAUNCHES["knn_merge"] == 5
    assert torch.equal(got.scores, want.scores) and torch.equal(got.indices, want.indices)


def test_elastic_round_trip_on_the_card(dev, tmp_path):
    """Smoke qwen3-moe's params placed on (2, 4) of the card, saved,
    restored on remesh(2 positions), saved, restored on (2, 4): bitwise."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import use_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime.elastic import remesh, reshard_tree
    from repro_torch.runtime.sharding import NamedSharding, sanitize_spec
    from repro_torch.tree import reference_layout, tree_leaves, tree_map

    cfg = get_config("qwen3-moe-30b-a3b").smoke_model
    p = T.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    layout = reference_layout(p)
    mesh = _card_mesh(dev, (2, 4))
    with use_mesh(mesh):
        specs = T.param_specs(cfg, training=True)
    placed = reshard_tree(layout, specs, mesh)
    save_checkpoint(tmp_path / "a", 1, placed)

    def shardings(m):
        return tree_map(lambda x, sp: NamedSharding(m, sanitize_spec(
            tuple(x.shape), sp, dict(m.shape))), layout, specs)

    small = remesh([dev] * 2)
    got, _ = load_checkpoint(tmp_path / "a", placed, shardings=shardings(small))
    save_checkpoint(tmp_path / "b", 2, got)
    back, _ = load_checkpoint(tmp_path / "b", placed, shardings=shardings(mesh))
    for a, b in zip(tree_leaves(layout), tree_leaves(back)):
        a = torch.stack(a.parts) if hasattr(a, "parts") else a
        b = torch.stack([t.full() for t in b.parts]) if hasattr(b, "parts") else b.full()
        assert torch.equal(a, b)


# ------------------------------------------------------------ distinct cards
@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _each_guarded_kernel(q, x) -> dict:
    """Every kernel the library launches, on (q, x)'s card: knn_scan,
    knn_merge, the pilot's scan and merge, knn_int8_scan, l2dist, topk."""
    from repro_torch.core.quantized import quantize_dataset
    from repro_torch.kernels.l2dist import kernel as L
    from repro_torch.kernels.topk import kernel as T

    qn, xn = torch.sum(q * q, -1), torch.sum(x * x, -1)
    sv, si, skips = K.knn_scan(q, x, qn, xn, 64, "l2", 16, 512, True, 32)
    ds = quantize_dataset(x)
    int8 = ops.int8_shard_operands(q, ds.q, ds.scales, ds.err, ds.qnorm_sq, 63)
    scores = L.l2dist_tiles(q, x, qn, xn)
    return {"knn_scan": (sv, si, skips), "knn_merge": K.knn_merge(sv, si),
            "pilot": K.pilot_bound(q, x, qn, xn, 64, "l2", 16, 512, 2048),
            "knn_int8_scan": K.knn_int8_scan(*int8, True, 8), "l2dist": (scores,),
            "topk": T.topk_scan(scores, 64, 512, 16)}


def test_each_guarded_kernel_launches_on_the_card_of_its_operands(cards):
    """With card 0 current, every kernel launched for tensors on card 1
    runs there (the launch guard makes their card current, then restores
    card 0) and gives card 0's bits."""
    g = torch.Generator(device=cards[0]).manual_seed(41)
    q, x = _ints((16, 256), g, cards[0]), _ints((65536, 256), g, cards[0])
    want = _each_guarded_kernel(q, x)
    with torch.cuda.device(cards[0]):
        K.reset_launch_counts()
        got = _each_guarded_kernel(q.to(cards[1]), x.to(cards[1]))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(cards[1])
    assert K.LAUNCHES == {"knn_scan": 2, "knn_merge": 2, "knn_int8_scan": 1, "topk": 1,
                          "l2dist": 1}
    for name, outs in want.items():
        for a, b in zip(outs, got[name]):
            assert b.device == cards[1] and torch.equal(a.cpu(), b.cpu()), name


def test_a_launch_with_operands_on_two_cards_raises(cards):
    from repro_torch.core.quantized import quantize_dataset
    from repro_torch.kernels.l2dist import kernel as L

    a, b = cards[:2]
    q, x = torch.ones(16, 256, device=a), torch.ones(1024, 256, device=b)
    qn, xn = q.sum(-1), x.sum(-1)
    v = torch.zeros(16, 2, 64, device=a)
    ds = quantize_dataset(torch.ones(1024, 256, device=a))
    int8 = list(ops.int8_shard_operands(q, ds.q, ds.scales, ds.err, ds.qnorm_sq, 63))
    int8[1] = int8[1].to(b)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="share one CUDA device"):
        K.knn_scan(q, x, qn, xn, 64, "l2", 16, 512)
    with pytest.raises(ValueError, match="share one CUDA device"):
        K.knn_merge(v, torch.zeros(16, 2, 64, dtype=torch.int32, device=b))
    with pytest.raises(ValueError, match="share one CUDA device"):
        K.knn_int8_scan(*int8)
    with pytest.raises(ValueError, match="share one CUDA device"):
        L.l2dist_tiles(q, x, qn, xn)
    assert sum(K.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", ["fqsd", "fdsq"])
def test_the_mesh_over_distinct_cards_answers_as_one_card(cards, mode):
    """``Router.create(devices=n)`` over n distinct cards (four where there
    are, else two): the ring (fqsd) and FD-SQ's merge tree answer as one
    card's scan of the same rows, bit for bit on integer rows."""
    from repro_torch.api import Router

    n = 4 if len(cards) >= 4 else 2
    g = torch.Generator(device=cards[0]).manual_seed(43)
    x, q = _ints((n * 65536, 256), g, cards[0]), _ints((64, 256), g, cards[0])
    eng = Router().create("ring", x, devices=n, k=1024, backend="cuda")
    assert list(eng.mesh.devices.flat) == cards[:n]
    got = eng.search(SearchRequest(queries=q, mode_hint=mode))
    want = ExactKNN(k=1024, backend="cuda", device=cards[0]).fit(x).search(
        SearchRequest(queries=q, mode_hint=mode))
    assert got.plan.executor == f"{mode}-sharded"
    assert got.topk.scores.device == cards[0]
    assert torch.equal(got.topk.scores, want.topk.scores)
    assert torch.equal(got.topk.indices, want.topk.indices)


def test_blocks_fitted_over_distinct_cards_hold_their_own_bytes(cards):
    """Fitted from rows on card 0 and the rows dropped, every card's block
    (vectors and norms) is memory of its own, not a view that keeps a
    larger tensor alive on its card."""
    from repro_torch.api import Router

    g = torch.Generator(device=cards[0]).manual_seed(44)
    x = _ints((len(cards) * 4096, 256), g, cards[0])
    eng = Router().create("own", x, devices=len(cards), k=16, backend="cuda")
    del x
    for sharded in (eng._ds.vectors, eng._ds.norms):
        for dev, block in zip(cards, sharded.local):
            assert block.device == dev
            assert block.untyped_storage().nbytes() == block.nbytes
