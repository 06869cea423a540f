"""Online mutation in the port against the reference: upserts into delta
shards, deletes as +inf norms, and the engine that searches both.

The same seeded numpy history (upserts, deletes, a compaction) goes through
both packages on the CPU, the port with ``device="cpu"`` (its kernel steps
run their plain versions). Rows are integers in [-127, 127] with one entry
at ±127, so every score is exact and every row's int8 scale is exactly 1:
values, indices, tie order, certificates and stream counters must be
bit-identical — resident on both backends (``fdsq-torch`` / ``fqsd-torch``
and ``fdsq-cuda``), the int8 tier, and streamed. A mutated engine must also
equal a fresh engine fitted on its live rows in external-id order, with
positions mapped to ids: the check ``chip_smoke.py`` makes on the card.
Modelled on ``TestOnlineMutation`` in ``tests/test_store.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.api.types import SearchRequest as JRequest
from repro.core.engine import ExactKNN as JExactKNN
from repro.store import DatasetStore as JStore
from repro_torch import ExactKNN, SearchRequest
from repro_torch.core.executors import cache_info, clear_executable_cache
from repro_torch.store import DatasetStore

N, D, K_, ROWS = 700, 40, 6, 256


def _np(t):
    return np.asarray(t)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _ints(rng, n):
    x = rng.integers(-127, 128, (n, D)).astype(np.float32)
    x[np.arange(n), rng.integers(0, D, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(61)
    x = _ints(rng, N)
    x[300], x[650] = x[12], x[12]  # exact ties across shards
    ups = [_ints(rng, 5), _ints(rng, 300)]
    ups[0][0] = x[12]  # a delta row tied with three main rows
    ups[1][7] = x[40]
    q = rng.integers(-40, 41, (4, D)).astype(np.float32)
    q[0], q[1] = x[12], ups[1][7]
    return x, ups, q


def _mutate(eng, ups):
    """The history both packages replay: two upserts, deletes of main and
    delta rows (one of them a planted tie), another upsert."""
    a = eng.upsert(ups[0])
    eng.delete([3, 650, int(a[2])])
    b = eng.upsert(ups[1])
    eng.delete([int(b[0]), 41])
    return np.concatenate([a, b])


def _same_result(got, want, streamed=False):
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same(got.certified, want.certified)
    if streamed:
        for key in ("transfers", "restarts", "bytes_scanned"):
            assert got.stats[key] == want.stats[key], key


_BACKENDS = {"torch": "xla", "cuda": "pallas"}


def _engines(x, backend, resident, int8=False):
    if resident:
        t = ExactKNN(k=K_, backend=backend, device="cpu").fit(x)
        j = JExactKNN(k=K_, backend=_BACKENDS[backend]).fit(x)
    else:
        t = ExactKNN(k=K_, backend=backend, device="cpu", retry_backoff_s=0.0).fit_store(
            DatasetStore.from_array(x, rows_per_shard=ROWS), resident=False)
        j = JExactKNN(k=K_, backend=_BACKENDS[backend], retry_backoff_s=0.0).fit_store(
            JStore.from_array(x, rows_per_shard=ROWS), resident=False)
    if int8:
        t.enable_int8()
        j.enable_int8()
    return t, j


_CASES = [(b, r, tier, mode) for b in ("torch", "cuda") for r in (True, False)
          for tier, mode in (("f32", "fdsq"), ("f32", "fqsd"), ("int8", "fqsd"))]


@pytest.mark.parametrize("backend,resident,tier,mode", _CASES,
                         ids=[f"{b}-{'resident' if r else 'streamed'}-{t}-{m}"
                              for b, r, t, m in _CASES])
def test_mutated_engine_matches_reference(data, backend, resident, tier, mode):
    x, ups, q = data
    t, j = _engines(x, backend, resident, int8=tier == "int8")
    assert _mutate(t, ups).tolist() == _mutate(j, ups).tolist()
    got = t.search(SearchRequest(queries=q, tier=tier, mode_hint=mode))
    want = j.search(JRequest(queries=q, tier=tier, mode_hint=mode))
    _same_result(got, want, streamed=not resident)
    assert int(got.topk.indices[1, 0]) in (40, N + 5 + 7)  # a delta row ties a main row
    if not resident:
        n_delta = len(t.store.delta_shards())
        assert n_delta == 2 and (got.stats["transfers"] == 3 + n_delta if tier == "f32"
                                 else got.stats["transfers"] == 3)
    # and again after the fold: ids survive, answers do not move
    t.store.compact()
    j.store.compact()
    again = t.search(SearchRequest(queries=q, tier=tier, mode_hint=mode))
    _same_result(again, j.search(JRequest(queries=q, tier=tier, mode_hint=mode)))
    _same(again.topk.scores, got.topk.scores)
    _same(again.topk.indices, got.topk.indices)


def test_per_request_k_and_filter_mask_in_external_ids(data):
    """A compaction remaps positions (dropped rows); masks still come in
    external ids and results go back in them, for any per-request k."""
    x, ups, q = data
    t, j = _engines(x, "cuda", resident=True, int8=True)
    _mutate(t, ups)
    _mutate(j, ups)
    t.store.compact()
    j.store.compact()
    with t.store.snapshot() as view:
        assert not view.identity
    assert t.n_ids == j.n_ids == N + 305
    mask = np.random.default_rng(3).random(t.n_ids) < 0.5
    mask[40] = mask[N + 5 + 7] = True
    t.upsert(ups[0][:2] + 1)  # delta rows after the fold, outside the mask
    j.upsert(ups[0][:2] + 1)
    mask = np.concatenate([mask, [True, False]])
    for k in (1, 3, 17):
        for tier in ("f32", "int8"):
            got = t.search(SearchRequest(queries=q, k=k, tier=tier, filter_mask=mask))
            want = j.search(JRequest(queries=q, k=k, tier=tier, filter_mask=mask))
            _same_result(got, want)
            ids = got.topk.indices.numpy()
            assert mask[ids[ids >= 0]].all()
    with pytest.raises(ValueError, match="filter_mask"):
        t.search(SearchRequest(queries=q, filter_mask=mask[:-1]))


def _pow2_rows(rng, n, d):
    """Rows of ±1 with 1, 4 or 16 nonzeros: norms 1, 2 or 4, so the cos
    normalisation is exact."""
    counts = rng.choice([1, 4, 16], n)
    ranks = rng.random((n, d)).argsort(1).argsort(1)
    return ((ranks < counts[:, None]) * rng.choice([-1.0, 1.0], (n, d))).astype(np.float32)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_mutated_engine_equals_a_fresh_fit_on_its_live_rows(backend, metric):
    """Values bit-identical, indices equal after mapping the fresh engine's
    positions to external ids: a delete, an upsert and a compaction are
    invisible but for the id space."""
    rng = np.random.default_rng(8)
    make = (lambda n: _pow2_rows(rng, n, D)) if metric == "cos" else (lambda n: _ints(rng, n))
    x, extra = make(500), make(1300)
    q = make(3)
    q[0] = extra[100]
    eng = ExactKNN(k=K_, metric=metric, backend=backend, device="cpu").fit(x)
    ids = np.concatenate([eng.upsert(extra[:1]), eng.upsert(extra[1:128]),
                          eng.upsert(extra[128:])])
    dead = [5, 17, int(ids[0]), int(ids[1000]), 499]
    eng.delete(dead)
    rows = np.concatenate([x, extra])
    live = np.setdiff1d(np.arange(rows.shape[0]), dead)

    def check(res):
        fresh = ExactKNN(k=K_, metric=metric, backend=backend, device="cpu").fit(rows[live])
        for mode in ("fdsq", "fqsd"):
            want = fresh.search(SearchRequest(queries=q, mode_hint=mode))
            got = res(mode)
            _same(got.topk.scores, want.topk.scores)
            wi = want.topk.indices.numpy()
            _same(got.topk.indices, np.where(wi >= 0, live[wi], -1))

    check(lambda mode: eng.search(SearchRequest(queries=q, mode_hint=mode)))
    assert len(eng._delta_dev) == 2  # 1,024 + 276 delta rows
    eng.store.compact()
    check(lambda mode: eng.search(SearchRequest(queries=q, mode_hint=mode)))


def test_mutations_add_no_cache_entry(data):
    """After the first search of each tier that meets a delta shard (one
    entry each: the partition step, the direct-form step), upserts,
    deletes, searches and a compaction that keeps the shard count add no
    entry."""
    x, ups, q = data
    clear_executable_cache()
    eng = ExactKNN(k=K_, backend="cuda", device="cpu").fit(x).enable_int8()

    def serve():
        for req in (SearchRequest(queries=q), SearchRequest(queries=q[:1], mode_hint="fdsq"),
                    SearchRequest(queries=q, tier="int8")):
            eng.search(req)

    serve()
    warm = cache_info()
    ids = eng.upsert(ups[0])
    eng.search(SearchRequest(queries=q))
    assert cache_info()["misses"] <= warm["misses"] + 1
    eng.search(SearchRequest(queries=q, tier="int8"))
    after = cache_info()
    assert after["misses"] <= warm["misses"] + 2
    eng.delete([int(ids[0]), 7])
    eng.upsert(ups[1][:200])
    serve()
    eng.store.compact()
    assert eng.store.n_shards == 1
    serve()
    eng.upsert(ups[1][200:210])
    serve()
    assert cache_info()["misses"] == after["misses"]
    assert cache_info()["size"] == after["size"]


def test_delete_errors(data):
    x, _, _ = data
    eng = ExactKNN(k=2, device="cpu").fit(x)
    with pytest.raises(KeyError, match="does not exist"):
        eng.delete([10**6])
    eng.delete([5])
    with pytest.raises(KeyError, match="already deleted"):
        eng.delete([5])
    assert eng.n == N - 1
    eng.store.compact()
    with pytest.raises(KeyError, match="already deleted"):
        eng.delete(torch.tensor([5]))  # compacted away: no position left


def test_delete_is_atomic(data):
    """A bad id anywhere in a batch leaves the store, its journal and the
    engine untouched."""
    x, _, q = data
    eng = ExactKNN(k=1, device="cpu").fit(x)
    target = int(eng.search(SearchRequest(queries=q[:1])).topk.indices[0, 0])
    before = eng.store.mutation_count
    with pytest.raises(KeyError):
        eng.delete([target, 10**6])
    assert eng.store.mutation_count == before and eng.store.n_live == N
    assert int(eng.search(SearchRequest(queries=q[:1])).topk.indices[0, 0]) == target
    with pytest.raises(KeyError, match="already deleted"):
        eng.delete([7, 7])  # duplicate ids in one batch
    assert eng.store.n_live == N


def test_upsert_dim_checked(data):
    x, _, _ = data
    eng = ExactKNN(k=2, device="cpu").fit(x)
    with pytest.raises(ValueError, match="upsert"):
        eng.upsert(np.zeros((2, 7), np.float32))
    assert eng.store.n_delta == 0


def test_many_upserts_roll_into_equal_delta_shards():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    store = DatasetStore.from_array(x, delta_rows=128)
    jstore = JStore.from_array(x, delta_rows=128)
    rows = rng.standard_normal((200, 16)).astype(np.float32)
    store.upsert(torch.from_numpy(rows))  # a tensor is taken as it is
    jstore.upsert(rows)
    shards = store.delta_shards()
    assert [tuple(s.vectors.shape) for s in shards] == [(128, 128), (128, 128)]
    assert [s.n_valid for s in shards] == [128, 72]
    assert [s.base_index for s in shards] == [300, 428]
    assert store.n_live == 500
    for s, js in zip(shards, jstore.delta_shards()):
        _same(s.vectors, js.vectors)
        np.testing.assert_allclose(_np(s.norms), _np(js.norms), rtol=1e-6)
    # a delta shard is one block, written in place as rows arrive: the same
    # tensors on every call, tombstones flipped into its norms
    again = store.delta_shards()
    assert again[0].vectors is shards[0].vectors and again[1].vectors is shards[1].vectors
    store.delete([300, 499])
    masked = store.delta_shards()
    assert masked[0].vectors is shards[0].vectors
    assert torch.isinf(masked[0].norms[0]) and torch.isinf(masked[1].norms[71])
    assert torch.isinf(masked[1].norms[72:]).all() and store.n_live == 498


def test_rows_with_overflowing_norms_rejected():
    """A row whose f32 squared norm is +inf would wear the tombstone
    sentinel: stored but never returnable. Refused before anything moves."""
    huge = np.full((2, 16), 2e19, np.float32)
    with pytest.raises(ValueError, match="non-finite"):
        DatasetStore.from_array(huge)
    store = DatasetStore.from_array(np.ones((4, 16), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        store.upsert(huge[0])
    assert store.n_live == 4 and store.n_delta == 0 and store.n_ids == 4


def test_resident_engine_reuses_full_delta_shards_on_its_device(data):
    """A full delta shard goes to the device once: a later delete re-puts
    only its norms; the partial tail is put again."""
    x, ups, q = data
    eng = ExactKNN(k=K_, backend="cuda", device="cpu").fit_store(
        DatasetStore.from_array(x[:100], delta_rows=128))
    eng.upsert(ups[1][:150])
    first = [p.vectors for p in eng._delta_dev]
    eng.delete([101])
    assert eng._delta_dev[0].vectors is first[0]
    assert torch.isinf(eng._delta_dev[0].norms[1])
    assert [p.n_valid for p in eng._delta_dev] == [128, 22]
