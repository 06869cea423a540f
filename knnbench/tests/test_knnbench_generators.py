"""The rows, queries and arrivals are fixed by the seed (and the block)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from knnbench import data, traffic
from knnbench.tests.conftest import tiny


@pytest.mark.parametrize("ip", [False, True])
def test_dataset_is_its_blocks_and_fixed_by_the_seed(ip):
    cfg = tiny(n=1300, d=12, block_rows=512, ip_as_l2=ip)
    x = data.dataset(cfg, 2 ** 31 + 77, "cpu")
    assert x.shape == (1300, cfg["d"]) and x.dtype == torch.float32
    assert torch.equal(x, data.dataset(cfg, 2 ** 31 + 77, "cpu"))
    assert not torch.equal(x, data.dataset(cfg, 2 ** 31 + 78, "cpu"))
    cent = data.centres(cfg, 2 ** 31 + 77, "cpu")
    m2 = data.max_norm_sq(cfg, 2 ** 31 + 77, cent) if ip else None
    for b in range(data.n_blocks(cfg)):
        blk = data.block(cfg, 2 ** 31 + 77, b, cent, m2)
        assert torch.equal(blk, x[b * 512: b * 512 + blk.shape[0]])
    if ip:  # every row's norm is M^2: L2 order is inner-product order
        norms = (x.double() ** 2).sum(1)
        assert torch.allclose(norms, norms.max().expand_as(norms), rtol=1e-5)


def test_queries_are_fixed_by_the_seed_and_near_the_rows():
    cfg = tiny(n=2000, d=24, ip_as_l2=True)
    q = data.queries(cfg, 9, 50, "cpu")
    assert torch.equal(q, data.queries(cfg, 9, 50, "cpu"))
    assert (q[:, -1] == 0).all()
    x = data.dataset(cfg, 9, "cpu")
    cent = data.centres(cfg, 9, "cpu")
    near = torch.cdist(q[:, :-1], cent).min(1).values
    far = torch.cdist(x[:, :-1], x[:, :-1]).median()
    assert (near < far).all()


def test_arrivals_are_one_set_of_gaps_in_a_seeded_order():
    mix = {"arrivals": [{"law": "poisson", "rate_per_s": 400.0}]}
    a = traffic.arrivals(mix, 10.0, 2 ** 31 + 1)
    b = traffic.arrivals(mix, 10.0, 2 ** 31 + 2)
    assert len(a) == len(b) == 4000
    assert np.array_equal(a, traffic.arrivals(mix, 10.0, 2 ** 31 + 1))
    assert not np.array_equal(a, b)
    assert a[0] == 0 and (np.diff(a) > 0).all() and a[-1] < 10.0
    ga = np.diff(np.append(a, 10.0))
    gb = np.diff(np.append(b, 10.0))
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=1e-9, atol=1e-12)
    assert abs(np.mean(ga) - 1 / 400) < 1e-6
    # one cycle of gaps, entered at another point: b's gaps are a's rotated
    shift = int(np.argmin(np.abs(ga - gb[0])))
    np.testing.assert_allclose(np.roll(ga, -shift), gb, rtol=1e-9, atol=1e-12)
    other = traffic.arrivals({"arrivals": [{"law": "poisson", "rate_per_s": 400.0,
                                            "order_seed": 3}]}, 10.0, 2 ** 31 + 1)
    assert not np.array_equal(a, other)
    with pytest.raises(ValueError):
        traffic.arrivals({"arrivals": [{"law": "zipf", "rate_per_s": 1}]}, 1.0, 0)


def test_arrival_laws_superpose():
    bursts = {"law": "periodic", "every_s": 0.25, "burst": 64}
    trickle = {"law": "periodic", "every_s": 0.02, "offset_s": 0.01}
    due = traffic.arrivals({"arrivals": [bursts, trickle]}, 1.0, 5)
    assert len(due) == 4 * 64 + 50
    assert (np.diff(due) >= 0).all() and due[-1] < 1.0
    assert (due == 0.5).sum() == 64 and np.isclose(due, 0.03).sum() == 1
    both = traffic.arrivals({"arrivals": [bursts, {"law": "poisson", "rate_per_s": 100}]}, 2.0, 5)
    assert len(both) == 8 * 64 + 200
    assert np.array_equal(both, traffic.arrivals(
        {"arrivals": [bursts, {"law": "poisson", "rate_per_s": 100}]}, 2.0, 5))


def test_requests_take_the_pool_in_turn():
    mix = {"queries_per_request": 16, "query_pool": 64, "request": {"k": 8}}
    assert [traffic.pool_rows(mix, i) for i in range(5)] == [(0, 16), (16, 16), (32, 16),
                                                            (48, 16), (0, 16)]
    assert traffic.pool_index(mix, [1]).tolist() == [list(range(16, 32))]
    pool = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    assert traffic.queries_of(mix, pool, 5).shape == (16, 3)
    one = dict(mix, queries_per_request=1)
    assert traffic.queries_of(one, pool, 65).tolist() == pool[1].tolist()
    assert traffic.k(mix) == 8
    from knnbench import spec

    assert spec.module("loops", "closed").pending({"callers": 3}) == 3
    assert spec.module("loops", "closed").pending({}) == 1
    assert spec.module("loops", "open").pending({}) is None


def test_the_window_keeps_a_seeded_sample_of_answers():
    from knnbench.harness import Window

    def run(seed):
        w = Window(m=2, keep=50, seed=seed)
        for i in range(1000):
            w.note(i, None if i % 10 == 0 else ("s", i), float(i))
        return w

    w = run(7)
    assert len(w.answers) == 50 and w.failed == 100 and w.queries == 1800
    assert len(w.latencies_ms) == 1000
    assert all(w.answers[i] == ("s", i) and i % 10 for i in w.answers)
    assert sorted(w.answers) == sorted(run(7).answers)
    assert sorted(w.answers) != sorted(run(8).answers)
    assert max(w.answers) > 500  # late answers are drawn too, not only the first
    few = Window(keep=50, seed=1)
    for i in range(20):
        few.note(i, i, 1.0)
    assert sorted(few.answers) == list(range(20))
