"""The port's fault layer against the reference's: the same seeded
``FaultPlan`` fires the same faults in both packages, and the streamed
search over an opened store in files absorbs them the same way (bounded
retries, quarantine of a dead int8 shard to its f32 rows, ``allow_partial``,
transfer and gather faults, CRC checks on read).

Inputs are made with numpy from a seed (integer rows whose int8 scale is
exactly 1, so every score is exact) and go through both packages on the
CPU, the port with ``device="cpu"``. Both engines open the same files,
written by the port under ``tmp_path``.

Hygiene: every injector goes in through ``installed(...)`` (process-wide)
or :func:`attached` (one store), both of which take it out again in
``finally``; an autouse fixture fails a test that leaves one behind. No
plan arms a crash that exits the process.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.api.types import SearchRequest as JRequest
from repro.core.engine import ExactKNN as JExactKNN
from repro.store import DatasetStore as JStore
from repro_torch import ExactKNN, SearchRequest, faults
from repro_torch.core.partition import PaddedDataset
from repro_torch.core.streaming import DoubleBufferedStream, device_put_partition
from repro_torch.faults import (
    FaultInjector,
    FaultPlan,
    InjectedCrash,
    ShardCorruptError,
    ShardReadError,
    installed,
)
from repro_torch.store import DatasetStore

N, D, ROWS, K_ = 512, 16, 128, 5  # 4 shards of 128 rows


def _np(t):
    return np.asarray(t)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.fixture(autouse=True)
def _no_injector_left_behind():
    assert faults.active() is None and jfaults.active() is None
    try:
        yield
    finally:
        left = (faults.active(), jfaults.active())
        faults.uninstall()
        jfaults.uninstall()
    assert left == (None, None), "a test left a process-wide injector installed"


@contextlib.contextmanager
def attached(store, inj):
    """``inj`` as `store`'s own injector for the block, removed after."""
    store.fault_injector = inj
    try:
        yield inj
    finally:
        store.fault_injector = None


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    x = rng.integers(-127, 128, (N, D)).astype(np.float32)
    x[np.arange(N), rng.integers(0, D, N)] = 127.0
    q = rng.integers(-40, 41, (4, D)).astype(np.float32)
    q[0] = x[200]
    return x, q


def _pair(x, tmp_path, verify_on_read=False, **kw):
    """A port and a reference engine over one store in files (int8 tier
    written), opened by each package, searched out of core."""
    store = DatasetStore.from_array(x, rows_per_shard=ROWS, directory=str(tmp_path))
    store.ensure_tier("int8")
    kw = {"k": K_, "retry_backoff_s": 0.0, **kw}
    teng = ExactKNN(backend="cuda", device="cpu", **kw).fit_store(
        DatasetStore.open(str(tmp_path), verify_on_read=verify_on_read), resident=False)
    jeng = JExactKNN(**kw).fit_store(
        JStore.open(str(tmp_path), verify_on_read=verify_on_read), resident=False)
    return teng.enable_int8(), jeng.enable_int8()


def _same_result(got, want):
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same(got.certified, want.certified)
    for key in ("transfers", "bytes_scanned", "partial"):
        assert got.stats[key] == want.stats[key], key
    g, w = dict(got.stats["health"]), dict(want.stats["health"])
    g.pop("slow_shards"), w.pop("slow_shards")  # wall-clock, not a result
    assert g == w


def _both(teng, jeng, q, plan: dict, tier="f32", **req):
    """The same plan installed process-wide in each package around its own
    search: (port result, reference result, port events, reference events)."""
    with installed(FaultInjector(FaultPlan(**plan))) as ti:
        got = teng.search(SearchRequest(queries=q, tier=tier, **req))
    with jfaults.installed(jfaults.FaultInjector(jfaults.FaultPlan(**plan))) as ji:
        want = jeng.search(JRequest(queries=q, tier=tier, **req))
    return got, want, ti.events, ji.events


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("kw", [
    {"read_error_rate": 1.5}, {"corrupt_rate": -0.1}, {"slow_s": -1.0},
    {"max_failures_per_op": -1}, {"fail_tier": "int4"}, {"crash_site": "nowhere"},
    {"crash_occurrence": 0}, {"crash_mode": "kill"}, {"torn_fraction": 1.0},
])
def test_both_packages_reject_the_same_bad_knobs(kw):
    with pytest.raises(ValueError):
        FaultPlan(**kw)
    with pytest.raises(ValueError):
        jfaults.FaultPlan(**kw)


def test_plans_are_interchangeable():
    assert [f.name for f in dataclasses.fields(FaultPlan)] == [
        f.name for f in dataclasses.fields(jfaults.FaultPlan)]
    assert faults.CRASH_SITES == jfaults.CRASH_SITES
    assert faults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE
    kw = dict(seed=7, read_error_rate=0.2, fail_shards=(1, 3), fail_tier="int8",
              crash_site="compact.begin", crash_occurrence=2)
    assert dataclasses.asdict(FaultPlan(**kw)) == dataclasses.asdict(jfaults.FaultPlan(**kw))


def _drive(mod, plan: dict) -> tuple[list, list, dict]:
    """One fixed sequence of hook calls through `mod`'s injector: each
    call's outcome (or the error it raised), the events and the counts."""
    inj = mod.FaultInjector(mod.FaultPlan(**plan))
    arr = np.arange(64, dtype=np.float32)
    outcomes = []
    calls = ([lambda i=i, t=t: inj.on_shard_read(i, t) for i in range(4)
              for t in ("f32", "int8")] * 3
             + [lambda i=i: inj.maybe_corrupt(arr, i, "f32").tobytes() for i in range(4)] * 2
             + [lambda i=i: inj.on_device_put(128 * i) for i in range(4)] * 2
             + [lambda: inj.on_gather(9)] * 4)
    for call in calls:
        try:
            out = call()
            outcomes.append(out if isinstance(out, bytes) else "ok")
        except (mod.ShardReadError, RuntimeError) as e:
            outcomes.append(f"{type(e).__name__}: {e}")
    return outcomes, inj.events, inj.counts()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_same_plan_fires_the_same_events(seed):
    plan = dict(seed=seed, read_error_rate=0.3, corrupt_rate=0.4, slow_rate=0.2, slow_s=0.0,
                put_error_rate=0.3, gather_error_rate=0.5, fail_shards=(3,),
                fail_tier="int8")
    got, want = _drive(faults, plan), _drive(jfaults, plan)
    assert got == want
    assert sum(got[2].values()) > 0


def test_consecutive_failures_are_bounded():
    inj = FaultInjector(FaultPlan(read_error_rate=1.0, max_failures_per_op=2))
    outcomes = []
    for _ in range(9):
        try:
            inj.on_shard_read(0, "f32")
            outcomes.append("ok")
        except ShardReadError:
            outcomes.append("fail")
    assert outcomes == ["fail", "fail", "ok"] * 3


def test_fail_shards_are_persistent_and_tier_scoped():
    inj = FaultInjector(FaultPlan(fail_shards=(1,), fail_tier="int8", max_failures_per_op=0))
    for _ in range(5):
        with pytest.raises(ShardReadError) as err:
            inj.on_shard_read(1, "int8")
    assert err.value.shard_id == 1 and err.value.tier == "int8"
    inj.on_shard_read(1, "f32")
    inj.on_shard_read(0, "int8")


def test_corruption_flips_one_byte_of_a_copy():
    arr = torch.zeros(64)
    out = FaultInjector(FaultPlan(seed=1, corrupt_rate=1.0, max_failures_per_op=1)
                        ).maybe_corrupt(arr, 0, "f32")
    assert (out.view(np.uint8) != 0).sum() == 1
    assert not arr.any()  # the input is never touched


def test_crash_points_raise_and_never_exit():
    """The crash fields ride along so plans are interchangeable; the read
    side visits no crash site, and the raise mode is a BaseException that
    ``except Exception`` cannot absorb."""
    inj = FaultInjector(FaultPlan(crash_site="compact.after_shards", crash_occurrence=2))
    inj.crash_point("compact.after_shards")  # the first visit lives
    with pytest.raises(InjectedCrash) as err:
        inj.crash_point("compact.after_shards")
    assert not isinstance(err.value, Exception) and err.value.site == "compact.after_shards"
    torn = FaultInjector(FaultPlan(crash_site="journal.append.torn", torn_fraction=0.25))
    assert torn.torn_write_armed("journal.append.torn") == 0.25
    assert torn.torn_write_armed("journal.append.torn") is None


def test_installed_takes_the_injector_out_on_error():
    inj = FaultInjector(FaultPlan())
    with pytest.raises(KeyError):
        with installed(inj):
            assert faults.active() is inj
            raise KeyError("boom")
    assert faults.active() is None


# ------------------------------------------ through an opened store in files
@pytest.mark.parametrize("tier", ["f32", "int8"])
@pytest.mark.parametrize("seed", [4, 5])
def test_a_seeded_plan_gives_the_same_events_and_results(data, tmp_path, tier, seed):
    x, q = data
    teng, jeng = _pair(x, tmp_path, verify_on_read=True, max_retries=4)
    plan = dict(seed=seed, read_error_rate=0.3, corrupt_rate=0.3, slow_rate=0.2, slow_s=0.0,
                put_error_rate=0.3, gather_error_rate=0.4, max_failures_per_op=2)
    got, want, tev, jev = _both(teng, jeng, q, plan, tier, spec_trigger=1.0)
    assert tev == jev and tev
    _same_result(got, want)
    base = teng.search(SearchRequest(queries=q, tier=tier))
    _same(got.topk.scores, base.topk.scores)
    _same(got.topk.indices, base.topk.indices)
    ops = {e["op"] for e in tev}
    errors = sum(e["op"] in ("read", "corrupt", "put", "gather") for e in tev)
    assert got.stats["health"]["retries"] == errors and ops & {"read", "corrupt"}


def test_transient_read_errors_are_retried_to_success(data, tmp_path):
    x, q = data
    teng, jeng = _pair(x, tmp_path)
    base = teng.search(SearchRequest(queries=q))
    with attached(teng.store, FaultInjector(FaultPlan(seed=2, read_error_rate=0.6))) as inj:
        got = teng.search(SearchRequest(queries=q))
    with attached(jeng.store, jfaults.FaultInjector(jfaults.FaultPlan(
            seed=2, read_error_rate=0.6))) as jinj:
        want = jeng.search(JRequest(queries=q))
    assert inj.events == jinj.events and inj.counts()["read"] >= 1
    assert got.stats["health"]["retries"] == inj.counts()["read"]
    _same(got.topk.indices, base.topk.indices)
    _same_result(got, want)


def test_a_dead_int8_shard_is_quarantined_to_its_f32_rows(data, tmp_path):
    x, q = data
    teng, jeng = _pair(x, tmp_path)
    base = teng.search(SearchRequest(queries=q, tier="int8"))
    got, want, tev, jev = _both(teng, jeng, q, dict(fail_shards=(1,), fail_tier="int8"),
                                "int8")
    assert got.stats["health"]["degraded"] == [1] and not got.stats["partial"]
    _same(got.topk.scores, base.topk.scores)
    _same(got.topk.indices, base.topk.indices)
    _same_result(got, want)
    assert tev == jev


def test_a_dead_f32_shard_raises_unless_allow_partial(data, tmp_path):
    x, q = data
    teng, jeng = _pair(x, tmp_path, max_retries=1)
    plan = dict(fail_shards=(2,), fail_tier="f32")
    with installed(FaultInjector(FaultPlan(**plan))):
        with pytest.raises(ShardReadError) as err:
            teng.search(SearchRequest(queries=q))
    assert err.value.shard_index == 2
    got, want, tev, jev = _both(teng, jeng, q, plan, allow_partial=True)
    assert got.stats["partial"] and got.stats["health"]["failed_shards"] == [2]
    idx = _np(got.topk.indices)
    assert not ((idx >= 2 * ROWS) & (idx < 3 * ROWS)).any()
    _same_result(got, want)
    assert tev == jev


def test_device_put_faults_are_retried(data, tmp_path):
    x, q = data
    teng, jeng = _pair(x, tmp_path)
    base = teng.search(SearchRequest(queries=q))
    got, want, tev, jev = _both(teng, jeng, q, dict(seed=5, put_error_rate=0.7))
    puts = sum(e["op"] == "put" for e in tev)
    assert puts >= 1 and got.stats["health"]["retries"] == puts
    assert {e["shard"] for e in tev} <= {0, 128, 256, 384}  # keyed by base index
    _same(got.topk.indices, base.topk.indices)
    _same_result(got, want)
    assert tev == jev


def test_device_put_partition_and_the_stream_fire_the_hook():
    p = PaddedDataset(torch.zeros(4, 2), torch.zeros(4), 4, 256)
    with installed(FaultInjector(FaultPlan(put_error_rate=1.0, max_failures_per_op=1))) as inj:
        with pytest.raises(RuntimeError, match="partition base 256"):
            device_put_partition(p, "cpu")
        assert device_put_partition(p, "cpu").base_index == 256  # forced success
        health = {"retries": 0}
        stream = DoubleBufferedStream([p._replace(base_index=0)], put_retries=1,
                                      retry_backoff_s=0.0, health=health, device="cpu")
        assert [item.base_index for item in stream] == [0]
    assert health["retries"] == 1 and inj.counts()["put"] == 2


def test_gather_faults_retried_and_failed_speculation_degrades(data, tmp_path):
    x, q = data
    teng, jeng = _pair(x, tmp_path)
    base = teng.search(SearchRequest(queries=q, tier="int8"))
    plan = dict(gather_error_rate=1.0, max_failures_per_op=1)
    got, want, tev, jev = _both(teng, jeng, q, plan, "int8", spec_trigger=0.0)
    # the background gather fails, the synchronous one is forced through
    assert got.stats["speculation"]["failed"] == 1 and got.stats["health"]["retries"] == 0
    assert got.stats["speculation"] == want.stats["speculation"]
    _same(got.topk.scores, base.topk.scores)
    _same_result(got, want)
    got, want, tev, jev = _both(teng, jeng, q, plan, "int8", spec_trigger=1.0)
    assert got.stats["health"]["retries"] == 1 and tev == jev
    _same_result(got, want)


@pytest.mark.parametrize("verify_on_read", [True, False])
def test_verify_on_read_turns_corruption_into_retries(data, tmp_path, verify_on_read):
    """A flipped byte in a shard read: with CRCs checked on read it is a
    ShardCorruptError the scan retries past; without, it reaches the scan
    (which is why a store in files can check on read)."""
    x, q = data
    teng, jeng = _pair(x, tmp_path, verify_on_read=verify_on_read)
    plan = dict(seed=9, corrupt_rate=1.0, max_failures_per_op=1)
    got, want, tev, jev = _both(teng, jeng, q, plan, "int8", spec_trigger=1.0)
    assert tev == jev and [e["op"] for e in tev] == ["corrupt"] * 4
    assert got.stats["health"]["retries"] == (4 if verify_on_read else 0)
    _same_result(got, want)
    if verify_on_read:
        base = teng.search(SearchRequest(queries=q, tier="int8"))
        _same(got.topk.scores, base.topk.scores)
        _same(got.topk.indices, base.topk.indices)
    else:  # the corrupted codes are a copy: the mapping is never written
        with attached(teng.store, FaultInjector(FaultPlan(seed=9, corrupt_rate=1.0))):
            shard = teng.store.read_shard(0, "int8")
        assert not isinstance(shard.q, np.memmap)
        assert isinstance(teng.store.read_shard(0, "int8").q, np.memmap)


def test_the_store_injector_wins_over_the_process_wide_one(data, tmp_path):
    x, _ = data
    teng, _ = _pair(x, tmp_path)
    store = teng.store
    with installed(FaultInjector(FaultPlan(fail_shards=(0,)))) as process_wide:
        with attached(store, FaultInjector(FaultPlan())) as own:
            store.read_shard(0)
        with pytest.raises(ShardReadError):
            store.read_shard(0)
    assert own.events == [] and len(process_wide.events) == 1


def test_seeded_soak_zero_crashes_and_every_error_surfaces(data, tmp_path):
    """A seeded mixture over many streamed searches: no crash, every answer
    equal to the fault-free one, and every injected error counted once, as
    a retry or as a failed speculation."""
    x, q = data
    teng, _ = _pair(x, tmp_path, verify_on_read=True, max_retries=5)
    base = {tier: teng.search(SearchRequest(queries=q, tier=tier)) for tier in ("f32", "int8")}
    inj = FaultInjector(FaultPlan(seed=11, read_error_rate=0.1, corrupt_rate=0.08,
                                  slow_rate=0.05, slow_s=0.0, put_error_rate=0.05,
                                  gather_error_rate=0.1, max_failures_per_op=2))
    retries = spec_failed = 0
    with attached(teng.store, inj), installed(inj):
        for i in range(24):
            tier = "int8" if i % 2 else "f32"
            res = teng.search(SearchRequest(queries=q, tier=tier,
                                            spec_trigger=0.5 if tier == "int8" else None))
            assert not res.stats["partial"]
            _same(res.topk.scores, base[tier].topk.scores)
            _same(res.topk.indices, base[tier].topk.indices)
            retries += res.stats["health"]["retries"]
            spec_failed += res.stats.get("speculation", {}).get("failed", 0)
    c = inj.counts()
    errors = c["read"] + c["corrupt"] + c["put"] + c["gather"]
    assert errors > 0 and retries + spec_failed == errors


def test_shard_errors_are_os_errors():
    assert issubclass(ShardReadError, OSError) and issubclass(ShardCorruptError, OSError)
