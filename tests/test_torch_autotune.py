"""The port's per-device autotuner against the reference's: key formats,
the cache file both packages read, sweep legality, and the planner and
engine contract (tuned plans hit the executable cache, pins beat the tuner,
a negative CUDA verdict raises, tuned answers equal default answers).

Every test plans against a cache of its own: the autouse fixture installs
an in-memory cache in both packages and restores the lazy default in
``finally``; a test that needs a file writes it under ``tmp_path``. No test
writes ``artifacts/autotune/``. Sweeps run on the CPU (``device="cpu"``:
the kernels' plain versions) at small shapes with one repeat. Answers are
compared on integer-valued rows, where every score is exact whatever the
tiling (the plain versions' products per bn tile could round differently
on another BLAS otherwise).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.tuning as jtune
from repro.core import planner as jplanner
from repro_torch import ExactKNN, SearchRequest
from repro_torch.core import cache_info, clear_executable_cache
from repro_torch.core import planner as tplanner
from repro_torch.kernels.knn import kernel as K
from repro_torch.kernels.knn import ops
from repro_torch.store import DatasetStore
from repro_torch.tuning import (
    AutotuneCache,
    BlockShapes,
    PipelineKnobs,
    autotune_knn,
    autotune_pipeline,
    candidate_blocks,
    default_cache,
    lookup_blocks,
    lookup_cuda_capability,
    lookup_pipeline,
    pipeline_key,
    probe_cuda_capability,
    set_default_cache,
    tuning_key,
)
from repro_torch.tuning import autotune as tauto


@pytest.fixture(autouse=True)
def isolated_default_cache():
    """Neither package reads or writes a real per-device cache here."""
    set_default_cache(AutotuneCache(path=None))
    jtune.set_default_cache(jtune.AutotuneCache(path=None))
    try:
        yield
    finally:
        set_default_cache(None)
        jtune.set_default_cache(None)


def _use(cache):
    set_default_cache(cache)
    return cache


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float32)


KEY = tuning_key("fdsq-cuda", m=8, n=1024, d=128, dtype="float32", metric="l2", k=10)
PIPE_KEY = pipeline_key("fqsd-int8-streamed", m=8, n=1024, d=128, dtype="float32",
                        metric="l2", k=10)
KNOBS = PipelineKnobs(prefetch_depth=2, spec_trigger=0.5, rescore_factor=4,
                      rows_per_shard=256)


# ------------------------------------------------------------- key parity
@pytest.mark.parametrize("args", [
    ("fdsq-cuda", 8, 1024, 128, "float32", "l2", 10, None),
    ("fdsq-cuda", 5, 1_000_448, 1024, "float32", "l2", 1024, None),
    ("fdsq-cuda", 1, 8_842_240, 896, "bfloat16", "ip", 72, None),
    ("fqsd-int8-cuda", 33, 4096, 64, "float32", "l2", 7, 4),
    ("fqsd-int8-cuda", 64, 1_000_448, 1024, "float32", "l2", 1024, 16),
])
def test_tuning_key_matches_the_reference(args):
    *head, r = args
    assert tuning_key(*head, rescore_factor=r) == jtune.tuning_key(*head, rescore_factor=r)
    assert ("|r" in tuning_key(*head, rescore_factor=r)) == (r is not None)


@pytest.mark.parametrize("m", [1, 5, 8, 16, 64, 100])
def test_pipeline_key_matches_the_reference(m):
    args = ("fqsd-int8-streamed", m, 1_048_576, 1024, "float32", "l2", 1024)
    assert pipeline_key(*args) == jtune.pipeline_key(*args)


def test_pipeline_key_format_and_bucketing():
    assert PIPE_KEY == "pipe|fqsd-int8-streamed|m8|n1024|d128|float32|l2|k10"
    assert pipeline_key("fqsd-int8-streamed", 5, 1024, 128, "float32", "l2", 10) == PIPE_KEY
    assert "|r" not in PIPE_KEY


# ------------------------------------------------------------ cache files
def test_put_get_round_trip(tmp_path):
    path = str(tmp_path / "card.json")
    cache = AutotuneCache(path)
    assert cache.get(KEY) is None  # missing file == cold cache
    cache.put(KEY, BlockShapes(8, 512, 128), us_per_call=12.5)
    assert AutotuneCache(path).get(KEY) == BlockShapes(8, 512, 128)
    payload = json.load(open(path))
    assert payload["schema_version"] == 1
    assert payload["entries"][KEY]["us_per_call"] == 12.5
    cache.put_pipeline(PIPE_KEY, KNOBS)
    assert AutotuneCache(path).get_pipeline(PIPE_KEY) == KNOBS


def test_missing_file_is_cold_not_fatal(tmp_path):
    cache = AutotuneCache(str(tmp_path / "never_written.json"))
    assert cache.get(KEY) is None and len(cache) == 0


def test_corrupted_json_is_cold_then_recovers(tmp_path):
    path = str(tmp_path / "card.json")
    with open(path, "w") as f:
        f.write("{ this is not json !!")
    cache = AutotuneCache(path)
    assert cache.get(KEY) is None
    cache.put(KEY, BlockShapes(4, 256, 128))
    assert AutotuneCache(path).get(KEY) == BlockShapes(4, 256, 128)


@pytest.mark.parametrize("payload", [
    '{"schema_version": 1, "entries": "nope"}',
    '{"schema_version": 1, "entries": {"k": {"block_m": "x"}}}',
    '{"schema_version": 1}',
    '[]',
])
def test_wrong_schema_is_cold(tmp_path, payload):
    path = str(tmp_path / "card.json")
    with open(path, "w") as f:
        f.write(payload)
    assert AutotuneCache(path).get(KEY) is None


def test_lookups_never_raise(tmp_path):
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("garbage")
    _use(AutotuneCache(bad))
    assert lookup_blocks("fdsq-cuda", 8, 1024, 128, "float32", "l2", k=10) is None
    assert lookup_pipeline("fqsd-int8-streamed", 8, 1024, 128, "float32", "l2", 10) is None
    assert lookup_cuda_capability() is None


def test_kinds_do_not_cross_read(tmp_path):
    cache = AutotuneCache(str(tmp_path / "card.json"))
    cache.put(KEY, BlockShapes(8, 512, 128))
    cache.put_pipeline(PIPE_KEY, KNOBS)
    assert cache.get(PIPE_KEY) is None
    assert cache.get_pipeline(KEY) is None


def test_load_drops_only_bad_entries(tmp_path):
    path = str(tmp_path / "card.json")
    with open(path, "w") as f:
        json.dump({"schema_version": 1, "entries": {
            KEY: {"block_m": 8, "block_n": 512, "block_d": 128},
            PIPE_KEY: {"prefetch_depth": "not-an-int"},
            "capability|cuda": {"compiled": False},
        }}, f)
    cache = AutotuneCache(path)
    assert cache.get(KEY) == BlockShapes(8, 512, 128)
    assert cache.get_pipeline(PIPE_KEY) is None
    assert cache.get_capability() is False


def test_a_file_written_by_the_port_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "card.json")
    port = AutotuneCache(path)
    port.put(KEY, BlockShapes(8, 512, 128))
    port.put_pipeline(PIPE_KEY, KNOBS)
    port.put_capability(True)
    ref = jtune.AutotuneCache(path)
    assert tuple(ref.get(KEY)) == (8, 512, 128)
    assert tuple(ref.get_pipeline(PIPE_KEY)) == tuple(KNOBS)
    assert ref.get_capability("cuda") is True
    assert ref.get_capability("pallas") is None  # the port's verdict is not the reference's
    jtune.set_default_cache(ref)
    # the reference reads only its own executor names
    assert jtune.lookup_blocks("fdsq-pallas", 8, 1024, 128, "float32", "l2", 10) is None


def test_a_file_written_by_the_reference_loads_in_the_port(tmp_path):
    path = str(tmp_path / "card.json")
    ref = jtune.AutotuneCache(path)
    jkey = jtune.tuning_key("fdsq-pallas", 8, 1024, 128, "float32", "l2", 10)
    ref.put(jkey, jtune.BlockShapes(32, 512, 128))
    ref.put_pipeline(PIPE_KEY, jtune.PipelineKnobs(4, 0.25, 8, 512))
    ref.put_capability(False)  # a negative *pallas* verdict
    with open(path) as f:
        payload = json.load(f)
    payload["entries"]["pipe|fqsd-int8-mmap-streamed|m8|n1024|d128|float32|l2|k10"] = {
        "prefetch_depth": 1}  # malformed: dropped alone
    with open(path, "w") as f:
        json.dump(payload, f)
    port = _use(AutotuneCache(path))
    assert len(port) == 3
    assert port.get(jkey) == BlockShapes(32, 512, 128)
    assert lookup_blocks("fdsq-cuda", 8, 1024, 128, "float32", "l2", 10) is None
    # the streamed executors share their names, so the knobs transfer
    assert lookup_pipeline("fqsd-int8-streamed", 8, 1024, 128, "float32", "l2",
                           10) == PipelineKnobs(4, 0.25, 8, 512)
    assert lookup_cuda_capability() is None  # "capability|pallas" is not the port's


# ------------------------------------------------------------- candidates
@pytest.mark.parametrize("m,n,d,k,r", [
    (1, 4096, 128, 10, None), (16, 4096, 128, 10, None), (5, 1_000_448, 1024, 1024, None),
    (1, 8_842_240, 896, 72, None), (64, 300, 128, 7, None), (16, 4096, 64, 10, 4),
    (16, 1_000_448, 1024, 1024, 4), (64, 1_000_448, 1024, 1024, 4), (3, 2048, 256, 3, 16),
])
def test_candidates_are_legal_fixed_points(m, n, d, k, r):
    cands = candidate_blocks(m, n, d, k, r)
    assert cands
    bm_max = min(ops.next_pow2(m), K.int8_max_block_m() if r else K.max_block_m())
    queue = ops.next_pow2(k) if r is None else ops.int8_queue(k, r)[1]
    bns = sorted({c.block_n for c in cands})
    for c in cands:
        assert ops.resolved_blocks(k, d, *c, m=m, rescore_factor=r) == tuple(c)
        assert c.block_m in K._BLOCK_ROWS and c.block_m <= bm_max
        assert c.block_n >= queue and c.block_n & (c.block_n - 1) == 0 and c.block_n >= 256
        assert c.block_n == bns[0] or c.block_n <= 2 * ops.round_up(n, 256)
        assert c.block_d == ops.resolved_blocks(k, d)[2]  # bd is not swept
    assert tuple(ops.resolved_blocks(k, d, m=m, rescore_factor=r)) in map(tuple, cands)


def test_queue_width_and_budget_shape_the_sweep():
    # k=1024 with r=4 needs a 8,192-wide queue: bn has one value, bm sweeps
    cands = candidate_blocks(64, 1_000_448, 1024, 1024, 4)
    assert {c.block_n for c in cands} == {8192}
    assert [c.block_m for c in cands] == [1, 2, 4, 8, 16]
    # m=1: only bm=1, so only bn varies
    assert {c.block_m for c in candidate_blocks(1, 8_842_240, 896, 72)} == {1}


# ------------------------------------------------------- sweep + planner
@pytest.fixture
def engine():
    return ExactKNN(k=4, backend="cuda", device="cpu").fit(_ints((900, 32), 0))


def test_cold_cache_gives_default_blocks(engine):
    p = engine.plan_for("fqsd", 8)
    assert p.executor == "fdsq-cuda" and (p.block_m, p.block_n, p.block_d) == (0, 0, 0)
    out = engine.search(SearchRequest(queries=_ints((8, 32), 1)))
    assert tuple(out.topk.indices.shape) == (8, 4)


def test_sweep_persists_and_planner_consults(tmp_path, engine):
    cache = _use(AutotuneCache(str(tmp_path / "dev.json")))
    p0 = engine.plan_for("fqsd", 8)
    best, timings = autotune_knn(p0.m, p0.padded_rows, p0.padded_dim, k=engine.k,
                                 repeats=1, max_candidates=3, device="cpu")
    assert len(timings) == 3 and all(t > 0 for t in timings.values())
    assert AutotuneCache(cache.path).get(
        tuning_key("fdsq-cuda", 8, p0.padded_rows, p0.padded_dim, "float32", "l2", 4)) == best
    p1, p2 = engine.plan_for("fqsd", 8), engine.plan_for("fqsd", 8)
    assert p1 == p2 and (p1.block_m, p1.block_n, p1.block_d) == tuple(best) != (0, 0, 0)
    assert p1.cache_key() != p0.cache_key()
    # a tuned plan differs from the default one in its blocks and nothing else
    assert dataclasses.replace(p1, block_m=0, block_n=0, block_d=0) == p0


def test_tuned_plans_hit_executable_cache(engine):
    p0 = engine.plan_for("fqsd", 8)
    autotune_knn(p0.m, p0.padded_rows, p0.padded_dim, k=engine.k, repeats=1,
                 max_candidates=1, device="cpu")
    q = _ints((8, 32), 2)
    clear_executable_cache()
    engine.search(SearchRequest(queries=q, mode_hint="fqsd"))
    first = cache_info()
    assert first["misses"] == 1
    engine.search(SearchRequest(queries=q, mode_hint="fqsd"))
    second = cache_info()
    assert second["misses"] == first["misses"] and second["hits"] == first["hits"] + 1


def test_tuned_plans_hit_the_routers_shared_cache():
    from repro_torch.api import Router

    router = Router()
    router.create("c", _ints((900, 32), 0), k=4, backend="cuda", device="cpu")
    p = router.engine("c").plan_for("fqsd", 8)
    best, _ = autotune_knn(p.m, p.padded_rows, p.padded_dim, k=4, repeats=1,
                           max_candidates=2, device="cpu")
    req = SearchRequest(queries=_ints((8, 32), 2), mode_hint="fqsd")
    clear_executable_cache()
    first = router.search("c", req)
    misses = router.cache_info()["misses"]
    again = router.search("c", req)
    assert router.cache_info()["misses"] == misses
    assert (again.plan.block_m, again.plan.block_n, again.plan.block_d) == tuple(best)
    assert torch.equal(first.topk.indices, again.topk.indices)


def test_int8_sweep_uses_its_own_key():
    eng = ExactKNN(k=3, backend="cuda", device="cpu").fit(_ints((600, 24), 1)).enable_int8()
    p0 = eng.plan_for("fqsd", 4, tier="int8")
    assert p0.executor == "fqsd-int8-cuda"
    best, _ = autotune_knn(p0.m, p0.padded_rows, p0.padded_dim, k=eng.k, tier="int8",
                           repeats=1, max_candidates=1, device="cpu")
    p = eng.plan_for("fqsd", 4, tier="int8")
    assert (p.block_m, p.block_n, p.block_d) == tuple(best)
    pf = eng.plan_for("fqsd", 4)
    assert (pf.block_m, pf.block_n, pf.block_d) == (0, 0, 0)  # the f32 key is distinct


def test_rescore_factor_is_part_of_the_int8_key():
    x = _ints((600, 24), 4)
    eng = ExactKNN(k=3, backend="cuda", device="cpu", rescore_factor=4).fit(x).enable_int8()
    p = eng.plan_for("fqsd", 4, tier="int8")
    autotune_knn(p.m, p.padded_rows, p.padded_dim, k=eng.k, tier="int8", rescore_factor=4,
                 repeats=1, max_candidates=1, device="cpu")
    assert eng.plan_for("fqsd", 4, tier="int8").block_n > 0
    other = ExactKNN(k=3, backend="cuda", device="cpu", rescore_factor=16).fit(x).enable_int8()
    po = other.plan_for("fqsd", 4, tier="int8")
    assert (po.block_m, po.block_n, po.block_d) == (0, 0, 0)


def test_k_is_part_of_the_key():
    x = _ints((600, 24), 3)
    eng = ExactKNN(k=3, backend="cuda", device="cpu").fit(x)
    p = eng.plan_for("fqsd", 4)
    autotune_knn(p.m, p.padded_rows, p.padded_dim, k=eng.k, repeats=1, max_candidates=1,
                 device="cpu")
    assert eng.plan_for("fqsd", 4).block_n > 0
    po = ExactKNN(k=64, backend="cuda", device="cpu").fit(x).plan_for("fqsd", 4)
    assert (po.block_m, po.block_n, po.block_d) == (0, 0, 0)


@pytest.mark.parametrize("tier,mode,m", [("f32", "fdsq", 1), ("f32", "fqsd", 16),
                                         ("int8", "fqsd", 16), ("int8", "fqsd", 5)])
def test_tuned_and_default_answers_are_bit_identical(tier, mode, m):
    """Every legal candidate stored as the tuned blocks answers with the
    default plan's bits: values, indices and certificates."""
    x = _ints((3000, 64), 5)
    q = _ints((m, 64), 6)
    eng = ExactKNN(k=10, backend="cuda", device="cpu").fit(x)
    if tier == "int8":
        eng.enable_int8()
    req = SearchRequest(queries=q, mode_hint=mode, tier=tier)
    want = eng.search(req)
    assert (want.plan.block_m, want.plan.block_n) == (0, 0)
    p = want.plan
    r = p.rescore_factor if tier == "int8" else None
    cache = _use(AutotuneCache(path=None))
    key = tuning_key(p.executor, p.m, p.padded_rows, p.padded_dim, "float32", "l2", 10, r)
    for blocks in candidate_blocks(p.m, p.padded_rows, p.padded_dim, 10, r):
        cache.put(key, blocks)
        got = eng.search(req)
        assert (got.plan.block_m, got.plan.block_n, got.plan.block_d) == tuple(blocks)
        assert got.kernel_stats["blocks"] == tuple(blocks)
        assert torch.equal(got.topk.scores, want.topk.scores)
        assert torch.equal(got.topk.indices, want.topk.indices)
        if tier == "int8":
            assert torch.equal(got.certified, want.certified)


def test_a_candidate_that_changes_the_answer_fails_the_sweep(monkeypatch):
    real = ops.knn

    def wrong_for_small_bm(q, x, k, metric="l2", x_norms=None, block_m=128, **kw):
        out = real(q, x, k, metric, x_norms, block_m=block_m, **kw)
        return out._replace(scores=out.scores + 1.0) if block_m == 1 else out

    monkeypatch.setattr(ops, "knn", wrong_for_small_bm)
    with pytest.raises(RuntimeError, match="answer differently"):
        autotune_knn(4, 1024, 128, k=3, repeats=1, device="cpu")
    assert lookup_blocks("fdsq-cuda", 4, 1024, 128, "float32", "l2", 3) is None


def test_sweeps_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune_knn(4, 1024, 128, k=3, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune_pipeline(m=2, n=512, d=32, k=3, repeats=1)


def test_the_default_cache_in_tests_is_in_memory(engine):
    """A sweep with cache=None writes the installed (in-memory) default,
    never a file under artifacts/autotune/."""
    real = AutotuneCache.for_device()
    before = os.path.getmtime(real.path) if os.path.exists(real.path) else None
    p = engine.plan_for("fqsd", 8)
    best, _ = autotune_knn(p.m, p.padded_rows, p.padded_dim, k=engine.k, repeats=1,
                           max_candidates=1, device="cpu")
    assert default_cache().path is None and len(default_cache()) == 1
    after = os.path.getmtime(real.path) if os.path.exists(real.path) else None
    assert before == after


# --------------------------------------------------------------- pipeline
META = tplanner.DatasetStoreMeta(padded_rows=2048, padded_dim=128, n_valid=2000,
                                 tier="int8", rows_per_shard=512, n_shards=4)
STREAM_META = dataclasses.replace(META, resident=False)
CFG = tplanner.EngineConfig(k=10, backend="cuda")


def _tune_pipe(executor="fqsd-int8-streamed", **kw):
    knobs = PipelineKnobs(prefetch_depth=kw.get("prefetch_depth", 4),
                          spec_trigger=kw.get("spec_trigger", 0.25),
                          rescore_factor=kw.get("rescore_factor", 8), rows_per_shard=512)
    _use(AutotuneCache(path=None)).put_pipeline(
        pipeline_key(executor, 8, 2048, 128, "float32", "l2", 10), knobs)
    return knobs


def test_untuned_streamed_plan_carries_sentinels():
    p = tplanner.plan((8, 128), STREAM_META, CFG, "fqsd")
    assert p.executor == "fqsd-int8-streamed"
    assert (p.prefetch_depth, p.spec_trigger) == (0, -1.0)
    assert p.rescore_factor == CFG.rescore_factor


def test_tuned_knobs_land_on_plan_and_cache_key():
    untuned = tplanner.plan((8, 128), STREAM_META, CFG, "fqsd")
    knobs = _tune_pipe()
    tuned = tplanner.plan((8, 128), STREAM_META, CFG, "fqsd")
    assert (tuned.prefetch_depth, tuned.spec_trigger, tuned.rescore_factor) == (
        knobs.prefetch_depth, knobs.spec_trigger, knobs.rescore_factor)
    assert tuned.cache_key() != untuned.cache_key()
    assert dataclasses.replace(tuned, prefetch_depth=0, spec_trigger=-1.0,
                               rescore_factor=CFG.rescore_factor) == untuned


def test_pinned_rescore_budget_wins_over_tuner():
    _tune_pipe(rescore_factor=8)
    cfg = dataclasses.replace(CFG, rescore_factor=2, rescore_pinned=True)
    p = tplanner.plan((8, 128), STREAM_META, cfg, "fqsd")
    assert p.rescore_factor == 2
    assert (p.prefetch_depth, p.spec_trigger) == (4, 0.25)  # scheduling still applies


def test_resident_plans_never_carry_pipeline_knobs():
    _tune_pipe()
    p = tplanner.plan((8, 128), META, CFG, "fqsd")
    assert p.executor == "fqsd-int8-cuda"
    assert (p.prefetch_depth, p.spec_trigger) == (0, -1.0)


def test_streamed_knobs_plan_as_the_reference_plans():
    """One cache file feeds both packages' streamed int8 plans (the
    executors share their names): equal knobs on equal geometry."""
    knobs = _tune_pipe(prefetch_depth=1, spec_trigger=0.75, rescore_factor=2)
    jcache = jtune.AutotuneCache(path=None)
    jcache.put_pipeline(pipeline_key("fqsd-int8-streamed", 8, 2048, 128, "float32", "l2",
                                     10), jtune.PipelineKnobs(*knobs))
    jtune.set_default_cache(jcache)
    jmeta = jplanner.DatasetStoreMeta(**dataclasses.asdict(STREAM_META))
    for pinned in (False, True):
        jp = jplanner.plan((8, 128), jmeta, jplanner.EngineConfig(
            k=10, backend="pallas", rescore_factor=4, rescore_pinned=pinned), "fqsd")
        tp = tplanner.plan((8, 128), STREAM_META, dataclasses.replace(
            CFG, rescore_factor=4, rescore_pinned=pinned), "fqsd")
        assert jp.executor == tp.executor == "fqsd-int8-streamed"
        assert (tp.prefetch_depth, tp.spec_trigger, tp.rescore_factor) == (
            jp.prefetch_depth, jp.spec_trigger, jp.rescore_factor)


def _streamed_engine(**kw):
    x = _ints((2000, 32), 7)
    store = DatasetStore.from_array(x, rows_per_shard=512)
    eng = ExactKNN(k=10, backend="cuda", device="cpu", **kw)
    return eng.fit_store(store, resident=False).enable_int8()


@pytest.mark.parametrize("engine_kw,request_kw,tuned,want", [
    ({}, {}, False, (2, 0.5, 4)),  # engine defaults
    ({}, {}, True, (4, 0.25, 8)),  # the tuned plan
    ({"prefetch_depth": 1}, {}, True, (1, 0.25, 8)),  # engine pin beats tuned
    ({"rescore_factor": 2}, {}, True, (4, 0.25, 2)),  # a pinned budget too
    ({"prefetch_depth": 1, "spec_trigger": 1.0}, {"prefetch_depth": 3}, True,
     (3, 1.0, 8)),  # the request beats the engine pin
    ({}, {"prefetch_depth": 3, "spec_trigger": 0.0}, False, (3, 0.0, 4)),
])
def test_engine_knob_precedence(engine_kw, request_kw, tuned, want):
    """Request pin > engine pin > tuned plan > default, and every setting
    returns the same bits."""
    from repro_torch.core.executors import DEFAULT_SPEC_TRIGGER

    q = _ints((8, 32), 8)
    ref = _streamed_engine().search(SearchRequest(queries=q, tier="int8"))
    eng = _streamed_engine(**engine_kw)
    if tuned:
        meta = eng.dataset_meta(tier="int8")
        _use(AutotuneCache(path=None)).put_pipeline(
            pipeline_key("fqsd-int8-streamed", 8, meta.padded_rows, meta.padded_dim,
                         "float32", "l2", 10), PipelineKnobs(4, 0.25, 8, 512))
    res = eng.search(SearchRequest(queries=q, tier="int8", **request_kw))
    ctx = eng._last_ctx
    trigger = ctx.spec_trigger
    if trigger is None:  # the executor's resolution
        trigger = (res.plan.spec_trigger if res.plan.spec_trigger >= 0
                   else DEFAULT_SPEC_TRIGGER)
    assert res.plan.executor == "fqsd-int8-streamed"
    assert (ctx.prefetch_depth, trigger, res.plan.rescore_factor) == want
    assert torch.equal(res.topk.scores, ref.topk.scores)
    assert torch.equal(res.topk.indices, ref.topk.indices)


def test_pipeline_sweep_persists_for_both_streamed_executors(tmp_path):
    cache = AutotuneCache(str(tmp_path / "dev.json"))
    best, timings = autotune_pipeline(
        m=4, n=512, d=32, k=3, cache=cache, repeats=1, prefetch_candidates=(1,),
        trigger_candidates=(0.5, 1.0), rescore_candidates=(2,), shard_candidates=(128,),
        directory=str(tmp_path / "shards"), device="cpu")
    assert isinstance(best, PipelineKnobs)
    assert len(timings) == 2 and all(t > 0 for t in timings.values())
    assert best.rescore_factor == 2 and best.rows_per_shard == 128
    reread = AutotuneCache(str(tmp_path / "dev.json"))
    keys = [key for key in reread.keys() if key.startswith("pipe|")]
    assert sorted(key.split("|")[1] for key in keys) == [
        "fqsd-int8-mmap-streamed", "fqsd-int8-streamed"]
    for key in keys:
        assert reread.get_pipeline(key) == best


def test_pipeline_sweep_holds_every_combination_to_the_default_answer(monkeypatch):
    from repro_torch.core import engine as teng

    real = teng.ExactKNN.search

    def wrong_at_depth_4(self, request):
        res = real(self, request)
        if request.prefetch_depth == 4:
            res.topk.scores.add_(1.0)
        return res

    monkeypatch.setattr(teng.ExactKNN, "search", wrong_at_depth_4)
    with pytest.raises(RuntimeError, match="answers differently"):
        autotune_pipeline(m=2, n=512, d=32, k=3, repeats=1, prefetch_candidates=(2, 4),
                          trigger_candidates=(0.5,), rescore_candidates=(4,),
                          shard_candidates=(128,), device="cpu")


def test_non_l2_pipeline_sweep_rejected():
    with pytest.raises(ValueError, match="l2"):
        autotune_pipeline(m=4, n=512, d=32, metric="ip", device="cpu")


# ------------------------------------------------------------- capability
def test_unprobed_is_none(tmp_path):
    assert AutotuneCache(str(tmp_path / "c.json")).get_capability() is None
    assert lookup_cuda_capability() is None


def test_probe_without_a_card_raises_and_persists_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py probes it")
    cache = AutotuneCache(str(tmp_path / "c.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_cuda_capability(cache=cache)
    assert not os.path.exists(cache.path) and cache.get_capability() is None


@pytest.mark.parametrize("tier,resident", [("f32", True), ("int8", True), ("f32", False),
                                           ("int8", False)])
def test_negative_verdict_raises_and_never_falls_back(tmp_path, tier, resident):
    x = _ints((900, 32), 9)
    store = DatasetStore.from_array(x, rows_per_shard=512)
    eng = ExactKNN(k=4, backend="cuda", device="cpu").fit_store(store, resident=resident)
    if tier == "int8":
        eng.enable_int8()
    cache = _use(AutotuneCache(str(tmp_path / "card.json")))
    cache.put_capability(False)
    mode = "fqsd" if resident else "fqsd-streamed"
    with pytest.raises(RuntimeError, match="card.json"):
        eng.plan_for(mode, 8, tier=tier)
    with pytest.raises(RuntimeError, match="capability verdict"):
        eng.search(SearchRequest(queries=x[:2], tier=tier))
    # plain backends plan as before, and a true verdict is permissive
    plain = ExactKNN(k=4, backend="torch", device="cpu").fit_store(store, resident=resident)
    assert plain.plan_for(mode, 8).backend == "torch"
    cache.put_capability(True)
    assert eng.plan_for(mode, 8, tier=tier).backend == "cuda"


def test_negative_verdict_names_the_executor():
    cache = _use(AutotuneCache(path=None))
    cache.put_capability(False)
    for meta, executor in ((dataclasses.replace(META, tier="f32"), "fdsq-cuda"),
                           (META, "fqsd-int8-cuda"), (STREAM_META, "fqsd-int8-streamed")):
        with pytest.raises(RuntimeError, match=executor):
            tplanner.plan((8, 128), meta, CFG, "fqsd")


def test_the_references_pallas_verdict_does_not_veto_the_port(tmp_path):
    path = str(tmp_path / "card.json")
    jtune.AutotuneCache(path).put_capability(False)  # capability|pallas
    _use(AutotuneCache(path))
    assert tplanner.plan((8, 128), META, CFG, "fqsd").executor == "fqsd-int8-cuda"


def test_without_capability_view(tmp_path):
    cache = AutotuneCache(str(tmp_path / "c.json"))
    cache.put(KEY, BlockShapes(8, 512, 128))
    cache.put_pipeline(PIPE_KEY, KNOBS)
    cache.put_capability(False)
    view = cache.without_capability()
    assert view.get_capability() is None
    assert view.get(KEY) == BlockShapes(8, 512, 128) and view.get_pipeline(PIPE_KEY) == KNOBS
    view.put_capability(True)  # detached: the file keeps its verdict
    assert AutotuneCache(str(tmp_path / "c.json")).get_capability() is False


def test_port_exports_the_references_names():
    import repro_torch.tuning as tt

    want = {n.replace("pallas", "cuda") for n in jtune.__all__}
    assert set(tt.__all__) == want
    assert tauto.SCHEMA_VERSION == 1 and tauto.BN_CANDIDATES == jtune.autotune.BN_CANDIDATES
