"""Crash recovery of the port's store: every named crash site recovers to
the state before or after the interrupted operation, opened by either
package.

The workload is ``tests/crash_child.py``'s (a store in files of 300 rows in
shards of 128, an upsert batch and two deletes journaled), run on the
port's store; the oracles are the reference's own digests of that workload
stopped before the crashing operation or run past it.

* In process, the full matrix over the ten ``faults.CRASH_SITES``: an
  injector installed with ``installed(...)`` raises ``InjectedCrash`` (a
  BaseException the store cannot absorb) at the armed site; the crashed
  store is dropped, and the directory, copied once, is reopened by the port
  and by the reference.
* As real kills, the reference's four smoke cases: this file run as a
  script (below) in a subprocess dies by ``os._exit(43)`` at the armed site
  (``crash_mode="exit"``, only ever in that child), and the parent reopens
  what it left, then checks that the recovered store still mutates,
  compacts and reopens.

Every file lives under ``tmp_path``.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import crash_child as cc
from repro_torch import faults
from repro_torch.faults import (
    CRASH_EXIT_CODE,
    CRASH_SITES,
    FaultInjector,
    FaultPlan,
    InjectedCrash,
    installed,
)
from repro_torch.store import DatasetStore

HERE = pathlib.Path(__file__).resolve().parent

JOURNAL_SITES = tuple(s for s in CRASH_SITES if s.startswith("journal."))
COMPACT_SITES = tuple(s for s in CRASH_SITES if s.startswith("compact."))

#: protocol truth per journal site: before the record is durable the
#: mutation must vanish; after, it must replay
JOURNAL_EXPECT = {"journal.append.begin": "before", "journal.append.torn": "before",
                  "journal.append.after_write": "after", "journal.append.after_fsync": "after"}
#: the generation a compaction crash leaves live: CURRENT is the commit point
COMPACT_GENERATION = {s: int(s in ("compact.after_current", "compact.after_gc"))
                      for s in COMPACT_SITES}

#: the reference's tier-1 kill subset: a torn write, a durable but
#: unacknowledged mutation, both sides of the compactor's pointer swap
SMOKE = (("journal.append.torn", "upsert"), ("journal.append.after_fsync", "delete"),
         ("compact.before_current", "compact"), ("compact.after_current", "compact"))


def build(directory: str, seed: int) -> DatasetStore:
    """``crash_child.build`` on the port's store: the written store, then
    an upsert batch and a delete of one main and one delta row, journaled."""
    store = DatasetStore.from_array(cc.corpus(seed), rows_per_shard=cc.ROWS_PER_SHARD,
                                    directory=directory)
    rng = np.random.default_rng(seed + 1)
    store.upsert(rng.standard_normal((cc.SETUP_UPSERTS, cc.D)).astype(np.float32))
    store.delete([3, cc.N0 + 1])
    return store


@pytest.fixture(autouse=True)
def _no_injector_left_behind():
    from repro import faults as jfaults

    assert faults.active() is None and jfaults.active() is None
    yield
    assert faults.active() is None and jfaults.active() is None


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """(before, after) digests of the reference's workload, per operation."""
    cache = {}

    def get(op: str, seed: int = 0):
        if (op, seed) not in cache:
            d = tmp_path_factory.mktemp(f"oracle_{op}_{seed}")
            b = cc.build(str(d / "before"), seed)
            before = cc.digest(b)
            b.close()
            a = cc.build(str(d / "after"), seed)
            cc.crash_op(a, op, seed)
            cache[(op, seed)] = (before, cc.digest(a))
            a.close()
        return cache[(op, seed)]

    return get


def _reopen_both(directory: pathlib.Path) -> tuple[DatasetStore, object]:
    """The crashed directory opened by the port, and a copy of it (as the
    crash left it) by the reference."""
    from repro.store import DatasetStore as JStore

    copy = directory.parent / (directory.name + "_for_reference")
    shutil.copytree(directory, copy)
    return DatasetStore.open(str(directory)), JStore.open(str(copy))


@pytest.mark.parametrize("op", ["upsert", "delete"])
@pytest.mark.parametrize("site", JOURNAL_SITES)
def test_journal_sites(tmp_path, oracles, site, op):
    before, after = oracles(op)
    assert before != after  # the matrix must tell them apart
    store = build(str(tmp_path / "store"), seed=0)
    with installed(FaultInjector(FaultPlan(crash_site=site))):
        with pytest.raises(InjectedCrash):
            cc.crash_op(store, op, seed=0)
    store.close()
    port, ref = _reopen_both(tmp_path / "store")
    want = before if JOURNAL_EXPECT[site] == "before" else after
    assert cc.digest(port) == want and cc.digest(ref) == want


@pytest.mark.parametrize("site", COMPACT_SITES)
def test_compact_sites(tmp_path, oracles, site):
    before, after = oracles("compact")
    assert before == after  # compaction never changes the logical state
    store = build(str(tmp_path / "store"), seed=0)
    with installed(FaultInjector(FaultPlan(crash_site=site))):
        with pytest.raises(InjectedCrash):
            store.compact()
    store.close()
    port, ref = _reopen_both(tmp_path / "store")
    gen = COMPACT_GENERATION[site]
    assert cc.digest(port) == cc.digest(ref) == before
    assert port.generation == ref.generation == gen
    if gen == 0:  # the crashed build's orphan directory was swept at open
        assert not (tmp_path / "store" / "gen_000001").exists()
    assert port.compact()["generation"] == gen + 1  # recovery is not a dead end
    assert cc.digest(port) == before


# ------------------------------------------------------------ real kills
def _kill(workdir: pathlib.Path, site: str, op: str, seed: int) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"), str(HERE),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, str(HERE / "test_torch_crash.py"), str(workdir),
                           site, op, str(seed)], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == CRASH_EXIT_CODE, (
        f"{site}/{op}: child exited {proc.returncode} (expected {CRASH_EXIT_CODE} = died at "
        f"the armed site)\nstdout: {proc.stdout}\nstderr: {proc.stderr}")


@pytest.mark.parametrize("site,op", SMOKE)
def test_kill_and_reopen_smoke(tmp_path, oracles, site, op):
    workdir = tmp_path / "crash"
    workdir.mkdir()
    _kill(workdir, site, op, seed=0)
    before, after = oracles(op)
    port, ref = _reopen_both(workdir / "store")
    recovered = cc.digest(port)
    assert recovered in (before, after) and cc.digest(ref) == recovered
    if op == "compact":
        assert port.generation == ref.generation == COMPACT_GENERATION[site]
    # the recovered store keeps its whole lifecycle
    n_ids = port.n_ids
    ids = port.upsert(np.ones((1, cc.D), np.float32))
    assert int(ids[0]) == n_ids
    port.delete([int(ids[0])])
    port.compact()
    final = cc.digest(port)
    port.close()
    assert cc.digest(DatasetStore.open(str(workdir / "store"), verify=True)) == final


def main(argv) -> int:
    """The child: build the workload in WORKDIR/store, arm SITE to exit the
    process (no flush, no atexit: what a kill leaves), run OP. Exit 43 means
    the site fired; 0 means the operation never reached it."""
    workdir, site, op, seed = argv[0], argv[1], argv[2], int(argv[3])
    store = build(os.path.join(workdir, "store"), seed)
    with installed(FaultInjector(FaultPlan(crash_site=site, crash_mode="exit"))):
        cc.crash_op(store, op, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
