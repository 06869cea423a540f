"""``python -m repro_torch.launch.serve --mode knn`` and
``examples/torch_quickstart.py`` on the CPU, against the reference's.

Both serving CLIs replay the same bursty trace over the same corpus
(``vector_dataset(n, d, seed=0)``) at a tiny ``--n/--d``. Their reports
must have the same lines in the same order, and the per-plan lines the
same plans, counts, tiers and certified shares, with the port's executor
in place of the reference's. Plans are compared under the latency and
throughput policies, where the measured service times do not decide them.
The quickstart's plans are held against the reference engine's plans for
the same calls.
"""
from __future__ import annotations

import re
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SMALL = ["--mode", "knn", "--n", "2000", "--d", "32", "--queries", "80", "--k", "5",
         "--burst-size", "32", "--trickle", "4"]
#: the reference executor (default backend "xla") -> the port's on backend "cuda"
_EXEC = {"fdsq-xla": "fdsq-cuda", "fqsd-xla": "fdsq-cuda", "fqsd-int8": "fqsd-int8-cuda"}
_PLAN = re.compile(r"plan=(\S+)\s+n=(\d+)\s+.* executors=(\S+) tier=(\S+) certified=(\S+)")


def _report(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


def _shape(lines):
    """Each line's first word and the keys it reports, in order."""
    return [(ln.split()[0].split("=")[0], re.findall(r"(\w+)=", ln)) for ln in lines]


def _plans(lines):
    return [m.groups() for ln in lines if (m := _PLAN.search(ln))]


@pytest.mark.parametrize("extra", [
    ["--policy", "latency"],
    ["--policy", "throughput"],
    ["--fqsd", "--int8-depth", "1", "--collection", "passages"],
    ["--policy", "latency", "--verify-on-open", "--compact-min-pending", "64",
     "--max-retries", "1", "--allow-partial"],
])
def test_serve_cli_prints_the_reference_report(capsys, extra):
    want = _report(jserve.main, SMALL + extra, capsys)
    got = _report(serve.main, SMALL + extra + ["--device", "cpu"], capsys)
    assert _shape(got) == _shape(want)
    assert got[0].split("  ")[:2] == want[0].split("  ")[:2]  # collection, policy
    for key in ("served=80", "shed=0", "deadline_misses=0"):
        assert key in got[0] and key in want[0]
    assert got[1] == want[1]  # health and breaker
    assert [(p, n, _EXEC[e], t, c) for p, n, e, t, c in _plans(want)] == _plans(got)
    assert _plans(got) and sum(int(n) for _, n, *_ in _plans(got)) == 80


def test_serve_cli_routes_bursts_to_int8_and_trickles_to_fdsq(capsys):
    """Adaptive with the int8 hook: a burst is a deep backlog (int8 FQ-SD),
    a trickle request arriving alone an FD-SQ dispatch."""
    got = _report(serve.main, SMALL + ["--policy", "adaptive", "--int8-depth", "32",
                                       "--device", "cpu"], capsys)
    plans = {p: e for p, _, e, _, _ in _plans(got)}
    assert plans["fqsd-int8"] == "fqsd-int8-cuda" and plans["fdsq"] == "fdsq-cuda"
    switches = int(re.search(r"mode_switches=(\d+)", got[0]).group(1))
    assert switches > 0


def test_serve_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--mode", "lm", "--arch", "minicpm-2b"])


_LM_LINE = re.compile(r"LM decode: (\d+) seqs, (\d+) tokens in \S+s \(\S+ tok/s, "
                      r"continuous batching over 4 slots\)")


@pytest.mark.parametrize("arch,queries", [("minicpm-2b", "100"), ("qwen3-moe-30b-a3b", "9")])
def test_serve_lm_prints_the_reference_report(capsys, arch, queries):
    """``--mode lm --device cpu``: the reference's report line, with the same
    sequence and token counts (100 requests run the 128-position cache past
    max_len - 1, where every later sequence ends after one token). The
    served tokens stay in the vocabulary."""
    argv = ["--mode", "lm", "--arch", arch, "--queries", queries]
    srv = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    jserve.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert _LM_LINE.fullmatch(got[0]).groups() == _LM_LINE.fullmatch(want[0]).groups()
    assert len(srv.completed) == int(queries)
    assert all(0 <= t < srv.cfg.vocab for s in srv.completed for t in s.tokens)


def test_quickstart_runs_the_reference_plans(capsys, monkeypatch):
    from repro.api import SearchRequest as JRequest
    from repro.core import ExactKNN as JExactKNN
    from repro.data import query_stream, vector_dataset

    n, d, k = 3000, 48, 10
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py", "--device", "cpu", "--n", str(n),
                                      "--d", str(d), "--k", str(k)])
    runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"), run_name="__main__")
    out = capsys.readouterr().out
    for line in (f"exactness: scores allclose to oracle, recall@{k} = 1.000",
                 "filter_mask: banned row excluded, runner-up promoted",
                 "FQ-SD host-streamed (fqsd-mmap-streamed) == resident result",
                 "certified-exact rows: 100%"):
        assert line in out
    got = re.findall(r"mode=(\S+)\s+executor=(\S+)\s+m=(\d+)\s+k=(\d+)\s+chunk=\d+ "
                     r"partitions=(\d+)", out)
    # the reference engine under the quickstart's calls
    x = vector_dataset(n, d, seed=0)
    q = query_stream(x, 64, seed=1)
    eng = JExactKNN(k=k, n_partitions=8).fit(x)
    eng.search(JRequest(queries=q[0], mode_hint="fdsq"))
    batch = eng.search(JRequest(queries=q, mode_hint="fqsd"))
    eng.search(JRequest(queries=q, k=3, mode_hint="fqsd"))
    mask = np.ones(eng.n_ids, bool)
    mask[int(batch.indices[0, 0])] = False
    eng.search(JRequest(queries=q[0], filter_mask=mask))
    want = [(p.mode, str(p.m), str(p.k), str(p.n_partitions)) for p in eng.plans]
    assert [(mode, m, kk, parts) for mode, _, m, kk, parts in got] == want
    assert {e for _, e, *_ in got} == {"fdsq-cuda"}
