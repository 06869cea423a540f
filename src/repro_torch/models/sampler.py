"""CSR neighbor sampler for sampled-training GNN shapes (minibatch_lg).

Host-side (numpy) fanout sampling a la GraphSAGE: given a CSR adjacency,
sample `fanouts[l]` neighbors per frontier node per hop, uniformly without
replacement, and emit a padded fixed-shape subgraph the train step
consumes (fixed shapes: the same buffers every step). The code is the
reference's (``repro.models.sampler``), so one seed gives the reference's
subgraphs bit for bit.

For n_nodes=232_965 / fanout 15-10 / batch 1024 the padded budget is
    hop0 edges: 1024*15 = 15_360
    hop1 edges: (1024 + 15_360)*10 = 163_840
    nodes <= 1024 + 15_360 + 163_840 = 180_224
Real samples are smaller (duplicates); padding is masked.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray  # (N_pad,) global ids, -1 pad
    node_feat: np.ndarray  # (N_pad, d)
    senders: np.ndarray  # (E_pad,) local indices
    receivers: np.ndarray  # (E_pad,)
    edge_mask: np.ndarray  # (E_pad,) bool
    node_mask: np.ndarray  # (N_pad,) bool
    seed_mask: np.ndarray  # (N_pad,) bool — loss only on seeds


class CSRGraph:
    """Compressed adjacency built once on the host."""

    def __init__(self, n_nodes: int, senders: np.ndarray, receivers: np.ndarray):
        order = np.argsort(receivers, kind="stable")
        self.src_sorted = senders[order].astype(np.int64)
        counts = np.bincount(receivers, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes

    def neighbors(self, v: int) -> np.ndarray:
        return self.src_sorted[self.offsets[v] : self.offsets[v + 1]]


def edge_budget(batch_nodes: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """(node_pad, edge_pad) for fixed-shape compilation."""
    frontier, nodes, edges = batch_nodes, batch_nodes, 0
    for f in fanouts:
        e = frontier * f
        edges += e
        frontier = e
        nodes += e
    return nodes, edges


def sample_subgraph(
    graph: CSRGraph,
    features: np.ndarray,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledSubgraph:
    n_pad, e_pad = edge_budget(len(seeds), fanouts)
    local = {int(v): i for i, v in enumerate(seeds)}
    node_ids = list(map(int, seeds))
    snd, rcv = [], []
    frontier = list(map(int, seeds))
    for f in fanouts:
        nxt = []
        for v in frontier:
            nbrs = graph.neighbors(v)
            if len(nbrs) == 0:
                continue
            take = nbrs if len(nbrs) <= f else rng.choice(nbrs, size=f, replace=False)
            for u in map(int, take):
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                    nxt.append(u)
                snd.append(local[u])
                rcv.append(local[v])
        frontier = nxt
    n, e = len(node_ids), len(snd)
    assert n <= n_pad and e <= e_pad, (n, n_pad, e, e_pad)
    ids = np.full(n_pad, -1, np.int64)
    ids[:n] = node_ids
    feat = np.zeros((n_pad, features.shape[1]), features.dtype)
    feat[:n] = features[ids[:n]]
    senders = np.zeros(e_pad, np.int32)
    receivers = np.zeros(e_pad, np.int32)
    senders[:e] = snd
    receivers[:e] = rcv
    edge_mask = np.zeros(e_pad, bool)
    edge_mask[:e] = True
    node_mask = np.zeros(n_pad, bool)
    node_mask[:n] = True
    seed_mask = np.zeros(n_pad, bool)
    seed_mask[: len(seeds)] = True
    return SampledSubgraph(ids, feat, senders, receivers, edge_mask, node_mask, seed_mask)


def minibatch_stream(
    graph: CSRGraph,
    features: np.ndarray,
    batch_nodes: int,
    fanouts: tuple[int, ...],
    seed: int = 0,
):
    """Endless generator of sampled subgraphs (feeds the double-buffered
    device prefetcher in repro_torch.data.pipeline)."""
    rng = np.random.default_rng(seed)
    while True:
        seeds = rng.choice(graph.n_nodes, size=batch_nodes, replace=False)
        yield sample_subgraph(graph, features, seeds, fanouts, rng)
