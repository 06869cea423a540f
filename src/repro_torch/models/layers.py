"""Shared neural layers: RMSNorm, RoPE, GQA attention (full / blockwise-flash
/ decode), SwiGLU MLP, sort-based MoE dispatch.

Each layer is an ``nn.Module`` holding its parameters under the names of
the JAX package's param dicts, read as ``params["wq"]`` (``ParamModule``),
and a function of the reference's name that takes either such a module or
a plain dict of tensors: ``attention(params, x, positions, ...)``. The
functions are the reference's arithmetic op for op, with its casts: f32
norms, RoPE and softmax, bf16 products widened after rounding.

On a mesh made active with ``repro_torch.core.mesh.use_mesh`` the layers
take the reference's sharded branches where it takes them:
``decode_attention`` a distributed flash-decode over a sequence-sharded
cache (``_flash_decode_sharded``) and ``moe`` the expert-parallel island
(``_moe_manual``). Each runs the reference's ``shard_map`` body position
by position on the position's blocks and device, its collectives (``pmax``,
``psum``, ``pmean``) explicit reductions over the positions between two
loops; everything else computes on the global tensors (see
``runtime.sharding``). Without a mesh the paths are the meshless ones.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mesh import current_mesh


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters and children read as the keys of the
    reference's param dict: ``m["wq"]``, ``"bq" in m``."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


def _param(t: torch.Tensor) -> nn.Parameter:
    # serving holds the weights fixed: no autograd graph unless a caller
    # asks for one with requires_grad_(), as training does
    return nn.Parameter(t, requires_grad=False)


def draw_device(generator: torch.Generator, device=None) -> torch.device:
    """Where ``generator``'s draws are made: on its own device, or on the
    meta device when ``device`` is meta (shapes only, nothing drawn)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return generator.device


def dense_init(generator: torch.Generator, shape, dtype, scale=None, device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) in f32, drawn on the generator's device (see
    :func:`draw_device`), then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=draw_device(generator, device),
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# ------------------------------------------------------------------ RMSNorm
class RMSNorm(ParamModule):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)

    def forward(self, x, eps: float = 1e-6):
        return rmsnorm(self, x, eps)


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(d_head: int, theta: float = 1e4, device=None):
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (..., S, H, d_head); positions: broadcastable to (..., S). Rotates
    the two halves (not interleaved pairs), in f32, cast back to x's dtype."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)  # (half,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (...,S,1,half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
class Attention(ParamModule):
    """wq (d, H·dh), wk / wv (d, KVH·dh), wo (H·dh, d); optional QKV biases."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(w) for w in (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (None if b is None else _param(b) for b in (bq, bk, bv))

    def forward(self, x, positions, **kw):
        return attention(self, x, positions, **kw)


def init_attention(generator, d_model, n_heads, n_kv_heads, d_head, qkv_bias, dtype,
                   device=None):
    w = [dense_init(generator, s, dtype, device=device) for s in (
        (d_model, n_heads * d_head), (d_model, n_kv_heads * d_head),
        (d_model, n_kv_heads * d_head), (n_heads * d_head, d_model))]
    biases = {}
    if qkv_bias:
        dev = draw_device(generator, device)
        biases = {"bq": torch.zeros(n_heads * d_head, dtype=dtype, device=dev),
                  "bk": torch.zeros(n_kv_heads * d_head, dtype=dtype, device=dev),
                  "bv": torch.zeros(n_kv_heads * d_head, dtype=dtype, device=dev)}
    return Attention(*w, **biases)


def _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, n_heads, d_head)
    k = k.reshape(b, s, n_kv_heads, d_head)
    v = v.reshape(b, s, n_kv_heads, d_head)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: query head h reads KV head h // rep (``jnp.repeat`` on axis 2)."""
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=2)


def _decode_scores(q, k, rep: int) -> torch.Tensor:
    """(B, 1, H, dh) queries against (B, S, KVH, dh) keys: (B, H, 1, S) f32
    logits, query head h reading KV head h // rep, without materialising
    the repeated keys (a decode cache is S long: at 32,768 positions and
    batch 128 the repeat alone would take tens of GB)."""
    b, one, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, one, kvh, rep, dh)
    return torch.einsum("bqgrd,bkgd->bgrqk", qg, k).to(torch.float32).reshape(
        b, h, one, k.shape[1])


def _decode_values(p, v, rep: int) -> torch.Tensor:
    """(B, H, 1, S) weights over (B, S, KVH, dh) values: (B, 1, H, dh)."""
    b, h, one, s = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, rep, one, s)
    return torch.einsum("bgrqk,bkgd->bqgrd", pg, v).reshape(b, one, h, v.shape[-1])


def _sdpa_full(q, k, v, causal: bool):
    """Reference attention; fine for short sequences / smoke tests."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    k = _repeat_kv(k, rep)
    v = _repeat_kv(v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = logits.masked_fill(~mask[None, None], -torch.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_blockwise(q, k, v, causal: bool, q_block: int, kv_block: int):
    """Memory-efficient (flash-style) attention: a loop over KV blocks with
    running (max, sumexp, acc); no (S, S) intermediate materialises, in the
    backward neither.

    Shapes: q (B, Sq, H, dh); k/v (B, Skv, KVH, dh). GQA handled by
    repeating each KV block's heads per q block.
    """
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    rep = h // kvh
    scale = 1.0 / math.sqrt(dh)
    nq = sq // q_block
    nk = skv // kv_block
    dev = q.device

    qb = q.reshape(b, nq, q_block, h, dh)
    kb = k.reshape(b, nk, kv_block, kvh, dh)
    vb = v.reshape(b, nk, kv_block, kvh, dh)

    def kv_step(carry, qi, q_tile, kj):
        m, l, acc = carry
        k_rep = _repeat_kv(kb[:, kj], rep)  # (b, kv_block, h, dh)
        v_rep = _repeat_kv(vb[:, kj], rep)
        s_ = torch.einsum("bqhd,bkhd->bhqk", q_tile, k_rep).to(torch.float32)
        s_ = s_ * scale
        if causal:
            qpos = qi * q_block + torch.arange(q_block, device=dev)
            kpos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s_ = s_.masked_fill(~mask[None, None], -torch.inf)
        m_new = torch.maximum(m, s_.amax(dim=-1))
        # guard fully-masked rows (exp(-inf - -inf))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s_ - m_safe[..., None])
        p = torch.where(torch.isfinite(s_), p, 0.0)
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
        corr = torch.where(torch.isfinite(m), corr, 0.0)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), v_rep).to(torch.float32)
        return m_new, l_new, acc_new

    # the backward recomputes each KV step (the reference's jax.checkpoint
    # of kv_step): its working set stays one (q_block, kv_block) tile
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        q_tile = qb[:, qi]  # (b, q_block, h, dh)
        carry = (torch.full((b, h, q_block), -torch.inf, dtype=torch.float32, device=dev),
                 torch.zeros((b, h, q_block), dtype=torch.float32, device=dev),
                 torch.zeros((b, h, q_block, dh), dtype=torch.float32, device=dev))
        # causal early exit: kv blocks strictly above this q block's
        # diagonal contribute nothing
        last_kj = nk if not causal else min(nk, ((qi + 1) * q_block + kv_block - 1) // kv_block)
        for kj in range(last_kj):
            if remat:
                carry = checkpoint(kv_step, carry, qi, q_tile, kj, use_reentrant=False)
            else:
                carry = kv_step(carry, qi, q_tile, kj)
        _, l, acc = carry
        l = torch.clamp_min(l, 1e-30)
        out = acc / l[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))  # (b, q_block, h, dh)
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


def attention(params, x, positions, *, n_heads: int, n_kv_heads: int, d_head: int,
              rope_theta: float, causal: bool = True, flash_threshold: int = 2048,
              q_block: int = 512, kv_block: int = 1024, return_kv: bool = False):
    """Self-attention over (B, S, d_model); flash path beyond the threshold."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    if s > flash_threshold and s % q_block == 0 and s % kv_block == 0:
        o = _flash_blockwise(q, k, v, causal, q_block, kv_block)
    else:
        o = _sdpa_full(q, k, v, causal)
    out = o.reshape(b, s, n_heads * d_head) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def decode_attention(params, x, cache_k, cache_v, cache_len: int, *,
                     n_heads, n_kv_heads, d_head, rope_theta):
    """One-token decode against a KV cache (linear in cache length).

    x: (B, 1, d); cache_k/v: (B, S_max, KVH, dh); cache_len: a host int, the
    number of valid cache positions. The new position is written into
    cache_k / cache_v in place (nothing when cache_len >= S_max, as the
    reference's one-hot insert writes nothing there); returns (out, cache_k,
    cache_v). On a mesh whose ``model`` axis (tp > 1) divides S_max but not
    the KV heads the cache is sequence-sharded, and the softmax runs as the
    reference's distributed flash-decode (:func:`_flash_decode_sharded`).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    s_max = cache_k.shape[1]
    if cache_len < s_max:
        cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
        cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    mesh = current_mesh()
    tp = mesh.shape["model"] if mesh is not None and "model" in mesh.axis_names else 1
    if tp > 1 and s_max % tp == 0 and n_kv_heads % tp:
        o = _flash_decode_sharded(q, cache_k, cache_v, cache_len, mesh=mesh,
                                  n_heads=n_heads, n_kv_heads=n_kv_heads, d_head=d_head)
    else:
        rep = n_heads // n_kv_heads
        logits = _decode_scores(q, cache_k, rep) / math.sqrt(d_head)
        valid = torch.arange(s_max, device=x.device) <= cache_len
        logits = logits.masked_fill(~valid[None, None, None, :], -torch.inf)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = _decode_values(probs, cache_v, rep)
    o = o.reshape(b, 1, n_heads * d_head)
    return o @ params["wo"], cache_k, cache_v


def island(mesh, batch: int):
    """The layout of an island whose activations shard the batch over the
    data axes (pod, data) when they divide it, and are replicated over
    ``model``: (data blocks, rows a block, device(i, t)) — the device of
    data block i at ``model`` position t (other axes at 0). A batch that
    does not divide is one block, computed at data position 0 (its other
    data positions hold replicas of the same values)."""
    names = mesh.axis_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = math.prod(mesh.shape[a] for a in data_axes)
    blocks = dp if data_axes and batch % dp == 0 else 1
    mi = names.index("model")

    def device(i: int, t: int) -> torch.device:
        coord = [0] * len(names)
        for a, c in zip(data_axes, np.unravel_index(i, [mesh.shape[a] for a in data_axes])
                        if blocks > 1 else ()):
            coord[names.index(a)] = int(c)
        coord[mi] = t
        return mesh.devices[tuple(coord)]

    return blocks, batch // blocks, device


def _flash_decode_sharded(q, k, v, cache_len: int, *, mesh, n_heads, n_kv_heads, d_head):
    """Exact distributed softmax over a sequence-sharded KV cache.

    Every ``model`` position scores its slice of the cache: a loop over the
    positions for the local logits and their maxima (f32), the global max
    over positions (the reference's ``pmax``), a second loop for ``p``, the
    local denominators and ``o_part``, then their sums over positions in
    position order (``psum``, in f32) — the flash-attention identity across
    positions. The batch splits over the data axes as in :func:`island`.
    """
    tp = mesh.shape["model"]
    blocks, b_loc, device = island(mesh, q.shape[0])
    rep = n_heads // n_kv_heads
    scale = 1.0 / math.sqrt(d_head)
    s_loc = k.shape[1] // tp
    first = mesh.first
    outs = []
    for i in range(blocks):
        rows = slice(i * b_loc, (i + 1) * b_loc)
        logits, maxima = [], []
        for t in range(tp):  # local logits and maxima
            dev = device(i, t)
            k_loc = k[rows, t * s_loc:(t + 1) * s_loc].to(dev)
            lg = _decode_scores(q[rows].to(dev), k_loc, rep) * scale
            gpos = t * s_loc + torch.arange(s_loc, device=dev)
            lg = lg.masked_fill(~(gpos <= cache_len)[None, None, None, :], -torch.inf)
            logits.append(lg)
            maxima.append(lg.amax(dim=-1))  # (b, h, 1)
        m = torch.stack([mx.to(first) for mx in maxima]).amax(dim=0)  # pmax
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        denoms, parts = [], []
        for t in range(tp):  # p, its denominators and o_part
            dev = device(i, t)
            lg = logits[t]
            ms = m_safe.to(dev)
            p = torch.where(torch.isfinite(lg), torch.exp(lg - ms[..., None]), 0.0)
            v_loc = v[rows, t * s_loc:(t + 1) * s_loc].to(dev)
            denoms.append(p.sum(dim=-1))
            parts.append(_decode_values(p.to(q.dtype), v_loc, rep).to(torch.float32))
        denom, o = denoms[0].to(first), parts[0].to(first)
        for t in range(1, tp):  # psum, in position order
            denom = denom + denoms[t].to(first)
            o = o + parts[t].to(first)
        denom = torch.clamp_min(denom, 1e-30)
        outs.append((o / denom.transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs) if blocks > 1 else outs[0]


# ------------------------------------------------------------- SwiGLU MLP
class MLP(ParamModule):
    """w_gate / w_up (d, d_ff), w_down (d_ff, d)."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (_param(w) for w in (w_gate, w_up, w_down))

    def forward(self, x):
        return mlp(self, x)


def init_mlp(generator, d_model, d_ff, dtype, device=None):
    return MLP(*(dense_init(generator, s, dtype, device=device)
                 for s in ((d_model, d_ff), (d_model, d_ff), (d_ff, d_model))))


def mlp(params, x):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ------------------------------------------------------------------- MoE
class MoE(ParamModule):
    """router (d, E) in f32; w_gate / w_up (E, d, de), w_down (E, de, d)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = (
            _param(w) for w in (router, w_gate, w_up, w_down))

    def forward(self, x, **kw):
        return moe(self, x, **kw)


def init_moe(generator, d_model, n_experts, d_expert, dtype, device=None):
    return MoE(dense_init(generator, (d_model, n_experts), torch.float32, device=device),
               *(dense_init(generator, s, dtype, device=device) for s in (
                   (n_experts, d_model, d_expert), (n_experts, d_model, d_expert),
                   (n_experts, d_expert, d_model))))


def moe(params, x, *, n_experts: int, top_k: int, capacity_factor: float = 1.25):
    """Sort-based token-choice top-k MoE. Returns (y, aux) with aux =
    load-balance loss (Switch-style).

    Two paths, as in the reference: meshless, the global sort-based
    dispatch of :func:`_moe_dense`; on a mesh with a ``model`` axis, the
    expert-parallel island :func:`_moe_manual`."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        return _moe_manual(params, x, n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor, mesh=mesh)
    return _moe_dense(params, x, n_experts=n_experts, top_k=top_k,
                      capacity_factor=capacity_factor)


def _route(xf, router, top_k: int):
    """Router probabilities and each token's top_k (gates renormalised,
    experts by descending probability, the lower index first on ties, as
    ``lax.top_k``; torch.topk's tie order is unspecified)."""
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :top_k], gate_idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def _moe_dense(params, x, *, n_experts: int, top_k: int, capacity_factor: float):
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx = _route(xf, params["router"], top_k)  # (T, E), (T, k)

    capacity = int(math.ceil(t * top_k / n_experts * capacity_factor))
    capacity = max(capacity, 1)

    flat_e = gate_idx.reshape(-1)  # (T*k,)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]
    # position within expert: arange - start offset of this expert's run
    counts = torch.bincount(sorted_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=dev) - starts[sorted_e]
    keep = pos < capacity
    trash = n_experts * capacity  # one slot past the experts' for dropped assignments
    slot = torch.where(keep, sorted_e * capacity + pos, trash)

    buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[sorted_tok] * keep[:, None].to(x.dtype)
    ebuf = buf[:-1].reshape(n_experts, capacity, d)

    h = F.silu(torch.bmm(ebuf, params["w_gate"])) * torch.bmm(ebuf, params["w_up"])
    eout = torch.bmm(h, params["w_down"]).reshape(trash, d)

    # return trip: gather each kept assignment's expert output
    contrib = torch.where(keep[:, None], eout[torch.clamp_max(slot, trash - 1)], 0)
    weights = gate_vals.reshape(-1)[order]
    # the reference scatter-adds in sorted order; here the sort is inverted
    # and each token sums its top_k contributions in one fixed order, so a
    # run's bits do not depend on atomics
    weighted = torch.empty((t * top_k, d), dtype=torch.float32, device=dev)
    weighted[order] = contrib.to(torch.float32) * weights[:, None]
    y = weighted.reshape(t, top_k, d).sum(dim=1)
    y = y.reshape(b, s, d).to(x.dtype)

    # Switch load-balance aux: E * sum_e f_e * p_e
    dispatch_frac = torch.bincount(flat_e, minlength=n_experts) / (t * top_k)
    router_frac = probs.mean(dim=0)
    aux = n_experts * torch.sum(dispatch_frac * router_frac)
    return y, aux


def _moe_manual(params, x, *, n_experts: int, top_k: int, capacity_factor: float, mesh):
    """Expert-parallel MoE: the reference's ``shard_map`` island, position by
    position.

    Layout: activations (B, S, d) split B over the data axes
    (:func:`island`) and are replicated over ``model``; expert weights
    (E, d, de) split E over ``model``, E / tp a position. Each position
    routes its tokens over all E experts, dispatches to its own E / tp
    only (the rest go to a trash bucket, ``e_loc``) at the island's own
    capacity ``max(4, ceil(t_loc·top_k / E · cf))``, and accumulates its
    experts' weighted outputs in f32, each token's contributions in the
    order of the reference's sorted scatter (by local expert). The combine
    is the reference's bf16 ``psum`` over ``model``: each position's sum
    rounded to bf16, the positions' values summed in f32 in position order
    and rounded once (how XLA sums a bf16 all-reduce on the CPU). The aux
    loss is each position's, averaged over ``model`` and the data axes
    (``pmean``). E must be a multiple of ``model``'s size.
    """
    tp = mesh.shape["model"]
    if n_experts % tp:
        raise ValueError(f"{n_experts} experts not divisible by model={tp}")
    e_loc = n_experts // tp
    b, s, d = x.shape
    blocks, b_loc, device = island(mesh, b)
    t_loc = b_loc * s
    capacity = max(4, int(math.ceil(t_loc * top_k / n_experts * capacity_factor)))
    # one split a weight: its backward is one concatenation, not a full-size
    # gradient a position
    wg, wu, wd = (torch.split(params[n], e_loc) for n in ("w_gate", "w_up", "w_down"))
    first = mesh.first
    ys, auxes = [], []
    for i in range(blocks):
        partial = []
        for j in range(tp):
            dev = device(i, j)
            xf = x[i * b_loc:(i + 1) * b_loc].to(dev).reshape(t_loc, d)
            probs, gate_vals, gate_idx = _route(xf, params["router"].to(dev), top_k)
            lo = j * e_loc
            flat_e = gate_idx.reshape(-1)
            flat_t = torch.arange(t_loc, device=dev).repeat_interleave(top_k)
            flat_w = gate_vals.reshape(-1)
            is_local = (flat_e >= lo) & (flat_e < lo + e_loc)
            loc_e = torch.where(is_local, flat_e - lo, e_loc)  # e_loc = trash bucket
            order = torch.argsort(loc_e, stable=True)
            s_e, s_t, s_w = loc_e[order], flat_t[order], flat_w[order]
            counts = torch.bincount(s_e, minlength=e_loc + 1)
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(t_loc * top_k, device=dev) - starts[s_e]
            keep = (s_e < e_loc) & (pos < capacity)
            trash = e_loc * capacity
            slot = torch.where(keep, s_e * capacity + pos, trash)
            buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=dev)
            buf[slot] = xf[s_t] * keep[:, None].to(x.dtype)
            ebuf = buf[:-1].reshape(e_loc, capacity, d)
            wg_j, wu_j, wd_j = wg[j].to(dev), wu[j].to(dev), wd[j].to(dev)
            h = F.silu(torch.bmm(ebuf, wg_j)) * torch.bmm(ebuf, wu_j)
            eout = torch.bmm(h, wd_j).reshape(trash, d)
            contrib = torch.where(keep[:, None], eout[torch.clamp_max(slot, trash - 1)], 0)
            weighted = contrib.to(torch.float32) * s_w[:, None]
            # the scatter-add's order: a token's entries as they stand sorted
            by_token = weighted[torch.argsort(s_t, stable=True)].reshape(t_loc, top_k, d)
            y = by_token[:, 0]
            for r in range(1, top_k):
                y = y + by_token[:, r]
            partial.append(y.to(torch.bfloat16))
            dispatch_frac = torch.bincount(flat_e, minlength=n_experts) / (t_loc * top_k)
            auxes.append(n_experts * torch.sum(dispatch_frac * probs.mean(dim=0)))
        y = partial[0].to(first, torch.float32)
        for j in range(1, tp):  # the bf16 psum over model
            y = y + partial[j].to(first, torch.float32)
        ys.append(y.to(torch.bfloat16).reshape(b_loc, s, d).to(x.dtype))
    # pmean over model and the data axes: a replicated batch block stands
    # for each of its data positions alike
    aux = auxes[0].to(first)
    for a in auxes[1:]:
        aux = aux + a.to(first)
    aux = aux / len(auxes)
    return (torch.cat(ys) if blocks > 1 else ys[0]), aux
