"""Shared neural layers: RMSNorm, RoPE, GQA attention (full / blockwise-flash
/ decode), SwiGLU MLP, sort-based MoE dispatch.

Each layer is an ``nn.Module`` holding its parameters under the names of
the JAX package's param dicts, read as ``params["wq"]`` (``ParamModule``),
and a function of the reference's name that takes either such a module or
a plain dict of tensors: ``attention(params, x, positions, ...)``. The
functions are the reference's arithmetic op for op, with its casts: f32
norms, RoPE and softmax, bf16 products widened after rounding.

Only the meshless paths are here: the port's layers take no mesh, so the
reference's sharding constraints (identity without a mesh) are dropped and
its sharded branches (``_flash_decode_sharded``, ``_moe_manual``) are not
offered.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


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
    cache_v).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_theta)
    s_max = cache_k.shape[1]
    if cache_len < s_max:
        cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
        cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    rep = n_heads // n_kv_heads
    k_all = _repeat_kv(cache_k, rep)
    v_all = _repeat_kv(cache_v, rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_all).to(torch.float32)
    logits = logits / math.sqrt(d_head)
    valid = torch.arange(s_max, device=x.device) <= cache_len
    logits = logits.masked_fill(~valid[None, None, None, :], -torch.inf)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v_all)
    o = o.reshape(b, 1, n_heads * d_head)
    return o @ params["wo"], cache_k, cache_v


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
    """Sort-based token-choice top-k MoE (the reference's meshless path).
    Returns (y, aux) with aux = load-balance loss (Switch-style)."""
    return _moe_dense(params, x, n_experts=n_experts, top_k=top_k,
                      capacity_factor=capacity_factor)


def _moe_dense(params, x, *, n_experts: int, top_k: int, capacity_factor: float):
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ params["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the lower index first on ties; a stable descending sort
    # keeps that order (torch.topk's tie order is unspecified)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :top_k], gate_idx[:, :top_k]  # (T, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

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
