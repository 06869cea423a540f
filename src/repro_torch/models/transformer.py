"""Transformer LM (dense + MoE, GQA + RoPE): training and decode serving.

Covers the five LM architectures of ``repro_torch.configs`` through one
config-driven implementation. The parameters are a ``Transformer`` module
(the reference's param dict as nn.Modules: ``params["layers"][i]["attn"]
["wq"]``, weights laid out (in, out) as the reference has them); the
reference's scan over stacked layers is a Python loop over its
``nn.ModuleList``.

Entry points:
    init(generator, cfg, device=None) -> Transformer (the parameters)
    apply(params, cfg, tokens)        -> (logits (B, S, V) f32, moe aux loss)
    loss_fn(params, cfg, batch)       -> (loss, aux)
    value_and_grad(params, cfg, batch) -> ((loss, aux), grads by parameter name)
    prefill(params, cfg, tokens, max_len=None) -> (last-token logits, cache)
    init_cache(cfg, batch, max_len, dtype=None, device=None) -> cache
    decode_step(params, cfg, cache, tokens) -> (logits (B, V), cache)

Training: the weights are ``requires_grad=False`` as ``init`` makes them
(serving builds no graph); ``params.requires_grad_()`` makes them
trainable, and ``loss_fn``'s backward is autograd's. With ``cfg.remat``
and grad enabled each layer of ``apply`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body): the backward keeps one activation a layer and recomputes the rest.
``prefill`` and ``decode_step`` run under ``torch.no_grad()``, so a model
being trained is served without a graph.

The cache is ``{"k", "v": (L, B, S_max, KVH, dh), "len": int}`` with a
global length kept on the host. ``decode_step`` writes the new position
into the cache's tensors in place (the reference rebuilds the whole cache
with a one-hot ``where``; the values are the same) and returns a dict over
the same tensors with ``len`` advanced.

On a CUDA device ``apply``, ``prefill`` and ``decode_step`` switch off
cuBLAS's reduced-precision bf16 reductions and TF32 for the process: a
bf16 product is then summed in f32 and rounded once, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamModule, _param


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int  # dense FFN hidden; for MoE archs this is the per-expert dim
    vocab: int
    n_experts: int = 0  # 0 => dense FFN
    expert_top_k: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    capacity_factor: float = 1.25
    remat: bool = True  # checkpoint each layer in the backward (apply)
    scan_unroll: bool = False  # the reference's dry-run knob; the port loops
    dtype: Any = torch.bfloat16
    flash_threshold: int = 2048
    q_block: int = 512
    kv_block: int = 1024

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 128; pad logits are masked to -inf, so pad ids
        are never emitted (minicpm's odd 122753 -> 122880)."""
        return ((self.vocab + 127) // 128) * 128

    def params_count(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.vocab_padded * d * 2 + self.n_layers * per_layer + d

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.params_count()
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        ffn = self.expert_top_k * 3 * d * self.d_ff + d * self.n_experts
        per_layer = attn + ffn + 2 * d
        return self.vocab_padded * d * 2 + self.n_layers * per_layer + d


class Block(ParamModule):
    """One layer: ln1, attn, ln2 and either mlp or moe."""

    def __init__(self, ln1, ln2, attn, mlp=None, moe=None):
        super().__init__()
        self.ln1, self.ln2, self.attn = ln1, ln2, attn
        self.mlp, self.moe = mlp, moe


class Transformer(ParamModule):
    """The LM's parameters: embed (V_padded, d), layers, final_norm, head
    (d, V_padded). ``forward(tokens)`` is ``apply``."""

    def __init__(self, cfg: LMConfig, embed, layers, final_norm, head):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = _param(head)

    def forward(self, tokens):
        return apply(self, self.cfg, tokens)

    def reference_ndim(self, name: str) -> int:
        """The rank of parameter ``name``'s leaf in the reference's param
        tree, whose layer weights carry a leading L axis (an ``ln1`` scale
        is (d,) here and (L, d) there): AdamW decays by it."""
        return self.get_parameter(name).ndim + name.startswith("layers.")


def _exact_matmuls(device: torch.device) -> None:
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------------------------------- init
def init(generator: torch.Generator, cfg: LMConfig, device=None) -> Transformer:
    """Random parameters drawn from ``generator`` on its own device, then
    placed on ``device`` (``None`` means CUDA and raises without a card).
    On ``device="meta"`` nothing is drawn: the parameters' shapes and dtypes
    only (``launch.steps``' cells)."""
    device = resolve_device(device)
    g = generator
    dev = L.draw_device(g, device)
    ones = lambda: torch.ones(cfg.d_model, dtype=torch.float32, device=dev)  # noqa: E731
    vp = cfg.vocab_padded
    embed = (torch.randn((vp, cfg.d_model), generator=g, device=dev) * 0.02).to(cfg.dtype)
    layers = []
    for _ in range(cfg.n_layers):
        attn = L.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                cfg.qkv_bias, cfg.dtype, device)
        if cfg.is_moe:
            ffn = {"moe": L.init_moe(g, cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.dtype, device)}
        else:
            ffn = {"mlp": L.init_mlp(g, cfg.d_model, cfg.d_ff, cfg.dtype, device)}
        layers.append(Block(L.RMSNorm(ones()), L.RMSNorm(ones()), attn, **ffn))
    head = (torch.randn((cfg.d_model, vp), generator=g, device=dev)
            / math.sqrt(cfg.d_model)).to(cfg.dtype)
    return Transformer(cfg, embed, layers, L.RMSNorm(ones()), head).to(device)


# ---------------------------------------------------------------- forward
def _ffn(cfg: LMConfig, lp, y, capacity_factor: float):
    """The layer's MLP, or its MoE and aux loss (None for a dense layer)."""
    if cfg.is_moe:
        return L.moe(lp["moe"], y, n_experts=cfg.n_experts, top_k=cfg.expert_top_k,
                     capacity_factor=capacity_factor)
    return L.mlp(lp["mlp"], y), None


def _attn_kw(cfg: LMConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, causal=True, flash_threshold=cfg.flash_threshold,
                q_block=cfg.q_block, kv_block=cfg.kv_block)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _layer_forward(cfg: LMConfig, lp, x, positions):
    """One layer: (x out, its MoE aux loss or None)."""
    x = x + L.attention(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
                        **_attn_kw(cfg))
    m, a = _ffn(cfg, lp, L.rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.capacity_factor)
    return x + m, a


def apply(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V_padded) f32, moe aux loss)."""
    _exact_matmuls(tokens.device)
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = _positions(b, s, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(_layer_forward, cfg, lp, x, positions, use_reentrant=False)
        else:
            x, a = _layer_forward(cfg, lp, x, positions)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ params["head"]).to(torch.float32)
    return _mask_pad_vocab(logits, cfg), aux


def _mask_pad_vocab(logits: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Pad ids' logits to -inf, in place."""
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -torch.inf
    return logits


def loss_fn(params, cfg: LMConfig, batch):
    """Causal LM loss; batch = {"tokens": (B, S+1)} or {"tokens", "labels"}.
    Differentiable through autograd once the weights require grad."""
    if "labels" in batch:
        tokens, labels = batch["tokens"], batch["labels"]
    else:
        tokens, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits, aux = apply(params, cfg, tokens)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold).mean()
    total = nll + 0.01 * aux
    return total, {"nll": nll, "moe_aux": aux}


def value_and_grad(params: Transformer, cfg: LMConfig, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux), grads),
    the grads a dict by parameter name (``named_parameters``' order), each
    in its parameter's dtype. The weights must require grad; nothing is
    accumulated into ``.grad``."""
    names, weights = zip(*params.named_parameters())
    loss, aux = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, weights, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), dict(zip(names, grads))


@torch.no_grad()
def prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int | None = None):
    """Serving prefill: (B, S) tokens -> (last-token logits (B, V), cache).

    Only the last position goes through the head. The per-layer K/V become
    the decode cache, of ``max_len`` positions when that is longer than S.
    """
    _exact_matmuls(tokens.device)
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = _positions(b, s, tokens.device)
    s_max = max_len if max_len is not None and max_len > s else s
    shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.d_head)
    cache_k = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    cache_v = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        h, k, v = L.attention(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
                              return_kv=True, **_attn_kw(cfg))
        cache_k[i, :, :s] = k
        cache_v[i, :, :s] = v
        x = x + h
        x = x + _ffn(cfg, lp, L.rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.capacity_factor)[0]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _mask_pad_vocab((x[:, -1, :] @ params["head"]).to(torch.float32), cfg)
    return logits, {"k": cache_k, "v": cache_v, "len": s}


# ----------------------------------------------------------------- decode
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None):
    """An empty cache; ``device=None`` means CUDA, which must exist."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


@torch.no_grad()
def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> logits (B, V); the cache advances by
    one, its tensors written in place."""
    _exact_matmuls(tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    cache_len = int(cache["len"])
    # tiny T decode: the reference raises the capacity factor to at least 8
    capacity_factor = max(cfg.capacity_factor, 8.0)
    for i, lp in enumerate(params["layers"]):
        h, _, _ = L.decode_attention(
            lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cache["k"][i], cache["v"][i],
            cache_len, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta)
        x = x + h
        x = x + _ffn(cfg, lp, L.rmsnorm(lp["ln2"], x, cfg.norm_eps), capacity_factor)[0]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _mask_pad_vocab((x[:, 0, :] @ params["head"]).to(torch.float32), cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
