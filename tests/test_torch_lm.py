"""The port's LM decode-serving path against the JAX package's on the CPU.

The same numpy inputs (made from a seed) and the same weights (the
reference's ``init`` carried over by ``convert.lm_params_from_numpy``) go
through ``repro.models`` and ``repro_torch.models``: each layer function,
the smoke models' ``apply`` / ``prefill`` / ``decode_step`` (dense and MoE),
``loss_fn`` and ``DecodeServer``'s tokens.

Tolerances. In f32 the two packages do the same operations in another
order (XLA-CPU and PyTorch's CPU kernels block their sums differently), so
values agree to a few ulps of the operands' scale: ``rtol=1e-5,
atol=1e-5`` (logits and activations here are O(1)). The one bf16 case is
held loosely, to ``atol=0.1`` on O(1) logits: every bf16 product is
rounded to 8 bits of mantissa, the residual stream's values of 1-4 have a
step of 2^-7-2^-5, and the two packages round the same sums from partial
sums taken in another order, so a step that differs in one layer moves the
next layer's outputs (measured: at most 0.048 on minicpm's smoke model in
bf16, 2 layers). The tight checks are the f32 ones. Integer outputs
(greedy tokens, pad masks) are equal.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import DecodeServer as JDecodeServer
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import DecodeServer

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.1
LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-30b-a3b", "qwen2.5-14b", "starcoder2-7b", "minicpm-2b")
_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(p) -> dict:
    """A reference param dict as a dict of torch tensors (f32 here)."""
    return {k: _t(v) for k, v in p.items()}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), _np(want), **(tol or F32))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jit(fn, **static):
    """The reference function compiled once for its static arguments
    (op-by-op dispatch compiles every primitive on the CPU, which is what
    makes eager JAX slow here)."""
    return _jitted(fn, tuple(sorted(static.items())))


@functools.cache
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


#: the reference's entry points, compiled once a config (static argument 1)
J_INIT = jax.jit(JT.init, static_argnums=1)
J_APPLY = jax.jit(JT.apply, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(1, 3))
J_DECODE = jax.jit(JT.decode_step, static_argnums=1)
J_LOSS = jax.jit(JT.loss_fn, static_argnums=1)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_fields_equal_the_reference(arch):
    got, want = get_config(arch), jget_config(arch)
    assert (got.arch_id, got.family, got.source, got.notes) == \
        (want.arch_id, want.family, want.source, want.notes)
    assert (got.train_moment_dtype, got.train_microbatches) == \
        (want.train_moment_dtype, want.train_microbatches)
    assert [(s.name, s.kind, dict(s.dims)) for s in got.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in want.shapes]
    for a, b in ((got.model, want.model), (got.smoke_model, want.smoke_model)):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.pop("dtype") is _DTYPES[fb.pop("dtype")]
        assert fa == fb
        assert (a.vocab_padded, a.params_count(), a.active_params_count(), a.is_moe) == \
            (b.vocab_padded, b.params_count(), b.active_params_count(), b.is_moe)


def test_registry_is_the_reference_less_what_is_not_ported():
    """Every architecture is ported: the registry is the reference's, in its
    order, and an unknown id raises."""
    assert ASSIGNED_ARCHS == tuple(J_ASSIGNED)
    assert ASSIGNED_ARCHS[:5] == LM_ARCHS
    assert ALL_ARCHS == tuple(J_ALL)
    with pytest.raises(KeyError, match="unknown arch 'resnet-50'; known: "):
        get_config("resnet-50")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_has_the_reference_shapes_and_count(arch):
    cfg = get_config(arch).smoke_model
    p = T.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda: JT.init(jax.random.key(0), jget_config(arch).smoke_model))
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    want = {"embed": jp["embed"].shape, "head": jp["head"].shape,
            "final_norm.scale": jp["final_norm"]["scale"].shape}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp["layers"]):
        name = ".".join(k.key for k in path)
        for i in range(cfg.n_layers):
            want[f"layers.{i}.{name}"] = tuple(leaf.shape[1:])
    assert got == want
    for n, t in p.named_parameters():
        assert not t.requires_grad
        want_dtype = torch.float32 if n.endswith(("scale", "router")) else cfg.dtype
        assert t.dtype is want_dtype, n
    real = sum(t.numel() for t in p.parameters())
    assert abs(real - cfg.params_count()) / real < 0.05
    again = T.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    cfg = get_config("minicpm-2b").smoke_model
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):  # before the tree is read
        lm_params_from_numpy({"embed": np.zeros((1, 1), np.float32)}, cfg)


# ------------------------------------------------------------------ layers
def test_rmsnorm():
    x, scale = _normal(0, 3, 5, 48), _normal(1, 48)
    _close(L.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5),
           _jit(JL.rmsnorm, eps=1e-5)({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    norm = L.RMSNorm(_t(scale))
    assert torch.equal(norm(_t(x)), L.rmsnorm(norm, _t(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = _normal(2, 2, 7, 3, 16)
    pos = np.random.default_rng(3).integers(0, 200, (2, 7)).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), theta),
           _jit(JL.apply_rope, theta=theta)(jnp.asarray(x), jnp.asarray(pos)))


def _qkv(seed, b, s, h, kvh, dh):
    return _normal(seed, b, s, h, dh), _normal(seed + 1, b, s, kvh, dh), \
        _normal(seed + 2, b, s, kvh, dh)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [4, 2, 1])  # rep 1, 2, 4
def test_sdpa_full(causal, kvh):
    q, k, v = _qkv(4, 2, 9, 4, kvh, 8)
    _close(L._sdpa_full(_t(q), _t(k), _t(v), causal),
           _jit(JL._sdpa_full, causal=causal)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh,q_block,kv_block", [(4, 8, 16), (2, 16, 8), (1, 8, 8)])
def test_flash_blockwise(causal, kvh, q_block, kv_block):
    q, k, v = _qkv(5, 2, 32, 4, kvh, 8)
    got = L._flash_blockwise(_t(q), _t(k), _t(v), causal, q_block, kv_block)
    want = _jit(JL._flash_blockwise, causal=causal, q_block=q_block, kv_block=kv_block)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, want)
    _close(got, L._sdpa_full(_t(q), _t(k), _t(v), causal).numpy())


def _weights(seed, **shapes) -> dict:
    """A layer's parameters as the reference lays them out: N(0, 1/fan_in)
    numpy f32 arrays, one seeded draw each (no JAX init to compile)."""
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) / np.sqrt(shape[-2] if len(shape) > 1 else 1))
            .astype(np.float32) for name, shape in shapes.items()}


def _attention_params(seed, d, h, kvh, dh, bias):
    shapes = dict(wq=(d, h * dh), wk=(d, kvh * dh), wv=(d, kvh * dh), wo=(h * dh, d))
    if bias:
        shapes |= dict(bq=(h * dh,), bk=(kvh * dh,), bv=(kvh * dh,))
    return _weights(seed, **shapes)


def _moe_params(seed, d, e, de):
    return _weights(seed, router=(d, e), w_gate=(e, d, de), w_up=(e, d, de), w_down=(e, de, d))


@pytest.mark.parametrize("s,flash_threshold,bias", [(12, 2048, False), (32, 16, True),
                                                     (32, 16, False), (24, 16, False)])
def test_attention_full_and_flash_paths(s, flash_threshold, bias):
    """s=32 over a threshold of 16 takes the flash path (q_block 8,
    kv_block 16); s=24 is no multiple of kv_block and stays on the full one."""
    jp = _attention_params(6, 32, 4, 2, 8, bias)
    x = _normal(7, 2, s, 32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    kw = dict(n_heads=4, n_kv_heads=2, d_head=8, rope_theta=1e4, flash_threshold=flash_threshold,
              q_block=8, kv_block=16, return_kv=True)
    got = L.attention(_tree(jp), _t(x), _t(pos), **kw)
    want = _jit(JL.attention, **kw)(jp, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)
    module = L.Attention(**_tree(jp))
    assert torch.equal(module(_t(x), _t(pos), **kw)[0], got[0])


@pytest.mark.parametrize("kvh", [4, 1])
@pytest.mark.parametrize("cache_len", [0, 5, 11, 12])
def test_decode_attention(kvh, cache_len):
    """cache_len 11 fills the last slot; 12 (= S_max) writes nothing, as the
    reference's one-hot insert matches no position."""
    s_max = 12
    jp = _attention_params(8, 32, 4, kvh, 8, False)
    x = _normal(9, 3, 1, 32)
    ck, cv = _normal(10, 3, s_max, kvh, 8), _normal(11, 3, s_max, kvh, 8)
    kw = dict(n_heads=4, n_kv_heads=kvh, d_head=8, rope_theta=1e4)
    got_k, got_v = _t(ck), _t(cv)
    out, nk, nv = L.decode_attention(_tree(jp), _t(x), got_k, got_v, cache_len, **kw)
    want = _jit(JL.decode_attention, **kw)(jp, jnp.asarray(x), jnp.asarray(ck),
                                           jnp.asarray(cv), jnp.int32(cache_len))
    _close(out, want[0])
    _close(nk, want[1])
    _close(nv, want[2])
    assert nk is got_k and nv is got_v  # written in place
    if cache_len >= s_max:
        assert np.array_equal(nk.numpy(), ck)


def test_mlp():
    jp = _weights(12, w_gate=(32, 64), w_up=(32, 64), w_down=(64, 32))
    x = _normal(13, 2, 5, 32)
    _close(L.mlp(_tree(jp), _t(x)), _jit(JL.mlp)(jp, jnp.asarray(x)))
    assert torch.equal(L.MLP(**_tree(jp))(_t(x)), L.mlp(_tree(jp), _t(x)))


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.5), (2, 0.5), (2, 1.25), (2, 8.0),
                                                    (3, 8.0)])
def test_moe(top_k, capacity_factor):
    """cf 0.5 drops assignments (capacity below the mean load); 8.0 keeps
    every one. The aux loss is the reference's."""
    jp = _moe_params(14, 32, 8, 16)
    x = _normal(15, 3, 7, 32)
    kw = dict(n_experts=8, top_k=top_k, capacity_factor=capacity_factor)
    y, aux = L.moe(_tree(jp), _t(x), **kw)
    wy, waux = _jit(JL.moe, **kw)(jp, jnp.asarray(x))
    _close(y, wy)
    _close(aux, waux)
    assert torch.equal(L.MoE(**_tree(jp))(_t(x), **kw)[0], y)
    if capacity_factor < 1:
        full, _ = L.moe(_tree(jp), _t(x), **{**kw, "capacity_factor": 8.0})
        assert not torch.allclose(full, y)  # assignments were dropped


def test_moe_ties_route_to_the_lower_expert():
    """A zero router makes every expert equally likely: lax.top_k picks the
    lowest indices, and so must the port (not torch.topk's unspecified order)."""
    jp = _moe_params(16, 32, 8, 16)
    jp["router"] = np.zeros((32, 8), np.float32)
    x = _normal(17, 2, 6, 32)
    kw = dict(n_experts=8, top_k=2, capacity_factor=8.0)
    _close(L.moe(_tree(jp), _t(x), **kw)[0], _jit(JL.moe, **kw)(jp, jnp.asarray(x))[0])
    only_01 = {**_tree(jp), "w_gate": _tree(jp)["w_gate"].clone()}
    only_01["w_gate"][2:] = torch.nan  # experts 2.. must never run on a token
    assert torch.isfinite(L.moe(only_01, _t(x), **kw)[0]).all()


# ------------------------------------------------------------ whole models
def _models(arch, dtype=None, seed=0):
    jcfg, cfg = jget_config(arch).smoke_model, get_config(arch).smoke_model
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jp = J_INIT(jax.random.key(seed), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(jp, cfg, device="cpu")


def _tokens(seed, cfg, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _logits_close(got, want, **tol):
    """Equal -inf pad logits, the rest within tolerance."""
    want = _np(want)
    got = got.to(torch.float32).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **(tol or F32))


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-30b-a3b", "starcoder2-7b",
                                  "kimi-k2-1t-a32b", "qwen2.5-14b"])
def test_apply_prefill_and_decode_step(arch):
    jcfg, jp, cfg, p = _models(arch)
    tok = _tokens(18, cfg, 2, 12)
    logits, aux = T.apply(p, cfg, _t(tok))
    jlogits, jaux = J_APPLY(jp, jcfg, jnp.asarray(tok))
    _logits_close(logits, jlogits)
    _close(aux, jaux)
    assert logits.shape == (2, 12, cfg.vocab_padded)
    assert (logits[..., cfg.vocab:] == -torch.inf).all()

    got, cache = T.prefill(p, cfg, _t(tok[:, :8]), max_len=16)
    want, jcache = J_PREFILL(jp, jcfg, jnp.asarray(tok[:, :8]), 16)
    _logits_close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert cache["len"] == int(jcache["len"]) == 8
    for pos in range(8, 12):
        got, cache = T.decode_step(p, cfg, cache, _t(tok[:, pos:pos + 1]))
        want, jcache = J_DECODE(jp, jcfg, jcache, jnp.asarray(tok[:, pos:pos + 1]))
        _logits_close(got, want)
        assert cache["len"] == int(jcache["len"]) == pos + 1
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    if not cfg.is_moe:  # no capacity drops: decoding is the forward
        _logits_close(got, logits[:, -1].numpy())


def test_decode_from_an_empty_cache_and_the_module_forward():
    jcfg, jp, cfg, p = _models("qwen2.5-14b")  # GQA 4/2 with QKV biases
    tok = _tokens(19, cfg, 3, 5)
    cache, jcache = T.init_cache(cfg, 3, 8, device="cpu"), JT.init_cache(jcfg, 3, 8)
    for pos in range(5):
        got, cache = T.decode_step(p, cfg, cache, _t(tok[:, pos:pos + 1]))
        want, jcache = J_DECODE(jp, jcfg, jcache, jnp.asarray(tok[:, pos:pos + 1]))
        _logits_close(got, want)
    logits, _ = p(_t(tok))
    _logits_close(got, logits[:, -1].numpy())


def test_bf16_apply_and_decode():
    """minicpm's smoke model in bf16 (its real dtype): held loosely, see the
    module docstring."""
    jcfg, jp, cfg, p = _models("minicpm-2b", dtype="bf16")
    assert p.embed.dtype is torch.bfloat16
    assert np.array_equal(p.head.view(torch.int16).numpy(),
                          np.asarray(jp["head"]).view(np.int16))  # bits carried
    tok = _tokens(20, cfg, 2, 10)
    logits, _ = T.apply(p, cfg, _t(tok))
    _logits_close(logits, J_APPLY(jp, jcfg, jnp.asarray(tok))[0], rtol=0, atol=BF16_ATOL)
    got, cache = T.prefill(p, cfg, _t(tok[:, :9]), max_len=12)
    want, jcache = J_PREFILL(jp, jcfg, jnp.asarray(tok[:, :9]), 12)
    _logits_close(got, want, rtol=0, atol=BF16_ATOL)
    got, _ = T.decode_step(p, cfg, cache, _t(tok[:, 9:]))
    want, _ = J_DECODE(jp, jcfg, jcache, jnp.asarray(tok[:, 9:]))
    _logits_close(got, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("labels", [False, True])
def test_loss_fn_forward(labels):
    jcfg, jp, cfg, p = _models("qwen3-moe-30b-a3b")
    tok = _tokens(21, cfg, 2, 9)
    batch = {"tokens": tok[:, :8], "labels": tok[:, 1:]} if labels else {"tokens": tok}
    total, parts = T.loss_fn(p, cfg, {k: _t(v) for k, v in batch.items()})
    jtotal, jparts = J_LOSS(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(total, jtotal)
    _close(parts["nll"], jparts["nll"])
    _close(parts["moe_aux"], jparts["moe_aux"])


# ------------------------------------------------------------ DecodeServer
def _served(server_cls, params, cfg, n_slots, max_len, requests, n_tokens):
    srv = server_cls(params, cfg, n_slots=n_slots, max_len=max_len)
    for rid in range(requests):
        srv.submit(rid, prompt_token=rid + 1, n_tokens=n_tokens)
    return [(s.rid, s.tokens) for s in srv.run_until_drained()]


@pytest.mark.parametrize("max_len,requests", [(64, 5), (8, 7)])
def test_decode_server_tokens_equal_the_reference(max_len, requests):
    """test_substrates.py's continuous-batching setup (2 slots, 5 requests
    of 3 tokens), and a short cache where the lock-step length reaches
    max_len - 1 and every later sequence ends after one token."""
    jcfg = JT.LMConfig(name="s", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                       d_ff=64, vocab=64, dtype=jnp.float32, remat=False)
    cfg = T.LMConfig(name="s", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                     d_ff=64, vocab=64, dtype=torch.float32, remat=False)
    jp = J_INIT(jax.random.key(0), jcfg)
    got = _served(DecodeServer, lm_params_from_numpy(jp, cfg, device="cpu"), cfg, 2, max_len,
                  requests, 3)
    want = _served(JDecodeServer, jp, jcfg, 2, max_len, requests, 3)
    assert got == want
    assert sorted(rid for rid, _ in got) == list(range(requests))
    if max_len == 64:
        assert all(len(t) == 4 for _, t in got)
    else:
        assert min(len(t) for _, t in got) == 2  # ended after one token


def test_decode_server_never_emits_a_pad_id():
    """minicpm's smoke vocab (257) pads to 384; a head whose pad columns
    dominate still never yields a pad id, since those logits are -inf."""
    cfg = get_config("minicpm-2b").smoke_model
    p = T.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    p.head.data[:, cfg.vocab:] = 1e4
    p.head.data[:, :cfg.vocab] *= 1e-3
    got = _served(DecodeServer, p, cfg, 3, 32, 5, 6)
    assert all(0 <= t < cfg.vocab for _, toks in got for t in toks)
    assert all(len(toks) == 7 for _, toks in got)
