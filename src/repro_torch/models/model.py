"""The decoder models of the port: config, parameters, prefill, decode and
the training forward.

A port of ``repro/models/model.py``.  A model is a stack of ``n_periods``
identical periods; a period is a short sequence of blocks (``block_pattern``:
``attn``, ``mamba`` or ``rwkv``) with a per-position FFN (``ffn_pattern``:
``dense``, ``moe``, ``moe_res`` or ``none``; an RWKV block carries its own
channel mix and takes no FFN).  The dense transformers (qwen3-14b) have the
period ``attn``/``dense``; granite-moe-1b-a400m ``attn``/``moe``; arctic-480b
``attn``/``moe_res`` (a MoE beside a dense FFN); rwkv6-3b ``rwkv``/``none``;
jamba-v0.1-52b eight layers, one attention and seven Mamba blocks, dense and
MoE FFNs in turn.
The JAX package's layouts hold at every public function: weights are
(d_in, d_out) and applied as ``x @ W``; per-layer tensors stay stacked over
the period axis P (``layers.b{i}.wq`` is (P, d, H*dh) for period position
``i``), and a Python loop over periods and positions takes the place of
``lax.scan``.  The decode cache holds, for each position ``i``: attention
``k{i}``/``v{i}`` (P, B, S, KV, dh), the layout
``serving.transfer.paged_view`` pages; Mamba ``ssm{i}`` (P, B, d_inner, 16)
f32 and ``conv{i}`` (P, B, 3, d_inner); RWKV ``wkv{i}`` (P, B, H, 64, 64)
f32 and the shift states ``sa{i}``/``sc{i}`` (P, B, d).  ``pos`` is a
host int, or a (B,) vector of per-slot positions, as JAX's decode takes;
:func:`decode_step` turns it into the one form the decode layers take, each
row's position on the device and the longest as a host int, and runs the
writing step (:func:`decode_body`) or the read-only one
(:func:`readonly_body`) on it.

Weights are stored once in ``compute_dtype``.  JAX keeps f32 parameters and
casts every f32 tensor of more than one dimension to ``compute_dtype`` on
each call (the stacked per-layer norm scales included, since the period axis
makes them 2-D) and gathers the embedding in f32 before the same cast.
Storing those tensors in ``compute_dtype`` gives the same values, and saves
an f32 copy that would not fit one card at qwen3-14b width (59 GB of f32
plus a 30 GB cast copy).  The rule covers every stacked leaf in the same way
(checked against ``_backbone_seq``'s cast): RWKV's ``decay_base``, ``ln_x``,
``ln1``, ``ln2`` (P, d), ``bonus_u`` (P, H, 64), ``mu_base`` (P, 5, d) and
``cm_mu`` (P, 2, d); Mamba's ``conv_b``, ``dt_bias``, ``d_skip`` (P, d_inner)
and ``a_log`` (P, d_inner, 16); the MoE leaves (``layers.f{i}.moe.*``, the
router included).  The blocks up-cast what JAX up-casts, where it is used:
RWKV's ``bonus_u`` and decay exponent, Mamba's ``a_log``, the router.
``out_norm`` is 1-D and stays f32, as in JAX.

A model made to train (``Model(..., train_dtype=...)``) keeps JAX's master
parameters instead, every one in ``train_dtype`` (f32; bf16 for arctic) and
requiring grad; :func:`forward_train` casts them per call as JAX does
(:func:`compute_view`), sums the MoE aux loss, runs RWKV's recurrence on its
plain version and, with ``cfg.remat``, recomputes each period in the
backward pass.  The serving entry points are unchanged by it.

Three options the JAX package's config lacks give the published Jamba block
(``configs/jamba_v01_52b.py::published``); each defaults to JAX's
behaviour, and none is a dataclass field (``common.ConfigOptions``):
``ModelConfig.attn_rope`` False runs attention with no positional encoding,
``ModelConfig.mamba_inner_norms`` True gives each Mamba mixer its dt, B and
C RMSNorms (``ssm.py``), and ``MoEConfig.renormalize`` False keeps the
router's top-k probabilities unnormalised (``moe.py``).

An encoder-decoder (``n_enc_layers`` > 0, seamless-m4t-medium) adds an
encoder of ``n_enc_layers`` periods of bidirectional attention (with RoPE)
and a dense FFN (``enc_layers.b0.*``, ``enc_layers.f0.*``), its final norm
``enc_norm``, and a cross-attention block ``cross_layers.c{i}.*`` (stacked
over the decoder's periods) after the self-attention of each attention
position.  :func:`encode` maps stub frame embeddings to the memory;
:func:`prefill` projects it once to the cross K/V ``ck{i}``/``cv{i}`` (P,
B, S_enc, KV, dh) and keeps it as ``cross_memory``; each decode step
attends to ``ck{i}``/``cv{i}`` whole.  A vision model (``frontend`` "vision",
internvl2-76b) takes ``n_prefix_embeds`` stub patch embeddings in front of
the tokens.  Attention with H % KV != 0 runs the head-expanded paths of
``attention.py``; its decode pads the query heads for K4.
"""

from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import hosttrace
from ..kernels import ref
from ..kernels.build import resolve_device
from .attention import (
    chunked_causal_attention,
    cross_attention,
    kernel_decode_attention,
    seq_sharded_decode_attention,
)
from .common import ConfigOptions, InitSpec, rms_norm, rope_tables, rotate, swiglu
from .moe import MoEConfig, moe_ffn, moe_param_specs, moe_residual_param_specs, moe_with_residual
from .rwkv import (
    HEAD_DIM as RWKV_HEAD_DIM,
    rwkv_channel_mix,
    rwkv_channel_mix_step,
    rwkv_param_specs,
    rwkv_time_mix,
    rwkv_time_mix_step,
)
from .sharding import (
    constrain,
    current_mesh,
    current_rules,
    fsdp_gather,
    local_region,
    merge_dims,
    recompute_contexts,
    split_dim,
)
from .ssm import D_CONV, D_STATE, mamba_decode_step, mamba_forward, mamba_param_specs

BLOCKS = ("attn", "mamba", "rwkv")
FFNS = ("dense", "moe", "moe_res", "none")


@dataclasses.dataclass(frozen=True, eq=False)
class ModelConfig(ConfigOptions):
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = ("attn",)
    ffn_pattern: tuple[str, ...] = ("dense",)
    qk_norm: bool = False
    moe: MoEConfig | None = None
    n_enc_layers: int = 0              # > 0: an encoder-decoder
    frontend: str | None = None        # None, "vision" or "audio" (stubs)
    n_prefix_embeds: int = 0           # vision: stub patch embeddings a sample
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    attn_chunk: int = 1024
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = False                # training: recompute each period in backward
    # options JAX's config lacks (``ConfigOptions``; the module's docstring)
    attn_rope: dataclasses.InitVar[bool] = True
    mamba_inner_norms: dataclasses.InitVar[bool] = False

    OPTIONS = ("attn_rope", "mamba_inner_norms")

    def __post_init__(self, attn_rope, mamba_inner_norms):
        assert len(self.block_pattern) == len(self.ffn_pattern)
        assert self.n_layers % len(self.block_pattern) == 0
        self._keep(bool(attn_rope), bool(mamba_inner_norms))

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return all(b != "attn" for b in self.block_pattern)

    @property
    def n_attn_layers(self) -> int:
        return self.n_periods * sum(1 for b in self.block_pattern if b == "attn")


def _positions(cfg: ModelConfig):
    """(i, block, ffn, has_ffn) for each position of the period; raises on
    a kind JAX does not build."""
    for blk, ffn in zip(cfg.block_pattern, cfg.ffn_pattern):
        if blk not in BLOCKS or ffn not in FFNS:
            raise ValueError(f"{cfg.name}: block {blk!r} / FFN {ffn!r}")
    return [(i, blk, ffn, blk != "rwkv" and ffn != "none")
            for i, (blk, ffn) in enumerate(zip(cfg.block_pattern, cfg.ffn_pattern))]


def _block_specs(cfg: ModelConfig, kind: str) -> dict[str, InitSpec]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kind == "mamba":
        return {"ln": InitSpec((d,), kind="ones"),
                **mamba_param_specs(d, cfg.mamba_inner_norms)}
    if kind == "rwkv":
        return {"ln1": InitSpec((d,), kind="ones"), "ln2": InitSpec((d,), kind="ones"),
                **rwkv_param_specs(d, cfg.d_ff)}
    specs = {"ln": InitSpec((d,), kind="ones"), "wq": InitSpec((d, h * dh)),
             "wk": InitSpec((d, kv * dh)), "wv": InitSpec((d, kv * dh)),
             "wo": InitSpec((h * dh, d))}
    if cfg.qk_norm:
        specs["q_norm"] = InitSpec((dh,), kind="ones")
        specs["k_norm"] = InitSpec((dh,), kind="ones")
    return specs


def _ffn_specs(cfg: ModelConfig, kind: str) -> dict[str, InitSpec]:
    d = cfg.d_model
    if kind == "dense":
        ffn = {"gate": InitSpec((d, cfg.d_ff)), "up": InitSpec((d, cfg.d_ff)),
               "down": InitSpec((cfg.d_ff, d))}
    elif kind == "moe":
        ffn = {f"moe.{k}": s for k, s in moe_param_specs(d, cfg.moe).items()}
    else:
        ffn = {f"moe.{k}": s for k, s in
               moe_residual_param_specs(d, cfg.d_ff, cfg.moe).items()}
    return {"ln": InitSpec((d,), kind="ones"), **ffn}


def _stack(tree: str, period: dict[str, InitSpec], n: int) -> dict[str, InitSpec]:
    """``period``'s specs under ``tree``, each shape prefixed by ``n`` periods."""
    return {f"{tree}.{name}": InitSpec((n, *s.shape), s.scale, s.kind)
            for name, s in period.items()}


def param_specs(cfg: ModelConfig) -> dict[str, InitSpec]:
    """Flat ``name -> InitSpec``; per-layer shapes carry the period axis
    (the encoder's ``enc_layers`` that of its ``n_enc_layers`` periods)."""
    p = cfg.n_periods
    specs = {
        "embed": InitSpec((cfg.vocab_size, cfg.d_model), scale=0.01),
        "out_norm": InitSpec((cfg.d_model,), kind="ones"),
        "lm_head": InitSpec((cfg.d_model, cfg.vocab_size)),
    }
    for i, blk, ffn, has_ffn in _positions(cfg):
        period = {f"b{i}.{k}": s for k, s in _block_specs(cfg, blk).items()}
        if has_ffn:
            period.update({f"f{i}.{k}": s for k, s in _ffn_specs(cfg, ffn).items()})
        specs.update(_stack("layers", period, p))
    if cfg.is_enc_dec:
        enc = {f"b0.{k}": s for k, s in _block_specs(cfg, "attn").items()}
        enc.update({f"f0.{k}": s for k, s in _ffn_specs(cfg, "dense").items()})
        specs.update(_stack("enc_layers", enc, cfg.n_enc_layers))
        specs["enc_norm"] = InitSpec((cfg.d_model,), kind="ones")
        cross = {f"c{i}.{k}": s for i, blk, _, _ in _positions(cfg) if blk == "attn"
                 for k, s in _block_specs(cfg, "attn").items()}
        specs.update(_stack("cross_layers", cross, p))
    return specs


STACKED = ("layers", "enc_layers", "cross_layers")


def storage_dtype(cfg: ModelConfig, spec: InitSpec) -> torch.dtype:
    """compute_dtype for tensors of more than one dimension, f32 otherwise."""
    return cfg.compute_dtype if len(spec.shape) > 1 else torch.float32


def dtype_of(name) -> torch.dtype:
    """A torch dtype from its name ("float32", "bfloat16") or itself."""
    return getattr(torch, name) if isinstance(name, str) else name


class Model(nn.Module):
    """Parameters of one model, named as in the JAX parameter tree
    (``embed``, ``out_norm``, ``lm_head``, ``layers.b{i}.*`` and, for a
    position with an FFN, ``layers.f{i}.*``, the MoE's under
    ``layers.f{i}.moe.*``; an encoder-decoder's ``enc_layers.{b0,f0}.*``,
    ``enc_norm`` and ``cross_layers.c{i}.*``); a subtree is a nested
    ``ParameterDict``.  Allocated uninitialised; fill with
    :func:`init_random_` or ``convert.params_from_jax``.

    ``train_dtype`` (a dtype or its name: ``ArchSpec.train_param_dtype``)
    makes a model to train: every parameter is a master copy in that dtype
    that requires grad, as JAX's parameters are, and :func:`forward_train`
    casts them to ``compute_dtype`` on each call.  Without it the model
    serves, stored as :func:`storage_dtype` says, without grad."""

    def __init__(self, cfg: ModelConfig, *, device=None, train_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.specs = param_specs(cfg)
        trainable = train_dtype is not None
        dev = resolve_device(device)
        for tree in STACKED:
            if any(name.startswith(tree + ".") for name in self.specs):
                setattr(self, tree, nn.ModuleDict())
        for name, spec in self.specs.items():
            dtype = dtype_of(train_dtype) if trainable else storage_dtype(cfg, spec)
            t = nn.Parameter(torch.empty(spec.shape, dtype=dtype, device=dev),
                             requires_grad=trainable)
            parts = name.split(".")
            if len(parts) == 1:
                setattr(self, name, t)
                continue
            node = getattr(self, parts[0])
            for part in parts[1:-1]:
                if part not in node:
                    node[part] = nn.ParameterDict()
                node = node[part]
            node[parts[-1]] = t

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_random_(model: Model, seed: int) -> Model:
    """Draw every parameter from a ``torch.Generator`` seeded with ``seed``
    on the model's device, with the ``InitSpec`` scales (normal tensors are
    drawn in f32 one period slice at a time, then cast)."""
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = dict(model.named_parameters())
    for name, spec in model.specs.items():
        t = params[name]
        if spec.kind == "ones":
            t.fill_(1.0)
        elif spec.kind == "zeros":
            t.zero_()
        else:
            slices = t if name.split(".")[0] in STACKED else (t,)
            for sl in slices:
                sl.copy_(torch.randn(sl.shape, generator=gen, device=dev,
                                     dtype=torch.float32).mul_(spec.scale))
    return model


def make_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None, *,
                      enc_len: int | None = 0) -> dict:
    """Zeroed decode cache and ``pos`` (a host int): for each position ``i``
    of the period, attention ``k{i}``/``v{i}`` (P, B, cache_len, KV, dh)
    and, for an encoder-decoder, the cross K/V ``ck{i}``/``cv{i}`` (P, B,
    enc_len, KV, dh); Mamba ``ssm{i}`` (P, B, d_inner, 16) f32 and
    ``conv{i}`` (P, B, 3, d_inner); RWKV ``wkv{i}`` (P, B, H, 64, 64) f32
    and ``sa{i}``/``sc{i}`` (P, B, d).  Only the attention leaves depend on
    ``cache_len`` and ``enc_len``; the leaves are JAX's.  ``enc_len=None``
    leaves the cross K/V out, as JAX's prefill does without a memory."""
    dev = resolve_device(device)
    p, cd = cfg.n_periods, cfg.compute_dtype

    def zeros(*shape, dtype=cd):
        return torch.zeros((p, batch, *shape), dtype=dtype, device=dev)

    cache = {}
    for i, blk, _, _ in _positions(cfg):
        if blk == "attn":
            cache[f"k{i}"] = zeros(cache_len, cfg.n_kv_heads, cfg.d_head)
            cache[f"v{i}"] = zeros(cache_len, cfg.n_kv_heads, cfg.d_head)
            if cfg.is_enc_dec and enc_len is not None:
                cache[f"ck{i}"] = zeros(enc_len, cfg.n_kv_heads, cfg.d_head)
                cache[f"cv{i}"] = zeros(enc_len, cfg.n_kv_heads, cfg.d_head)
        elif blk == "mamba":
            cache[f"ssm{i}"] = zeros(2 * cfg.d_model, D_STATE, dtype=torch.float32)
            cache[f"conv{i}"] = zeros(D_CONV - 1, 2 * cfg.d_model)
        else:
            h = cfg.d_model // RWKV_HEAD_DIM
            cache[f"wkv{i}"] = zeros(h, RWKV_HEAD_DIM, RWKV_HEAD_DIM, dtype=torch.float32)
            cache[f"sa{i}"] = zeros(cfg.d_model)
            cache[f"sc{i}"] = zeros(cfg.d_model)
    cache["pos"] = 0
    return cache


def state_bytes(cfg: ModelConfig, seq_len: int) -> int:
    """Transferred decode-state bytes for one request (Eq. 1 generalised)."""
    total = 0
    p = cfg.n_periods
    for _, blk, _, _ in _positions(cfg):
        if blk == "attn":
            total += 2 * p * seq_len * cfg.n_kv_heads * cfg.d_head * 2
        elif blk == "mamba":
            total += p * (2 * cfg.d_model * D_STATE * 4 + (D_CONV - 1) * 2 * cfg.d_model * 2)
        else:
            h = cfg.d_model // RWKV_HEAD_DIM
            total += p * (h * RWKV_HEAD_DIM * RWKV_HEAD_DIM * 4 + 2 * cfg.d_model * 2)
    return total


def _slice(node, i: int) -> dict:
    """Period ``i`` of every leaf under ``node`` (a ``ParameterDict`` or a
    dict), nested as the subtrees; under a mesh that shards weights over
    FSDP axes, each gathered over them (``sharding.fsdp_gather``)."""
    return _take(node, i, fsdp_gather())


def _take(node, i: int, gather) -> dict:
    return {k: _take(v, i, gather) if isinstance(v, (nn.ParameterDict, dict))
            else v[i] if gather is None else gather(v[i]) for k, v in node.items()}


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, rope):
    """q, k (RoPE-turned by ``rope``'s (cos, sin), where it is not None)
    and v of the attention block."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = split_dim(xn @ p["wq"], -1, (h, dh))
    k = split_dim(xn @ p["wk"], -1, (kv, dh))
    v = split_dim(xn @ p["wv"], -1, (kv, dh))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is None:
        return q, k, v
    return rotate(q, *rope), rotate(k, *rope), v


def _attn_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, rope, causal: bool):
    """The attention block over a sequence: (its output, k, v)."""
    q, k, v = _qkv(cfg, p, x, rope)
    q = constrain(q, "batch", None, "heads", None)
    att = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal)
    return merge_dims(att, 2) @ p["wo"], k, v


def _cross_q(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The cross block's queries (B, S, H, dh): no RoPE, no q norm."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    return split_dim(xn @ p["wq"], -1, (cfg.n_heads, cfg.d_head))


def _ffn(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor):
    """The position's FFN on the normed x: (out, the MoE aux loss, 0.0 for a
    dense FFN).  Serving drops the aux loss; training sums it."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    if kind == "dense":
        return swiglu(xn, p["gate"], p["up"], p["down"]), 0.0
    return (moe_ffn if kind == "moe" else moe_with_residual)(xn, p["moe"], cfg.moe)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables for the attention blocks; None for an attention-free model
    and for attention without positional encoding (``attn_rope`` False)."""
    if cfg.is_attention_free or not cfg.attn_rope:
        return None
    return rope_tables(positions, cfg.d_head, cfg.rope_theta)


def _mamba_eps(cfg: ModelConfig) -> float | None:
    """The eps of the Mamba mixers' dt/B/C norms; None where they have none."""
    return cfg.norm_eps if cfg.mamba_inner_norms else None


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    gather = fsdp_gather()
    head = model.lm_head if gather is None else gather(model.lm_head)
    return constrain(rms_norm(x, model.out_norm, model.cfg.norm_eps) @ head,
                     "batch", None, "vocab")


def _embed_inputs(model: Model, tokens: torch.Tensor, prefix_embeds) -> torch.Tensor:
    """Token embeddings in ``compute_dtype`` (gathered, then cast, as JAX
    does), behind the stub prefix embeddings (B, n, d) if any."""
    x = model.embed[tokens].to(model.cfg.compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return constrain(x, "batch", None, None)


def _cross_kv(model: Model, memory) -> dict:
    """``{i: (k, v)}`` for each attention position ``i`` of an
    encoder-decoder: the encoder memory (B, S_enc, d) projected once by
    every period's ``cross_layers.c{i}`` to (P, B, S_enc, KV, dh).  Empty
    without a memory or an encoder."""
    cfg = model.cfg
    if not cfg.is_enc_dec or memory is None:
        return {}
    mem = memory.to(cfg.compute_dtype)[None]
    # every period's projection at once, (1, B, S_enc, d) @ (P, 1, d, KV*dh);
    # under a mesh on the local shards: DTensor has no rule for the batched
    # product of a batch-sharded memory with head-sharded weights
    proj = local_region(lambda m, w: m @ w[:, None], ((None, "batch", None, None),
                                                      (None, None, "heads")),
                        ((None, "batch", None, "heads"),))
    heads = (cfg.n_kv_heads, cfg.d_head)
    return {int(name[1:]): (split_dim(proj(mem, p["wk"]), -1, heads),
                            split_dim(proj(mem, p["wv"]), -1, heads))
            for name, p in model.cross_layers.items()}


def _remat_contexts():
    """checkpoint's (forward, recomputation) contexts: the recomputation runs
    inside ``torch.autograd.grad``, where the caller's function modes are
    off, so it enters ``sharding.recompute_under``'s again."""
    return contextlib.nullcontext(), recompute_contexts()


def _backbone(model: Model, x: torch.Tensor, cache: dict | None, cross: dict,
              causal: bool = True, train: bool = False):
    """The period stack over x: (x, the MoE aux loss summed over periods in
    order, as JAX's scan carries it).  ``train`` runs RWKV's recurrence on
    its plain version (the one autograd differentiates) and, with
    ``cfg.remat``, recomputes each period in the backward pass as JAX's
    ``jax.checkpoint(..., nothing_saveable)`` does."""
    rope = _rope(model.cfg, torch.arange(x.shape[1], device=x.device)[None, :])
    aux = 0.0
    for per in range(model.cfg.n_periods):
        if train and model.cfg.remat:
            x, a = checkpoint(_period_seq, model, per, x, cache, rope, cross, causal, train,
                              use_reentrant=False, context_fn=_remat_contexts)
        else:
            x, a = _period_seq(model, per, x, cache, rope, cross, causal, train)
        aux = aux + a
    return x, aux


def _encode(model: Model, frames: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = constrain(frames.to(cfg.compute_dtype), "batch", None, None)
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None, :])
    for per in range(cfg.n_enc_layers):
        x = x + _attn_seq(cfg, _slice(model.enc_layers["b0"], per), x, rope, False)[0]
        x = x + _ffn(cfg, "dense", _slice(model.enc_layers["f0"], per), x)[0]
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


@torch.no_grad()
def encode(model: Model, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over stub frame embeddings (B, T, d): ``n_enc_layers``
    periods of bidirectional attention with RoPE and a dense FFN, then
    ``enc_norm``; returns the memory (B, T, d) in ``compute_dtype``."""
    return _encode(model, frames)


@torch.no_grad()
def forward_logits(model: Model, tokens: torch.Tensor, prefix_embeds=None, memory=None,
                   causal: bool = True) -> torch.Tensor:
    """Logits (B, n_prefix + S, V) of every position; JAX's ``forward_logits``
    without its MoE aux loss (a training term: :func:`forward_logits_aux`)."""
    x = _embed_inputs(model, tokens, prefix_embeds)
    return _logits(model, _backbone(model, x, None, _cross_kv(model, memory), causal)[0])


def compute_view(model: Model) -> SimpleNamespace:
    """The training model's parameters as its forward uses them: every
    tensor of more than one dimension cast to ``compute_dtype`` (JAX casts
    the f32 ones on each call, ``_backbone_seq``'s rule; a bf16 master is
    cast only where compute runs in f32, where JAX promotes it), the
    embedding left whole for its gather, the 1-D norms as stored.  The casts
    are part of the autograd graph, so gradients reach the master copy in
    its own dtype."""
    cd = model.cfg.compute_dtype

    def cast(t):
        return t.to(cd) if t.dim() > 1 else t

    def tree(node):
        return {k: tree(v) if isinstance(v, nn.ParameterDict) else cast(v)
                for k, v in node.items()}

    view = SimpleNamespace(cfg=model.cfg, device=model.device, embed=model.embed,
                           out_norm=model.out_norm, lm_head=cast(model.lm_head))
    for name in STACKED:
        if hasattr(model, name):
            setattr(view, name, tree(getattr(model, name)))
    if model.cfg.is_enc_dec:
        view.enc_norm = model.enc_norm
    return view


def _logits_aux(view: SimpleNamespace, tokens, prefix_embeds, memory, causal: bool):
    x = _embed_inputs(view, tokens, prefix_embeds)
    x, aux = _backbone(view, x, None, _cross_kv(view, memory), causal, train=True)
    return _logits(view, x), aux


def forward_logits_aux(model: Model, tokens: torch.Tensor, prefix_embeds=None, memory=None,
                       causal: bool = True):
    """JAX's ``forward_logits`` for training: (logits (B, n_prefix + S, V)
    in ``compute_dtype``, the MoE aux loss summed over positions and
    periods; 0.0 without a MoE), differentiable, on a model made with
    ``train_dtype``."""
    return _logits_aux(compute_view(model), tokens, prefix_embeds, memory, causal)


def forward_train(model: Model, batch: dict, aux_weight: float = 0.01):
    """Causal-LM (or seq2seq) loss of JAX's ``forward_train``: the mean NLL
    of ``batch["labels"]`` under f32 ``log_softmax`` of the logits, plus
    ``aux_weight`` times the MoE aux loss.  ``batch``: ``tokens``,
    ``labels`` (B, S) and ``frames`` (B, T, d; an encoder-decoder) or
    ``embeds`` (B, n, d; a vision model, whose logits past the prefix
    count).  Returns (loss, {"ce", "aux"})."""
    view = compute_view(model)
    cfg = model.cfg
    memory = _encode(view, batch["frames"]) if cfg.is_enc_dec else None
    prefix = batch.get("embeds") if cfg.frontend == "vision" else None
    logits, aux = _logits_aux(view, batch["tokens"], prefix, memory, True)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    loss = -ll.mean()
    aux_out = aux.detach() if isinstance(aux, torch.Tensor) else torch.zeros((), device=ll.device)
    return loss + aux_weight * aux, {"ce": loss.detach(), "aux": aux_out}


@torch.no_grad()
def prefill(model: Model, tokens: torch.Tensor, prefix_embeds=None, memory=None,
            cache_len: int | None = None, cache: dict | None = None):
    """Run the prompt (B, S), behind ``prefix_embeds`` (B, n, d) if given;
    return (last-token logits (B, 1, V), cache) with ``pos`` n + S.

    The attention K/V leaves are allocated at ``cache_len`` (>= n + S) and
    zero past the prompt, the JAX version's padding, so decode can append in
    place.  Mamba and RWKV leaves hold each layer's final state.  An
    encoder-decoder given its ``memory`` (B, S_enc, d) also caches the cross
    K/V ``ck{i}``/``cv{i}`` and the memory as ``cross_memory``.  ``cache``:
    the leaves of :func:`make_decode_cache` to fill instead of new ones (the
    dry run passes them distributed over its mesh)."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens, prefix_embeds)
    b, s, _ = x.shape
    if cache is None:
        cache = make_decode_cache(cfg, b, cache_len or s, model.device, enc_len=None)
        for name, leaf in cache.items():
            if name[0] in "kv" and leaf.dim() == 5:
                cache[name] = constrain(leaf, None, "batch", "kv_seq", None, None)
    cross = _cross_kv(model, memory)
    for i, (k, v) in cross.items():
        cache[f"ck{i}"], cache[f"cv{i}"] = k, v
    if cross:
        cache["cross_memory"] = memory
    x = _backbone(model, x, cache, cross)[0]
    cache["pos"] = s
    return _logits(model, x[:, -1:]), cache


def _period_seq(model: Model, per: int, x: torch.Tensor, cache: dict | None, rope,
                cross: dict, causal: bool, train: bool = False):
    """Period ``per`` over the sequence: (x, the period's MoE aux loss);
    writes its slice of every cache leaf (none without a cache).  An
    attention position with cross K/V runs the cross block after its
    self-attention.  RWKV's time mix runs its recurrence through
    ``ops.rwkv_scan``, or, to train, through its plain version."""
    cfg = model.cfg
    eps = cfg.norm_eps
    b, s = x.shape[:2]
    aux = 0.0
    tr = hosttrace.RECORDER
    for i, blk, ffn, has_ffn in _positions(cfg):
        p = _slice(model.layers[f"b{i}"], per)
        if blk == "attn":
            out, k, v = _attn_seq(cfg, p, x, rope, causal)
            x = x + out
            if cache is not None:
                cache[f"k{i}"][per, :, :s] = k
                cache[f"v{i}"][per, :, :s] = v
            if i in cross:
                cp = _slice(model.cross_layers[f"c{i}"], per)
                att = cross_attention(_cross_q(cfg, cp, x), cross[i][0][per], cross[i][1][per])
                x = x + merge_dims(att, 2) @ cp["wo"]
        elif blk == "mamba":
            if tr is not None:
                i_mamba = tr.begin(hosttrace.MAMBA, per * len(cfg.block_pattern) + i, b * s)
            out, state = mamba_forward(p, rms_norm(x, p["ln"], eps), _mamba_eps(cfg))
            x = x + out
            if cache is not None:
                cache[f"ssm{i}"][per] = state["ssm"]
                cache[f"conv{i}"][per] = state["conv"]
            if tr is not None:
                tr.end(i_mamba)
        else:
            out, (wkv, last) = rwkv_time_mix(p, rms_norm(x, p["ln1"], eps),
                                             scan=ref.rwkv_scan_ref if train else None)
            x = x + out
            out, last2 = rwkv_channel_mix(p, rms_norm(x, p["ln2"], eps))
            x = x + out
            if cache is not None:
                cache[f"wkv{i}"][per] = wkv
                cache[f"sa{i}"][per] = last
                cache[f"sc{i}"][per] = last2
        if has_ffn:
            out, a = _ffn(cfg, ffn, _slice(model.layers[f"f{i}"], per), x)
            x = x + out
            aux = aux + a
        x = constrain(x, "batch", None, None)
    return x, aux


def decode_body(model: Model, token: torch.Tensor, positions: torch.Tensor, cache: dict,
                longest: int) -> torch.Tensor:
    """The writing decode step from device tensors alone: token (B, 1) and
    each row's position ``positions`` (B,) int64, both on the model's
    device, and ``longest``, a host int at least ``max(positions) + 1``,
    which K4 plans its split over -> logits (B, 1, V).

    On the device it derives the lengths ``positions + 1`` (int32), each
    row's flat index ``b * cache_len + pos`` into a (B * cache_len, ...)
    view of a K/V leaf, and the RoPE tables; then every period and the
    head.  The cache is written in place; ``cache["pos"]`` is left as it
    is.  Nothing is copied from the host or read back, so a CUDA graph can
    capture it (``models/decode_graph.py``)."""
    cfg = model.cfg
    attn = [i for i, blk, _, _ in _positions(cfg) if blk == "attn"]
    cache_len = cache[f"k{attn[0]}"].shape[2] if attn else 1
    lengths = (positions + 1).to(torch.int32)
    flat = torch.arange(positions.shape[0], device=positions.device) * cache_len + positions
    rope = _rope(cfg, positions[:, None])
    x = constrain(F.embedding(token, model.embed), "batch", None, None)
    for per in range(cfg.n_periods):
        x = _period_decode(model, per, x, cache, rope, lengths, longest, flat)
    return _logits(model, x)


def readonly_body(model: Model, token: torch.Tensor, positions: torch.Tensor, cache: dict,
                  longest: int) -> tuple[torch.Tensor, dict]:
    """The read-only decode step over :func:`decode_body`'s inputs, with
    ``longest`` a host int at least ``max(positions)`` -> (logits (B, 1, V),
    the step's new K/V fragments and states by leaf name, each stacked over
    the periods).  Row b attends to its first ``positions[b]`` cache rows
    and to its own token; no tensor of ``cache`` is written."""
    cfg = model.cfg
    lengths = positions.to(torch.int32)
    rope = _rope(cfg, positions[:, None])
    # F.embedding is the same gather as indexing; a vocab-sharded table then
    # stays sharded under a mesh (a masked lookup and a sum of (B, 1, d))
    x = constrain(F.embedding(token, model.embed), "batch", None, None)
    new = {}
    for per in range(cfg.n_periods):
        x = _period_decode(model, per, x, cache, rope, lengths, longest, new)
    return _logits(model, x), {k: torch.stack(v) for k, v in new.items()}


@torch.no_grad()
def decode_step(model: Model, token: torch.Tensor, cache: dict, *, update_cache: bool = True,
                graphs=None):
    """token (B, 1) -> (logits (B, 1, V), cache); ``cache["pos"]`` advances
    by one and keeps its form.

    ``cache["pos"]`` is an int, every row at that position, or, as in
    JAX, a (B,) vector of per-slot positions (a tensor or an array; best
    on the host, so that nothing is read back from the card).  Here, and
    only here, it becomes the one form every layer below takes: each row's
    position, a (B,) int64 vector on the model's device (the host values,
    an int as B equal ones, in one copy), and ``longest``, their
    maximum as a host int.  ``token`` may lie on the host; it is copied to
    the model's device.

    The cache is updated in place (JAX returns an updated copy; writing in
    place saves a cache copy per layer): :func:`decode_body`.  Attention:
    each row's new K/V lands at its position and attention runs through
    ``attention.kernel_decode_attention`` (K4) over each row's first pos+1
    entries (per-row lengths); RoPE turns each row by its position.  An
    encoder-decoder's cross block then attends, through K4 too, to the
    whole ``ck{i}``/``cv{i}`` (pos = S_enc for every row).  Mamba and RWKV:
    each layer's states are overwritten by the step's (plain PyTorch, as in
    JAX).

    ``graphs``, a ``decode_graph.DecodeGraphs`` over this ``cache``, runs
    the step as a CUDA graph where its rule takes the input
    (``decode_graph.eager_reason``): :func:`decode_body` with every row at
    the scalar ``pos``, K4 planned over the top of ``pos + 1``'s bucket.
    The logits are then the runner's buffer, rewritten by its next step.
    Elsewhere the step runs eagerly, as without it.

    ``update_cache=False`` is JAX's read-only (paged) decode,
    :func:`readonly_body`: no tensor of ``cache`` is written.  Row b of
    each attention layer attends to its first ``pos[b]`` cache rows and to
    the current token as a self term in the same softmax (K4 with those
    lengths and ``k_new``/``v_new``; under a mesh whose rules shard
    ``kv_seq``, the sequence-sharded partials and merge).  Returns a new
    dict with JAX's keys: ``kf{i}``/``vf{i}`` (P, B, 1, KV, dh), the
    token's K/V after RoPE, for the caller to land; the new ``ssm``/
    ``conv``/``wkv``/``sa``/``sc`` states as new tensors; ``ck``/``cv`` and
    ``cross_memory`` passed through; ``pos + 1``."""
    pos = cache["pos"]
    logits = None if graphs is None else graphs.run(token, cache, update_cache)
    if logits is not None:
        cache["pos"] = int(pos) + 1
        return logits, cache
    if token.device != model.device:
        token = token.to(model.device)
    host = torch.as_tensor(pos).to("cpu", torch.int64).expand(token.shape[0]).contiguous()
    positions, longest = host.to(model.device), int(host.max())
    if update_cache:
        logits = decode_body(model, token, positions, cache, longest + 1)
        cache["pos"] = pos + 1
        return logits, cache
    logits, out = readonly_body(model, token, positions, cache, longest)
    out.update({k: v for k, v in cache.items() if k.startswith(("ck", "cv"))})
    if "cross_memory" in cache:
        out["cross_memory"] = cache["cross_memory"]
    out["pos"] = pos + 1
    return logits, out


def _seq_sharding(cfg: ModelConfig) -> dict | None:
    """The sequence-sharded decode's mesh arguments under a mesh whose rules
    shard ``kv_seq`` (and H % KV == 0, as JAX picks); None otherwise."""
    rules = current_rules() or {}
    mesh = current_mesh()
    seq_axes = tuple(rules.get("kv_seq", ()))
    if mesh is None or not seq_axes or cfg.n_heads % cfg.n_kv_heads:
        return None
    return {"mesh": mesh, "batch_axes": tuple(rules.get("batch", ())), "seq_axes": seq_axes}


def _readonly_attention(cfg: ModelConfig, q, k, v, k_cache, v_cache, lengths, longest):
    """The read-only decode's attention of q (B, 1, H, dh) over each row's
    first ``lengths[b]`` cache rows, with the self term k/v (B, 1, KV, dh):
    sequence-sharded under :func:`_seq_sharding`, else K4."""
    sharding = _seq_sharding(cfg)
    if sharding is not None:
        return seq_sharded_decode_attention(q, k_cache, v_cache, lengths, longest, k, v,
                                            **sharding)[:, 0]
    return kernel_decode_attention(q[:, 0].contiguous(), k_cache, v_cache, longest, lengths,
                                   k_new=k[:, 0].contiguous(), v_new=v[:, 0].contiguous())


def _period_decode(model: Model, per: int, x: torch.Tensor, cache: dict, rope,
                   lengths: torch.Tensor, longest: int, into) -> torch.Tensor:
    """Period ``per`` of a decode step: attention reads row b's first
    ``lengths[b]`` cache rows, K4 planned over ``longest``.  ``into`` is
    where the step's new K/V and states go.  A (B,) tensor, each row's flat
    index into a (B * cache_len, ...) view of the K/V leaves, writes the
    cache in place, the K/V before attention reads it (:func:`decode_body`).
    A dict of lists makes the step read-only (:func:`readonly_body`): the
    token's K/V joins attention as a self term, and the fragments and
    states are appended there by leaf name."""
    cfg = model.cfg
    eps = cfg.norm_eps
    b = x.shape[0]
    readonly = isinstance(into, dict)

    def keep(name, t, inplace):
        if readonly:
            into.setdefault(name, []).append(t)
        else:
            inplace.copy_(t)

    tr = hosttrace.RECORDER
    for i, blk, ffn, has_ffn in _positions(cfg):
        if tr is not None and blk == "attn":
            i_attn = tr.begin(hosttrace.ATTN, per * len(cfg.block_pattern) + i)
        p = _slice(model.layers[f"b{i}"], per)
        if blk == "attn":
            q, k, v = _qkv(cfg, p, x, rope)
            k_cache, v_cache = cache[f"k{i}"][per], cache[f"v{i}"][per]
            if readonly:
                att = _readonly_attention(cfg, q, k, v, k_cache, v_cache, lengths, longest)
                keep(f"kf{i}", k, None)
                keep(f"vf{i}", v, None)
            else:
                for c, kv_new in ((k_cache, k), (v_cache, v)):
                    c.view(-1, *c.shape[2:]).index_copy_(0, into, kv_new[:, 0].to(c.dtype))
                att = kernel_decode_attention(q[:, 0].contiguous(), k_cache, v_cache, longest,
                                              lengths)
            x = x + att.reshape(b, 1, -1) @ p["wo"]
            if cfg.is_enc_dec:
                cp = _slice(model.cross_layers[f"c{i}"], per)
                ck, cv = cache[f"ck{i}"][per], cache[f"cv{i}"][per]
                cq, sharding = _cross_q(cfg, cp, x), _seq_sharding(cfg)
                if sharding is None:
                    att = kernel_decode_attention(cq[:, 0].contiguous(), ck, cv, ck.shape[1])
                else:   # the cross cache is cut along S_enc as the self cache is
                    att = seq_sharded_decode_attention(cq, ck, cv,
                                                       torch.full_like(lengths, ck.shape[1]),
                                                       ck.shape[1], **sharding)[:, 0]
                x = x + att.reshape(b, 1, -1) @ cp["wo"]
            if tr is not None:
                tr.end(i_attn)
        elif blk == "mamba":
            if tr is not None:
                i_mamba = tr.begin(hosttrace.MAMBA, per * len(cfg.block_pattern) + i, b)
            ssm, conv = cache[f"ssm{i}"][per], cache[f"conv{i}"][per]
            out, state = mamba_decode_step(p, rms_norm(x, p["ln"], eps),
                                           {"ssm": ssm, "conv": conv}, _mamba_eps(cfg))
            x = x + out
            keep(f"ssm{i}", state["ssm"], ssm)
            keep(f"conv{i}", state["conv"], conv)
            if tr is not None:
                tr.end(i_mamba)
        else:
            wkv, sa, sc = cache[f"wkv{i}"][per], cache[f"sa{i}"][per], cache[f"sc{i}"][per]
            out, new_wkv, last = rwkv_time_mix_step(p, rms_norm(x, p["ln1"], eps), wkv, sa)
            x = x + out
            out, last2 = rwkv_channel_mix_step(p, rms_norm(x, p["ln2"], eps), sc)
            x = x + out
            keep(f"wkv{i}", new_wkv, wkv)
            keep(f"sa{i}", last, sa)
            keep(f"sc{i}", last2, sc)
        if has_ffn:
            if tr is not None:
                i_ffn = tr.begin(hosttrace.FFN, per * len(cfg.block_pattern) + i,
                                 int(ffn != "dense"))
            x = x + _ffn(cfg, ffn, _slice(model.layers[f"f{i}"], per), x)[0]
            if tr is not None:
                tr.end(i_ffn)
    return x
