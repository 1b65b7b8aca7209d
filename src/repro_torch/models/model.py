"""The decoder models of the port: config, parameters, prefill and decode.

A port of four periods of ``repro/models/model.py``: the dense transformer
(``attn``/``dense``, qwen3-14b), attention with a MoE FFN (``attn``/``moe``,
granite-moe-1b-a400m; ``attn``/``moe_res``, arctic-480b, with a parallel
dense FFN) and RWKV-6 (``rwkv``/``none``, rwkv6-3b).
The JAX package's layouts hold at every public function: weights are
(d_in, d_out) and applied as ``x @ W``; per-layer tensors stay stacked over
the period axis P (``layers.b0.wq`` is (P, d, H*dh)), and a Python loop over
layers takes the place of ``lax.scan``; attention caches are (P, B, S, KV,
dh), the layout ``serving.transfer.paged_view`` pages, and the RWKV state
is ``wkv0`` (P, B, H, 64, 64) f32 with the shift states ``sa0``/``sc0``
(P, B, d).

Weights are stored once in ``compute_dtype``.  JAX keeps f32 parameters and
casts every f32 tensor of more than one dimension to ``compute_dtype`` on
each call (the stacked per-layer norm scales included, since the period axis
makes them 2-D) and gathers the embedding in f32 before the same cast.
Storing those tensors in ``compute_dtype`` gives the same values, and saves
an f32 copy that would not fit one card at qwen3-14b width (59 GB of f32
plus a 30 GB cast copy).  The rule covers RWKV's small stacked leaves in
the same way (checked against ``_backbone_seq``'s cast): ``decay_base``,
``ln_x``, ``ln1``, ``ln2`` (P, d), ``bonus_u`` (P, H, 64), ``mu_base``
(P, 5, d) and ``cm_mu`` (P, 2, d) reach the JAX blocks in
``compute_dtype``, and the blocks upcast ``bonus_u`` and the decay
exponent to f32 themselves.  The MoE leaves (``layers.f0.moe.*``, the
router included) are stacked over P too, so they are stored in
``compute_dtype``, and the router is up-cast to f32 where it is used, as in
JAX.  ``out_norm`` is 1-D and stays f32, as in JAX.

Other block kinds (Mamba, cross-attention) are not ported yet (ROADMAP §1,
other architectures) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..kernels import ops
from ..kernels.build import resolve_device
from .attention import chunked_causal_attention
from .common import InitSpec, rms_norm, rope_tables, rotate, swiglu
from .moe import MoEConfig, moe_ffn, moe_param_specs, moe_residual_param_specs, moe_with_residual
from .rwkv import (
    HEAD_DIM as RWKV_HEAD_DIM,
    rwkv_channel_mix,
    rwkv_channel_mix_step,
    rwkv_param_specs,
    rwkv_time_mix,
    rwkv_time_mix_step,
)

# The ported periods: (block_pattern, ffn_pattern).
PORTED = {(("attn",), ("dense",)): "dense", (("attn",), ("moe",)): "moe",
          (("attn",), ("moe_res",)): "moe_res", (("rwkv",), ("none",)): "rwkv"}
NOT_PORTED = ("only the attn/dense, attn/moe, attn/moe_res and rwkv/none periods are "
              "ported; other block kinds are queued in ROADMAP §1 (other architectures)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
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
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    attn_chunk: int = 1024
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.block_pattern) == len(self.ffn_pattern)
        assert self.n_layers % len(self.block_pattern) == 0

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(b != "attn" for b in self.block_pattern)

    @property
    def n_attn_layers(self) -> int:
        return self.n_periods * sum(1 for b in self.block_pattern if b == "attn")


def period_kind(cfg: ModelConfig) -> str:
    """``"dense"``, ``"moe"``, ``"moe_res"`` or ``"rwkv"``; raises on every
    period not ported."""
    kind = PORTED.get((tuple(cfg.block_pattern), tuple(cfg.ffn_pattern)))
    if kind is None:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")
    return kind


def param_specs(cfg: ModelConfig) -> dict[str, InitSpec]:
    """Flat ``name -> InitSpec``; per-layer shapes carry the period axis."""
    kind = period_kind(cfg)
    d, h, kv, dh, p = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_periods
    specs = {
        "embed": InitSpec((cfg.vocab_size, d), scale=0.01),
        "out_norm": InitSpec((d,), kind="ones"),
        "lm_head": InitSpec((d, cfg.vocab_size)),
    }
    if kind == "rwkv":
        block = {"ln1": InitSpec((d,), kind="ones"), "ln2": InitSpec((d,), kind="ones"),
                 **rwkv_param_specs(d, cfg.d_ff)}
        specs.update({f"layers.b0.{name}": InitSpec((p, *s.shape), s.scale, s.kind)
                      for name, s in block.items()})
        return specs
    specs.update({
        "layers.b0.ln": InitSpec((p, d), kind="ones"),
        "layers.b0.wq": InitSpec((p, d, h * dh)),
        "layers.b0.wk": InitSpec((p, d, kv * dh)),
        "layers.b0.wv": InitSpec((p, d, kv * dh)),
        "layers.b0.wo": InitSpec((p, h * dh, d)),
    })
    if cfg.qk_norm:
        specs["layers.b0.q_norm"] = InitSpec((p, dh), kind="ones")
        specs["layers.b0.k_norm"] = InitSpec((p, dh), kind="ones")
    if kind == "dense":
        ffn = {"gate": InitSpec((d, cfg.d_ff)), "up": InitSpec((d, cfg.d_ff)),
               "down": InitSpec((cfg.d_ff, d))}
    elif kind == "moe":
        ffn = {f"moe.{k}": s for k, s in moe_param_specs(d, cfg.moe).items()}
    else:
        ffn = {f"moe.{k}": s for k, s in
               moe_residual_param_specs(d, cfg.d_ff, cfg.moe).items()}
    specs["layers.f0.ln"] = InitSpec((p, d), kind="ones")
    specs.update({f"layers.f0.{name}": InitSpec((p, *s.shape), s.scale, s.kind)
                  for name, s in ffn.items()})
    return specs


def storage_dtype(cfg: ModelConfig, spec: InitSpec) -> torch.dtype:
    """compute_dtype for tensors of more than one dimension, f32 otherwise."""
    return cfg.compute_dtype if len(spec.shape) > 1 else torch.float32


class Model(nn.Module):
    """Parameters of one model, named as in the JAX parameter tree
    (``embed``, ``out_norm``, ``lm_head``, ``layers.b0.*`` and, for the
    dense and MoE periods, ``layers.f0.*``, the MoE's under
    ``layers.f0.moe.*``); a subtree is a nested ``ParameterDict``.
    Allocated uninitialised; fill with :func:`init_random_` or
    ``convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.specs = param_specs(cfg)
        self.layers = nn.ModuleDict()
        for name, spec in self.specs.items():
            t = nn.Parameter(torch.empty(spec.shape, dtype=storage_dtype(cfg, spec),
                                         device=dev), requires_grad=False)
            parts = name.split(".")
            if len(parts) == 1:
                setattr(self, name, t)
                continue
            node = self.layers
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
            slices = t if name.startswith("layers.") else (t,)
            for sl in slices:
                sl.copy_(torch.randn(sl.shape, generator=gen, device=dev,
                                     dtype=torch.float32).mul_(spec.scale))
    return model


def make_decode_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """Zeroed decode cache and ``pos`` (a host int).  Dense and MoE: ``k0``/``v0``
    (P, B, cache_len, KV, dh).  RWKV: ``wkv0`` (P, B, H, 64, 64) f32 and
    ``sa0``/``sc0`` (P, B, d), whatever ``cache_len``."""
    dev = resolve_device(device)
    p, cd = cfg.n_periods, cfg.compute_dtype
    if period_kind(cfg) == "rwkv":
        h = cfg.d_model // RWKV_HEAD_DIM
        return {"wkv0": torch.zeros((p, batch, h, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                                    dtype=torch.float32, device=dev),
                "sa0": torch.zeros((p, batch, cfg.d_model), dtype=cd, device=dev),
                "sc0": torch.zeros((p, batch, cfg.d_model), dtype=cd, device=dev),
                "pos": 0}
    shape = (p, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    return {"k0": torch.zeros(shape, dtype=cd, device=dev),
            "v0": torch.zeros(shape, dtype=cd, device=dev),
            "pos": 0}


def state_bytes(cfg: ModelConfig, seq_len: int) -> int:
    """Transferred decode-state bytes for one request (Eq. 1 generalised)."""
    p = cfg.n_periods
    if period_kind(cfg) == "rwkv":
        h = cfg.d_model // RWKV_HEAD_DIM
        return p * (h * RWKV_HEAD_DIM * RWKV_HEAD_DIM * 4 + 2 * cfg.d_model * 2)
    return 2 * p * seq_len * cfg.n_kv_heads * cfg.d_head * 2


def _layer(model: Model, i: int, block: str) -> dict:
    return _slice(model.layers[block], i)


def _slice(node: nn.ParameterDict, i: int) -> dict:
    """Period ``i`` of every leaf under ``node``, nested as the subtrees."""
    return {k: _slice(v, i) if isinstance(v, nn.ParameterDict) else v[i]
            for k, v in node.items()}


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (xn @ p["wq"]).reshape(b, s, h, dh)
    k = (xn @ p["wk"]).reshape(b, s, kv, dh)
    v = (xn @ p["wv"]).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The period's FFN on the normed x; serving drops the MoE aux loss."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    kind = period_kind(cfg)
    if kind == "dense":
        return swiglu(xn, p["gate"], p["up"], p["down"])
    return (moe_ffn if kind == "moe" else moe_with_residual)(xn, p["moe"], cfg.moe)[0]


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, model.out_norm, model.cfg.norm_eps) @ model.lm_head


@torch.no_grad()
def prefill(model: Model, tokens: torch.Tensor, cache_len: int | None = None):
    """Run the prompt (B, S); return (last-token logits (B, 1, V), cache).

    Dense and MoE: the K/V leaves are allocated at ``cache_len`` (>= S) and zero
    past the prompt, the JAX version's padding, so decode can append in
    place.  RWKV: each layer's final WKV state and last shift inputs."""
    cfg = model.cfg
    b, s = tokens.shape
    cache = make_decode_cache(cfg, b, cache_len or s, model.device)
    x = model.embed[tokens]
    if period_kind(cfg) == "rwkv":
        x = _prefill_rwkv(model, x, cache)
    else:
        x = _prefill_dense(model, x, cache)
    cache["pos"] = s
    return _logits(model, x[:, -1:]), cache


def _prefill_dense(model: Model, x: torch.Tensor, cache: dict) -> torch.Tensor:
    cfg = model.cfg
    b, s, _ = x.shape
    cos, sin = rope_tables(torch.arange(s, device=model.device)[None, :],
                           cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_periods):
        pa, pf = _layer(model, i, "b0"), _layer(model, i, "f0")
        q, k, v = _qkv(cfg, pa, x, cos, sin)
        att = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk)
        x = x + att.reshape(b, s, -1) @ pa["wo"]
        cache["k0"][i, :, :s] = k
        cache["v0"][i, :, :s] = v
        x = x + _ffn(cfg, pf, x)
    return x


def _prefill_rwkv(model: Model, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """The time mix's recurrence runs through ``ops.rwkv_scan``."""
    eps = model.cfg.norm_eps
    for i in range(model.cfg.n_periods):
        p = _layer(model, i, "b0")
        out, (wkv, last) = rwkv_time_mix(p, rms_norm(x, p["ln1"], eps))
        x = x + out
        out, last2 = rwkv_channel_mix(p, rms_norm(x, p["ln2"], eps))
        x = x + out
        cache["wkv0"][i] = wkv
        cache["sa0"][i] = last
        cache["sc0"][i] = last2
    return x


@torch.no_grad()
def decode_step(model: Model, token: torch.Tensor, cache: dict):
    """token (B, 1) -> (logits (B, 1, V), cache); ``cache["pos"]`` advances
    by one.

    The cache is updated in place (JAX returns an updated copy; writing in
    place saves a cache copy per layer).  Dense and MoE: the new K/V rows land at
    the scalar ``pos`` and attention runs through ``ops.flash_decode`` over
    the first pos+1 entries.  RWKV: each layer's WKV and shift states are
    overwritten by the step's (plain PyTorch, as in JAX)."""
    cfg = model.cfg
    x = model.embed[token]
    if period_kind(cfg) == "rwkv":
        x = _decode_rwkv(model, x, cache)
    else:
        x = _decode_dense(model, x, cache)
    cache["pos"] = int(cache["pos"]) + 1
    return _logits(model, x), cache


def _decode_dense(model: Model, x: torch.Tensor, cache: dict) -> torch.Tensor:
    cfg = model.cfg
    pos = int(cache["pos"])
    b = x.shape[0]
    cos, sin = rope_tables(torch.full((1, 1), pos, device=model.device),
                           cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_periods):
        pa, pf = _layer(model, i, "b0"), _layer(model, i, "f0")
        q, k, v = _qkv(cfg, pa, x, cos, sin)
        k_cache, v_cache = cache["k0"][i], cache["v0"][i]
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        att = ops.flash_decode(q[:, 0].contiguous(), k_cache, v_cache, pos + 1)
        x = x + att.reshape(b, 1, -1) @ pa["wo"]
        x = x + _ffn(cfg, pf, x)
    return x


def _decode_rwkv(model: Model, x: torch.Tensor, cache: dict) -> torch.Tensor:
    eps = model.cfg.norm_eps
    for i in range(model.cfg.n_periods):
        p = _layer(model, i, "b0")
        wkv, sa, sc = cache["wkv0"][i], cache["sa0"][i], cache["sc0"][i]
        out, new_wkv, last = rwkv_time_mix_step(p, rms_norm(x, p["ln1"], eps), wkv, sa)
        x = x + out
        out, last2 = rwkv_channel_mix_step(p, rms_norm(x, p["ln2"], eps), sc)
        x = x + out
        wkv.copy_(new_wkv)
        sa.copy_(last)
        sc.copy_(last2)
    return x
