"""The dense decoder of the port: config, parameters, prefill and decode.

A port of the ``attn``/``dense`` period of ``repro/models/model.py``.  The
JAX package's layouts hold at every public function: weights are
(d_in, d_out) and applied as ``x @ W``; per-layer tensors stay stacked over
the period axis P (``layers.b0.wq`` is (P, d, H*dh)), and a Python loop over
layers takes the place of ``lax.scan``; caches are (P, B, S, KV, dh), the
layout ``serving.transfer.paged_view`` pages.

Weights are stored once in ``compute_dtype``.  JAX keeps f32 parameters and
casts every f32 tensor of more than one dimension to ``compute_dtype`` on
each call (the stacked per-layer norm scales included, since the period axis
makes them 2-D) and gathers the embedding in f32 before the same cast.
Storing those tensors in ``compute_dtype`` gives the same values, and saves
an f32 copy that would not fit one card at qwen3-14b width (59 GB of f32
plus a 30 GB cast copy).  ``out_norm`` is 1-D and stays f32, as in JAX.

Other block kinds (MoE, Mamba, RWKV, cross-attention) are not ported yet
(ROADMAP §1, other architectures) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..kernels import ops
from ..kernels.build import resolve_device
from .attention import chunked_causal_attention
from .common import InitSpec, rms_norm, rope_tables, rotate, swiglu

NOT_PORTED = ("only the dense attn/dense block is ported; other block kinds "
              "are queued in ROADMAP §1 (other architectures)")


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


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.block_pattern != ("attn",) or cfg.ffn_pattern != ("dense",):
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")


def param_specs(cfg: ModelConfig) -> dict[str, InitSpec]:
    """Flat ``name -> InitSpec``; per-layer shapes carry the period axis."""
    _check_dense(cfg)
    d, h, kv, dh, p = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_periods
    specs = {
        "embed": InitSpec((cfg.vocab_size, d), scale=0.01),
        "out_norm": InitSpec((d,), kind="ones"),
        "lm_head": InitSpec((d, cfg.vocab_size)),
        "layers.b0.ln": InitSpec((p, d), kind="ones"),
        "layers.b0.wq": InitSpec((p, d, h * dh)),
        "layers.b0.wk": InitSpec((p, d, kv * dh)),
        "layers.b0.wv": InitSpec((p, d, kv * dh)),
        "layers.b0.wo": InitSpec((p, h * dh, d)),
    }
    if cfg.qk_norm:
        specs["layers.b0.q_norm"] = InitSpec((p, dh), kind="ones")
        specs["layers.b0.k_norm"] = InitSpec((p, dh), kind="ones")
    specs.update({
        "layers.f0.ln": InitSpec((p, d), kind="ones"),
        "layers.f0.gate": InitSpec((p, d, cfg.d_ff)),
        "layers.f0.up": InitSpec((p, d, cfg.d_ff)),
        "layers.f0.down": InitSpec((p, cfg.d_ff, d)),
    })
    return specs


def storage_dtype(cfg: ModelConfig, spec: InitSpec) -> torch.dtype:
    """compute_dtype for tensors of more than one dimension, f32 otherwise."""
    return cfg.compute_dtype if len(spec.shape) > 1 else torch.float32


class Model(nn.Module):
    """Parameters of one dense model, named as in the JAX parameter tree
    (``embed``, ``out_norm``, ``lm_head``, ``layers.b0.*``, ``layers.f0.*``).
    Allocated uninitialised; fill with :func:`init_random_` or
    ``convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.specs = param_specs(cfg)
        self.layers = nn.ModuleDict({"b0": nn.ParameterDict(), "f0": nn.ParameterDict()})
        for name, spec in self.specs.items():
            t = nn.Parameter(torch.empty(spec.shape, dtype=storage_dtype(cfg, spec),
                                         device=dev), requires_grad=False)
            parts = name.split(".")
            if len(parts) == 1:
                setattr(self, name, t)
            else:
                self.layers[parts[1]][parts[2]] = t

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
    """Zeroed decode cache: ``k0``/``v0`` (P, B, cache_len, KV, dh) and
    ``pos`` (a host int)."""
    _check_dense(cfg)
    shape = (cfg.n_periods, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k0": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v0": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "pos": 0}


def state_bytes(cfg: ModelConfig, seq_len: int) -> int:
    """Transferred decode-state bytes for one request (Eq. 1 generalised)."""
    _check_dense(cfg)
    return 2 * cfg.n_periods * seq_len * cfg.n_kv_heads * cfg.d_head * 2


def _layer(model: Model, i: int) -> tuple[dict, dict]:
    b0 = {k: v[i] for k, v in model.layers["b0"].items()}
    f0 = {k: v[i] for k, v in model.layers["f0"].items()}
    return b0, f0


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
    return swiglu(rms_norm(x, p["ln"], cfg.norm_eps), p["gate"], p["up"], p["down"])


def _logits(model: Model, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, model.out_norm, model.cfg.norm_eps) @ model.lm_head


@torch.no_grad()
def prefill(model: Model, tokens: torch.Tensor, cache_len: int | None = None):
    """Run the prompt (B, S); return (last-token logits (B, 1, V), cache).

    The K/V leaves are allocated at ``cache_len`` (>= S) and zero past the
    prompt, the JAX version's padding, so decode can append in place."""
    cfg = model.cfg
    b, s = tokens.shape
    cache = make_decode_cache(cfg, b, cache_len or s, model.device)
    x = model.embed[tokens]
    cos, sin = rope_tables(torch.arange(s, device=model.device)[None, :],
                           cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_periods):
        pa, pf = _layer(model, i)
        q, k, v = _qkv(cfg, pa, x, cos, sin)
        att = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk)
        x = x + att.reshape(b, s, -1) @ pa["wo"]
        cache["k0"][i, :, :s] = k
        cache["v0"][i, :, :s] = v
        x = x + _ffn(cfg, pf, x)
    cache["pos"] = s
    return _logits(model, x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Model, token: torch.Tensor, cache: dict):
    """token (B, 1) -> (logits (B, 1, V), cache) at the scalar ``cache["pos"]``.

    The new K/V rows are written into the cache at ``pos`` in place (JAX
    returns an updated copy; writing in place saves a cache copy per layer)
    and ``cache["pos"]`` advances by one.  Attention runs through
    ``ops.flash_decode`` over the first pos+1 entries."""
    cfg = model.cfg
    pos = int(cache["pos"])
    b = token.shape[0]
    x = model.embed[token]
    cos, sin = rope_tables(torch.full((1, 1), pos, device=model.device),
                           cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_periods):
        pa, pf = _layer(model, i)
        q, k, v = _qkv(cfg, pa, x, cos, sin)
        k_cache, v_cache = cache["k0"][i], cache["v0"][i]
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        att = ops.flash_decode(q[:, 0].contiguous(), k_cache, v_cache, pos + 1)
        x = x + att.reshape(b, 1, -1) @ pa["wo"]
        x = x + _ffn(cfg, pf, x)
    cache["pos"] = pos + 1
    return _logits(model, x), cache
