"""Synthetic, seeded, step-indexed data (``repro/train/data.py``).

Every batch is a pure function of (seed, step), so a restart from the
checkpoint of step N reproduces the rest of the stream: the property that
makes a restart bitwise reproducible.  The NumPy stream is the JAX
package's draw for draw, so the tokens, labels, frames and embeddings are
its bit for bit; frames and embeddings are rounded to bf16 through f32, as
``jnp.asarray(x, jnp.bfloat16)`` rounds a float64 array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.build import resolve_device
from ..models.model import ModelConfig


def synth_batch(cfg: ModelConfig, *, global_batch: int, seq_len: int, seed: int,
                step: int, device=None) -> dict:
    """Markov-ish token stream, t[i+1] = (31 t[i] + noise) % V over an
    alphabet of min(V, 256), so small models learn it in a few hundred
    steps.  ``tokens``/``labels`` (B, S) int32 (S less the prefix for a
    vision model, the last column zero padding), plus ``frames`` (B, S, d)
    bf16 for an encoder-decoder or ``embeds`` (B, n_prefix, d) bf16 for a
    vision model, on ``device`` (the card unless it says otherwise)."""
    dev = resolve_device(device)
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    b = global_batch
    s_tok = seq_len - cfg.n_prefix_embeds if cfg.frontend == "vision" else seq_len
    v = min(cfg.vocab_size, 256)
    a = 31
    t0 = rng.integers(0, v, size=(b, 1))
    noise = rng.integers(0, 3, size=(b, s_tok))
    toks = np.empty((b, s_tok), np.int64)
    toks[:, 0] = t0[:, 0]
    for i in range(1, s_tok):
        toks[:, i] = (a * toks[:, i - 1] + noise[:, i]) % v
    pad = np.zeros((b, 1), np.int32)
    batch = {"tokens": np.concatenate([toks[:, :-1].astype(np.int32), pad], axis=1),
             "labels": np.concatenate([toks[:, 1:].astype(np.int32), pad], axis=1)}
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    if cfg.is_enc_dec:
        batch["frames"] = _bf16(rng.standard_normal((b, seq_len, cfg.d_model)), dev)
    elif cfg.frontend == "vision":
        batch["embeds"] = _bf16(rng.standard_normal((b, cfg.n_prefix_embeds, cfg.d_model)), dev)
    return batch


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
