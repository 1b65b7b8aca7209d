"""The weights of a run, drawn on the device from ``--seed``.

One ``normal_`` call a tensor, in the type it is served in (bf16; the final
norm scale in f32), from one ``torch.Generator`` on the device, in the order
and with the moments the layer stack's ``weight_specs`` gives (``nkb.stacks``;
a tied output head is not drawn, ``lm_head`` is the embedding's transpose).
Names and stacked layouts are the program's parameter tree (``layers.b0.wq`` is
(layers, d, H*dh), weights applied as ``x @ W``), so the program's model can
hold these tensors without a copy; the reference reads the same tensors.
Scales keep each projection's output at the scale of its input (std
1/sqrt(fan_in)); norm scales are 1 + N(0, 0.1^2); the embedding's std is
1/sqrt(d), so that a tied output head gives logits of unit scale too.
Attention scores then have a std of ~1, and attention averages its
context: greedy decoding may settle into repeating a token, where the
served tokens' margins are wide and any precision picks them; the check
therefore compares the logits themselves too (``nkb.correct``).  Sharper
scores (query and key std 2/sqrt(d)) end the repeats but make the deep
random model chaotic: bf16 rounding then moves a granite-moe model's
logits (24 layers, on the CPU) past its margins at 93% of the positions,
as far as fp8 does (97%), and no limit separates the two.
"""

from __future__ import annotations

import torch

from . import stacks


@torch.no_grad()
def draw(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    w = {}
    for name, shape, dtype, mean, std in stacks.of(cfg).weight_specs(cfg):
        t = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
        w[name] = t.normal_(mean, std, generator=gen)
    if cfg.get("tie_word_embeddings"):
        w["lm_head"] = w["embed"].t()
    return w

