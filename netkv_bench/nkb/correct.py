"""What decides ``correct``: the served tokens against the float32
reference, every decision against the frozen Eq. (2)-(7), every transfer
against the pages and bytes its request needs.

The numbers compared, each with its limit (the configuration file's
``limits``; exact comparisons have the limit 0):

* ``logit_gap``: over a sample of the finished requests drawn from the
  seed, with the longest in it, the widest gap by which a served token's
  reference logit lies below the reference's best at that position.  The
  reference (the configuration's layer stack's, ``nkb.stacks``) runs once
  over each prompt followed by its served tokens (prefill's first token,
  then every decode step's, through the landed cache).  The sample stops
  at ``SAMPLE_TOKENS`` served tokens, ``SAMPLE_MAX`` requests or
  ``SAMPLE_POSITIONS`` positions, whichever comes first.
* ``logit_rel_err``: over the same positions, the widest relative error of
  the logits the program picked each served token from: the root mean
  square over the vocabulary of their difference from the reference's,
  over the reference's own spread about its mean.  Where greedy decoding
  repeats a token its margin is wide and any precision picks it, so the
  widest gap can read 0 for a lower precision; the logits' error does not.
* ``logit_rel_err_median``: the median of those errors over every
  compared position: a MoE router in bf16 sends a few tokens to another
  expert than the float32 reference does, and those positions set the
  widest error, not the precision of the rest.
* ``decision_mismatches``: decisions whose instance or tier differ from
  ``reference.decision``.
* ``transfer_mismatches``: transfers whose shipped bytes, page tables,
  leaves shipped whole or landed tables differ from what the request's
  prompt needs (the layer stack's ``transfer_layout``: for the decoder every
  valid page of every layer, none held by the decode side, since prompts
  are unique).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import decision as decision_ref
from reference.model import set_exact

from . import stacks
from .roofline import PAGE_TOKENS, Dims

SAMPLE_TOKENS = 256
SAMPLE_MAX = 12
SAMPLE_POSITIONS = 24_000


def sample(reqs: list, seed: int) -> list:
    """Finished requests: the one with the most served tokens, then others
    in an order drawn from the seed, until the sample's limits."""
    done = sorted((r for r in reqs if r.finished), key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(int(seed) ^ 0x5EED).permutation(len(rest))
    out, tokens = [longest], len(longest.tokens)
    positions = longest.prompt_len + len(longest.tokens)
    for i in order:
        r = rest[i]
        if tokens >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX \
                or positions + r.prompt_len + len(r.tokens) > SAMPLE_POSITIONS:
            break
        out.append(r)
        tokens += len(r.tokens)
        positions += r.prompt_len + len(r.tokens)
    return out


def _seqs(reqs, prompts, device):
    return [(torch.as_tensor(np.concatenate([prompts[r.rid], r.tokens[:-1]]), device=device),
             r.prompt_len) for r in reqs]


def rel_err(z: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row: rms over the vocabulary of (z - ref) over the rms of ref
    about its mean."""
    ref = ref.float()
    spread = (ref - ref.mean(-1, keepdim=True)).square().mean(-1).sqrt()
    return (z.float() - ref).square().mean(-1).sqrt() / spread


def position_gaps(weights, cfg, reqs, prompts, device, *, control: bool = False):
    """Per sampled request, at each served position: the gap of the served
    token below the float32 reference's best, and the relative error of the
    program's logits (host float64 arrays).  With ``control``, the same two
    readings for the fp8 reference put in the program's place (the gap of
    the token it puts first, and its logits' error) and, for a MoE model,
    the float32 reference's smallest router margin at each position.
    Returns ((gaps, errs), (control gaps, control errs, margins) or None)."""
    model_ref = stacks.of(cfg).reference
    set_exact()
    seqs = _seqs(reqs, prompts, device)
    margins = [] if control else None
    ref = model_ref.served_logits(weights, cfg, seqs, margins=margins)
    low = model_ref.served_logits(weights, cfg, seqs, fp8=True) if control else None

    def gaps_of(lg, pick):
        return (lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]).double().cpu().numpy()

    def host(t):
        return t.double().cpu().numpy()

    served = ([gaps_of(lg, torch.as_tensor(r.tokens, device=lg.device))
               for lg, r in zip(ref, reqs)],
              [host(rel_err(torch.stack(r.logits).to(lg.device), lg)) for lg, r in zip(ref, reqs)])
    ctrl = None
    if control:
        ctrl = ([gaps_of(lg, lo.argmax(-1)) for lg, lo in zip(ref, low)],
                [host(rel_err(lo, lg)) for lg, lo in zip(ref, low)],
                [host(m) for m in margins])
    return served, ctrl


def decision_mismatches(decisions, deploy) -> list[dict]:
    return decision_ref.mismatches(decisions, deploy)


def transfer_mismatches(packs, unpacks, cfg: dict, prompt_lens: set) -> list[str]:
    """Each pack against its prompt: no page held by the decode side (the
    prompts are unique), the page tables and the leaves shipped whole that
    the layer stack's ``transfer_layout`` expects, the bytes they hold; each
    unpack against its pack's tables, in call order."""
    page_bytes = Dims(cfg).page_bytes
    layout = stacks.of(cfg).transfer_layout
    pages_per_layer = int(cfg["deployment"]["cache_len"]) // PAGE_TOKENS
    bad = []
    if len(packs) != len(unpacks):
        bad.append(f"{len(packs)} packs, {len(unpacks)} unpacks")
    for n, p in enumerate(packs):
        valid = math.ceil(p["pos"] / PAGE_TOKENS)
        tables, whole = layout(cfg, p["pos"], pages_per_layer)
        if p["pos"] not in prompt_lens:
            bad.append(f"pack {n}: pos {p['pos']} is no prompt's length")
        if p["hit_pages"] != 0:
            bad.append(f"pack {n}: {p['hit_pages']} hit pages for a unique prompt")
        if p["tables"] != tables:
            bad.append(f"pack {n}: page tables differ from pages 0..{valid - 1} of each layer")
        if p["whole"] != whole:
            bad.append(f"pack {n}: leaves shipped whole {sorted(p['whole'].items())}, "
                       f"expected {sorted(whole.items())}")
        want_bytes = sum(map(len, tables.values())) * page_bytes + sum(whole.values())
        if p["nbytes"] != want_bytes:
            bad.append(f"pack {n}: {p['nbytes']} bytes shipped, {want_bytes} needed")
        if n < len(unpacks) and unpacks[n]["tables"] != p["tables"]:
            bad.append(f"unpack {n}: landed tables differ from the shipped ones")
    return bad
