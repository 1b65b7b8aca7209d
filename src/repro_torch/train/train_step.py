"""The train step: gradient-accumulated microbatches over a (remat'd)
backbone (``repro/train/train_step.py``).

Microbatch layout: the global batch (B, ...) is viewed as
(batch_shards, mb, local/mb, ...) and the mb axis is moved to the front, so
that every microbatch takes an equal slice of every data shard, the rows
JAX's layout puts in it.  Gradients come from ``torch.autograd``; they
accumulate in ``accum_dtype`` in microbatch order and are divided by the
microbatch count, and the loss is the microbatches' mean, as JAX's scan
sums them.
"""

from __future__ import annotations

import torch

from ..models.model import Model, forward_train


def effective_microbatches(global_batch: int, mb: int, batch_shards: int) -> int:
    """Largest feasible mb <= requested that divides the per-shard batch."""
    local = max(global_batch // batch_shards, 1)
    mb = min(mb, local)
    while local % mb:
        mb -= 1
    return max(mb, 1)


def microbatch_split(batch: dict, mb: int, batch_shards: int) -> dict:
    """Each (B, ...) leaf as (mb, B/mb, ...): microbatch i holds rows
    ``[s*local + i*(local/mb), ...)`` of every shard s."""
    def split(x):
        b = x.shape[0]
        local = b // batch_shards
        x = x.reshape(batch_shards, mb, local // mb, *x.shape[1:]).movedim(1, 0)
        return x.reshape(mb, b // mb, *x.shape[3:])

    return {k: split(x) for k, x in batch.items()}


def make_train_step(optimizer, microbatches: int = 1, batch_shards: int = 1,
                    aux_weight: float = 0.01, accum_dtype=torch.float32):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the model's parameters (a :class:`Model` made with
    ``train_dtype``) are overwritten by the optimizer's new values; metrics
    are the loss and the f32 norm of the averaged gradients, as 0-d
    tensors on the model's device (nothing is read back)."""
    def grads_of(model: Model, names: list, batch: dict):
        loss, _ = forward_train(model, batch, aux_weight=aux_weight)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return loss.detach(), dict(zip(names, grads))

    def train_step(model: Model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        names = list(params)
        gb = next(iter(batch.values())).shape[0]
        mb_eff = effective_microbatches(gb, microbatches, batch_shards)
        if mb_eff <= 1:
            loss, grads = grads_of(model, names, batch)
        else:
            mbs = microbatch_split(batch, mb_eff, batch_shards)
            gsum = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                    for k, p in params.items()}
            lsum = 0.0
            for i in range(mb_eff):
                loss, g = grads_of(model, names, {k: x[i] for k, x in mbs.items()})
                for k in names:
                    gsum[k] = gsum[k] + g[k].to(accum_dtype)
                lsum = lsum + loss
                del g
            grads = {k: g / mb_eff for k, g in gsum.items()}
            loss = lsum / mb_eff
        new_params, opt_state = optimizer.update(grads, opt_state, params)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float())) for k in names))
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
