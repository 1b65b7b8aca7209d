"""Optimizers as plain functions on tensors: AdamW and (factored) Adafactor
(``repro/train/optimizer.py``).

Each follows the JAX formulas operation for operation, in f32, so that a
step rounds as JAX's does: AdamW's bias corrections ``1 - b ** t`` in f32,
``eps`` added to ``sqrt(v_hat)``, the weight decay inside the update;
Adafactor's factored second moment for tensors of two or more dimensions
(row and column means of ``g^2 + eps``), its ``rsqrt`` factors, the update's
RMS clip, ``1 - t ** -decay`` as its decay.  ``torch.optim`` is not used:
its AdamW rounds differently.

``params`` and ``grads`` are dicts of tensors by parameter name (the
model's dotted names); a state holds dicts of the same names.  ``update``
returns new tensors and leaves its inputs as they are.  Each optimizer's
``state_partition_specs`` and :func:`opt_state_specs` give the state's specs
(``models/sharding.py``: a tuple of mesh-axis entries per dimension) from
the parameters', as JAX's do.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32


def _t(step: torch.Tensor) -> torch.Tensor:
    return step.to(F32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: dict) -> dict:
        """{"m", "v": f32 zeros like each parameter, "step": int32 0}."""
        dev = next(iter(params.values())).device
        return {"m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """(new params in each parameter's dtype, new state)."""
        step = state["step"] + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** _t(step)
        bc2 = 1.0 - b2 ** _t(step)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(F32)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.to(F32)
            new_p[k] = (p.to(F32) - self.lr * delta).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "step": step}

    def state_partition_specs(self, param_specs: dict) -> dict:
        return {"m": param_specs, "v": param_specs, "step": ()}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(self, params: dict) -> dict:
        """{"acc": {name: {"vr", "vc"} (two or more dims) or {"v"}}, "step"}."""
        def leaf(p):
            z = dict(dtype=F32, device=p.device)
            if self._factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        dev = next(iter(params.values())).device
        return {"acc": {k: leaf(p) for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        beta = 1.0 - _t(step) ** (-self.decay)
        eps = self.eps
        new_p, new_acc = {}, {}
        for k, p in params.items():
            g = grads[k].to(F32)
            acc = state["acc"][k]
            g2 = torch.square(g) + eps
            if self._factored(g.shape):
                vr = beta * acc["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * acc["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                                   + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                new_acc[k] = {"vr": vr, "vc": vc}
            else:
                v = beta * acc["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_acc[k] = {"v": v}
            rms = torch.sqrt(torch.square(u).mean() + eps)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            newp = p.to(F32) - self.lr * (u + self.weight_decay * p.to(F32))
            new_p[k] = newp.to(p.dtype)
        return new_p, {"acc": new_acc, "step": step}

    def state_partition_specs(self, param_specs: dict) -> dict:
        """JAX's raw form: the parameters' specs under ``acc``; the factored
        leaves' specs come from :func:`opt_state_specs`."""
        return {"acc": param_specs, "step": ()}


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)


def opt_state_specs(opt, params: dict, state: dict, param_specs: dict) -> dict:
    """Specs matching ``state`` leaf by leaf (``params``: name -> tensor or
    shape).  AdamW's m and v mirror the parameters'; Adafactor's ``vr``
    drops the last dimension of its parameter's spec, ``vc`` the one before
    it, and ``v`` keeps it."""
    if isinstance(opt, AdamW):
        return opt.state_partition_specs(param_specs)

    def acc_spec(name, kind, leaf):
        rank = len(leaf.shape) if hasattr(leaf, "shape") else len(leaf)
        dims = list(param_specs.get(name, ()))
        dims += [None] * (rank + (1 if kind in ("vr", "vc") else 0) - len(dims))
        if kind == "vr":
            dims = dims[:-1]
        elif kind == "vc":
            dims = dims[:-2] + dims[-1:]
        dims = dims[:rank]
        return tuple(dims + [None] * (rank - len(dims)))

    return {"acc": {name: {kind: acc_spec(name, kind, leaf) for kind, leaf in acc.items()}
                    for name, acc in state["acc"].items()}, "step": ()}
