"""Shared model components: norms, RoPE, activations, init specs.

Forward math runs in the model's ``compute_dtype`` with f32 norms and RoPE
angles, as in ``repro/models/common.py``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def rope_tables(positions: torch.Tensor, d_head: int, theta: float):
    """(cos, sin) of shape (..., S, 1, d_head/2) for positions (..., S)."""
    angles = positions[..., None].float() * rope_freqs(d_head, theta, positions.device)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE over split halves of the head dim, in f32; x: (..., S, H, dh)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: broadcastable to (..., S)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return rotate(x, cos, sin)


class ConfigOptions:
    """Options of a frozen config dataclass that the JAX package's config
    lacks.  Each is a ``dataclasses.InitVar`` with its default, named in
    ``OPTIONS`` and kept on the instance by :meth:`_keep` in
    ``__post_init__``: the constructor and ``dataclasses.replace`` take it,
    but it is no field, so ``dataclasses.fields`` and ``asdict`` stay the
    JAX config's.  Equality and the hash count the options with the fields
    (the dataclass is made with ``eq=False``)."""

    OPTIONS: tuple[str, ...] = ()

    def _keep(self, *values) -> None:
        for name, value in zip(self.OPTIONS, values):
            object.__setattr__(self, name, value)

    def _key(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)) + \
            tuple(getattr(self, name) for name in self.OPTIONS)

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


@dataclasses.dataclass(frozen=True)
class InitSpec:
    """A parameter's shape and init: N(0, scale^2), zeros or ones."""

    shape: tuple[int, ...]
    scale: float = 0.02
    kind: str = "normal"  # "normal" | "zeros" | "ones"
