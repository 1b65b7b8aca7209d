"""Production mesh construction (``repro/launch/mesh.py``) as a torch
``DeviceMesh``.

Single pod:  (16, 16)      axes ("data", "model")          = 256 chips
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")   = 512 chips

No machine of the port has 512 cards: the dry run (``launch/dryrun.py``)
builds these meshes over a fake process group of world 512, initialised
once a process, and traces every step on the meta device as rank 0 (the pod
mesh takes ranks 0-255).  ``make_production_mesh`` is a function, so
importing this module touches no distributed state.
"""

from __future__ import annotations

import math

import torch

WORLD = 512


def init_fake_world(world_size: int = WORLD) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives are recorded by the dry run, never sent."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"initialised; the dry run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world()
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def batch_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def batch_shards(multi_pod: bool) -> int:
    return 32 if multi_pod else 16
