"""Mesh construction: ``torch.distributed`` ``DeviceMesh``es with the reference's axes.

``make_production_mesh`` and ``make_host_mesh`` are FUNCTIONS (not
module-level constants), so importing this module never touches device or
process-group state.

Mesh shapes:
    single-pod:  (16, 16)      dims ("data", "model")        — 256 ranks
    multi-pod:   (2, 16, 16)   dims ("pod", "data", "model") — 512 ranks

The production meshes need a process group of 256 or 512 ranks: one rank a
card, or a fake process group where nothing runs
(``torch.testing._internal.distributed.fake_pg``).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.layers import _device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data", "model"),
    over the ranks of the current process group, which must have 256 or 512 of them.
    ``device`` None means the card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'production'} mesh {shape} needs a process group "
                           f"of {need} ranks; this one has {have}")
    return init_device_mesh(_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device=None):
    """A (n // model, model) mesh over ("data", "model") on the n ranks of the current
    process group (tests, examples, one card).  Without a group, this process starts
    a one-rank group itself (``nccl`` on the card, ``gloo`` on the CPU, through an
    in-memory store, so no port is opened): one card is a (1, 1) mesh.  ``device``
    None means the card."""
    dev = _device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(dev, (n // model, model), mesh_dim_names=("data", "model"))
