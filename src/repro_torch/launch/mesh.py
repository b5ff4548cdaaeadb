"""Mesh definitions: the production meshes and the local one.

The port of ``repro/launch/mesh.py``. Meshes are torch ``DeviceMesh``es
with the reference's axis names. Building one needs a default process
group: the production meshes need a world of 256 or 512 ranks (a fake
group does for the sharding rules, which read only names and sizes);
``make_local_mesh`` starts a world of one on the caller's device if no
group exists, so an entry point needs no launcher.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.storage.cluster import _device


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks), over
    the default process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device="cuda"):
    """The ranks of the default process group as a ('data', 'model') mesh
    with model = 1, on ``device``'s type.

    Without a default group it starts one of world size 1 (NCCL for a CUDA
    device, gloo on the CPU) over a TCP store on 127.0.0.1; a failure to
    start raises."""
    dev = _device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=store, rank=0, world_size=1,
            device_id=dev if dev.type == "cuda" else None,
        )
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=("data", "model"))


def set_mesh(mesh):
    """The reference's context manager for activating ``mesh``, kept by
    name. In torch the mesh travels with each DTensor, so there is nothing
    to activate: it yields ``mesh``."""
    return contextlib.nullcontext(mesh)
