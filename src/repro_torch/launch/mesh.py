"""Local (data, model) meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

The port serves SPMD by hand: one process per rank, each running the same
host loop on its shard of the weights (``runtime/sharding.py``). A mesh is
a :class:`~torch.distributed.device_mesh.DeviceMesh` with dims ``("data",
"model")`` over the default process group; its size must equal the world
size. Launch the ranks with

    python -m torch.distributed.run --nproc-per-node N ...

(which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
address), or initialize the process group yourself before
:func:`make_local_mesh`.

The backend is chosen explicitly: ``nccl`` when every rank has a card of
its own, ``gloo`` when ranks share one card (NCCL refuses two ranks on one
GPU) or run on the CPU; with ``gloo`` the collectives of a CUDA tensor go
through host memory (:class:`~repro_torch.runtime.sharding.Layout`). A
rank's device is ``cuda:{local_rank % device_count}``; a rank without CUDA
raises unless the caller asks for the CPU.

``make_production_mesh`` and ``degraded_mesh`` (the dry run's 256/512-chip
meshes and its elastic re-lowering) are not ported.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import DeviceLike, resolve_device

AXES = ("data", "model")


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else the global
    rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device a rank computes on: ``cuda:{local_rank % device_count}``
    by default (raises without CUDA), or the device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when each of ``local_world`` ranks has a card of its own,
    else ``gloo`` (ranks sharing a card, or on the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_process_group(device: DeviceLike = None, *,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> str:
    """Initialize the default process group (from the environment
    ``torch.distributed.run`` sets, unless ``init_method``, ``rank`` and
    ``world_size`` are given) on the backend :func:`choose_backend` picks
    for ``device``; logs and returns the backend. A no-op returning the
    backend when already initialized."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev, local_world)
    kw = {} if init_method is None else dict(
        init_method=init_method, rank=rank, world_size=world)
    dist.init_process_group(backend=backend, **kw)
    if dist.get_rank() == 0:
        print(f"[mesh] process group: {backend} over {world} ranks "
              f"({local_world} on this host, "
              f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
              f"cards visible)", flush=True)
    return backend


def make_local_mesh(data: int = 1, model: int = 1):
    """A (data, model) DeviceMesh over the initialized process group; its
    size must equal the world size. Ranks are laid out row-major: rank r
    is data row ``r // model``, model column ``r % model``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_local_mesh needs an initialized process group: launch "
            "with python -m torch.distributed.run and call "
            "launch.mesh.init_process_group() first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(
            f"a {data}x{model} mesh needs {data * model} ranks but the "
            f"world holds {world}; launch with python -m "
            f"torch.distributed.run --nproc-per-node {data * model}")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's collectives run where the backend runs them: on the card
    # for nccl, in host memory for gloo
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, model), mesh_dim_names=AXES)


def parse_mesh(spec: str, device: DeviceLike = None):
    """``--mesh DATAxMODEL`` (e.g. ``2x4``) → a local (data, model) mesh,
    the default process group initialized first (:func:`init_process_group`)
    when it is not yet. The world size must equal DATA*MODEL."""
    try:
        data, model = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"--mesh expects DATAxMODEL (e.g. 2x4), got {spec!r}") from None
    have = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", 1))
    if data * model != have:
        raise ValueError(
            f"--mesh {spec} needs {data * model} ranks but {have} "
            f"{'is' if have == 1 else 'are'} running; launch with python "
            f"-m torch.distributed.run --nproc-per-node {data * model}")
    init_process_group(device)
    return make_local_mesh(data=data, model=model)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh``: ('data',) (a local mesh has no
    'pod' axis)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))
