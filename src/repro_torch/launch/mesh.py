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

The production meshes (:func:`make_production_mesh`: 16×16 ranks, or two
pods of them) exist for the dry run (``launch/dryrun.py``) without 256 or
512 processes: :func:`fake_world` makes a process group of that world size
in this one process (PyTorch's fake backend: its collectives return at
once and move nothing), and the mesh is a DeviceMesh over it, so the rank's
own step code runs unchanged on meta tensors. The port's layouts know the
axes "data" and "model" only, so two pods fold ("pod", "data") into one
data axis of 32 (the named departure ``pod_as_data``: JAX keeps a "pod"
axis, and its data-parallel axes are ("pod", "data")).

:func:`degraded_mesh` is elastic re-meshing: the mesh without its last
``drop_data`` data rows. On a fake world it is the smaller fake world; on a
live world the ranks of the dropped rows leave (:class:`LeftMesh`) and the
survivors join a fresh process group of the smaller world on a new store
(``init_method``), as torchelastic restarts its workers: a rank that has
failed cannot take part in ``new_group`` over the old world, and nothing of
the old world's sockets is kept. A survivor keeps its rank (row-major, the
first rows survive, as JAX keeps the first devices).
"""
from __future__ import annotations

import datetime
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
                       world_size: Optional[int] = None,
                       timeout: Optional[datetime.timedelta] = None) -> str:
    """Initialize the default process group (from the environment
    ``torch.distributed.run`` sets, unless ``init_method``, ``rank`` and
    ``world_size`` are given) on the backend :func:`choose_backend` picks
    for ``device``, each collective bounded by ``timeout`` when given;
    logs and returns the backend. A no-op returning the backend when
    already initialized."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev, local_world)
    kw = {} if init_method is None else dict(
        init_method=init_method, rank=rank, world_size=world)
    if timeout is not None:
        kw["timeout"] = timeout
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
    """The data-parallel axes of ``mesh``: ('data',) (no mesh of the port
    has a 'pod' axis: ``pod_as_data``)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# production meshes (the dry run) and elastic re-meshing
# ---------------------------------------------------------------------------

PRODUCTION = (16, 16)            # (data, model) ranks of one pod
PODS = 2


def fake_world(world: int, rank: int = 0) -> None:
    """Make the default process group a fake one of ``world`` ranks in this
    process, as ``rank`` (a fake group already there is replaced; a live
    one raises). Every collective on it returns at once; with meta tensors
    nothing is moved or allocated. PyTorch ships the fake backend in its
    testing package: this is the one place the port reaches it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a live {dist.get_backend()} process group is initialized:"
                f" a fake world would replace it")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def fake_mesh(data: int, model: int, rank: int = 0):
    """A (data, model) mesh over a fake world of its size, as ``rank``."""
    fake_world(data * model, rank)
    return make_local_mesh(data=data, model=model)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    """16×16 = 256 ranks of one pod; two pods fold into one (32, 16) mesh
    (``pod_as_data``). Over a fake world of that size in this process, as
    ``rank`` (row-major: data row ``rank // 16``)."""
    data, model = PRODUCTION
    return fake_mesh(data * (PODS if multi_pod else 1), model, rank)


class LeftMesh(RuntimeError):
    """Raised on a rank of a dropped data row by :func:`degraded_mesh`:
    the rank has left the world and takes no further part."""


def degraded_mesh(mesh, *, drop_data: int = 1,
                  init_method: Optional[str] = None,
                  timeout: Optional[datetime.timedelta] = None):
    """The (data - ``drop_data``, model) mesh of the survivors (JAX's
    ``degraded_mesh``: one lost slice, re-lowered on the rest). On a fake
    world: the smaller fake world, this rank kept when it survives (else
    rank 0). On a live world every rank calls it: the ranks of the last
    ``drop_data`` data rows destroy their process group and raise
    :class:`LeftMesh`; the survivors join a fresh group of the smaller world
    at ``init_method`` (a new store), each keeping its rank, with
    ``timeout`` as :func:`init_process_group`'s."""
    data = mesh.size(mesh.mesh_dim_names.index("data"))
    model = mesh.size(mesh.mesh_dim_names.index("model"))
    left = data - drop_data
    if left < 1:
        raise ValueError(f"dropping {drop_data} of {data} data rows leaves "
                         f"no mesh")
    me, backend = dist.get_rank(), dist.get_backend()
    if backend == "fake":
        return fake_mesh(left, model, me if me < left * model else 0)
    if init_method is None:
        raise ValueError("re-meshing a live world needs the new store's "
                         "init_method")
    dist.destroy_process_group()
    if me >= left * model:
        raise LeftMesh(f"rank {me} of data row {me // model} left the "
                       f"{data}x{model} mesh")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=me,
                            world_size=left * model, **kw)
    return make_local_mesh(data=left, model=model)
