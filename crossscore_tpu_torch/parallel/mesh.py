"""Process groups over ranks and nodes: the port's counterpart of the process
half of ``crossscore_tpu/parallel/mesh.py``.

The JAX package runs one controller over a device mesh; the port runs one
process per card (``torchrun`` or :mod:`crossscore_tpu_torch.parallel.launch`)
and joins them in a ``torch.distributed`` process group. The launcher's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` give the
topology, ``MASTER_ADDR`` and ``MASTER_PORT`` the rendezvous; rank r of a node
takes card ``LOCAL_RANK % device_count`` (ranks share a card when there are
more ranks than cards, which only the gloo backend allows). The backend is
the caller's (``model.gpu.dist_backend``): ``nccl`` for one rank per card,
``gloo`` for the CPU and for ranks that share a card.

The view group is the group whose ranks shard the K reference views (view
parallelism, the decoder's ``cp`` attention route); like the JAX package's
current mesh it is registered here, because the model carries only the
string ``"cp"`` and resolves the group when it runs. :func:`make_groups`, the
counterpart of ``make_mesh(model_parallel=...)``, lays the ranks out as a
(data, model) grid and registers this rank's model group (the ranks that
shard the heads, the ``tp`` route) and data group (the ranks whose gradients
are summed).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

_VIEW_GROUP: Optional[dist.ProcessGroup] = None
_MODEL_GROUP: Optional[dist.ProcessGroup] = None
_DATA_GROUP: Optional[dist.ProcessGroup] = None


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int

    @property
    def n_nodes(self) -> int:
        return self.world_size // self.local_world_size


def topology_from_env() -> Topology:
    """The launcher's topology; one rank of one node when ``WORLD_SIZE`` is unset."""
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    top = Topology(rank=int(env.get("RANK", "0")), world_size=world,
                   local_rank=int(env.get("LOCAL_RANK", "0")),
                   local_world_size=int(env.get("LOCAL_WORLD_SIZE", str(world))))
    if not (0 <= top.rank < world and 0 <= top.local_rank < top.local_world_size <= world
            and world % top.local_world_size == 0):
        raise ValueError(f"inconsistent launcher topology {top}")
    return top


def rank_device(top: Topology, device_type: str) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU
    when asked. Raises without a card: no rank carries on on the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device type must be cuda or cpu, got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; ask for the CPU explicitly")
    return torch.device("cuda", top.local_rank % torch.cuda.device_count())


def init_distributed(backend: str, device_type: str = "cuda",
                     timeout_s: float = 600.0) -> tuple[Topology, torch.device]:
    """Join the process group of the launcher's ranks and register the view
    group (all ranks: one node). Returns the topology and this rank's device.

    ``backend``: ``nccl`` (CUDA only, one rank per card) or ``gloo``. The
    collectives give up after ``timeout_s``, so a rank that never arrives
    fails the others instead of hanging them."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend needs CUDA tensors; use gloo on the CPU")
    top = topology_from_env()
    device = rank_device(top, device_type)
    if backend == "nccl" and top.local_world_size > torch.cuda.device_count():
        raise ValueError(f"nccl takes one rank per card: {top.local_world_size} ranks on "
                         f"{torch.cuda.device_count()} cards; use gloo for ranks that share a card")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        raise RuntimeError("MASTER_PORT is not set: start the ranks with torchrun or parallel.launch")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=top.rank,
                            world_size=top.world_size, timeout=datetime.timedelta(seconds=timeout_s))
    set_view_group(dist.group.WORLD)
    return top, device


def set_view_group(group: Optional[dist.ProcessGroup]) -> None:
    global _VIEW_GROUP
    _VIEW_GROUP = group


def view_group() -> dist.ProcessGroup:
    """The registered view group; raises when none is."""
    if _VIEW_GROUP is None:
        raise RuntimeError("no view group: call parallel.mesh.init_distributed (or set_view_group) "
                           "before running a model whose attention_impl is 'cp'")
    return _VIEW_GROUP


@dataclasses.dataclass(frozen=True)
class Grid:
    """The (data, model) grid of :func:`make_groups` and this rank's place in
    it; ``data_rank`` and ``model_rank`` are None on a rank left out of it."""

    data_parallel: int
    model_parallel: int
    data_rank: Optional[int]
    model_rank: Optional[int]

    @property
    def active(self) -> bool:
        return self.model_rank is not None


def _node_sizes(world: int) -> list[int]:
    """Every rank's ``LOCAL_WORLD_SIZE``, gathered over the process group (a
    collective): how many ranks each node launched."""
    local = topology_from_env().local_world_size
    sizes = [None] * world
    dist.all_gather_object(sizes, local)
    return sizes


def requested_ranks(devices, world: int) -> int:
    """``trainer.devices`` as a number of ranks: -1 (or None) is every launched
    rank, an int is that many, a list its length. More than were launched
    raises: one process drives one card, so the ranks come from the launcher."""
    n = world if devices in (-1, None) else devices if isinstance(devices, int) else len(devices)
    if n < 1 or n > world:
        raise ValueError(
            f"trainer.devices={devices!r} asks for {n} ranks, and {world} were launched: one process "
            f"drives one card; launch one rank per card (torchrun --nproc_per_node {max(n, 1)} ..., "
            "--nnodes with the rendezvous flags for several nodes) or set trainer.devices=-1")
    return n


def grid_members(world: int, node_sizes: list[int], model_parallel: int, batch_size: Optional[int],
                 n_ranks: Optional[int] = None) -> list[int]:
    """The ranks of the (data, model) grid of :func:`make_groups`, in grid
    order (data-major), from each rank's ``LOCAL_WORLD_SIZE``; the rank
    counterpart of the devices the JAX ``make_mesh`` keeps. Raises where it
    raises, and for nodes of unequal rank counts."""
    mp = model_parallel
    n = world if n_ranks in (None, -1) else min(n_ranks, world)
    if mp < 1 or n < mp:
        raise ValueError(f"model_parallel={mp} exceeds the {n} available ranks")
    local = node_sizes[0] if node_sizes else 0
    if len(set(node_sizes)) != 1 or local < 1 or world % local:
        raise ValueError(f"the nodes launched unequal numbers of ranks (LOCAL_WORLD_SIZE by rank: {node_sizes}); "
                         "a data layout needs an equal rank count per node: launch every node with the same "
                         "--nproc_per_node")
    n_nodes = world // local
    if batch_size is not None and n_nodes > 1:
        per_node = local
        if n_ranks not in (None, -1):
            if n < n_nodes:
                raise ValueError(f"trainer.devices={n_ranks} is below the {n_nodes} nodes; a multi-node data "
                                 "layout needs >= 1 rank per node")
            per_node = min(per_node, n // n_nodes)
        d = _per_process_data_par(per_node, mp, batch_size)
        return [node * local + j for node in range(n_nodes) for j in range(d * mp)]
    if batch_size is not None:
        n = _per_process_data_par(n, mp, batch_size) * mp
    if n % mp:
        raise ValueError(f"{n} ranks not divisible by model_parallel={mp}")
    return list(range(n))


def make_groups(model_parallel: int = 1, batch_size: Optional[int] = None,
                n_ranks: Optional[int] = None) -> Grid:
    """Lay the ranks out as a (data, model) grid and register this rank's
    model and data groups; the counterpart of the JAX ``make_mesh(n_devices,
    model_parallel, batch_size)``, with one node for one JAX process.

    On one node the first ``n_ranks`` ranks (all by default) take part: rank
    r sits at data index r // mp and model index r % mp, so the model axis is
    the fast one, as ``devices.reshape(n // mp, mp)``. ``batch_size`` clamps
    the data axis to the largest width that divides it
    (:func:`_per_process_data_par`).

    Over several nodes with a ``batch_size`` (each node's own batch, as each
    JAX process loads its own), every node keeps the same ranks: its first
    ``d * mp``, ``d`` the data width of ``_per_process_data_par`` over the
    node's ranks (capped by ``n_ranks // nodes`` when ``n_ranks`` is given),
    so the data index is ``node * d + local // mp``. Nodes that launched
    different numbers of ranks, and a cap below one rank a node, raise.

    Ranks past the grid get no groups. Raises when ``model_parallel``
    exceeds the ranks or does not divide them. Every rank of the process
    group must call this (each new group is a collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_groups needs a process group: call init_distributed first")
    mp = model_parallel
    world, rank = dist.get_world_size(), dist.get_rank()
    members = grid_members(world, _node_sizes(world), mp, batch_size, n_ranks)
    dp = len(members) // mp
    model_groups = [dist.new_group(members[i * mp:(i + 1) * mp]) for i in range(dp)]
    data_groups = [dist.new_group(members[m::mp]) for m in range(mp)]
    global _MODEL_GROUP, _DATA_GROUP
    if rank not in members:
        _MODEL_GROUP = _DATA_GROUP = None
        return Grid(dp, mp, None, None)
    d, m = divmod(members.index(rank), mp)
    _MODEL_GROUP, _DATA_GROUP = model_groups[d], data_groups[m]
    return Grid(dp, mp, d, m)


def model_group() -> dist.ProcessGroup:
    """The registered model group (the ``tp`` route's head shards); raises
    when none is."""
    if _MODEL_GROUP is None:
        raise RuntimeError("no model group: call parallel.mesh.make_groups before building or running "
                           "a model whose attention_impl is 'tp'")
    return _MODEL_GROUP


def data_group() -> Optional[dist.ProcessGroup]:
    """The registered data group, or None when :func:`make_groups` was not
    called (one data replica: no gradient sum)."""
    return _DATA_GROUP


def teardown() -> None:
    """Forget the view, model and data groups and leave the process group, if
    one was joined."""
    global _MODEL_GROUP, _DATA_GROUP
    set_view_group(None)
    _MODEL_GROUP = _DATA_GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _per_process_data_par(group_size: int, model_parallel: int, batch_size: int) -> int:
    """Per-process width of the data axis: the largest d <= group_size //
    model_parallel with ``batch_size % d == 0`` (the port's copy of the JAX
    package's rule: each process's own ``batch_size`` rows divide evenly over
    its devices)."""
    d = group_size // model_parallel
    if d < 1:
        raise ValueError(f"model_parallel={model_parallel} exceeds the {group_size} "
                         "devices available per process")
    while d > 1 and batch_size % d:
        d -= 1
    return d
