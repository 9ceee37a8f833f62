"""Process-group meshes (counterpart of
``image_restoration_agent_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a named ``Mesh`` and lets XLA insert
the collectives. Here one process drives one card (or one CPU rank), and a
:class:`Mesh` holds named ``torch.distributed`` process groups over the
ranks, laid out row-major as the JAX mesh orders its devices: rank ``r`` of
a ``{"data": 2, "model": 2}`` mesh sits at ``(r // 2, r % 2)``. Axes:

- ``data``: data parallel (batch, independent images);
- ``tile``: tile parallel, the domain's sequence parallelism (the tiles of
  one large image spread over ranks);
- ``model``: weights sharded for training.

Collectives run on the backend the world was started with: ``nccl`` on the
card, ``gloo`` on the CPU (:func:`init_distributed`). Without an
initialized world every axis has size 1, no group and no collective.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Named axes over ranks, with this rank's process group along each.

    ``shape`` maps axis names to sizes (as ``jax.sharding.Mesh.shape``);
    ``ranks`` is the rank array; ``index(axis)`` is this rank's coordinate
    and ``group(axis)`` its group along ``axis`` (None without a world).
    A rank outside the mesh has ``coords`` None."""

    def __init__(self, names: Sequence[str], ranks: np.ndarray,
                 groups: dict, rank: int):
        self.axis_names = tuple(names)
        self.ranks = ranks
        self.groups = groups
        self.rank = rank
        where = np.argwhere(ranks == rank)
        self.coords = tuple(int(i) for i in where[0]) if len(where) else None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    def neighbor(self, axis: str, offset: int) -> int | None:
        """The global rank ``offset`` steps from this one along ``axis``
        (None past either end)."""
        ax = self.axis_names.index(axis)
        i = self.coords[ax] + offset
        if not 0 <= i < self.ranks.shape[ax]:
            return None
        return int(self.ranks[self.coords[:ax] + (i,) + self.coords[ax + 1:]])

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """Reduce ``t`` in place over ``axes`` (one name or several: one
        collective along each, which for a sum or max is the reduction over
        their product). Returns ``t``."""
        for axis in (axes,) if isinstance(axes, str) else axes:
            g = self.group(axis)
            if g is not None:
                dist.all_reduce(t, op=op, group=g)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """The ``t`` of every rank along ``axis``, in axis order."""
        g = self.group(axis)
        if g is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(out, t.contiguous(), group=g)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _build(names: Sequence[str], ranks: np.ndarray) -> Mesh:
    """Create the groups of every row of ``ranks`` along every axis (every
    rank of the world creates every group, in the same order, as
    ``new_group`` requires) and keep this rank's."""
    world, me = _world()
    groups = {}
    if dist.is_available() and dist.is_initialized():
        for ax, name in enumerate(names):
            rows = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for row in rows:
                g = dist.new_group(sorted(int(r) for r in row))
                if me in row:
                    groups[name] = g
    return Mesh(names, ranks, groups, me)


def make_mesh(axis_shapes: dict[str, int]) -> Mesh:
    """A mesh with named axes over the first ``prod(sizes)`` ranks, laid out
    row-major, e.g. ``make_mesh({"data": 2, "tile": 2})`` on 4 ranks.
    Collective over the world: every rank calls it. ValueError where the
    world has too few ranks."""
    world, _ = _world()
    names = tuple(axis_shapes)
    shape = tuple(int(s) for s in axis_shapes.values())
    n = int(np.prod(shape))
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    return _build(names, np.arange(n).reshape(shape))


def local_size() -> int:
    """Ranks per host: ``LOCAL_WORLD_SIZE`` (torchrun sets it), else the
    whole world."""
    world, _ = _world()
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def local_mesh(axis_name: str = "tile") -> Mesh:
    """1-D mesh over this host's ranks (every host's groups are made; each
    rank keeps its own host's)."""
    world, me = _world()
    n_local = local_size()
    grid = _build(("host", axis_name),
                  np.arange(world).reshape(world // n_local, n_local))
    row = grid.ranks[me // n_local]
    return Mesh((axis_name,), row, {axis_name: grid.group(axis_name)}, me)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 300.0) -> torch.device:
    """Join the world: ``torch.distributed.init_process_group``.

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous with
    ``num_processes`` and ``process_id``); without it the ``env://``
    rendezvous reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` (torchrun's). ``backend`` defaults to ``nccl`` where a card is
    present, else ``gloo``. With ``nccl`` the rank takes card
    ``LOCAL_RANK`` (default ``rank % device_count``). Returns the rank's
    device. Call once per process, before any mesh is made."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if coordinator_address is not None:
        addr = coordinator_address
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
        kw["world_size"] = num_processes
        kw["rank"] = process_id
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **kw)
    if backend == "nccl":
        idx = int(os.environ.get("LOCAL_RANK",
                                 dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(idx)
        return torch.device("cuda", idx)
    return torch.device("cpu")


def make_global_mesh(ici_axes: dict[str, int] | None = None,
                     dcn_axis: str = "data",
                     ranks_per_host: int | None = None) -> Mesh:
    """Host-aware global mesh: hosts form the OUTER ``dcn_axis`` (traffic
    between them crosses the network), each host's ranks fill the inner
    axes ``ici_axes`` (default one ``tile`` axis over the host's ranks).
    Ranks are host-major, as torchrun numbers them. ``ranks_per_host``
    defaults to :func:`local_size`. Pure data parallelism (one all-reduce a
    step) belongs on the outer axis; tile and weight sharding stay inside a
    host. One process: the outer axis has size 1."""
    world, _ = _world()
    n_local = ranks_per_host or local_size()
    n_proc = world // n_local
    ici_axes = dict(ici_axes or {"tile": n_local})
    n_ici = int(np.prod(list(ici_axes.values())))
    if n_ici > n_local:
        raise ValueError(
            f"inner axes need {n_ici} ranks but each host has {n_local}; "
            f"the {dcn_axis} axis must be the only one crossing hosts")
    ranks = np.arange(n_proc * n_local).reshape(n_proc, n_local)[:, :n_ici]
    return _build((dcn_axis,) + tuple(ici_axes),
                  ranks.reshape((n_proc,) + tuple(ici_axes.values())))
