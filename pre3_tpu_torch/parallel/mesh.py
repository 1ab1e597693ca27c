"""Process meshes and the collectives the parallel modules use.

Port of ``pre3_tpu/parallel/mesh.py``. The reference is SPMD inside one
process over a JAX ``Mesh`` of devices; the port is SPMD over processes,
one rank per device, with explicit collectives on ``torch.distributed``
process groups (NCCL between GPUs, gloo on the CPU or for ranks that
share a GPU). Axes used across the engine:

  "hyp"  — RANSAC hypothesis batch (data parallelism over hypotheses)
  "lm"   — landmark blocks (map sharding for the BA backend)
  "blk"  — keyframe blocks (pose-sharded BA)
  "frame" — frames of a chunk (the sharded frontend)

A ``Mesh`` carries, for each axis, its size, this rank's index along it,
its process group and the global ranks along it, plus the rank's device
and a ``CommLog`` of the collectives run on it. Without an initialized
process group the world is this one process: every axis has size 1 and
every collective is a local copy.

The collectives map the reference's as follows:

  psum(x)               → all_reduce(SUM) in place (``psum_``)
  all_gather(tiled)     → all_gather_into_tensor
  ppermute(x, perm)     → one batch_isend_irecv per permutation

Ranks that share a GPU run a gloo group. gloo's all_reduce, all_gather
and broadcast take CUDA tensors, but its send/recv take CPU tensors only:
on an H100 host (torch 2.11, two ranks) a send of a CUDA tensor failed
with "writev: Bad address" (the TCP transport handed the device pointer
to the socket) and aborted the process. So ppermute over gloo copies a
CUDA slab to the host and back; the choice follows the group's backend
name, never a caught error.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.distributed as dist


class CommLog:
    """Count and bytes of the collectives run on a mesh, per (operation,
    transport): "nccl", "gloo" (CPU tensors), "gloo-cuda" (CUDA tensors
    handed to gloo), "gloo-host" (CUDA slabs copied to the host for
    gloo's send/recv and back) or "local" (no other rank: a copy)."""

    def __init__(self) -> None:
        self.ops: dict[tuple[str, str], list[int]] = {}
        self._tape: list | None = None

    def record(self, op: str, nbytes: int, transport: str) -> None:
        if self._tape is not None:
            self._tape.append((op, nbytes, transport))
            return
        entry = self.ops.setdefault((op, transport), [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)

    @contextlib.contextmanager
    def taping(self):
        """Records made inside the block go to the yielded list (a tape),
        not to the log: what one run of a captured body issues, which
        ``extend`` logs once per replay."""
        prev, self._tape = self._tape, []
        try:
            yield self._tape
        finally:
            self._tape = prev

    def extend(self, tape: list) -> None:
        for rec in tape:
            self.record(*rec)

    def take(self) -> dict[str, dict[str, int]]:
        """The record so far as {"op/transport": {"count", "bytes"}}, and
        a fresh start."""
        out = {f"{op}/{tr}": {"count": c, "bytes": b}
               for (op, tr), (c, b) in sorted(self.ops.items())}
        self.ops = {}
        return out


class Axis(NamedTuple):
    size: int
    rank: int  # this process's index along the axis
    group: object  # ProcessGroup, or None when the axis is this process
    ranks: tuple[int, ...]  # global ranks along the axis, in axis order


@dataclass(eq=False)
class Mesh:
    axis_names: tuple[str, ...]
    axes: dict[str, Axis]
    device: torch.device
    group: object  # the group over every rank of the mesh (None: one)
    ranks: tuple[int, ...]  # every global rank of the mesh
    comm: CommLog = field(default_factory=CommLog)

    @property
    def shape(self) -> dict[str, int]:
        return {a: self.axes[a].size for a in self.axis_names}

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.axes[a].size
        return n

    def axis(self, name: str | None = None) -> Axis:
        return self.axes[name or self.axis_names[0]]


def world() -> tuple[int, int]:
    """(world size, this process's rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _new_group(ranks: list[int], n_world: int):
    """The process group over ``ranks``: the world group when they are
    the whole world. Every rank of the world must call this, in the same
    order, for every group (dist.new_group is collective)."""
    if n_world == 1:
        return None if not dist.is_initialized() else dist.group.WORLD
    if list(ranks) == list(range(n_world)):
        return dist.group.WORLD
    return dist.new_group(ranks=list(ranks))


def make_mesh(n_devices: int | None = None, axis: str = "hyp",
              device="cuda") -> Mesh | None:
    """A 1-axis mesh over the first ``n_devices`` ranks (all by default).

    Raises when fewer ranks exist than requested: silently truncating
    lets "multi-device" validation degrade to a 1-rank mesh that runs no
    collective. A submesh of fewer ranks than the world is a new process
    group; every rank of the world must call this (the group's creation
    is collective), and ranks outside the submesh get None."""
    n_world, rank = world()
    n = n_world if n_devices is None else n_devices
    if n_world < n:
        raise ValueError(
            f"make_mesh({n_devices}) but only {n_world} rank(s) exist; "
            f"start more processes or request fewer")
    ranks = tuple(range(n))
    group = _new_group(list(ranks), n_world)
    if rank >= n:
        return None
    return Mesh((axis,), {axis: Axis(n, rank, group, ranks)},
                _resolve_device(device), group, ranks)


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: str | None = None
                ) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s leading axis (the
    reference's P(axis) sharding); the leading axis must divide."""
    ax = mesh.axis(axis)
    b = x.shape[0]
    if b % ax.size:
        raise ValueError(f"shard_batch: leading axis {b} does not divide "
                         f"over {ax.size} ranks")
    per = b // ax.size
    return x[ax.rank * per:(ax.rank + 1) * per]


def replicated(mesh: Mesh, x: torch.Tensor, axis: str | None = None
               ) -> torch.Tensor:
    """The shards of ``shard_batch`` gathered back on every rank."""
    return all_gather(mesh, x, axis)


def _transport(mesh: Mesh, op: str, group, x: torch.Tensor) -> str:
    """The transport of a collective on ``x``, recorded in the log."""
    if group is None:
        transport = "local"
    else:
        transport = dist.get_backend(group)
        if transport == "gloo" and x.device.type == "cuda":
            transport = "gloo-host" if op == "ppermute" else "gloo-cuda"
    mesh.comm.record(op, x.numel() * x.element_size(), transport)
    return transport


def psum_(mesh: Mesh, x: torch.Tensor, axis: str | None = None
          ) -> torch.Tensor:
    """Sum of ``x`` over the axis' ranks (all_reduce SUM), in place on
    ``x`` (a program's buffer) on every rank. gloo's CUDA all-reduce
    waits for the current stream before it reads ``x`` and makes the
    current stream wait for its result."""
    ax = mesh.axis(axis)
    _transport(mesh, "all_reduce", ax.group, x)
    if ax.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group)
    return x


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str | None = None
               ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in axis order (the
    reference's ``all_gather(..., tiled=True)``)."""
    ax = mesh.axis(axis)
    if x.dtype == torch.bool:  # gathered as bytes on every backend
        return all_gather(mesh, x.to(torch.uint8), axis).to(torch.bool)
    _transport(mesh, "all_gather", ax.group, x)
    if ax.group is None:
        return x
    src = x.contiguous()
    out = torch.empty((ax.size * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=ax.group)
    return out


def broadcast(mesh: Mesh, x: torch.Tensor, src: int = 0,
              axis: str | None = None) -> torch.Tensor:
    """``x`` of the axis' rank ``src`` on every rank of the axis."""
    ax = mesh.axis(axis)
    _transport(mesh, "broadcast", ax.group, x)
    if ax.group is None:
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=ax.ranks[src], group=ax.group)
    return out


def ppermute(mesh: Mesh, x: torch.Tensor, perm: list[tuple[int, int]],
             axis: str | None = None) -> torch.Tensor:
    """``x`` moved along the axis by the permutation ``perm`` of (source,
    destination) axis indices; a rank no pair sends to gets zeros, as in
    the reference. A pair (i, i) is a local copy, never a send to self.
    One ``batch_isend_irecv`` per call: callers issue one permutation per
    call, in the same order on every rank, so that at two ranks (left
    and right neighbour the same rank) no two permutations' messages can
    match each other."""
    ax = mesh.axis(axis)
    me = ax.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    if dst == [me] and src == [me]:
        mesh.comm.record("ppermute", x.numel() * x.element_size(), "local")
        return x.clone()
    transport = _transport(mesh, "ppermute", ax.group, x)
    send = x.cpu() if transport == "gloo-host" else x
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, ax.ranks[d], ax.group) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, ax.ranks[s], ax.group) for s in src]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device)
