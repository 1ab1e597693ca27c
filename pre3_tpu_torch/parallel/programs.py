"""Step programs whose bodies hold collectives: the sharded BAs' solves.

The reference jits each sharded solve whole: ``shard_map`` puts the
collectives inside one XLA program. Here a solve's body is a schedule, a
list of ``Segment``s (device work on the program's buffers) and
``Collective``s between them (each on program buffers, its result
written into one), and the mesh axis' process group decides how a
``MeshProgram`` runs it (``fuses``):

* no process group (every collective a local copy) or an NCCL group of
  one rank: the whole schedule is one variant, captured as one graph
  with the collectives inside and replayed per run. The warm-up runs the
  collectives first, so NCCL's communicator exists before the capture;
* any other group: each segment is a variant of its own, captured once
  and replayed wherever the schedule repeats it (the conjugate-gradient
  iterations), and the host runs each collective between two replays,
  in place on a program buffer or into one. gloo's collectives run on
  the host (a CUDA tensor's all-reduce goes through pinned host memory),
  which a graph cannot hold; its CUDA collectives wait for the current
  stream before they read and make it wait for their result. NCCL
  across ranks takes this form too: a capture of its point-to-point
  exchanges has not been held against the eager loop on several cards.

On the CPU the same schedule runs eagerly in either form. The segments
hand each other their state through the buffers (``graphs.keep``), so a
variant's warm-up puts every buffer back (``carry="all"``).

Each collective logs itself to the mesh's ``CommLog`` where it runs. A
captured collective runs on every replay but logs only while its body
runs, so a fused variant keeps the records of one run (a tape) and logs
them once per run: the counts and bytes per solve are the eager
schedule's either way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch.distributed as dist

from pre3_tpu_torch.parallel.mesh import Mesh
from pre3_tpu_torch.utils.graphs import StepProgram


class Segment(NamedTuple):
    name: str  # the variant it is captured as when the schedule is split
    fn: Callable[[dict], None]  # device work on the buffers


class Collective(NamedTuple):
    fn: Callable[[dict], None]  # one collective on the buffers


def fuses(mesh: Mesh, axis: str | None = None) -> bool:
    """Whether one graph holds the axis' whole schedule: no process group
    (local copies) or NCCL at one rank (see the module docstring)."""
    ax = mesh.axis(axis)
    return ax.group is None or (
        ax.size == 1 and dist.get_backend(ax.group) == "nccl")


class MeshProgram(StepProgram):
    """A step program whose variants are schedules over a mesh axis (see
    the module docstring). ``fused``: the whole schedule one graph."""

    def __init__(self, name: str, buffers: dict, device, fused: bool) -> None:
        super().__init__(name, buffers, device, carry="all")
        self.fused = fused
        self.tapes: dict = {}  # fused variant → its collectives' records

    def run_schedule(self, mesh: Mesh, variant: str, items: list) -> None:
        """One run of the schedule ``items`` as ``variant``."""
        if self.fused:
            def body(b, _gens):
                with mesh.comm.taping() as tape:
                    for item in items:
                        item.fn(b)
                self.tapes[variant] = tape

            self.run(variant, body)
            mesh.comm.extend(self.tapes[variant])
            return
        for item in items:
            if isinstance(item, Segment):
                self.run(item.name, lambda b, _gens, fn=item.fn: fn(b))
            else:
                item.fn(self.buffers)
