"""Process-group setup and the global meshes.

Port of ``pre3_tpu/parallel/distributed.py``: the multi-host entry point
of the engine's scale-out path. Each process is one rank with one device;
``initialize_distributed`` joins the ranks into a ``torch.distributed``
process group (NCCL when the ranks run on GPUs, gloo on the CPU), and the
meshes below span every rank. The landmark-sharded BA reduces only its
[6F, 6F] camera system per Gauss-Newton iteration, so the same code path
serves one rank, one host of N GPUs (``torchrun --nproc-per-node=N``)
and several hosts.

NCCL runs one rank per GPU: it refuses two ranks on one device. Ranks
that share a GPU (more ranks than cards on a host) need a gloo group
(whose send/recv take host tensors, see parallel/mesh.py); the code says
so in an error and never switches backends by itself.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pre3_tpu_torch.parallel.mesh import (
    Axis, Mesh, _new_group, _resolve_device, broadcast, make_mesh, world,
)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
    timeout: timedelta = timedelta(minutes=5),
) -> torch.device:
    """Join this process to the process group and return its device.

    No-op for a single process (the common test and one-card case): with
    no arguments and no ``WORLD_SIZE`` > 1 in the environment nothing is
    initialized. With the arguments given (``coordinator_address`` as
    "host:port") the group is joined over ``tcp://``; with none given and
    ``WORLD_SIZE`` > 1 set, as ``torchrun`` sets it, over ``env://``.
    ``backend`` defaults to NCCL for ``device="cuda"`` and gloo for the
    CPU. ``timeout`` bounds every collective, so that a lost rank fails
    the run instead of hanging it.

    Each rank takes the GPU of its local rank (``LOCAL_RANK``, else its
    rank); with fewer GPUs than local ranks, ranks share GPUs, which only
    gloo allows."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes is None:
        if env_world <= 1:
            return _device_for(device, 0, 1, backend)
        init_method, n, rank = "env://", env_world, int(os.environ["RANK"])
    elif (num_processes or 1) == 1 and coordinator_address is None:
        return _device_for(device, 0, 1, backend)
    else:
        init_method = f"tcp://{coordinator_address}"
        n, rank = num_processes or 1, process_id or 0
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    dev = _device_for(device, local_rank, local_world, backend)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank, timeout=timeout)
    return dev


def _device_for(device: str, local_rank: int, local_world: int,
                backend: str | None) -> torch.device:
    """The rank's device; sets the current CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("initialize_distributed(device='cuda') but no "
                           "CUDA device is visible")
    if local_world > n_cards and (backend or "nccl") == "nccl":
        raise ValueError(
            f"{local_world} ranks on this host but {n_cards} GPU(s): NCCL "
            f"runs one rank per GPU; pass backend='gloo' for ranks that "
            f"share a GPU")
    dev = torch.device("cuda", local_rank % n_cards)
    torch.cuda.set_device(dev)
    return dev


def global_landmark_mesh(axis: str = "lm", device="cuda") -> Mesh:
    """Mesh over every rank of the (possibly multi-host) group, with a
    single landmark-sharding axis: the same code path serves one rank,
    one host of N GPUs and N hosts."""
    return make_mesh(None, axis=axis, device=device)


def globalize_replicated(mesh: Mesh, x) -> torch.Tensor:
    """Identical host data (numpy or a tensor) as a tensor on the rank's
    device. At world size > 1 it is broadcast from the mesh's first rank,
    so that every rank holds the same bits."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    t = t.to(mesh.device)
    if mesh.group is None or mesh.size == 1:
        return t
    whole = Mesh(("all",), {"all": Axis(mesh.size, 0, mesh.group,
                                        mesh.ranks)},
                 mesh.device, mesh.group, mesh.ranks, mesh.comm)
    return broadcast(whole, t, src=0)


def hybrid_mesh(local_size: int | None = None, device="cuda") -> Mesh:
    """2-D mesh (hosts × local ranks) with axes ("lm", "hyp"):
    hypothesis-parallel VO within a host while landmark blocks shard
    across hosts. ``local_size`` (ranks per host) defaults to
    ``LOCAL_WORLD_SIZE`` as torchrun sets it, else one host. Rank r sits
    at (r // local_size, r % local_size); every rank must call this
    (the axis groups are created collectively)."""
    n, rank = world()
    local = local_size or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local:
        raise ValueError(f"hybrid_mesh: {n} ranks do not split into hosts "
                         f"of {local}")
    hosts = n // local
    lm_groups, hyp_groups = {}, {}
    for j in range(local):  # "lm": the same local index on every host
        ranks = tuple(h * local + j for h in range(hosts))
        lm_groups[j] = (ranks, _new_group(list(ranks), n))
    for h in range(hosts):  # "hyp": the ranks of one host
        ranks = tuple(h * local + j for j in range(local))
        hyp_groups[h] = (ranks, _new_group(list(ranks), n))
    h, j = divmod(rank, local)
    axes = {"lm": Axis(hosts, h, lm_groups[j][1], lm_groups[j][0]),
            "hyp": Axis(local, j, hyp_groups[h][1], hyp_groups[h][0])}
    return Mesh(("lm", "hyp"), axes, _resolve_device(device),
                dist.group.WORLD if dist.is_initialized() else None,
                tuple(range(n)))
