"""Multi-process bootstrap: ``torch.distributed`` wiring and host-aware
view batches.

Counterpart of ``event3dgs_tpu/parallel/distributed.py``.  JAX runs one
process per host, each driving all of its local devices.  The port keeps
that meaning of a *process* (a host, ``--process_id`` of
``--num_processes``) but gives every device a rank of its own: a host
starts one rank per local card (or, on the CPU, per local share of the
mesh) with :func:`spawn_ranks`, and rank = process_id · local_ranks +
local_rank.  :func:`init_distributed` joins a rank to the job: NCCL for
CUDA ranks (one card each, ``cuda:<local rank>``), gloo for CPU ranks,
rendezvous at the coordinator (``host:port``, or a ``tcp://`` or
``file://`` URL), and a short timeout so a rank that fails does not leave
its peers blocked for the backends' default half hour.

JAX's ``host_local_to_global`` has no counterpart: each rank owns its
tensors, and a collective over a process group replaces an array that
spans hosts.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from event3dgs_tpu_torch.parallel.collectives import gather
from event3dgs_tpu_torch.parallel.mesh import GROUP_TIMEOUT, Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """Where this rank sits in the job."""

    rank: int
    world_size: int
    local_rank: int
    local_ranks: int  # ranks per host (process)
    device: torch.device

    @property
    def process_id(self) -> int:
        return self.rank // self.local_ranks


def init_method(coordinator_address: str) -> str:
    """A ``torch.distributed`` init URL: ``host:port`` becomes TCP."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init_distributed(
    coordinator_address: str,
    num_processes: int = 1,
    process_id: int = 0,
    local_ranks: int = 1,
    local_rank: int = 0,
    device: str = "cuda",
    timeout: timedelta = GROUP_TIMEOUT,
) -> RankInfo:
    """Join this rank to the job (every rank of every process calls it).

    ``device="cuda"`` binds the rank to ``cuda:<local_rank>`` and uses
    NCCL; ``"cpu"`` uses gloo.  Idempotent: a second call returns the
    rank's place without joining again.
    """
    if device == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    world = num_processes * local_ranks
    rank = process_id * local_ranks + local_rank
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method(coordinator_address),
            world_size=world, rank=rank, timeout=timeout)
    return RankInfo(rank=dist.get_rank(), world_size=dist.get_world_size(),
                    local_rank=local_rank, local_ranks=local_ranks, device=dev)


def _run_rank(local_rank, fn, args, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    fn(local_rank, *args)


def spawn_ranks(fn, args=(), nprocs: int = 1, timeout: float | None = None,
                threads_per_rank: int | None = None) -> None:
    """Start ``nprocs`` local ranks as spawned processes running
    ``fn(local_rank, *args)`` and wait for all of them.

    ``fn`` must be importable by module path (spawn re-imports it).  A rank
    that raises ends the others and re-raises here; past ``timeout``
    seconds every rank is ended and ``TimeoutError`` raised.
    ``threads_per_rank`` sets each rank's intra-op threads (CPU ranks
    sharing a host).
    """
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_run_rank, args=(fn, args, threads_per_rank),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # join() returns False while some ranks still run, and raises
        # (ending the others) when one failed
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def make_global_mesh(data: int | None = None, gauss: int | None = None,
                     device: torch.device | None = None) -> Mesh:
    """A ("data", "gauss") mesh over the job's global ranks.

    Ranks are process-major, so with the default factorization a host's
    ranks form consecutive data ranks; the gauss axis is innermost, so a
    gauss group stays on one host whenever ``gauss`` divides the ranks per
    host (its exchanges then ride the host's NVLink).
    """
    return make_mesh(dist.get_world_size(), data, gauss, device=device)


def process_data_ranks(mesh: Mesh, info: RankInfo) -> list[int]:
    """The data ranks with a rank on this rank's host (process)."""
    host = range(info.process_id * info.local_ranks,
                 (info.process_id + 1) * info.local_ranks)
    return sorted({r // mesh.gauss for r in host})


def process_view_slots(mesh: Mesh, info: RankInfo) -> list[int]:
    """The flat (data, gauss) view slots of this rank's host.  Under the
    exact strategy every rank renders its own view and its slot is its
    rank (d·K + g), so a host's slots are its ranks."""
    return list(range(info.process_id * info.local_ranks,
                      (info.process_id + 1) * info.local_ranks))


def make_global_view_batch(mesh: Mesh, info: RankInfo, local_indices,
                           gauss_mode: str = "exact") -> list[int]:
    """The global [B] view batch from each host's own indices (collective:
    every rank calls it).

    Exact strategy: ``local_indices`` holds one view per slot of
    :func:`process_view_slots`; partials: one per data rank of
    :func:`process_data_ranks`.  Every rank gets the whole batch.
    """
    local = np.asarray(local_indices, np.int64)
    if gauss_mode == "exact":
        mine = local[process_view_slots(mesh, info).index(mesh.rank)]
    else:
        mine = local[process_data_ranks(mesh, info).index(mesh.data_rank)]
    world = gather(torch.tensor([mine], dtype=torch.int64, device=mesh.device),
                   dist.group.WORLD)[:, 0].tolist()
    return world if gauss_mode == "exact" else world[::mesh.gauss]
