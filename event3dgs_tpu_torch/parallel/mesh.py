"""The ("data", "gauss") rank grid and this rank's share of it.

Counterpart of ``event3dgs_tpu/parallel/mesh.py``.  A JAX ``Mesh`` lays
devices out on two named axes; here every rank of a ``torch.distributed``
job is one device, and :func:`make_mesh` arranges the job's ranks as a
``[data, gauss]`` grid with the gauss axis innermost (rank = d·K + g, so a
gauss group is a run of consecutive ranks, as in the JAX global mesh).  It
makes one process group per row (the gauss groups) and per column (the
data groups), each with a short timeout, and wraps them in a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names.

Where JAX has shardings, the port has slot ranges: :func:`gauss_sharding`
is this rank's block of the Gaussian capacity, :func:`data_sharding` its
block of a batch sharded over ``data``.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"

# Collectives wait at most this long for a peer: a rank that raised leaves
# its peers blocked in a collective, and they should fail soon after it,
# not after the backends' default half hour.  Long enough for rank 0 to
# write a multi-million-Gaussian checkpoint while the others wait.
GROUP_TIMEOUT = timedelta(seconds=300)


def mesh_shape(n: int, data: int | None = None,
               gauss: int | None = None) -> tuple[int, int]:
    """The (data, gauss) factors of ``n`` ranks, by the JAX rules: all on
    ``data`` by default, a missing factor filled in from the other."""
    if data is None and gauss is None:
        data, gauss = n, 1
    elif data is None:
        data = n // gauss
    elif gauss is None:
        gauss = n // data
    if data * gauss != n:
        raise ValueError(f"mesh {data}x{gauss} != {n} devices")
    return data, gauss


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data × gauss) grid."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data_group: object  # ProcessGroup of this rank's column (same slots)
    gauss_group: object  # ProcessGroup of this rank's row (same views' group)
    data: int
    gauss: int
    data_rank: int
    gauss_rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, GAUSS_AXIS: self.gauss}

    @property
    def rank(self) -> int:
        """The flat (data-major) slot of this rank: d·K + g."""
        return self.data_rank * self.gauss + self.gauss_rank


def default_device() -> torch.device:
    """This rank's device: its current CUDA card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    gauss: int | None = None,
    device: torch.device | None = None,
    timeout: timedelta = GROUP_TIMEOUT,
) -> Mesh:
    """Build a ("data", "gauss") mesh over the job's ranks.

    Defaults: every rank on ``data`` (pure view-parallelism), the
    degenerate 1×1 mesh at world size 1.  Pass factors to split (e.g.
    ``data=2, gauss=4`` on 8 ranks).  Every rank of the job calls it, in
    the same order as its other process groups.
    """
    world = dist.get_world_size()
    n = n_devices or world
    data, gauss = mesh_shape(n, data, gauss)
    if n != world:
        raise ValueError(f"mesh {data}x{gauss} needs all {world} ranks of "
                         f"the job, got n_devices={n}")
    me = dist.get_rank()
    grid = torch.arange(world).reshape(data, gauss)
    # every rank creates every group, in the same order
    rows = [dist.new_group(grid[d].tolist(), timeout=timeout)
            for d in range(data)]
    cols = [dist.new_group(grid[:, g].tolist(), timeout=timeout)
            for g in range(gauss)]
    d, g = divmod(me, gauss)
    dev = device if device is not None else default_device()
    device_mesh = DeviceMesh.from_group(
        [cols[g], rows[d]], dev.type, mesh=grid,
        mesh_dim_names=(DATA_AXIS, GAUSS_AXIS))
    return Mesh(device_mesh=device_mesh, data_group=cols[g],
                gauss_group=rows[d], data=data, gauss=gauss, data_rank=d,
                gauss_rank=g, device=dev)


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by {parts} shards")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's block of a leading axis of ``n`` sharded over ``data``."""
    return _block(n, mesh.data, mesh.data_rank, "batch")


def gauss_sharding(mesh: Mesh, capacity: int) -> slice:
    """This rank's slot range of a capacity dimension sharded over
    ``gauss``."""
    return _block(capacity, mesh.gauss, mesh.gauss_rank, "capacity")

