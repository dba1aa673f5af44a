"""Multi-GPU training over a (data × gauss) rank grid on ``torch.distributed``.

Counterpart of ``event3dgs_tpu/parallel``:

- mesh axes ``("data", "gauss")``: views shard over ``data``, Gaussian
  storage (parameters, optimizer state, densify stats) over ``gauss``, so
  every rank holds O(N/K) state, never O(N);
- two gauss-axis compositing strategies: ``exact`` (default) exchanges
  per-view projected splats with one all_to_all so every rank rasterizes
  the full set for its own view in the global per-view depth order;
  ``partials`` has each rank rasterize its own Gaussians into (rgb, log T)
  partials merged in per-view shard rank order (approximate on orbits);
- ``collectives`` holds the collectives the step differentiates through,
  with their backward rules; ``distributed`` joins ranks to a job (NCCL on
  cards, gloo on the CPU) and spawns a host's ranks.
"""

from event3dgs_tpu_torch.parallel.compose import merge_depth_partials, view_depth_ranks
from event3dgs_tpu_torch.parallel.exchange import render_view_exchange
from event3dgs_tpu_torch.parallel.mesh import data_sharding, gauss_sharding, make_mesh
from event3dgs_tpu_torch.parallel.partition import repartition_by_depth
from event3dgs_tpu_torch.parallel.sharded_train import (
    make_sharded_train_step,
    shard_train_state,
    state_partition_specs,
    unshard_state,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "gauss_sharding",
    "make_sharded_train_step",
    "merge_depth_partials",
    "render_view_exchange",
    "repartition_by_depth",
    "shard_train_state",
    "state_partition_specs",
    "unshard_state",
    "view_depth_ranks",
]
