"""Training engine: state, train step, host-side loop, checkpoints."""

from event3dgs_tpu_torch.train.loop import train_loop
from event3dgs_tpu_torch.train.loop_sharded import train_loop_sharded
from event3dgs_tpu_torch.train.state import SceneData, TrainState, init_train_state
from event3dgs_tpu_torch.train.step import make_densify_step, make_train_step

__all__ = [
    "SceneData",
    "TrainState",
    "init_train_state",
    "make_densify_step",
    "make_train_step",
    "train_loop",
    "train_loop_sharded",
]
