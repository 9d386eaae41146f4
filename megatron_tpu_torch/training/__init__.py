"""Training: the step, the optimizer, the schedules and the microbatch
calculator (megatron_tpu/training); the loop and the checkpoints are the
submodules `loop` and `checkpointing`."""
from megatron_tpu_torch.training.microbatches import MicrobatchCalculator
from megatron_tpu_torch.training.optimizer import (OptState, ScalerState,
                                                   apply_optimizer,
                                                   init_optimizer,
                                                   weight_decay_mask)
from megatron_tpu_torch.training.scheduler import (learning_rate,
                                                   weight_decay)
from megatron_tpu_torch.training.train_step import (TrainState,
                                                    init_train_state,
                                                    make_train_step,
                                                    state_from_params,
                                                    train_step)

__all__ = ["MicrobatchCalculator", "OptState", "ScalerState",
           "apply_optimizer", "init_optimizer", "weight_decay_mask",
           "learning_rate", "weight_decay", "TrainState", "init_train_state",
           "make_train_step", "state_from_params", "train_step"]
