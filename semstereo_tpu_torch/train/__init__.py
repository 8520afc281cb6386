"""Training of the port: state, optimizer, the train and eval steps,
checkpoints (``train.checkpoint``) and the epoch loop (``train.trainer``)."""

from semstereo_tpu_torch.train.state import (
    TrainState,
    build_optimizer,
    init_state,
    merge_partial_params,
    set_learning_rate,
)
from semstereo_tpu_torch.train.steps import (
    assemble_train_loss,
    make_eval_step,
    make_grads_fn,
    make_train_step,
    valid_mask,
)

__all__ = [
    "TrainState", "build_optimizer", "init_state", "merge_partial_params", "set_learning_rate",
    "assemble_train_loss", "make_eval_step", "make_grads_fn", "make_train_step", "valid_mask",
]
