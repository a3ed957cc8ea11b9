"""Training: the eager route (autograd through the unfused chain) and the
fused route (kernels B3 and B4 for couplings, B9 and B10 for autoregressive flows,
B11 and B12 for mixture-density models). Counterpart of nflows_tpu/training."""

from nflows_tpu_torch.training.fused import fused_trainer
from nflows_tpu_torch.training.train import (
    TrainState,
    create_train_state,
    make_train_step,
    nll_loss,
)

__all__ = ["TrainState", "create_train_state", "make_train_step", "nll_loss",
           "fused_trainer"]
