"""nflows_tpu_torch: the PyTorch / CUDA port of nflows_tpu for NVIDIA Hopper.

It mirrors ``nflows_tpu``'s layout and names and imports nothing of it or
of JAX. Plain tensor code is PyTorch; the JAX package's Pallas kernels
become hand-written CUDA kernels in ``ops/cuda`` (sources in ``csrc``),
built with nvcc at first use. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from nflows_tpu_torch.version import VERSION, __version__

from nflows_tpu_torch import distributions, flows, models, training, transforms, utils
from nflows_tpu_torch.distributions.mixture import MADEMoG
from nflows_tpu_torch.flows.autoregressive import MaskedAutoregressiveFlow
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.interop import load_jax_params, load_jax_trainer_weights
from nflows_tpu_torch.models.iaf import InverseAutoregressiveFlow
from nflows_tpu_torch.models.nsf import NeuralSplineFlow
from nflows_tpu_torch.models.nsf_ar import NeuralSplineFlowAR
from nflows_tpu_torch.nn.nde import MixtureOfGaussiansMADE
from nflows_tpu_torch.serving import CompiledFlow

from nflows_tpu_torch.training import (
    TrainState,
    create_train_state,
    fused_trainer,
    make_train_step,
    nll_loss,
)

__all__ = ["VERSION", "__version__", "distributions", "flows", "models",
           "training", "transforms", "utils", "Flow", "NeuralSplineFlow",
           "NeuralSplineFlowAR", "MaskedAutoregressiveFlow",
           "InverseAutoregressiveFlow", "MADEMoG", "MixtureOfGaussiansMADE",
           "CompiledFlow", "load_jax_params", "load_jax_trainer_weights",
           "TrainState", "create_train_state", "make_train_step", "nll_loss",
           "fused_trainer"]
