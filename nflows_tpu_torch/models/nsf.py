"""Neural Spline Flow prebuilt: the flagship model (counterpart of
nflows_tpu/models/nsf.py).

``num_layers`` x [random feature permutation, spline coupling with a
ResidualNet conditioner (alternating masks)], StandardNormal base
(Durkan et al. 2019, arXiv:1906.04032). RQ splines by default, or the
linear-rational family (``spline="lrs"``, beyond the reference).

The chain is always unrolled. ``stacked`` is accepted for the JAX
package's signature; it only decides, as there, whether odd feature counts
pin the mask parity, so one set of arguments builds the same model in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nflows_tpu_torch.distributions.normal import StandardNormal
from nflows_tpu_torch.flows.base import Flow
from nflows_tpu_torch.nn import nets
from nflows_tpu_torch.nn.primitives import default_generator
from nflows_tpu_torch.transforms.base import CompositeTransform
from nflows_tpu_torch.transforms.coupling import (
    PiecewiseLinearRationalCouplingTransform,
    PiecewiseRationalQuadraticCouplingTransform,
)
from nflows_tpu_torch.transforms.permutations import (
    RandomPermutation,
    ReversePermutation,
)
from nflows_tpu_torch.utils.device import resolve_device
from nflows_tpu_torch.utils.masks import create_alternating_binary_mask

__all__ = ["NeuralSplineFlow"]


class NeuralSplineFlow(Flow):
    """NSF (coupling) for tabular data: RQ splines (``spline="rq"``) or the
    linear-rational family (``spline="lrs"``).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; None =
    fresh seed) and permutations from the numpy ``rng`` (None = derived from
    the generator's seed). The model lives on ``device``: ``cuda`` by
    default, which must exist; pass ``device="cpu"`` for the CPU.
    """

    STACKED_MAX_HIDDEN = 384

    def __init__(self, features, hidden_features, num_layers=10,
                 num_blocks_per_layer=2, num_bins=8, tail_bound=3.0,
                 context_features=None, use_random_permutations=True,
                 generator=None, activation=F.relu, dropout_probability=0.0,
                 batch_norm_within_layers=False, rng=None, spline="rq",
                 stacked=None, device=None):
        device = resolve_device(device)
        couplings = {"rq": PiecewiseRationalQuadraticCouplingTransform,
                     "lrs": PiecewiseLinearRationalCouplingTransform}
        if spline not in couplings:
            raise ValueError(f"spline must be 'rq' or 'lrs', got {spline!r}")
        generator = default_generator(generator)
        if rng is None:
            rng = np.random.default_rng(generator.initial_seed())
        if stacked is None:
            stacked = (hidden_features <= self.STACKED_MAX_HIDDEN
                       and (features % 2 == 0 or use_random_permutations))
        # the JAX package's stacked layout pins the mask parity at odd
        # feature counts (nflows_tpu/models/nsf.py:61-75); copy the rule
        fixed_parity = stacked and features % 2 == 1
        if fixed_parity and not use_random_permutations:
            raise ValueError(
                "stacked=True with an odd feature count requires "
                "use_random_permutations=True: reversal preserves index "
                "parity at odd d, so a fixed checkerboard mask would keep "
                "the same features on the identity side in every layer.")

        def create_net(in_f, out_f):
            return nets.ResidualNet(
                in_f, out_f, hidden_features=hidden_features,
                context_features=context_features,
                num_blocks=num_blocks_per_layer, generator=generator,
                activation=activation, dropout_probability=dropout_probability,
                use_batch_norm=batch_norm_within_layers, device=device)

        layers = []
        for i in range(num_layers):
            if use_random_permutations:
                layers.append(RandomPermutation(features, rng=rng, device=device))
            else:
                layers.append(ReversePermutation(features, device=device))
            layers.append(couplings[spline](
                mask=create_alternating_binary_mask(
                    features, even=False if fixed_parity else bool(i % 2)),
                transform_net_create_fn=create_net,
                num_bins=num_bins, tails="linear", tail_bound=tail_bound,
                device=device))

        super().__init__(transform=CompositeTransform(layers),
                         distribution=StandardNormal([features]))
        self.to(device)

    def fused(self, dtype=None):
        """Inference view of this flow on the whole-chain kernel B2
        (``ops/cuda/nsf_fused.FusedNSF``): ``sample`` / ``log_prob`` /
        ``sample_and_log_prob`` / ``forward`` / ``inverse`` each run the
        entire transform chain as one launch on the card (B2's plain
        version on the CPU).

        ``dtype`` is the conditioner GEMM precision: torch.float32 (the
        port's default) or torch.bfloat16 (the JAX package's default, its
        documented deployment), as ``fuse_nsf`` takes it."""
        from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
        return fuse_nsf(self, dtype=torch.float32 if dtype is None else dtype)
