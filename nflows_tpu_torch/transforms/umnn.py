"""Unconstrained Monotonic Neural Network transforms (counterpart of
nflows_tpu/transforms/umnn.py; reference
nflows/transforms/UMNN/MonotonicNormalizer.py:11-81, Wehenkel & Louppe,
NeurIPS 2019).

z(x) = integral from 0 to x of f(t, h) dt + h[..., 0], with f a positive
integrand net. The integral is Clenshaw-Curtis quadrature: its nodes and
weights are float32 constants computed in numpy for the step count, so it
is one batched evaluation of the integrand net at ``nb_steps + 1`` points
and a weighted sum. Node 0 is x itself, so the integrand there is the
jacobian dz/dx. The inverse is the reference's 25 bisection halvings on
[-20, 20], then one more forward for the logabsdet.

``h`` is [batch, dim, cond_size]; channel 0 doubles as the additive offset
z0 (zero when ``cond_size`` is 0). All of it is plain PyTorch on the card,
as the JAX package runs it outside any Pallas kernel: the integrand net's
small GEMMs are ``nn.Linear``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nflows_tpu_torch.nn.primitives import Dense, default_generator
from nflows_tpu_torch.transforms.base import Transform

__all__ = ["IntegrandNet", "MonotonicNormalizer",
           "UnconditionalMonotonicTransform", "cc_nodes_weights"]


def cc_nodes_weights(num_steps: int):
    """Clenshaw-Curtis nodes and weights on [-1, 1], num_steps + 1 nodes."""
    N = num_steps
    k = np.arange(N + 1)
    nodes = np.cos(np.pi * k / N)
    weights = np.zeros(N + 1)
    for i in range(N + 1):
        s = 1.0
        for j in range(1, N // 2 + 1):
            b = 1.0 if (2 * j == N) else 2.0
            s -= b * np.cos(2 * j * np.pi * i / N) / (4 * j * j - 1)
        weights[i] = 2.0 / N * s
    weights[0] /= 2.0
    weights[-1] /= 2.0
    return nodes.astype(np.float32), weights.astype(np.float32)


class IntegrandNet(nn.Module):
    """Positive integrand MLP: per dimension [x_d, h_d] -> ELU(.) + 1
    (reference MonotonicNormalizer.py:20-37). ``layers`` are the port's
    ``Dense``."""

    def __init__(self, hidden: Sequence[int], cond_in: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator = default_generator(generator)
        sizes_in = [1 + cond_in] + list(hidden)
        sizes_out = list(hidden) + [1]
        self.layers = nn.ModuleList(
            Dense(i, o, generator=generator, device=device)
            for i, o in zip(sizes_in, sizes_out))

    def forward(self, x, h):
        """x: [..., B, D]; h: [B, D, cond] -> positive integrand values
        [..., B, D]."""
        out = torch.cat([x[..., None], h.expand(*x.shape, h.shape[-1])], dim=-1)
        for layer in self.layers[:-1]:
            out = torch.relu(layer(out))
        out = self.layers[-1](out)
        return (F.elu(out) + 1.0)[..., 0]


class MonotonicNormalizer(nn.Module):
    """Monotone map z(x) = integral_0^x f(t, h) dt + h[..., 0] with f > 0."""

    def __init__(self, integrand_net, cond_size, nb_steps=20, solver="CCParallel",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if isinstance(integrand_net, (list, tuple)):
            self.integrand_net = IntegrandNet(integrand_net, cond_size, generator=generator,
                                              device=device)
        else:
            self.integrand_net = integrand_net
        self.nb_steps = nb_steps
        # CC and CCParallel differ only in the reference's memory strategy;
        # the quadrature here is always the batched form
        self.solver = solver
        nodes, weights = cc_nodes_weights(nb_steps)
        # constants of the step count, not leaves of the JAX model: kept out
        # of the state dict
        self.register_buffer("nodes", torch.from_numpy(nodes).to(device), persistent=False)
        self.register_buffer("weights", torch.from_numpy(weights).to(device),
                             persistent=False)

    def _integrate(self, x0, xT, h):
        """Integral from x0 to xT of f(t, h), elementwise over [B, D], and
        f(xT, h): node 0 is cos(0) = 1, so ts[0] is xT."""
        half_len = (xT - x0) / 2.0
        center = (xT + x0) / 2.0
        ts = center[None] + half_len[None] * self.nodes[:, None, None]   # [S+1, B, D]
        f = self.integrand_net(ts, h)
        return half_len * torch.tensordot(self.weights, f, dims=([0], [0])), f[0]

    def forward(self, x, h, context=None):
        """Returns (z, jac) with jac = f(x, h) = dz/dx (reference
        MonotonicNormalizer.py:49-64)."""
        z0 = h[:, :, 0] if h.shape[-1] > 0 else torch.zeros_like(x)
        integral, f_end = self._integrate(torch.zeros_like(x), x, h)
        return integral + z0, f_end

    def inverse_transform(self, z, h, context=None):
        """25 bisection halvings on [-20, 20] (MonotonicNormalizer.py:66-81)."""
        x_max = torch.ones_like(z) * 20.0
        x_min = -torch.ones_like(z) * 20.0
        for _ in range(25):
            x_middle = (x_max + x_min) / 2.0
            z_middle, _ = self.forward(x_middle, h, context)
            left = (z_middle > z).to(z.dtype)
            right = 1.0 - left
            x_max = left * x_middle + right * x_max
            x_min = right * x_middle + left * x_min
        return (x_max + x_min) / 2.0


class UnconditionalMonotonicTransform(Transform):
    """A MonotonicNormalizer with cond_size 0 as a Transform: the UMNN
    coupling's ``apply_unconditional_transform=True`` map of the identity
    half (reference coupling.py:171-173). One monotone map a feature, no
    conditioning."""

    def __init__(self, features, integrand_net_layers=(50, 50, 50), nb_steps=20,
                 solver="CCParallel", generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.features = features
        self.normalizer = MonotonicNormalizer(
            list(integrand_net_layers), 0, nb_steps=nb_steps, solver=solver,
            generator=generator, device=device)

    @staticmethod
    def _h(x):
        return x.new_zeros(*x.shape, 0)

    def forward(self, inputs, context=None):
        z, jac = self.normalizer.forward(inputs, self._h(inputs))
        return z, torch.log(jac).sum(dim=tuple(range(1, inputs.ndim)))

    def inverse(self, inputs, context=None):
        h = self._h(inputs)
        x = self.normalizer.inverse_transform(inputs, h)
        _, jac = self.normalizer.forward(x, h)
        return x, -torch.log(jac).sum(dim=tuple(range(1, inputs.ndim)))
