"""Carry a JAX model's weights into the port's model.

The port never imports JAX. The caller flattens the JAX model into numpy
leaves keyed by their pytree paths, e.g. with
``jax.tree_util.tree_flatten_with_path`` and ``jax.tree_util.keystr``::

    params = {keystr(path): np.asarray(leaf)
              for path, leaf in tree_flatten_with_path(jax_flow)[0]}
    load_jax_params(torch_flow, params)

Keys look like ``.transform.transforms[1].transform_net.initial_layer.weight``;
the port's module tree keeps the JAX attribute names, so a key maps to a
state-dict entry by dropping the leading dot and writing ``[i]`` as ``.i``.
JAX ``Dense`` weights are [in, out] and ``nn.Linear`` weights [out, in], so
those are transposed. The conditioners' output columns are feature-major
in both packages. A ``MaskedDense`` carries its ``mask`` buffer, [in, out]
there and [out, in] here: the port builds its own masks from the degree
rule, so an incoming mask is only compared, and one that differs is
refused (the two models would not be the same autoregressive function).

A MixtureOfGaussiansMADE carries as a MADE does; a MADEMoG's keys start
with ``.made.``, its attribute in both packages.

A ``StackedTransform`` (the JAX package's scan-stacked chain) has to be
unstacked first: build the JAX flow with ``stacked=False``, or walk its
``layers()``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["load_jax_params", "load_jax_trainer_weights"]


def _jax_key_to_name(key: str) -> str:
    """``.a.b[3].c`` -> ``a.b.3.c``."""
    return re.sub(r"\[(\d+)\]", r".\1", key).lstrip(".")


def load_jax_params(module: nn.Module, params: Mapping[str, np.ndarray]) -> None:
    """Write the JAX leaves ``params`` into ``module``'s parameters and
    persistent buffers, in place. Raises on a missing key, an unexpected
    key, a shape mismatch or a MADE mask that differs from the port's."""
    from nflows_tpu_torch.nn.made import MaskedDense

    state = module.state_dict(keep_vars=True)
    linear_weights = {f"{name}.weight" if name else "weight"
                      for name, m in module.named_modules()
                      if isinstance(m, nn.Linear)}
    masks = {f"{name}.mask" if name else "mask"
             for name, m in module.named_modules()
             if isinstance(m, MaskedDense)}
    incoming = {_jax_key_to_name(k): (k, v) for k, v in params.items()}
    missing = sorted(set(state) - set(incoming))
    unexpected = sorted(incoming[n][0] for n in set(incoming) - set(state))
    if missing or unexpected:
        raise KeyError(f"load_jax_params: missing {missing}, unexpected {unexpected}")
    values = {}
    for name, target in state.items():
        key, value = incoming[name]
        value = np.asarray(value)
        transposed = name in linear_weights or name in masks
        if transposed:
            value = value.T
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"load_jax_params: {key} has shape {tuple(np.shape(params[key]))}, "
                f"the port expects {tuple(target.shape)}"
                + (" (transposed)" if transposed else ""))
        if name in masks and not np.array_equal(value, target.detach().cpu().numpy()):
            raise ValueError(
                f"load_jax_params: {key} differs from the mask the port built "
                "for this layer: the two models assign degrees differently "
                "(random masks need the same numpy rng on both sides)")
        values[name] = value
    with torch.no_grad():
        for name, value in values.items():
            target = state[name]
            target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))


def load_jax_trainer_weights(trainer, weights: Mapping[str, np.ndarray]) -> None:
    """Write a JAX fused trainer's kernel-layout weights as numpy arrays
    (``w0``, ``b0``, ``wb``, ``bb``, ``wf``, ``bf`` of ``FusedNSFTrainer``;
    the flat ``wi``, ``bi``, ``wb``, ``bb``, ``wf``, ``bf`` stacks of
    ``FusedMAFTrainer``, and of ``FusedMADEMoGTrainer`` with ``wci``,
    ``bci``, ``wcb``, ``bcb`` under a context) into the port's
    ``trainer.weights``, in place. The two layouts are equal by
    construction, so nothing is transposed; the MADE trainers' masks stay
    the port's own. Raises on a missing key, an
    unexpected key or a shape mismatch."""
    missing = sorted(set(trainer.weights) - set(weights))
    unexpected = sorted(set(weights) - set(trainer.weights))
    if missing or unexpected:
        raise KeyError(
            f"load_jax_trainer_weights: missing {missing}, unexpected {unexpected}")
    values = {k: np.asarray(v) for k, v in weights.items()}
    for k, target in trainer.weights.items():
        if tuple(values[k].shape) != tuple(target.shape):
            raise ValueError(
                f"load_jax_trainer_weights: {k} has shape {tuple(values[k].shape)}, "
                f"the port expects {tuple(target.shape)}")
    with torch.no_grad():
        for k, target in trainer.weights.items():
            target.copy_(torch.from_numpy(np.array(values[k])).to(target.dtype))
