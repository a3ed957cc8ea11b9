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
there and [out, in] here. A mask of the degree rule is only compared, and
one that differs is refused (the two models would not be the same
autoregressive function). A MADE built with random masks draws its hidden
degrees from an unseeded numpy generator in both packages, so its masks
are copied in: first the chain of incoming masks is checked to be still
autoregressive (through every path of the network, output feature i
reaches only inputs before i), then the masks are written and each random
layer's ``degrees`` set to the smallest that give its mask.

A MixtureOfGaussiansMADE carries as a MADE does; a MADEMoG's keys start
with ``.made.``, its attribute in both packages. A conditional ResidualNet
carries its context columns inside the initial layer's weight and its
blocks' ``context_layer``s, and a ``ConditionalDiagonalNormal``'s encoder,
a ``DiagonalNormal``'s ``mean_`` and ``log_std_`` and a flow's
``embedding_net`` carry by the same rule.

The learned CDFs (``transforms/nonlinearities.py``) keep the JAX leaf
names, one row a feature, and carry untransposed; a learned ``Sigmoid``
temperature is a [1] parameter, a fixed one no leaf in either package. The
UMNN integrand nets' layers are ``Dense`` (``nn.Linear``) and transpose as
any other; a UMNN transform's MADE carries as any MADE; the quadrature's
nodes and weights are constants of the step count, non-persistent buffers
here and no leaves there. The loader needed no change for them.

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


def _connectivity(made, masks) -> np.ndarray:
    """[outputs, inputs] > 0 where some path of ``made`` (a MADE) joins an
    output to an input, for the [out, in] ``masks`` keyed by layer name; a
    residual block adds its skip path."""
    from nflows_tpu_torch.nn.made import MaskedResidualBlock

    def mask(layer):
        return (masks[layer] != 0).astype(np.int64)

    reach = mask(made.initial_layer)
    for block in made.blocks:
        if isinstance(block, MaskedResidualBlock):
            inner = mask(block.linear_1) @ mask(block.linear_0)
            reach = reach + inner @ reach
        else:
            reach = mask(block.linear) @ reach
        reach = np.minimum(reach, 1)
    return mask(made.final_layer) @ reach


def _check_autoregressive(name, made, masks):
    """Refuse masks under which an output of feature i (outputs come in
    contiguous groups a feature) depends on an input i or later."""
    reach = _connectivity(made, masks)
    features = made.features
    feature_of_output = np.arange(reach.shape[0]) // (reach.shape[0] // features)
    later = np.arange(features)[None, :] >= feature_of_output[:, None]
    if np.any((reach > 0) & later):
        raise ValueError(
            f"load_jax_params: the incoming masks of {name or 'the model'} are not "
            "autoregressive: an output depends on its own or a later input")


def _degrees_of(mask, in_degrees):
    """The smallest hidden degrees that give ``mask`` [out, in] by the
    rule out_degree >= in_degree: the largest degree each unit sees (0 for
    a unit that sees none)."""
    seen = np.where(mask != 0, np.asarray(in_degrees)[None, :], 0)
    return tuple(int(d) for d in seen.max(axis=1))


def _set_random_degrees(made):
    """After a load, the degrees of a random-mask MADE's hidden layers as
    their masks now give them (the output layer keeps its rule's)."""
    degrees = np.arange(1, made.features + 1)
    layers = [made.initial_layer] + [b.linear for b in made.blocks]
    for layer in layers:
        if layer.random_mask:
            layer.degrees = _degrees_of(layer.mask.cpu().numpy(), degrees)
        degrees = np.asarray(layer.degrees)


def load_jax_params(module: nn.Module, params: Mapping[str, np.ndarray]) -> None:
    """Write the JAX leaves ``params`` into ``module``'s parameters and
    persistent buffers, in place. Raises on a missing key, an unexpected
    key, a shape mismatch, a degree-rule MADE mask that differs from the
    port's, or random MADE masks that are not autoregressive."""
    from nflows_tpu_torch.nn.made import MADE, MaskedDense

    state = module.state_dict(keep_vars=True)
    linear_weights = {f"{name}.weight" if name else "weight"
                      for name, m in module.named_modules()
                      if isinstance(m, nn.Linear)}
    masks = {f"{name}.mask" if name else "mask"
             for name, m in module.named_modules()
             if isinstance(m, MaskedDense)}
    random_masks = {f"{name}.mask" if name else "mask"
                    for name, m in module.named_modules()
                    if isinstance(m, MaskedDense) and m.random_mask}
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
        if (name in masks and name not in random_masks
                and not np.array_equal(value, target.detach().cpu().numpy())):
            raise ValueError(
                f"load_jax_params: {key} differs from the mask the port built "
                "for this layer: the two models assign degrees differently")
        values[name] = value
    random_mades = [(name, m) for name, m in module.named_modules()
                    if isinstance(m, MADE) and m.initial_layer.random_mask]
    for name, made in random_mades:
        prefix = f"{name}." if name else ""
        layer_masks = {layer: values[f"{prefix}{lname}.mask"]
                       for lname, layer in made.named_modules()
                       if isinstance(layer, MaskedDense)}
        _check_autoregressive(name, made, layer_masks)
    with torch.no_grad():
        for name, value in values.items():
            target = state[name]
            target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))
    for _, made in random_mades:
        _set_random_degrees(made)


def load_jax_trainer_weights(trainer, weights: Mapping[str, np.ndarray]) -> None:
    """Write a JAX fused trainer's kernel-layout weights as numpy arrays
    (``w0``, ``b0``, ``wb``, ``bb``, ``wf``, ``bf`` of ``FusedNSFTrainer``,
    and ``wc0``, ``wcb``, ``bcb`` under a context;
    the flat ``wi``, ``bi``, ``wb``, ``bb``, ``wf``, ``bf`` stacks of
    ``FusedMAFTrainer`` (and ``FusedIAFTrainer``) and of
    ``FusedMADEMoGTrainer``, with ``wci``, ``bci``, ``wcb``, ``bcb`` under
    a context) into the port's
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
