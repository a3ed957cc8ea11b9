"""Core machinery (counterpart of nflows_tpu/core): the ambient generator of
the stochastic layers. The JAX package's ``core/module.py`` (a pytree module
system) has no counterpart: the port's modules are ``torch.nn.Module``."""

from nflows_tpu_torch.core.stochastic import has_stochastic_context, next_generator, stochastic

__all__ = ["stochastic", "next_generator", "has_stochastic_context"]
