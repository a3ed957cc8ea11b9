"""Helpers: masks, shape utilities and device selection."""

from nflows_tpu_torch.utils import masks, shapes
from nflows_tpu_torch.utils.device import resolve_device

__all__ = ["masks", "shapes", "resolve_device"]
