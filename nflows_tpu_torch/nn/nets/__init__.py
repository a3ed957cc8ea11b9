"""Conditioner networks (counterpart of nflows_tpu/nn/nets)."""

from nflows_tpu_torch.nn.nets.resnet import ResidualBlock, ResidualNet

__all__ = ["ResidualBlock", "ResidualNet"]
