"""Version info (counterpart of nflows_tpu/version.py)."""

__version__ = "0.1.0"
VERSION = __version__
