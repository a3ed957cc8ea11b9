"""Hand-written Hopper kernels (sm_90a) and their Python wrappers.

One wrapper per Pallas file of the JAX package, with the same stem
(``rq_spline.py`` <-> ``ops/pallas/rq_spline.py``); CUDA sources live in
``nflows_tpu_torch/csrc/``. Kernels build at first use (``_build.py``),
never at import, so this package imports on a machine without CUDA.
"""
