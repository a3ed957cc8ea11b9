"""Selection of the fused trainer (counterpart of
nflows_tpu/training/fused.py).

``fused_trainer(flow, batch_size)`` probes the flow's structure and returns
the matching trainer: :class:`FusedNSFTrainer` for coupling chains of any
of the seven families (the rq, lrs, linear, quadratic and cubic splines,
the affine and additive couplings; the NSF and SimpleRealNVP among them;
with or without a context, but no embedding net; kernel B3, or B2 + B4
under autograd),
:class:`FusedMAFTrainer` for unwrapped autoregressive chains, MAF and
NSF-AR, with or without a context (kernels B9 + B10),
:class:`FusedIAFTrainer` for all-wrapped ones, an IAF, trained by reverse
KL in its sampling direction (B9 + B10, ``make_vi_train_step``),
:class:`FusedMADEMoGTrainer` for a MADEMoG or a bare
MixtureOfGaussiansMADE (kernels B11 + B12), probed in that order. A model
that matches no kernel raises with every prober's reason (or gives ``None``
with ``required=False``), and ``training.make_train_step`` (the eager
route) is then the path.
"""

from __future__ import annotations

__all__ = ["fused_trainer", "MIN_AUTO_BATCH"]

# Smallest batch at which the fused step was faster than the eager step, by
# family; None: never at a measured batch. Measured by chip_smoke.py with
# Adam, as the wall time of a step on one NVIDIA H100 80GB HBM3 with a
# 700.00 W power limit. Another card needs its own measurement.
# - "nsf", the flagship NSF (features 6, hidden 256, 10 layers, 8 bins):
#   fused 3.48, 3.54 and 3.66 ms against eager 70.6, 92.1 and 77.1 ms at
#   batches 512, 2,048 and 4,096 (the eager step is host-bound, its device
#   work 7.0 to 11.4 ms). The same family key covers RealNVP and NICE (B3
#   runs their affine and additive stages): SimpleRealNVP at the same widths
#   (10 affine couplings, final-layer weights x 0.1) fused 3.26, 3.33 and
#   3.37 ms against eager 30.6, 41.4 and 34.1 ms; and the LRS NSF and the
#   flagship's chain with linear, quadratic or cubic couplings: fused 3.35
#   to 3.61, 3.43 to 3.68 and 3.49 to 3.83 ms against eager 67 to 154, 71
#   to 165 and 78 to 153 ms.
# - "maf", the full-width MAF (features 10, hidden 256, 5 layers x 2 blocks):
#   fused (B9 forward, B10 backward, mask fold, Adam) 2.27, 2.31 and 2.34 ms
#   against eager 7.51, 8.21 and 7.57 ms at batches 512, 2,048 and 4,096;
#   three other runs read the eager step at 15.4 to 22.9 ms (it is
#   host-bound, its device work 1.5 to 2.3 ms) and the fused one at 2.30 to
#   2.89 ms.
# - "iaf", the full-width IAF (features 10, hidden 256, 5 layers x 2
#   blocks) trained by reverse KL against a 10-D correlated Gaussian: fused
#   (B9 sampling pass, B10 its backward, mask fold, Adam) 4.08, 3.88 and
#   5.35 ms against eager (autograd through the unfused sampling pass)
#   23.1, 24.6 and 22.2 ms at batches 512, 2,048 and 4,096; a second run
#   read fused 2.81, 2.85 and 2.77 ms against eager 15.5, 15.1 and 15.3 ms.
#   Both are host-bound (2.2-2.4 ms of device work fused, 1.6-2.4 eager).
# - "mademog", the full-width MixtureOfGaussiansMADE (features 10, hidden
#   256, 2 blocks, 10 components): fused (B11 forward, B12 backward, mask
#   fold, Adam) 1.90, 1.86 and 2.00 ms against eager 4.33, 3.68 and 4.06 ms
#   at batches 512, 2,048 and 4,096; its conditional twin (context 10) 2.59,
#   2.68 and 2.32 against 5.02, 5.07 and 5.14 ms. Both routes are host-bound
#   here (0.67 to 0.83 ms of device work fused, 0.42 to 0.76 eager).
# The fused step won at every measured batch in all four families, so each
# floor is the smallest batch the trainers take.
MIN_AUTO_BATCH = {
    "nsf": 128,
    "maf": 128,
    "iaf": 128,
    "mademog": 128,
}


def fused_trainer(flow, batch_size, required=None, auto=False):
    """Return the fused trainer matching ``flow``'s structure.

    Args:
        flow: a ``Flow`` over a StandardNormal base, or a MADEMoG /
            MixtureOfGaussiansMADE.
        batch_size: training batch size (a multiple of 128, as in the JAX
            package).
        required: when False, return ``None`` instead of raising if no
            kernel matches. Defaults to ``not auto``.
        auto: when True, also return ``None`` when the measured crossover
            (:data:`MIN_AUTO_BATCH`) says the eager route is faster at this
            batch size.
    """
    from nflows_tpu_torch.ops.cuda.mademog_train import FusedMADEMoGTrainer
    from nflows_tpu_torch.ops.cuda.maf_train import FusedIAFTrainer, FusedMAFTrainer
    from nflows_tpu_torch.ops.cuda.nsf_train import FusedNSFTrainer

    if required is None:
        required = not auto
    if batch_size % 128:
        raise ValueError(
            f"batch_size={batch_size} must be a multiple of 128 (the kernel "
            "lane width of the JAX package, kept so that one call behaves "
            "the same in both)")
    errors = []
    for cls, family in ((FusedNSFTrainer, "nsf"), (FusedMAFTrainer, "maf"),
                        (FusedIAFTrainer, "iaf"), (FusedMADEMoGTrainer, "mademog")):
        try:
            trainer = cls(flow, batch_size=batch_size)
        except (ValueError, AttributeError) as e:
            errors.append(f"{cls.__name__}: {e}")
            continue
        if auto:
            floor = MIN_AUTO_BATCH[family]
            if floor is None or batch_size < floor:
                return None
        return trainer
    if not required:
        return None
    raise ValueError(
        "this flow matches no fused training kernel -- train it on the "
        "eager route (training.make_train_step). Prober reasons:\n  "
        + "\n  ".join(errors))
