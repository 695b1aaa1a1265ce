"""Regularizers (a copy of ``paddle_tpu/regularizer.py``; reference:
python/paddle/regularizer.py). Only the decay coefficient matters: the
optimizers read ``_coeff`` and add ``coeff * p`` to the gradient, for
``L1Decay`` too (as ``paddle_tpu``'s updates do, which apply no sign
term)."""

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self._l1 = True

    def __repr__(self):
        return f"L1Decay({self._coeff})"
