"""Quanter/Observer factories (counterpart of
``paddle_tpu/quantization/factory.py``, which imports nothing of jax: a
copy).

A factory is a picklable recipe; ``_instance(layer)`` builds the concrete
quanter module for one host layer, and those instances are what
``PTQ.calibrate`` drives data through. ``_instance`` validates the recipe
eagerly, so a typo'd kwarg fails at ``quantize()`` time, at the
offending layer, instead of as a mid-calibration TypeError.
"""

from __future__ import annotations

import inspect

__all__ = ["QuanterFactory", "ObserverFactory"]


class ObserverFactory:
    def __init__(self, **kwargs):
        self._kwargs = dict(kwargs)

    @property
    def kwargs(self):
        """The recipe (picklable plain dict) this factory stamps
        instances from."""
        return dict(self._kwargs)

    def _get_class(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement _get_class() returning "
            "the observer Layer class this factory instantiates")

    def _instance(self, layer):
        cls = self._get_class()
        # validate the SIGNATURE up front, so only genuine recipe/
        # constructor mismatches wear the "recipe" error — a TypeError
        # raised inside the constructor BODY (validating values, a
        # downstream call) propagates untouched with its real message
        try:
            inspect.signature(cls).bind(layer, **self._kwargs)
        except TypeError as e:
            raise TypeError(
                f"{type(self).__name__} recipe {self._kwargs!r} does not "
                f"match {cls.__name__}'s constructor: {e}") from e
        return cls(layer, **self._kwargs)


class QuanterFactory(ObserverFactory):
    pass
