"""Quantization of the port (counterpart of ``paddle_tpu.quantization``):
QAT and PTQ over the module tree, for the port's ``nn.Linear``.

``per_channel_int8`` (``base.py``) is the quantizer the serving
artifacts share. The conv wrappers wait for ``nn.Conv2D`` (ROADMAP
Queue 1, item 9): ``QuantedConv2D`` raises ``NotImplementedError``.
"""

from .base import BaseObserver, BaseQuanter  # noqa: F401
from .config import (  # noqa: F401
    DEFAULT_QAT_LAYER_MAPPINGS,
    QuantConfig,
    SingleLayerConfig,
)
from .factory import ObserverFactory, QuanterFactory  # noqa: F401
from .ptq import PTQ  # noqa: F401
from .qat import QAT, UncalibratedQuanterError  # noqa: F401
from .quantize import Quantization  # noqa: F401
from .wrapper import (  # noqa: F401
    Int8InferenceLinear,
    ObserveWrapper,
    QuantedConv2D,
    QuantedLinear,
)
from . import observers, quanters  # noqa: F401

__all__ = [
    "QuantConfig", "SingleLayerConfig", "QAT", "PTQ", "Quantization",
    "UncalibratedQuanterError",
    "BaseQuanter", "BaseObserver", "QuanterFactory", "ObserverFactory",
    "ObserveWrapper", "QuantedLinear", "QuantedConv2D",
    "Int8InferenceLinear", "observers", "quanters",
]


def quanter(name):
    """Class decorator registering a custom quanter factory: creates a
    ``<name>`` QuanterFactory bound to the decorated BaseQuanter subclass.
    The factory is a module-level QuanterFactory subclass, so configured
    instances stay picklable."""
    def deco(cls):
        import sys

        from .factory import QuanterFactory

        mod = sys.modules[__name__]
        factory = type(name, (QuanterFactory,),
                       {"_get_class": lambda self, _cls=cls: _cls,
                        "__module__": __name__})
        setattr(mod, name, factory)
        if name not in __all__:
            __all__.append(name)
        return cls

    return deco


__all__.append("quanter")
