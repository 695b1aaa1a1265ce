from .abs_max import (  # noqa: F401
    AbsmaxObserver,
    AbsmaxObserverLayer,
    PerChannelAbsmaxObserver,
    PerChannelAbsmaxObserverLayer,
)

__all__ = ["AbsmaxObserver", "AbsmaxObserverLayer",
           "PerChannelAbsmaxObserver", "PerChannelAbsmaxObserverLayer"]
