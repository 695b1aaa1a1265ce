from .abs_max import (  # noqa: F401
    FakeQuanterWithAbsMaxObserver,
    FakeQuanterWithAbsMaxObserverLayer,
)

__all__ = ["FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer"]
