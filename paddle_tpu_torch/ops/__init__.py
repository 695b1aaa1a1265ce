"""Hand-written device kernels of the port (``ops/cuda``)."""
