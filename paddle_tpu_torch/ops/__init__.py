"""Device-side ops of the port: the hand-written kernels (``ops/cuda``)
and the row-sparse gradient route (``ops/sparse_grad.py``)."""
