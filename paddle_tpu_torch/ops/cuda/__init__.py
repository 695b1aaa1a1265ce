"""CUDA C++ kernels for Hopper (``sm_90a``), compiled from
``paddle_tpu_torch/csrc`` with ``nvcc`` on first use and bound with
ctypes (:mod:`._build`)."""
