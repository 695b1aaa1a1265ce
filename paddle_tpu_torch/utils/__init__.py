"""``paddle_tpu.utils`` counterparts: fault injection, the
transient-failure retry of the checkpoint paths, and the functional call
of a module (``params_dict``, ``functional_call``)."""

from .functional_call import functional_call, params_dict  # noqa: F401
