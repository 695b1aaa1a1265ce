"""``paddle_tpu.utils`` counterparts: fault injection and the
transient-failure retry of the checkpoint paths."""
