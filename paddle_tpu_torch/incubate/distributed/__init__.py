"""``paddle_tpu.incubate.distributed`` counterparts."""
