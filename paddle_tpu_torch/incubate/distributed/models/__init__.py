"""``paddle_tpu.incubate.distributed.models`` counterparts: MoE gating."""
