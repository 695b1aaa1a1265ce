"""``paddle_tpu.distributed.launch`` counterpart: the worker side of the
supervision contract (:mod:`.heartbeat`). The launcher itself, its
supervisor and restart budget are ROADMAP Queue 1 item 3."""
