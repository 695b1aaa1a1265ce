"""``paddle_tpu.distributed`` counterparts: the single-device sparse tables
(:mod:`.ps`) and their entry configs (:mod:`.compat`). Collectives,
sharding plans and meshes are ROADMAP Queue 1 item 8."""

from .compat import CountFilterEntry, ProbabilityEntry

__all__ = ["CountFilterEntry", "ProbabilityEntry"]
