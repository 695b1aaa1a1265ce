from .moe_layer import (MoELayer, combine_from_experts,
                        dispatch_to_experts, moe_capacity,
                        top_k_capacity_gating)

__all__ = ["MoELayer", "combine_from_experts", "dispatch_to_experts",
           "moe_capacity", "top_k_capacity_gating"]
