from .moe_layer import (combine_from_experts, dispatch_to_experts,
                        moe_capacity, top_k_capacity_gating)

__all__ = ["combine_from_experts", "dispatch_to_experts", "moe_capacity",
           "top_k_capacity_gating"]
