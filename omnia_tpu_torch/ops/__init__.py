from omnia_tpu_torch.ops.moe import (
    DISPATCH_MIN_TOKENS,
    moe_dense,
    moe_dispatch,
    moe_mlp,
    route_sparse,
    route_topk,
)

__all__ = [
    "DISPATCH_MIN_TOKENS",
    "moe_dense",
    "moe_dispatch",
    "moe_mlp",
    "route_sparse",
    "route_topk",
]
