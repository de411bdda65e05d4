from .segscan import compute_weights_packed, segmented_cumsum
from .trunc_exp import truncated_exp
from .weights import compute_weights
from .weights_dense import compute_weights_dense

__all__ = [
    "compute_weights",
    "compute_weights_dense",
    "compute_weights_packed",
    "segmented_cumsum",
    "truncated_exp",
]
