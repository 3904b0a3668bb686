"""BiSupervised core — the paper's contribution as PyTorch functions."""

from repro_torch.core.cascade import (CascadeThresholds, bisupervised_batch,
                                      combine_escalated, escalation_capacity,
                                      gather_requests, select_escalations)
from repro_torch.core.supervisors import (SOFTMAX_SUPERVISORS, max_softmax,
                                          seq_min_likelihood,
                                          seq_prod_likelihood)
from repro_torch.core.thresholds import (escalation_rate_threshold,
                                         nominal_quantile_threshold,
                                         separation_threshold)

__all__ = [
    "CascadeThresholds", "bisupervised_batch", "select_escalations",
    "gather_requests", "combine_escalated", "escalation_capacity",
    "max_softmax", "SOFTMAX_SUPERVISORS", "seq_min_likelihood",
    "seq_prod_likelihood", "nominal_quantile_threshold",
    "separation_threshold", "escalation_rate_threshold",
]
