"""BiSupervised core — the paper's contribution as PyTorch functions."""

from repro_torch.core.cascade import (EDGE, CascadeThresholds, TriThresholds,
                                      bisupervised_batch, combine_escalated,
                                      escalation_capacity, gather_requests,
                                      select_escalations, select_for_labeling,
                                      trisupervised_batch)
from repro_torch.core.metrics import (RAC, auc_rac, request_accuracy_curve,
                                      supervised_metrics, threshold_for_fpr)
from repro_torch.core.supervisors import (SAMPLING_SUPERVISORS,
                                          SOFTMAX_SUPERVISORS, MDSAState,
                                          autoencoder_confidence,
                                          equivalent_token_confidence,
                                          fit_autoencoder, fit_mdsa,
                                          max_softmax, mdsa_confidence,
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
    "EDGE", "TriThresholds", "trisupervised_batch", "select_for_labeling",
    "RAC", "request_accuracy_curve", "auc_rac", "supervised_metrics",
    "threshold_for_fpr", "SAMPLING_SUPERVISORS", "MDSAState", "fit_mdsa",
    "mdsa_confidence", "autoencoder_confidence", "fit_autoencoder",
    "equivalent_token_confidence",
]
