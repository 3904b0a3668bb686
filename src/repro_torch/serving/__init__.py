"""Two-tier cascade serving runtime and greedy generation (port)."""

from repro_torch.serving.engine import (CascadeEngine, CascadeStats,
                                        CostModel, make_cascade_step,
                                        make_gated_local_step,
                                        make_local_step)
from repro_torch.serving.generate import greedy_generate
from repro_torch.serving.policy import (DISPOSITIONS, ESCALATION_MODES,
                                        ON_MISS_MODES, PACKING_MODES,
                                        RemoteSpec, RequestPolicy,
                                        ServeConfig, TierSpec)
from repro_torch.serving.scheduler import (COMPLETION_MODES,
                                           MicrobatchScheduler, Request,
                                           Response)

__all__ = ["CascadeEngine", "CascadeStats", "CostModel", "COMPLETION_MODES",
           "DISPOSITIONS", "ESCALATION_MODES", "ON_MISS_MODES",
           "PACKING_MODES", "RemoteSpec", "RequestPolicy", "ServeConfig",
           "TierSpec", "greedy_generate", "make_cascade_step", "make_gated_local_step",
           "make_local_step", "MicrobatchScheduler", "Request", "Response"]
