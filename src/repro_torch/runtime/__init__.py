"""Adaptive cascade runtime — the control plane around the serving engine
(port). Host-side numpy modules carried over from ``repro.runtime``:
calibration, controller, transport/router, response cache,
observability, seeded chaos injection, the N-tier stage ladder and the
replica cluster. A remote apply may answer with a device tensor; the
runtime brings it to the host (``to_host``).
"""

from repro_torch.runtime.cache import (CacheStats, RemoteResponseCache,
                                       content_key, content_keys, to_host)
from repro_torch.runtime.chaos import (CHAOS_KINDS, ChaosEpisode, ChaosFault,
                                       ChaosRemote, ChaosSchedule, ChaosStats,
                                       ChaosTimeout, VirtualClock)
from repro_torch.runtime.calibration import (EscalationPrior,
                                             JointOperatingPoint,
                                             OperatingPoint, calibrate,
                                             fit_escalation_prior,
                                             joint_pareto_frontier,
                                             pareto_frontier,
                                             select_joint_operating_point,
                                             select_operating_point,
                                             sweep_joint_operating_points,
                                             sweep_operating_points)
from repro_torch.runtime.controller import (AdaptiveController,
                                            ControllerConfig,
                                            ControllerState,
                                            TieredBudgetController,
                                            population_stability_index)
from repro_torch.runtime.observability import (EventLog, MetricsRegistry,
                                               Observability, TraceSink)
from repro_torch.runtime.hierarchy import (CascadeStage, StageStats,
                                           TieredCascade, build_stage_chain)
from repro_torch.runtime.cluster import (CacheUpdate, ClusterBudgetConfig,
                                         ClusterBudgetController,
                                         ClusterBudgetState, ClusterHarness,
                                         ClusterReplica, ReplicaCacheView,
                                         SharedCacheStats,
                                         SharedResponseCache,
                                         cluster_billing)
from repro_torch.runtime.transport import (ROUTE_POLICIES, CircuitBreaker,
                                           CircuitOpenError, RemoteBackend,
                                           RemoteCallError, RemoteRouter,
                                           RemoteTimeout, RemoteTransport,
                                           RouteConstraint, RouterStats,
                                           TransportConfig, TransportFuture,
                                           TransportStats)

__all__ = [
    "CHAOS_KINDS", "ROUTE_POLICIES", "AdaptiveController", "CacheStats",
    "CacheUpdate", "CascadeStage", "ChaosEpisode", "ChaosFault",
    "ChaosRemote", "ChaosSchedule", "ChaosStats", "ChaosTimeout",
    "CircuitBreaker", "CircuitOpenError", "ClusterBudgetConfig",
    "ClusterBudgetController", "ClusterBudgetState", "ClusterHarness",
    "ClusterReplica", "ControllerConfig", "ControllerState",
    "EscalationPrior", "EventLog", "JointOperatingPoint",
    "MetricsRegistry", "Observability", "OperatingPoint", "RemoteBackend",
    "RemoteCallError", "RemoteResponseCache", "RemoteRouter",
    "RemoteTimeout", "RemoteTransport", "ReplicaCacheView",
    "RouteConstraint", "RouterStats", "SharedCacheStats",
    "SharedResponseCache", "StageStats", "TieredBudgetController",
    "TieredCascade", "TraceSink", "TransportConfig", "TransportFuture",
    "TransportStats", "VirtualClock", "build_stage_chain", "calibrate",
    "cluster_billing", "content_key", "content_keys",
    "fit_escalation_prior", "joint_pareto_frontier", "pareto_frontier",
    "population_stability_index", "select_joint_operating_point",
    "select_operating_point", "sweep_joint_operating_points",
    "sweep_operating_points", "to_host",
]
