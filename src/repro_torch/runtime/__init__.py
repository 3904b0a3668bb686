"""Adaptive cascade runtime — the control plane around the serving engine
(port). Host-side numpy modules carried over from ``repro.runtime``:
calibration, controller, transport/router, response cache and
observability. The hierarchy, cluster and chaos modules come with a later
slice of the port.
"""

from repro_torch.runtime.cache import (CacheStats, RemoteResponseCache,
                                       content_key, content_keys, to_host)
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
from repro_torch.runtime.transport import (ROUTE_POLICIES, CircuitBreaker,
                                           CircuitOpenError, RemoteBackend,
                                           RemoteCallError, RemoteRouter,
                                           RemoteTimeout, RemoteTransport,
                                           RouteConstraint, RouterStats,
                                           TransportConfig, TransportFuture,
                                           TransportStats)

__all__ = [
    "ROUTE_POLICIES", "AdaptiveController", "CacheStats", "CircuitBreaker",
    "CircuitOpenError", "ControllerConfig", "ControllerState",
    "EscalationPrior", "EventLog", "JointOperatingPoint", "MetricsRegistry",
    "Observability", "OperatingPoint", "RemoteBackend", "RemoteCallError",
    "RemoteResponseCache", "RemoteRouter", "RemoteTimeout",
    "RemoteTransport", "RouteConstraint", "RouterStats",
    "TieredBudgetController", "TraceSink", "TransportConfig",
    "TransportFuture", "TransportStats", "calibrate", "content_key",
    "content_keys", "fit_escalation_prior", "joint_pareto_frontier",
    "pareto_frontier", "population_stability_index",
    "select_joint_operating_point", "select_operating_point",
    "sweep_joint_operating_points", "sweep_operating_points", "to_host",
]
