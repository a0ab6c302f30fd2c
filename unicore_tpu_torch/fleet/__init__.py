"""``unicore_tpu_torch.fleet`` — the serve FLEET tier (counterpart of
``unicore_tpu.fleet``): a replica router with consistent-hash session
affinity, SLO-aware overflow, failover and rolling restart, and a
seeded trace-replay load generator over N
:class:`~unicore_tpu_torch.serve.engine.ServeEngine` replicas, and the
elastic scaling policy that grows and shrinks the fleet."""

from .autoscaler import FleetAutoscaler
from .health import CircuitBreaker, ReplicaHealth
from .ring import HashRing, stable_hash
from .router import FleetRouter
from .trace import (SCENARIOS, TraceEvent, clip_trace, generate_trace,
                    merge_traces, replay_trace, retag_sessions,
                    scenario_trace)

__all__ = [
    "CircuitBreaker", "FleetAutoscaler", "FleetRouter", "HashRing",
    "ReplicaHealth", "SCENARIOS", "TraceEvent", "clip_trace", "generate_trace",
    "merge_traces", "replay_trace", "retag_sessions", "scenario_trace",
    "stable_hash",
]
