"""Serve configuration dataclasses.

Ref analogs: python/ray/serve/config.py (DeploymentConfig, AutoscalingConfig,
HTTPOptions) and python/ray/serve/schema.py:326 — re-designed as plain
dataclasses; GPU replicas declare ``num_gpus`` in ``ray_actor_options``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Signal-fused autoscaling (ref: _private/autoscaling_policy.py:106).

    The controller fuses three signal families each policy tick (r14):

    - **Concurrency/queue depth**: the max of replica-reported ongoing
      requests and the router-reported per-replica in-flight counts
      (queued + executing, summed across router processes). The raw
      replica estimate is ``ceil(smoothing_factor * load /
      target_num_ongoing_requests_per_replica)``.
    - **Latency SLO burn** (``latency_slo_ms``): when the head's
      per-func phase histogram p99 for the replica request method
      exceeds the SLO, the policy scales up one step per satisfied
      upscale window even if concurrency alone would not — latency
      degrades before queue depth explodes when requests get slower
      rather than more numerous.
    - **Node pressure** (``downscale_cpu_block_pct``): a scale-DOWN is
      held while every node hosting this deployment's replicas reports
      ``node.cpu_percent`` at or above the bound — shrinking a hot
      fleet just moves the queue.

    Hysteresis: upscale/downscale each need their signal to persist for
    their own delay window (``upscale_delay_s`` / ``downscale_delay_s``),
    and each direction additionally honors a cooldown measured from the
    LAST scale event in any direction (``upscale_cooldown_s`` /
    ``downscale_cooldown_s``) so a burst right after a shrink cannot
    flap the fleet. Decisions are emitted as rate-limited
    ``serve_autoscale`` cluster events carrying direction + reason;
    ``doctor_warnings()`` flags flapping.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    target_num_ongoing_requests_per_replica: float = 2.0
    # how long the up/down signal must persist before acting
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    # exponential smoothing applied to the raw desired-replica estimate
    smoothing_factor: float = 1.0
    # --- r14 signal fusion ---
    # p99 latency SLO on the replica request path, milliseconds; when
    # the head phase histogram's p99 for ``slo_phase`` exceeds it, the
    # policy scales up one step per upscale window (0 disables the
    # latency signal). The histograms aggregate per FUNC (the shared
    # replica entrypoint), so the signal is serve-wide: deployments
    # sharing a cluster see each other's burn — set the SLO on the
    # deployment(s) that own the latency budget.
    latency_slo_ms: float = 0.0
    # which lifecycle phase the SLO reads: "e2e" (submit -> result,
    # includes queueing + transport: the user-visible number) or "exec"
    # (replica compute only).
    slo_phase: str = "e2e"
    # minimum gap after the LAST scale event (either direction) before
    # scaling in this direction — the anti-flap floor on top of the
    # delay windows. 0 keeps the pre-r14 windows-only behavior.
    upscale_cooldown_s: float = 0.0
    downscale_cooldown_s: float = 0.0
    # hold scale-downs while every node hosting this deployment's
    # replicas reports node.cpu_percent >= this (0 disables the veto).
    downscale_cpu_block_pct: float = 0.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"invalid autoscaling bounds [{self.min_replicas}, "
                f"{self.max_replicas}]")
        if self.slo_phase not in ("e2e", "exec"):
            raise ValueError(
                f"slo_phase must be 'e2e' or 'exec', got {self.slo_phase!r}")


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    user_config: Any = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    version: Optional[str] = None


@dataclasses.dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    # "HeadOnly": one proxy on the head node; "EveryNode": one proxy per
    # alive node, pinned there (the reference's http_state.py proxy fleet
    # — ingress scales with the cluster, a pod LB fronts all of them)
    location: str = "HeadOnly"


@dataclasses.dataclass
class ReplicaMetrics:
    """What a replica reports to the controller each health-check tick."""

    replica_id: str = ""
    num_ongoing_requests: int = 0
    num_completed_requests: int = 0
    healthy: bool = True
    # which node hosts this replica (r14: feeds slow-node-aware routing
    # and the node-pressure downscale veto); -1 until known
    node_idx: int = -1
