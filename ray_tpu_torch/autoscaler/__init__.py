"""Autoscaler: resource-demand-driven node scaling over a provider.

Ref parity: the reference's StandardAutoscaler
(python/ray/autoscaler/_private/autoscaler.py:166 update() loop over a
NodeProvider, resource_demand_scheduler.py bin-packing of pending demand,
idle-node termination). Nodes are whole hosts joining over TCP (node
agents); bin-packing is simple because accelerator fleets are
homogeneous per node type.

A copy of ``ray_tpu.autoscaler`` on the port's runtime: providers launch
``ray_tpu_torch.core.node_agent`` with ``--num-gpus``, and the GKE pools
(``FakeGkeGpuCloud``, ``gke.GkeGpuNodePoolCloud``) are GPU node pools
where the reference's are TPU ones.
"""

from ray_tpu_torch.autoscaler.autoscaler import (Autoscaler,
                                                 AutoscalingPolicy,
                                                 LocalNodeProvider,
                                                 NodeProvider)
from ray_tpu_torch.autoscaler.batching_provider import (BatchingNodeProvider,
                                                        CloudAPI,
                                                        FakeGkeGpuCloud,
                                                        ScaleRequest)

__all__ = ["Autoscaler", "AutoscalingPolicy", "NodeProvider",
           "LocalNodeProvider", "BatchingNodeProvider", "CloudAPI",
           "FakeGkeGpuCloud", "ScaleRequest"]
