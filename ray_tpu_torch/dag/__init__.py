"""General DAG IR: build lazy task/actor graphs, execute them later.

Ref parity: ray.dag (python/ray/dag/dag_node.py:23 DAGNode,
function_node.py, class_node.py, input_node.py): ``fn.bind(...)`` builds a
node instead of executing; ``dag.execute(input)`` walks the graph
submitting tasks bottom-up. Workflows (``ray_tpu_torch.workflow``) run
the same graphs durably.
"""

from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode,
                                        DAGNode, FunctionNode, InputNode)

__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode"]
