"""ray_tpu_torch.train — distributed training over worker-actor gangs.

Ref analog: python/ray/train + python/ray/air config/session layers
(SURVEY.md §2.4); the port of ``ray_tpu/train`` on the port's runtime. The
tensor plane is one ``torch.distributed`` process group over the gang
(backend.py: NCCL when the workers lease GPUs, gloo otherwise), on which
``ray_tpu_torch.parallel.make_mesh`` builds its DeviceMesh. Importing this
package loads no torch: the workers' loops import it.

The pipeline names of the reference (``Pipeline``, ``PipelineStage``,
``SingleProgramPipeline``, ``single_program_reference``, ``gpipe_order``,
``one_f_one_b_order``) are not ported yet.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    TrainingWorkerError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_local_rank,
    get_world_rank,
    get_world_size,
    report,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.worker_group import RayTrainWorker, WorkerGroup

__all__ = [
    "ScalingConfig", "RunConfig", "CheckpointConfig", "FailureConfig",
    "Result", "Checkpoint", "CheckpointManager",
    "Backend", "BackendConfig", "TorchConfig",
    "BackendExecutor", "TrainingWorkerError",
    "BaseTrainer", "DataParallelTrainer", "TorchTrainer",
    "WorkerGroup", "RayTrainWorker",
    "report", "get_checkpoint", "get_context", "get_dataset_shard",
    "get_world_rank", "get_world_size", "get_local_rank", "TrainContext",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu
