"""ray_tpu_torch.tune — hyperparameter tuning over trial actors.

Ref analog: python/ray/tune (Tuner tuner.py:59, TuneController
execution/tune_controller.py:80, Trainable trainable/trainable.py:75,
schedulers/, search/ — SURVEY.md §2.4); the port of ``ray_tpu/tune`` on
the port's runtime. One trial = one actor; the controller pumps
``train()`` futures and applies scheduler decisions. A trial that asks for
``"GPU"`` leases cards (``num_gpus``). Importing this package loads no
torch; the optional search libraries (optuna) are imported lazily.
"""

from .result_grid import ResultGrid
from .schedulers import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .external_search import OptunaSearch
from .search import (
    BasicVariantGenerator,
    RandomSearch,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    qrandint,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig)

from .session import get_checkpoint, report
from .trainable import FunctionTrainable, Trainable, with_parameters
from .trial import Trial
from .tuner import TuneConfig, Tuner, run

__all__ = [
    "Tuner", "TuneConfig", "run", "ResultGrid", "Trial",
    "RunConfig", "CheckpointConfig", "FailureConfig",
    "Trainable", "FunctionTrainable", "with_parameters",
    "report", "get_checkpoint",
    "TrialScheduler", "FIFOScheduler", "AsyncHyperBandScheduler",
    "ASHAScheduler", "HyperBandScheduler", "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher", "BasicVariantGenerator", "RandomSearch", "TPESearcher",
    "OptunaSearch",
    "choice", "uniform", "loguniform", "quniform", "randint", "qrandint",
    "grid_search", "sample_from",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("tune")
del _rlu
