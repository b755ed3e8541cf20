"""ray_tpu_torch.data — lazy distributed datasets over the object store.

Ref analog: python/ray/data (Dataset dataset.py:174, streaming executor
_internal/execution/streaming_executor.py:49). Blocks are dicts of numpy
columns in the shm object store (block.py); transforms are remote tasks
fused per block; barrier ops are two-phase task exchanges.
``iter_torch_batches`` places batches on the card (pinned host memory,
non-blocking copies; optionally DTensors on a mesh), and
``streaming_split`` feeds TorchTrainer workers. Importing the package
loads no torch, pyarrow or pandas: data workers stay light.
"""

from .block import Block, BlockAccessor
from .dataset import Dataset
from .grouped import AggregateFn, GroupedData
from .iterator import DataIterator
from .plan import ActorPoolStrategy
from .read_api import (
    from_arrow,
    from_blocks,
    from_items,
    from_numpy_arrays,
    from_pandas_df,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from .read_api import from_numpy_arrays as from_numpy
from .read_api import from_pandas_df as from_pandas

__all__ = [
    "Dataset", "DataIterator", "Block", "BlockAccessor",
    "ActorPoolStrategy", "GroupedData", "AggregateFn",
    "range", "range_tensor", "from_items", "from_pandas", "from_pandas_df",
    "from_numpy", "from_numpy_arrays", "from_arrow", "from_blocks",
    "read_parquet", "read_csv", "read_json", "read_numpy", "read_text",
    "read_binary_files", "read_datasource", "read_images",
    "read_tfrecords", "read_webdataset",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("data")
del _rlu
