"""ray_tpu_torch.collective — host-plane collective communication.

The port of ``ray_tpu.collective`` (the reference's ray.util.collective,
SURVEY.md §2.3): tensor-plane collectives are ``torch.distributed``'s (see
ray_tpu_torch.parallel); this module covers the host plane the reference
used NCCL/Gloo groups for: gang barriers, broadcasts, gradient
allreduce/reduce_scatter/allgather between data-parallel actors. The
coordination plane is a per-group rendezvous actor; the data plane is the
object plane — chunked ring / halving-doubling tree collectives moving
bytes store-to-store — with the rendezvous transport preserved behind
``collective_transport="rendezvous"``. Entry points take numpy arrays and
torch tensors (CPU or CUDA, bf16 included) and give back the caller's type.
"""

from .collective import (
    CollectiveError,
    Rendezvous,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    reduce,
    reduce_scatter,
)

__all__ = [
    "init_collective_group", "destroy_collective_group", "allreduce",
    "reduce_scatter", "allgather", "broadcast", "barrier", "reduce",
    "get_rank", "get_collective_group_size", "is_group_initialized",
    "create_collective_group", "Rendezvous", "CollectiveError",
]
