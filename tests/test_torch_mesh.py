"""The port's mesh shapes and logical-axis rules (``ray_tpu_torch.parallel``)
against the JAX package's, with no process group: ``MeshSpec.sizes`` (fills
and errors), ``logical_to_spec`` (rules, duplicates, absent axes, a hybrid
mesh), and the DTensor placements a spec turns into. Mirrors
tests/test_parallel.py's rule tests."""

import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import config as jcfg
from ray_tpu.models.transformer import param_logical_axes as jax_axes
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jshard
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tshard
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

SIZES = [
    (dict(fsdp=-1), 8),
    (dict(fsdp=-1, tensor=2), 8),
    (dict(data=2, fsdp=2, sequence=2), 8),
    (dict(sequence=4, fsdp=2), 8),
    (dict(slices=2, fsdp=-1), 8),
    (dict(slices=2, data=2, fsdp=-1), 8),
    (dict(fsdp=1), 1),
    (dict(data=-1, fsdp=2, pipeline=2), 32),
]
BAD_SIZES = [
    (dict(fsdp=3), 8),
    (dict(fsdp=-1, tensor=-1), 8),
    (dict(slices=3), 8),
    (dict(slices=0), 8),
    (dict(fsdp=-1, tensor=3), 8),
    (dict(data=2, fsdp=2), 8),
]
HYBRID = ("slice",) + tmesh.MESH_AXES
SPECS = [
    (("batch", "seq", "embed"), tmesh.MESH_AXES),
    (("batch", "seq"), HYBRID),
    (("embed", "mlp"), None),
    ((None, "heads", None), None),
    (("embed", "embed"), tmesh.MESH_AXES),          # duplicate -> replicate
    (("batch", "batch", "seq"), HYBRID),
    (("vocab", "embed"), ("data", "fsdp")),         # tensor absent -> None
    (("layers", "experts", "embed", "mlp"), tmesh.MESH_AXES),
    (("stages", "kv_heads", "qkv_dim"), tmesh.MESH_AXES),
]


def test_axes_match_the_reference():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.DCN_AXIS == jmesh.DCN_AXIS
    assert tshard.DEFAULT_RULES == jshard.DEFAULT_RULES


@pytest.mark.parametrize("spec,n", SIZES)
def test_mesh_spec_sizes_match_jax(spec, n):
    assert tmesh.MeshSpec(**spec).sizes(n) == jmesh.MeshSpec(**spec).sizes(n)


@pytest.mark.parametrize("spec,n", BAD_SIZES)
def test_mesh_spec_errors_match_jax(spec, n):
    with pytest.raises(ValueError) as want:
        jmesh.MeshSpec(**spec).sizes(n)
    with pytest.raises(ValueError) as got:
        tmesh.MeshSpec(**spec).sizes(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("logical,axes", SPECS)
def test_logical_to_spec_matches_jax(logical, axes):
    want = jshard.logical_to_spec(logical, mesh_axes=axes)
    got = tshard.logical_to_spec(logical, mesh_axes=axes)
    assert P(*got) == want


@pytest.mark.parametrize("logical,axes", [s for s in SPECS
                                          if s[1] is not None])
def test_spec_to_placements(logical, axes):
    """Shard(d) on every mesh dim the spec names for tensor dim d, in mesh
    order; Replicate() on the others."""
    spec = tshard.logical_to_spec(logical, mesh_axes=axes)
    got = tshard.spec_to_placements(spec, axes)
    assert len(got) == len(axes)
    for i, ax in enumerate(axes):
        dims = [d for d, e in enumerate(spec)
                if ax == e or (isinstance(e, tuple) and ax in e)]
        assert got[i] == (Shard(dims[0]) if dims else Replicate())


@pytest.mark.parametrize("moe", [0, 4])
def test_param_logical_axes_match_jax(moe):
    kw = dict(moe_experts=moe, tie_embeddings=not moe)
    assert param_logical_axes(tcfg.tiny_config(**kw)) == jax_axes(
        jcfg.tiny_config(**kw))


def test_batch_placements_on_a_hybrid_mesh():
    """batch over ("slice", "data", "fsdp"), seq over sequence: three mesh
    dims shard tensor dim 0, in mesh order."""
    spec = tshard.logical_to_spec(("batch", "seq"), mesh_axes=HYBRID)
    assert spec == (("slice", "data", "fsdp"), "sequence")
    assert tshard.spec_to_placements(spec, HYBRID) == (
        Shard(0), Shard(0), Shard(0), Replicate(), Replicate(), Shard(1),
        Replicate())
