"""The port's checkpoints of torch state (``ray_tpu_torch.train.Checkpoint``
and ``CheckpointManager``) against the JAX package's: trees of fp32, bf16,
fp16, int32 and 0-d leaves back bit for bit, in memory and through a
directory that loads without pickle; the same leaves in the same order as
``ray_tpu.train.Checkpoint``'s; DTensor leaves of a 2-rank gloo world
gathered whole; top-K retention."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.train import Checkpoint as JaxCheckpoint
from ray_tpu_torch.interop import tensor_from_numpy
from ray_tpu_torch.models import training as TR
from ray_tpu_torch.parallel.world import run_world
from ray_tpu_torch.train import Checkpoint, CheckpointManager
from torch_parallel_ranks import checkpoint_rank, one_world_at_a_time
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_DTYPES = [jnp.float32, jnp.bfloat16, jnp.float16, jnp.int32]


def _jax_tree(seed: int):
    """Nested dicts of every dtype the tests cover, 0-d leaves included,
    as numpy (bf16 as ml_dtypes' bfloat16)."""
    rng = np.random.RandomState(seed)
    out = {}
    for dt in _DTYPES:
        name = jnp.dtype(dt).name
        x = rng.randn(3, 4, 5) * 50
        out[name] = {"w": np.asarray(jnp.asarray(x, dt)),
                     "s": np.asarray(jnp.asarray(x[0, 0, 0], dt))}
    out["step"] = np.asarray(7, np.int32)
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tensor_from_numpy(tree, "cpu")


def _bits(x):
    """A leaf's bytes as numpy, whichever package it came from."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.itemsize > 1 else x


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k])
            continue
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert torch.equal(got[k].view(torch.uint8) if got[k].dim() else
                           got[k].reshape(1).view(torch.uint8),
                           want[k].view(torch.uint8) if want[k].dim() else
                           want[k].reshape(1).view(torch.uint8))


def test_tree_round_trips_in_memory():
    tree = _torch_tree(_jax_tree(0))
    ckpt = Checkpoint.from_pytree(tree, epoch=2)
    out, extra = ckpt.to_pytree()
    assert extra == {"epoch": 2}
    _assert_same_tree(out, tree)
    # the caller owns what it gets: neither side aliases the other
    out["float32"]["w"].add_(1)
    tree["float32"]["s"].add_(1)
    again, _ = ckpt.to_pytree()
    assert not torch.equal(again["float32"]["w"], out["float32"]["w"])
    assert not torch.equal(again["float32"]["s"], tree["float32"]["s"])


def test_directory_round_trip_loads_without_pickle(tmp_path):
    tree = _torch_tree(_jax_tree(1))
    path = Checkpoint.from_pytree(tree, note="x").to_directory(
        str(tmp_path / "c"))
    with np.load(os.path.join(path, "pytree_leaves.npz"),
                 allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with open(os.path.join(path, "pytree_def.json")) as f:
        meta = json.load(f)
    want = TR.tree_leaves(tree)
    assert meta["dtypes"] == [str(x.dtype).removeprefix("torch.")
                              for x in want]
    assert [_bits(a).tobytes() for a in leaves] == \
        [_bits(x).tobytes() for x in want]
    # bf16 is stored as the unsigned integers of its size
    assert {a.dtype.name for a in leaves} == {"float32", "uint16",
                                              "float16", "int32"}
    with open(os.path.join(path, "payload.pkl"), "rb") as f:
        raw = f.read()
    assert b"torch" not in raw and pickle.loads(raw) == {"note": "x"}
    out, extra = Checkpoint.from_directory(path).to_pytree()
    assert extra == {"note": "x"}
    _assert_same_tree(out, tree)


def test_leaves_match_the_reference_checkpoint(tmp_path):
    """The same tree through ray_tpu.train.Checkpoint and the port's: the
    same leaves, in the same order, with the same bits (JAX's bf16 leaves
    against the port's uint16 view)."""
    tree = _jax_tree(2)
    jpath = JaxCheckpoint.from_pytree(tree).to_directory(str(tmp_path / "j"))
    tpath = Checkpoint.from_pytree(_torch_tree(tree)).to_directory(
        str(tmp_path / "t"))
    jleaves, _ = jax.tree.flatten(JaxCheckpoint.from_directory(jpath)
                                  .to_pytree()[0])
    tleaves = TR.tree_leaves(Checkpoint.from_directory(tpath)
                             .to_pytree()[0])
    assert len(jleaves) == len(tleaves) == 9
    for a, b in zip(jleaves, tleaves):
        assert tuple(np.shape(a)) == tuple(b.shape)
        assert _bits(a).tobytes() == _bits(b).tobytes()


def test_train_state_round_trips(tmp_path):
    """A whole tiny train state (JAX's init, bf16 params and mu) through
    the port's checkpoint: every leaf back bit for bit."""
    cfg = jcfg.tiny_config(param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(0),
                                                      cfg))
    p = _torch_tree(params)
    tx = TR.make_optimizer(1e-3, mu_dtype=torch.bfloat16)
    state = {"step": torch.tensor(4, dtype=torch.int32), "params": p,
             "opt_state": tx.init(p)}
    path = Checkpoint.from_pytree(state).to_directory(str(tmp_path / "s"))
    out, _ = Checkpoint.from_directory(path).to_pytree()
    _assert_same_tree(out, state)
    assert out["opt_state"]["mu"]["embed"].dtype == torch.bfloat16


def test_rejects_keys_that_are_not_str():
    with pytest.raises(TypeError, match="str"):
        Checkpoint.from_pytree({1: torch.zeros(2)})


def test_dtensor_leaves_gather_whole(tmp_path):
    """A train state sharded on make_mesh(fsdp=2) over a 2-rank gloo world:
    every rank calls from_pytree (full_tensor() is a collective) and gets
    the whole unsharded state; rank 0's directory holds it too."""
    cfg = jcfg.tiny_config(param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.key(1),
                                                      cfg))
    with one_world_at_a_time():
        out = run_world(checkpoint_rank, 2, (params, str(tmp_path / "d")),
                        device="cpu", timeout=120)
    p = _torch_tree(params)
    tx = TR.make_optimizer(1e-3, mu_dtype=torch.bfloat16)
    want = TR.tree_leaves({"step": torch.tensor(3, dtype=torch.int32),
                           "params": p, "opt_state": tx.init(p)})
    for rank, r in enumerate(out):
        assert "DTensor" in r["sharded"] and r["extra"] == {"rank": rank}
        assert [_bits(a).tobytes() for a in r["leaves"]] == \
            [_bits(x).tobytes() for x in want]
    tree, extra = Checkpoint.from_directory(str(tmp_path / "d")).to_pytree()
    assert extra == {"rank": 0}
    assert [_bits(x).tobytes() for x in TR.tree_leaves(tree)] == \
        [_bits(x).tobytes() for x in want]


def test_manager_keeps_top_k(tmp_path):
    m = CheckpointManager(str(tmp_path), num_to_keep=2,
                          score_attribute="loss", score_order="min")
    for i, loss in enumerate([3.0, 1.0, 2.0, 0.5]):
        m.register(Checkpoint.from_pytree({"w": torch.full((2,), float(i))}),
                   {"loss": loss})
    kept = m.checkpoints
    assert [t.metrics["loss"] for t in kept] == [1.0, 0.5]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000001",
                                            "checkpoint_000003"]
    assert m.best.metrics["loss"] == 0.5 and m.latest.index == 3
    w, _ = m.best.checkpoint.to_pytree()
    assert torch.equal(w["w"], torch.full((2,), 3.0))
