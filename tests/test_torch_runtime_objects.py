"""The port's object plane: the native shared-memory store (the cases of
tests/test_object_store.py) and the zero-copy device path of
tests/test_device_path.py with torch tensors in place of jax.Arrays, held
against the reference's serialization where both packages can carry the
same value."""

import gc
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.core import serialization as ref_serialization
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import (ObjectExistsError,
                                             ObjectStoreFullError,
                                             ShmObjectStore)

_ROOT = Path(__file__).resolve().parent.parent
ARENA = 96 * 1024 * 1024


@pytest.fixture
def store():
    s = ShmObjectStore(f"rtpu_tt_{ObjectID.from_random().hex()[:8]}",
                       ARENA, create=True)
    yield s
    s.close()


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _put(store, value):
    oid = ObjectID.from_random()
    sv = serialization.serialize(value)
    store.put_serialized(oid, sv.frames)
    return oid


def _roundtrip(store, value):
    oid = _put(store, value)
    frames = store.get_frames(oid, pin_borrows=True)
    out = serialization.deserialize(frames)
    del frames
    store.release(oid)
    return out


def _seeded(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point or dtype.is_complex:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(dtype)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, size=shape) > 0)
    return torch.from_numpy(rng.integers(-1000, 1000, size=shape)).to(dtype)


# ------------------------------------------------------ the native store


def test_create_seal_get_delete(store):
    oid = ObjectID.from_random()
    buf = store.create(oid, 5)
    buf[:] = b"hello"
    assert not store.contains(oid)  # not sealed yet
    store.seal(oid)
    assert store.contains(oid)
    data, meta = store.get(oid)
    assert bytes(data) == b"hello" and len(meta) == 0
    del data, meta
    store.release(oid)
    assert store.delete(oid)
    assert store.get(oid) is None


def test_duplicate_create_rejected(store):
    oid = ObjectID.from_random()
    store.create(oid, 4)
    with pytest.raises(ObjectExistsError):
        store.create(oid, 4)


def test_pinned_object_not_deletable(store):
    oid = ObjectID.from_random()
    store.create(oid, 4)
    store.seal(oid)
    d, m = store.get(oid)
    del d, m
    assert not store.delete(oid)  # pinned
    store.release(oid)
    assert store.delete(oid)


def test_multi_client_zero_copy(store):
    oid = ObjectID.from_random()
    t = torch.arange(100_000, dtype=torch.int64)
    store.put_serialized(oid, serialization.serialize(t).frames)
    client = ShmObjectStore(store.name)  # attach as another client
    try:
        frames = client.get_frames(oid)
        out = serialization.deserialize(frames)
        assert torch.equal(out, t)
        del out, frames
        client.release(oid)
    finally:
        client.close()


def test_alloc_free_coalescing(store):
    """Fill, free, refill — fragmentation must not leak arena space."""
    ids = []
    for _ in range(20):
        oid = ObjectID.from_random()
        store.put_serialized(oid, [b"x" * 1_000_000])
        ids.append(oid)
    used = store.bytes_in_use()
    for oid in ids:
        assert store.delete(oid)
    assert store.bytes_in_use() == 0
    big = ObjectID.from_random()
    store.put_serialized(big, [b"y" * (20 * 1_000_000)])
    assert store.bytes_in_use() >= 20 * 1_000_000
    assert used > 0


def test_eviction_frees_lru(store):
    ids = []
    for _ in range(10):
        oid = ObjectID.from_random()
        store.put_serialized(oid, [b"x" * 2_000_000])
        ids.append(oid)
    evicted = store.evict(6_000_000)
    assert len(evicted) >= 3
    assert evicted[0] == ids[0]  # oldest first


def test_store_full_raises(store):
    with pytest.raises(ObjectStoreFullError):
        store.create(ObjectID.from_random(), 128 * 1024 * 1024)


def test_metadata_roundtrip(store):
    oid = ObjectID.from_random()
    buf = store.create(oid, 3, 2)
    buf[:3] = b"abc"
    buf[3:] = b"mm"
    store.seal(oid)
    data, meta = store.get(oid)
    assert bytes(data) == b"abc" and bytes(meta) == b"mm"
    del data, meta
    store.release(oid)


def test_native_libraries_build_outside_the_package():
    from ray_tpu_torch.native import build

    assert Path(build.BUILD_DIR) == _ROOT / ".build" / "ray_tpu_torch" / \
        "native"
    for lib in build.TARGETS:
        path = Path(build.lib_path(lib))
        assert path.parent == Path(build.BUILD_DIR) and path.exists()
    assert not list((_ROOT / "ray_tpu_torch" / "native").glob("*.so"))


# --------------------------------------------------- the tensor fast path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.float16, torch.uint8,
                                   torch.bool, torch.complex64])
def test_tensor_roundtrip_through_arena(store, dtype):
    """Out of band in every dtype, numpy's or not, and back bit for bit
    with its dtype and shape."""
    t = _seeded((96, 33), dtype)
    sv = serialization.serialize(t)
    assert len(sv.frames) == 2 and len(sv.frames[0]) < 1024
    assert len(sv.frames[1]) == t.numel() * t.element_size()
    out = _roundtrip(store, t)
    assert type(out) is torch.Tensor and out.dtype == dtype
    assert out.shape == t.shape and out.device.type == "cpu"
    assert torch.equal(out, t)


def test_4mib_tensor_is_one_out_of_band_frame():
    t = torch.arange(1 << 20, dtype=torch.float32)  # 4 MiB
    sv = serialization.serialize(t)
    assert [len(f) for f in sv.frames[1:]] == [4_194_304]
    assert len(sv.frames[0]) < 1024
    assert bytes(sv.frames[1]) == t.numpy().tobytes()


def test_noncontiguous_tensor_ships_contiguous(store):
    base = _seeded((512, 768), torch.float32)
    strided = base.t()[::2]
    assert not strided.is_contiguous()
    sv = serialization.serialize(strided)
    assert sum(len(f) for f in sv.frames[1:]) == strided.numel() * 4
    out = _roundtrip(store, strided)
    assert out.is_contiguous() and torch.equal(out, strided)


def test_parameter_and_requires_grad_survive(store):
    p = torch.nn.Parameter(_seeded((8, 16), torch.float32))
    out = _roundtrip(store, {"w": p, "frozen": torch.nn.Parameter(
        _seeded((4,), torch.float32), requires_grad=False)})
    assert type(out["w"]) is torch.nn.Parameter and out["w"].requires_grad
    assert torch.equal(out["w"].detach(), p.detach())
    assert type(out["frozen"]) is torch.nn.Parameter
    assert not out["frozen"].requires_grad
    leaf = _seeded((3,), torch.float32).requires_grad_(True)
    got = _roundtrip(store, leaf)
    assert type(got) is torch.Tensor and got.requires_grad


def test_tensor_inside_container(store):
    t = torch.ones((64, 64), dtype=torch.bfloat16)
    sv = serialization.serialize({"w": t, "step": 7})
    assert len(sv.frames) == 2
    out = serialization.deserialize([bytes(f) for f in sv.frames])
    assert out["step"] == 7 and torch.equal(out["w"], t)


def test_readonly_wire_frames_deserialize():
    t = _seeded((128, 128), torch.float32)
    sv = serialization.serialize(t)
    stream = pickle.dumps([bytes(f) for f in sv.frames])
    out = serialization.deserialize(pickle.loads(stream))
    assert torch.equal(out, t)


def test_device_path_toggle_restores_pickle_path():
    """serialization_device_zero_copy=False: tensors go back through
    torch's own (in-band) pickling."""
    cfg = get_config()
    prev = cfg.serialization_device_zero_copy
    cfg.serialization_device_zero_copy = False
    try:
        t = torch.arange(1 << 16, dtype=torch.float32)  # 256 KiB
        sv = serialization.serialize(t)
        assert len(sv.frames) == 1 and len(sv.frames[0]) >= t.nbytes
        out = serialization.deserialize([bytes(f) for f in sv.frames])
        assert torch.equal(out, t)
    finally:
        cfg.serialization_device_zero_copy = prev


def test_cuda_payload_refuses_a_process_without_a_card(monkeypatch):
    """A tensor serialized from a card comes back on a card or not at
    all: never silently as a CPU tensor."""

    class _FromTheCard:
        def __reduce__(self):
            host = np.arange(16, dtype=np.float32)
            return (serialization._rebuild_tensor,
                    ("float32", host.dtype.str, (16,), "cuda", False, False,
                     serialization._payload_buffer(host)))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sv = serialization.serialize(_FromTheCard())
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        serialization.deserialize([bytes(f) for f in sv.frames])


# ------------------------------------------ zero-copy reads and borrow pins


def _mapping_of(ptr):
    """(file, offset in that file) of the mapping of this process that
    holds address ``ptr``, from /proc/self/maps."""
    for line in Path("/proc/self/maps").read_text().splitlines():
        parts = line.split()
        lo, hi = (int(x, 16) for x in parts[0].split("-"))
        if lo <= ptr < hi:
            path = parts[5] if len(parts) > 5 else ""
            return path, int(parts[2], 16) + (ptr - lo)
    raise AssertionError(f"{ptr:#x} is in no mapping")


def _arena_offset(store, oid):
    """Offset in the arena of the entry's data."""
    data, _meta = store.get(oid)
    addr = np.frombuffer(data, dtype=np.uint8).__array_interface__["data"][0]
    del data, _meta
    store.release(oid)
    return addr - store._base


def test_cpu_tensor_aliases_the_arena_and_pins_its_slot(store):
    """Zero-copy: the rebuilt tensor's memory is the arena file's own
    pages at the entry's offset (a private mapping of them), a byte
    flipped in the sealed entry shows through it, and the entry cannot be
    freed while the tensor lives."""
    t = torch.arange(1 << 20, dtype=torch.float32)
    oid = _put(store, t)
    frames = store.get_frames(oid, pin_borrows=True)
    out = serialization.deserialize(frames)
    off = len(frames[0])
    del frames
    store.release(oid)  # the read pin; the borrow pin stays with `out`
    assert _mapping_of(out.data_ptr()) == (
        f"/dev/shm/{store.name}", _arena_offset(store, oid) + off)
    data, _meta = store.get(oid)
    orig = data[off]
    data[off] = orig ^ 0x01
    assert out.view(torch.uint8)[0].item() == orig ^ 0x01
    data[off] = orig
    del data, _meta
    store.release(oid)

    assert store.delete(oid) is False  # deferred under the live tensor
    assert store.live_borrows(oid) > 0
    for i in range(8):  # allocation pressure must not recycle the slot
        tmp = ObjectID.from_random()
        store.put_serialized(tmp, [np.full(6 << 20, i, dtype=np.uint8)])
        store.delete(tmp)
    assert torch.equal(out, t)
    del out
    gc.collect()
    store.reap_borrows()
    assert not store.contains(oid)
    assert store.borrow_deferred_deletes >= 1


def test_in_place_write_stays_with_its_reader(store):
    """Torch has no read-only tensors, so a reader may write to the
    tensor it got: the write changes that tensor alone. A second reader,
    a later read and the sealed bytes keep the object as it was put."""
    t = _seeded((512, 512), torch.float32)
    oid = _put(store, t)
    frames = store.get_frames(oid, pin_borrows=True)
    first = serialization.deserialize(frames)
    second = serialization.deserialize(frames)
    del frames
    store.release(oid)
    first.add_(1.0)
    first[0, 0] = -7.0
    assert torch.equal(first, (t + 1.0).index_put_(
        (torch.tensor([0]), torch.tensor([0])), torch.tensor(-7.0)))
    assert torch.equal(second, t)
    frames = store.get_frames(oid, pin_borrows=True)
    assert torch.equal(serialization.deserialize(frames), t)
    sealed = np.frombuffer(frames[1], dtype=np.float32).reshape(512, 512)
    assert np.array_equal(sealed, t.numpy())
    del frames, sealed
    store.release(oid)


def test_inline_bytes_are_not_aliased():
    """A tensor rebuilt from read-only bytes (an inline value) owns a copy:
    writing to it leaves the bytes as they were."""
    t = _seeded((64, 64), torch.float32)
    frames = [bytes(f) for f in serialization.serialize(t).frames]
    out = serialization.deserialize(frames)
    out.mul_(3.0)
    assert frames[1] == t.numpy().tobytes()
    assert torch.equal(serialization.deserialize(frames), t)


def test_bf16_view_keeps_the_pin(store):
    t = _seeded((1024, 512), torch.bfloat16)
    oid = _put(store, t)
    frames = store.get_frames(oid, pin_borrows=True)
    out = serialization.deserialize(frames)
    del frames
    store.release(oid)
    assert out.dtype == torch.bfloat16
    assert oid not in store.evict(ARENA)
    assert store.delete(oid) is False
    assert torch.equal(out, t)
    del out
    gc.collect()
    store.reap_borrows()
    assert not store.contains(oid)


# --------------------------------------------- parity with the reference


@pytest.mark.parametrize("value", [
    np.arange(300_000, dtype=np.int32),
    np.random.default_rng(3).normal(size=(512, 256)).astype(np.float32),
    np.arange(4 << 20, dtype=np.uint8).reshape(2048, 2048)[::2, ::2],
], ids=["int32", "float32_2d", "strided_uint8"])
def test_ndarray_frames_equal_the_reference(value):
    ours = serialization.serialize(value)
    theirs = ref_serialization.serialize(value)
    assert [bytes(f) for f in ours.frames[1:]] == \
        [bytes(f) for f in theirs.frames[1:]]
    assert np.array_equal(
        serialization.deserialize([bytes(f) for f in ours.frames]), value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_payload_equals_the_reference_jax_array(dtype):
    """A jax.Array through ray_tpu and a torch tensor of the same data
    through the port carry the same out-of-band bytes."""
    host = np.random.default_rng(5).normal(size=(256, 384)).astype(
        np.float32)
    x = jnp.asarray(host).astype(dtype)
    t = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    assert np.asarray(x.astype(jnp.float32)).tobytes() == \
        t.float().numpy().tobytes()
    ours = serialization.serialize(t)
    theirs = ref_serialization.serialize(x)
    assert len(ours.frames) == len(theirs.frames) == 2
    assert bytes(ours.frames[1]) == bytes(theirs.frames[1])


# ------------------------------------------------------- without cloudpickle


def test_without_cloudpickle_functions_go_by_reference():
    """No cloudpickle: module-level functions pickle by reference, tensors
    still go out of band, and a lambda, a closure or a __main__ function
    raises a TypeError that names cloudpickle."""
    code = (
        "import sys\n"
        "sys.modules['cloudpickle'] = None\n"
        "import json, torch\n"
        "from ray_tpu_torch.core import serialization as S\n"
        "assert S.cloudpickle is None\n"
        "assert S.deserialize(S.serialize(json.dumps).frames) is json.dumps\n"
        "assert S.loads(S.dumps(json.loads)) is json.loads\n"
        "sv = S.serialize({'t': torch.ones(1 << 18)})\n"
        "assert len(sv.frames) == 2 and len(sv.frames[1]) == 1 << 20\n"
        "def main_fn():\n"
        "    return 1\n"
        "def outer():\n"
        "    y = 2\n"
        "    return lambda: y\n"
        "bad = 0\n"
        "for obj in (lambda: 1, outer(), main_fn):\n"
        "    for fn in (S.serialize, S.dumps):\n"
        "        try:\n"
        "            fn([obj])\n"
        "        except TypeError as e:\n"
        "            bad += 'cloudpickle' in str(e)\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "6"


# ------------------------------------------------- tensors through a cluster


def _tensor_stats(t):
    return (type(t).__name__, str(t.dtype), tuple(t.shape),
            float(t.double().sum()))


def _scaled_bf16(t):
    return (t * 2).to(torch.bfloat16)


def test_tensors_cross_processes(rt):
    t = _seeded((1024, 1024), torch.float32)  # 4 MiB
    ref = ray_tpu_torch.put(t)
    stats = ray_tpu_torch.remote(_tensor_stats)
    assert ray_tpu_torch.get(stats.remote(ref), timeout=60) == \
        ("Tensor", "torch.float32", (1024, 1024), float(t.double().sum()))
    back = ray_tpu_torch.get(ray_tpu_torch.remote(_scaled_bf16).remote(ref),
                             timeout=60)
    assert back.dtype == torch.bfloat16 and torch.equal(
        back, (t * 2).to(torch.bfloat16))


def _bump_in_place(t):
    t.add_(1.0)
    return float(t.double().sum())


def test_a_task_writing_its_argument_leaves_the_object(rt):
    """A task that writes in place to the tensor it was passed changes its
    own copy: the owner's later get and the next task see the object as
    it was put."""
    t = _seeded((1024, 1024), torch.float32)  # 4 MiB: in the arena
    ref = ray_tpu_torch.put(t)
    bump = ray_tpu_torch.remote(_bump_in_place)
    assert ray_tpu_torch.get(bump.remote(ref), timeout=60) == \
        float((t + 1.0).double().sum())
    assert torch.equal(ray_tpu_torch.get(ref, timeout=60), t)
    stats = ray_tpu_torch.remote(_tensor_stats)
    assert ray_tpu_torch.get(stats.remote(ref), timeout=60)[3] == \
        float(t.double().sum())

