"""The port's C++ and Java clients (``ray_tpu_torch/native``,
``ray_tpu_torch/java``) against the port's cross-language gateway and
arenas.

Mirrors ``tests/test_cpp_client.py`` case for case on
``ray_tpu_torch.init(num_cpus=2, num_gpus=0)``, with the binaries built by
the port's ``native/build.py``, and the JDK-gated cases of
``tests/test_java_client.py``; the functions the clients call by
descriptor are ``tests/xlang_funcs.py``'s. Then the wire between the two
packages: the port's ``task_client`` and the reference's, each against
each package's head, give the same exit codes and output; the port's
``client_example`` reads and writes the same bytes in a reference arena
as in a port arena; and every build output lies under
``.build/ray_tpu_torch/``.
"""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.native import build as native_build

_ROOT = Path(__file__).resolve().parent.parent


def _arena_name() -> str:
    """An arena name of this test's own: creating an arena unlinks any of
    the same name, so runs that overlap must not share one."""
    return f"rtpu_torch_cpp_{os.getpid()}_{os.urandom(4).hex()}"

jdk = pytest.mark.skipif(
    shutil.which("javac") is None or shutil.which("java") is None,
    reason="no JDK on this host (the Java client's wire contract is "
           "task_client's, which the C++ cases cover)")


@pytest.fixture(scope="module")
def cpp_example():
    return native_build.build_binary("client_example")


@pytest.fixture(scope="module")
def task_client():
    return native_build.build_binary("task_client")


@pytest.fixture
def store():
    s = ShmObjectStore(_arena_name(), 32 * 1024 * 1024, create=True)
    yield s
    s.close()


def _run(binary, *args):
    return subprocess.run([binary, *args], capture_output=True, text=True,
                          timeout=60)


@pytest.fixture
def port_head():
    """A port head with its TCP gateway open: (tcp address, head)."""
    import ray_tpu_torch

    info = ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        yield info.head.enable_tcp(host="127.0.0.1",
                                   advertise_ip="127.0.0.1"), info.head
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------- the data plane (C++)


def test_cpp_reads_python_object(cpp_example, store):
    oid = ObjectID(os.urandom(20))
    store.put_raw(oid, b"hello from python")
    out = _run(cpp_example, store.name, "get", oid.hex())
    assert out.returncode == 0, out.stderr
    assert "17 bytes: hello from python" in out.stdout


def test_python_reads_cpp_object(cpp_example, store):
    oid = ObjectID(os.urandom(20))
    out = _run(cpp_example, store.name, "put", oid.hex(), "bonjour from c++")
    assert out.returncode == 0, out.stderr
    assert store.contains(oid)
    assert store.get_raw(oid) == b"bonjour from c++"


def test_cpp_missing_object_errors(cpp_example, store):
    out = _run(cpp_example, store.name, "get", "ab" * 20)
    assert out.returncode == 1
    assert "not found" in out.stderr


def produce_raw():
    """A task that puts raw bytes into its node's arena (the native data
    loader's counterpart): the object's id in hex."""
    from ray_tpu_torch.core.context import get_context

    oid = ObjectID(os.urandom(20))
    get_context().store.put_raw(oid, b"worker payload")
    return oid.hex()


def test_cpp_attach_to_live_runtime_store(cpp_example):
    """Against a running port cluster: the C++ process reads an object a
    Python worker produced."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        store_name = ray_tpu_torch.nodes()[0]["store_name"]
        oid_hex = ray_tpu_torch.get(
            ray_tpu_torch.remote(produce_raw).remote(), timeout=60)
        out = _run(cpp_example, store_name, "get", oid_hex)
        assert out.returncode == 0, out.stderr
        assert "worker payload" in out.stdout
    finally:
        ray_tpu_torch.shutdown()


# --------------------------------------------------- task submission (C++)


class TestCppTaskSubmission:
    def test_submit_over_tcp_and_unix(self, task_client, port_head):
        addr, head = port_head
        out = _run(task_client, addr, "xlang_funcs:add", "[2, 3]")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "5"
        # the unix socket too (same-host native processes)
        out = _run(task_client, f"unix:{head.session_dir}/head.sock",
                   "xlang_funcs:greet", '["cpp"]')
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "hello cpp"
        # the task ran in a worker process, not the driver
        out = _run(task_client, addr, "xlang_funcs:pid")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().isdigit()
        assert int(out.stdout.strip()) != os.getpid()

    def test_submit_error_reported(self, task_client, port_head):
        addr, _ = port_head
        out = _run(task_client, addr, "xlang_funcs:no_such_fn")
        assert out.returncode == 1
        assert "error" in out.stderr.lower()

    def test_actor_create_call_kill_roundtrip(self, task_client, port_head):
        """Create a named actor, see its state persist across calls, kill
        it, then see calls fail."""
        addr, _ = port_head
        out = _run(task_client, addr, "actor-create", "xlang_funcs:Counter",
                   "[10]", '{"name": "cpp-counter"}')
        assert out.returncode == 0, out.stderr
        assert "cpp-counter" in out.stdout
        out = _run(task_client, addr, "actor-call", "cpp-counter", "inc",
                   "[5]")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "15"
        out = _run(task_client, addr, "actor-call", "cpp-counter", "value")
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "15"
        out = _run(task_client, addr, "actor-kill", "cpp-counter")
        assert out.returncode == 0, out.stderr
        out = _run(task_client, addr, "actor-call", "cpp-counter", "value")
        assert out.returncode == 1

    def test_actor_auto_name_assigned(self, task_client, port_head):
        addr, _ = port_head
        out = _run(task_client, addr, "actor-create", "xlang_funcs:Counter")
        assert out.returncode == 0, out.stderr
        assert "xlang-actor-" in out.stdout


# ------------------------------------------------------------- Java (JDK)


@pytest.fixture(scope="module")
def java_client():
    return native_build.build_java()


def _java(classdir, *args):
    return subprocess.run(["java", "-cp", classdir, "RayTpuClient", *args],
                          capture_output=True, text=True, timeout=60)


@jdk
def test_java_submit_roundtrip(java_client, port_head):
    addr, _ = port_head
    out = _java(java_client, addr, "xlang_funcs:add", "[2, 3]")
    assert out.returncode == 0, out.stderr
    assert '"result": 5' in out.stdout or '"result":5' in out.stdout


@jdk
def test_java_actor_roundtrip(java_client, port_head):
    addr, _ = port_head
    out = _java(java_client, addr, "actor-create", "xlang_funcs:Counter",
                "[7]", '{"name": "java-counter"}')
    assert out.returncode == 0, out.stderr
    out = _java(java_client, addr, "actor-call", "java-counter", "inc",
                "[3]")
    assert out.returncode == 0, out.stderr
    assert '": 10' in out.stdout or '":10' in out.stdout
    out = _java(java_client, addr, "actor-kill", "java-counter")
    assert out.returncode == 0, out.stderr


# ------------------------------------------- the wire across both packages

# (task_client's arguments after the address); the actor's name is one per
# client, so both clients run the same scenario against one head
_SCENARIO = (
    ("xlang_funcs:add", "[2, 3]"),
    ("xlang_funcs:greet", '["wire"]'),
    ("xlang_funcs:no_such_fn",),
    ("actor-create", "xlang_funcs:Counter", "[10]", '{"name": "{actor}"}'),
    ("actor-call", "{actor}", "inc", "[5]"),
    ("actor-call", "{actor}", "value"),
    ("actor-kill", "{actor}"),
    ("actor-call", "{actor}", "value"),
)


def _scenario(binary, addr, actor):
    """[(exit code, stdout with the actor's name blanked, whether stderr
    says error)] for each step of _SCENARIO."""
    rows = []
    for step in _SCENARIO:
        out = _run(binary, addr, *(a.replace("{actor}", actor)
                                   for a in step))
        rows.append((out.returncode, out.stdout.replace(actor, "<actor>"),
                     "error" in out.stderr.lower()))
    return rows


@pytest.fixture(scope="module")
def wire(task_client):
    """The scenario from the port's and the reference's task_client
    against the reference's head, then against the port's:
    {(head, client): rows}."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.native.build import build_binary as ref_build_binary

    clients = {"port": task_client, "ref": ref_build_binary("task_client")}
    got = {}
    for head_name, pkg, kw in (("ref", ray_tpu, {"num_tpus": 0}),
                               ("port", ray_tpu_torch, {"num_gpus": 0})):
        info = pkg.init(num_cpus=2, **kw)
        try:
            addr = info.head.enable_tcp(host="127.0.0.1",
                                        advertise_ip="127.0.0.1")
            for client, binary in clients.items():
                got[head_name, client] = _scenario(
                    binary, addr, f"wire-{client}")
        finally:
            pkg.shutdown()
    return got


def test_wire_scenario_holds_on_each_head(wire):
    for rows in wire.values():
        assert [r[0] for r in rows] == [0, 0, 1, 0, 0, 0, 0, 1]
        assert [r[1].strip() for r in rows[:2]] == ["5", "hello wire"]
        assert rows[2][2] and rows[7][2]
        assert [r[1].strip() for r in rows[4:6]] == ["15", "15"]


@pytest.mark.parametrize("pair", [("port", "ref"), ("ref", "port")],
                         ids=["port_client_ref_head", "ref_client_port_head"])
def test_wire_parity_across_packages(wire, pair):
    """The one client against the other package's head answers as the
    reference's client against the reference's head: the same exit codes,
    the same output, errors reported alike."""
    head, client = pair
    assert wire[head, client] == wire["ref", "ref"]
    assert wire[head, client] == wire["port", "port"]


def test_cpp_example_same_bytes_in_reference_and_port_arenas(cpp_example):
    """The port's client_example against an arena of each package: Python
    puts, C++ gets; C++ puts, Python gets; the same bytes and output."""
    from ray_tpu.core.ids import ObjectID as RefObjectID
    from ray_tpu.core.object_store import ShmObjectStore as RefStore

    payload = bytes(range(32, 127)).decode()
    seen = {}
    for name, cls, oid_cls in (("ref", RefStore, RefObjectID),
                               ("port", ShmObjectStore, ObjectID)):
        arena = f"{_arena_name()}_{name}"
        s = cls(arena, 8 * 1024 * 1024, create=True)
        try:
            a, b = oid_cls(b"\x01" * 20), oid_cls(b"\x02" * 20)
            s.put_raw(a, payload.encode())
            got = _run(cpp_example, arena, "get", a.hex())
            put = _run(cpp_example, arena, "put", b.hex(), payload[::-1])
            seen[name] = (got.returncode, got.stdout, put.returncode,
                          put.stdout, s.get_raw(b))
        finally:
            s.close()
    assert seen["ref"] == seen["port"]
    assert seen["port"][0] == seen["port"][2] == 0
    assert f"{len(payload)} bytes: {payload}" in seen["port"][1]
    assert seen["port"][4] == payload[::-1].encode()


def test_build_outputs_lie_under_dot_build(cpp_example, task_client):
    build_dir = _ROOT / ".build" / "ray_tpu_torch"
    outs = [Path(cpp_example), Path(task_client),
            *(Path(native_build.lib_path(lib))
              for lib in native_build.TARGETS)]
    if shutil.which("javac"):
        outs.append(Path(native_build.build_java()))
    for out in outs:
        assert out.exists() and build_dir in out.parents, out
    # the package holds its sources and nothing built
    sources = {".py", ".cc", ".h", ".java", ".md"}
    for sub in ("native", "java"):
        for f in (_ROOT / "ray_tpu_torch" / sub).iterdir():
            assert f.name == "__pycache__" or f.suffix in sources, f
