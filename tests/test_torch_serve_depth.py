"""The port's Serve in depth: the cases of tests/test_serve_depth.py
(streaming responses, model multiplexing, declarative config, the proxy
fleet) and tests/test_serve_grpc.py (gRPC ingress; skipped without grpc,
as there), one for one, on ray_tpu_torch.init(num_cpus=4, num_gpus=0), with
test_cli_serve_and_job_parsers on the port's CLI (``scripts``)."""

import json
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture
def serve_rt():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_streaming_response_via_handle(serve_rt):
    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(int(n)):
                yield i * i

    handle = serve.run(Streamer.bind(), name="stream_app")
    gen = handle.options(stream=True).remote(5)
    assert list(gen) == [0, 1, 4, 9, 16]
    # a second stream on the same replica pool works (slot released)
    assert list(handle.options(stream=True).remote(3)) == [0, 1, 4]
    # a non-streaming call on a generator callable surfaces an error
    # (the reference likewise requires stream=True for generators)
    with pytest.raises(Exception, match="generator"):
        handle.remote(2).result(timeout_s=30)


def test_streaming_over_http(serve_rt):
    @serve.deployment
    def token_stream(prompt):
        for tok in ("a", "b", "c"):
            yield {"token": tok}

    serve.run(token_stream.bind(), name="http_stream",
              route_prefix="/gen")
    from ray_tpu_torch.serve import HTTPOptions

    port = serve.start(HTTPOptions(port=0))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/gen", data=b'"hi"',
        headers={"X-Serve-Stream": "1",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers.get("Content-Type") == "application/x-ndjson"
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
    assert lines == [{"token": "a"}, {"token": "b"}, {"token": "c"}]


def test_multiplexed_models(serve_rt):
    loads = []

    @serve.deployment(num_replicas=1)
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            loads.append(model_id)
            return lambda x, m=model_id: f"{m}:{x}"

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            return self.get_model(mid)(x)

    handle = serve.run(Multi.bind(), name="mux")

    def call(mid, x):
        return handle.options(multiplexed_model_id=mid).remote(
            x).result(timeout_s=30)

    assert call("m1", 1) == "m1:1"
    assert call("m2", 2) == "m2:2"
    assert call("m1", 3) == "m1:3"   # cached — no reload
    assert call("m3", 4) == "m3:4"   # evicts LRU (m2)
    assert call("m2", 5) == "m2:5"   # m2 reloads


def test_multiplexed_lru_eviction_unit():
    from ray_tpu_torch.serve.multiplex import _ModelMultiplexWrapper

    loaded, unloaded = [], []

    class M:
        def __init__(self, mid):
            self.mid = mid

        def unload(self):
            unloaded.append(self.mid)

    def loader(mid):
        loaded.append(mid)
        return M(mid)

    w = _ModelMultiplexWrapper(loader, None, max_models=2)
    w.load_model("a")
    w.load_model("b")
    w.load_model("a")          # refresh a's recency
    w.load_model("c")          # evicts b (LRU)
    assert loaded == ["a", "b", "c"]
    assert unloaded == ["b"]
    assert set(w.loaded_model_ids()) == {"a", "c"}


def test_deploy_from_config(serve_rt, tmp_path):
    cfg = {
        "applications": [{
            "name": "cfg_app",
            "import_path": "tests.torch_serve_config_target:app",
            "route_prefix": "/cfg",
            "deployments": [{"name": "Echo", "num_replicas": 2}],
        }]
    }
    path = tmp_path / "serve.yaml"
    import yaml

    path.write_text(yaml.safe_dump(cfg))
    names = serve.deploy_config(str(path))
    assert names == ["cfg_app"]
    handle = serve.get_app_handle("cfg_app")
    assert handle.remote("x").result(timeout_s=60) == "echo:x"
    st = serve.status()["applications"]
    assert st["cfg_app"]["status"] == "RUNNING"
    # the num_replicas override took effect
    deps = st["cfg_app"]["deployments"]
    assert deps["Echo"]["target_replicas"] == 2


def test_cli_serve_and_job_parsers():
    from ray_tpu_torch.scripts import build_parser

    p = build_parser()
    a = p.parse_args(["serve", "deploy", "cfg.yaml"])
    assert a.serve_cmd == "deploy" and a.config_file == "cfg.yaml"
    a = p.parse_args(["serve", "run", "mod:app", "--name", "x"])
    assert a.import_path == "mod:app" and a.name == "x"
    a = p.parse_args(["serve", "status"])
    assert a.serve_cmd == "status"
    a = p.parse_args(["job", "submit", "--", "python", "x.py"])
    assert a.job_cmd == "submit"
    a = p.parse_args(["job", "logs", "some-job"])
    assert a.job_id == "some-job"


def test_streaming_with_multiplexed_model(serve_rt):
    """Generator bodies run lazily in stream_next — the multiplexed
    model id must be live there, not just in start_stream."""
    @serve.deployment(num_replicas=1)
    class MuxStream:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return model_id.upper()

        def __call__(self, n):
            model = self.get_model(serve.get_multiplexed_model_id())
            for i in range(int(n)):
                yield f"{model}-{i}"

    handle = serve.run(MuxStream.bind(), name="muxstream")
    out = list(handle.options(stream=True,
                              multiplexed_model_id="m1").remote(3))
    assert out == ["M1-0", "M1-1", "M1-2"]


def test_proxy_fleet_every_node(serve_rt):
    """HTTPOptions(location="EveryNode") pins one proxy per node, all
    serving the same routes (ref: per-node http_state proxy fleet)."""
    from ray_tpu_torch.core.api import _head
    from ray_tpu_torch.serve import HTTPOptions

    _head.add_node(num_cpus=1)  # second logical node

    @serve.deployment
    def hello(x):
        return {"hi": x}

    serve.run(hello.bind(), name="fleet", route_prefix="/fleet")
    serve.start(HTTPOptions(port=0, location="EveryNode"))
    ports = serve.proxy_ports()
    assert set(ports) == {0, 1}
    for port in ports.values():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/fleet", data=b'"x"',
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"hi": "x"}


# ---- gRPC ingress (tests/test_serve_grpc.py) ----------------------------


@pytest.fixture
def grpc(serve_rt):
    """The grpc module, on a fresh runtime; skips without grpc."""
    yield pytest.importorskip("grpc")


@serve.deployment
def echo(x):
    return {"echo": x}


@serve.deployment
class Streamer:
    def __call__(self, n):
        for i in range(int(n)):
            yield {"i": i}


def _channel(grpc, port):
    return grpc.insecure_channel(f"127.0.0.1:{port}")


def _unary(channel, method, payload=b"", metadata=None):
    fn = channel.unary_unary(
        f"/ray.serve.ServeAPIService/{method}",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b)
    return fn(payload, metadata=metadata, timeout=30)


class TestGrpcIngress:
    def test_healthz_and_predict(self, grpc):
        serve.run(echo.bind(), name="echoapp", route_prefix="/echo")
        port = serve.start_grpc()
        with _channel(grpc, port) as ch:
            assert json.loads(_unary(ch, "Healthz"))["status"] == "ok"
            apps = json.loads(_unary(ch, "ListApplications"))
            assert "echoapp" in apps
            out = _unary(ch, "Predict", json.dumps(7).encode(),
                         metadata=(("application", "echoapp"),))
            assert json.loads(out) == {"echo": 7}

    def test_single_app_default_routing(self, grpc):
        serve.run(echo.bind(), name="only", route_prefix="/only")
        port = serve.start_grpc()
        with _channel(grpc, port) as ch:
            out = _unary(ch, "Predict", json.dumps("hi").encode())
            assert json.loads(out) == {"echo": "hi"}

    def test_unknown_app_not_found(self, grpc):
        serve.run(echo.bind(), name="a1", route_prefix="/a1")
        serve.run(echo.bind(), name="a2", route_prefix="/a2")
        port = serve.start_grpc()
        with _channel(grpc, port) as ch:
            with pytest.raises(grpc.RpcError) as e:
                _unary(ch, "Predict", b"1",
                       metadata=(("application", "nope"),))
            assert e.value.code() == grpc.StatusCode.NOT_FOUND

    def test_streaming(self, grpc):
        serve.run(Streamer.bind(), name="stream", route_prefix="/stream")
        port = serve.start_grpc()
        with _channel(grpc, port) as ch:
            fn = ch.unary_stream(
                "/ray.serve.ServeAPIService/Streaming",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            items = [json.loads(b) for b in
                     fn(json.dumps(4).encode(),
                        metadata=(("application", "stream"),),
                        timeout=60)]
        assert items == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]

    def test_idempotent_start_same_port(self, grpc):
        serve.run(echo.bind(), name="idem", route_prefix="/idem")
        p1 = serve.start_grpc()
        p2 = serve.start_grpc()
        assert p1 == p2
