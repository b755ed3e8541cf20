"""HTTP ingress proxy: asyncio event loop routing requests to app handles.

Ref analog: python/ray/serve/_private/http_proxy.py:661 (HTTPProxyActor
over uvicorn/ASGI). Re-design: a stdlib ``asyncio.start_server`` HTTP/1.1
server inside a plain actor — no ASGI layer; JSON bodies map to handle
args, results map back to JSON. One event loop handles every connection
(keep-alive included); awaiting a response rides ObjectRef.__await__'s
callback future, so an in-flight request costs a coroutine, not a
thread. Explicit backpressure: at most ``max_inflight`` requests execute
concurrently, at most ``max_queued`` wait behind them, and everything
beyond that is refused with 503 + Retry-After (the reference's
proxy-level backpressure knob family: max_ongoing_requests/queue len).

Routes come from the controller's route table (route_prefix -> app),
longest prefix wins, refreshed with a small TTL.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import ray_tpu_torch

PROXY_NAME = "SERVE_HTTP_PROXY"
_ROUTES_TTL_S = 1.0
_MAX_HEADER = 64 * 1024
_MAX_BODY = 64 * 1024 * 1024
_REQUEST_TIMEOUT_S = 60.0


class _BadRequest(Exception):
    pass


class _CloseConnection(Exception):
    """Raised after response bytes are already on the wire in a shape
    that cannot be followed by another response (e.g. an aborted chunked
    stream) — the connection must close, not 500."""


class HTTPProxy:
    """Actor hosting the asyncio HTTP server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_inflight: int = 64, max_queued: int = 128):
        self._routes = {}
        self._routes_at = 0.0
        self._controller = None
        self._max_inflight = max_inflight
        self._max_queued = max_queued
        self._inflight = 0
        self._queued = 0
        # blocking runtime calls (handle submission, route refresh) run
        # here so the event loop never blocks; stream pumps get their OWN
        # pool because each occupies a thread for its stream's lifetime
        # and must not starve short-lived submissions
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="serve-io")
        self._stream_pool = ThreadPoolExecutor(
            max_workers=max(max_inflight, 1),
            thread_name_prefix="serve-stream")
        self._refresh_fut = None  # in-flight route refresh (coalesced)
        self._handles = {}        # app -> DeploymentHandle (TTL = routes)
        self._sem: Optional[asyncio.Semaphore] = None
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self._port = 0

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._start(host, port))
            self._started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-http")
        self._thread.start()
        if not self._started.wait(30):
            raise RuntimeError("http proxy failed to start")

    async def _start(self, host: str, port: int):
        self._sem = asyncio.Semaphore(self._max_inflight)
        self._server = await asyncio.start_server(
            self._handle_conn, host, port, limit=_MAX_HEADER)
        self._port = self._server.sockets[0].getsockname()[1]

    # -------------------------------------------------------- http plumbing

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            while True:  # HTTP/1.1 keep-alive loop
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                try:
                    await self._dispatch(method, path, headers, body,
                                         writer)
                except (ConnectionResetError, BrokenPipeError,
                        _CloseConnection):
                    break
                except Exception as e:  # noqa: BLE001 — surface to client
                    await self._reply(writer, 500, json.dumps(
                        {"error": repr(e)}).encode())
                if not keep:
                    break
        except _BadRequest as e:
            try:
                await self._reply(writer, 400, json.dumps(
                    {"error": str(e)}).encode())
            except Exception:  # noqa: BLE001
                pass
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionResetError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader) -> Optional[Tuple]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        lines = head.decode("latin1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 3:
            return None
        method, target = parts[0], parts[1]
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length") or 0)
        except ValueError:
            raise _BadRequest("invalid Content-Length") from None
        if n < 0 or n > _MAX_BODY:
            raise _BadRequest("Content-Length out of range")
        body = await reader.readexactly(n) if n else b""
        return method, target, headers, body

    async def _reply(self, writer, code: int, payload: bytes,
                     ctype: str = "application/json",
                     extra: str = ""):
        status = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(code, "OK")
        writer.write(
            f"HTTP/1.1 {code} {status}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n{extra}"
            f"\r\n".encode("latin1") + payload)
        await writer.drain()

    # ------------------------------------------------------------ dispatch

    async def _dispatch(self, method, target, headers, body, writer):
        path = target.split("?", 1)[0]
        if path == "/-/healthz":
            await self._reply(writer, 200, b'"ok"')
            return
        if path == "/-/routes":
            table = await self._route_table_async()
            await self._reply(writer, 200, json.dumps(table).encode())
            return
        app = self._match(await self._route_table_async(), path)
        if app is None:
            await self._reply(writer, 404, json.dumps(
                {"error": f"no app mounted at {path}"}).encode())
            return
        # ---- backpressure gate (FIFO: asyncio.Semaphore wakes waiters
        # in acquisition order). EVERY acquirer counts as queued while it
        # waits — gating on an inflight counter instead would let
        # requests arriving in the release->wakeup window wait uncounted,
        # bypassing the max_queued cap.
        if self._sem.locked() and self._queued >= self._max_queued:
            await self._reply(writer, 503, json.dumps(
                {"error": "proxy saturated"}).encode(),
                extra="Retry-After: 1\r\n")
            return
        self._queued += 1
        try:
            await self._sem.acquire()
        finally:
            self._queued -= 1
        self._inflight += 1
        try:
            arg = None
            if body:
                if headers.get("content-type", "").startswith(
                        "application/octet-stream"):
                    # raw-bytes passthrough (r14): binary payloads must
                    # not be lossily utf-8-decoded, and a large body
                    # handed to the handle as bytes rides the zero-copy
                    # by-ref ingress path end-to-end
                    arg = body
                else:
                    try:
                        arg = json.loads(body)
                    except json.JSONDecodeError:
                        arg = body.decode("utf-8", "replace")
            loop = asyncio.get_running_loop()
            handle = await loop.run_in_executor(
                self._pool, self._app_handle, app)
            if headers.get("x-serve-stream") == "1":
                await self._stream(handle, arg, writer)
                return
            # submission may block on routing metadata -> executor;
            # awaiting the response rides the ref's callback future. The
            # timeout frees the inflight slot if a replica hangs — a dead
            # replica must not eat the proxy's whole concurrency budget
            resp = await loop.run_in_executor(
                self._pool, lambda: handle.remote(arg))
            result = await asyncio.wait_for(resp, _REQUEST_TIMEOUT_S)
            if isinstance(result, bytes):
                await self._reply(writer, 200, result,
                                  "application/octet-stream")
            else:
                await self._reply(writer, 200, json.dumps(result).encode())
        finally:
            self._inflight -= 1
            self._sem.release()

    async def _stream(self, handle, arg, writer):
        """Chunked ndjson streaming (ref: StreamingResponse over a
        generator deployment, replica.py:339). The sync generator is
        consumed on an executor thread feeding an asyncio queue; client
        disconnects propagate back and release the replica slot."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue(maxsize=32)
        done = object()
        stop = threading.Event()

        gen = await loop.run_in_executor(
            self._pool, lambda: handle.options(stream=True).remote(arg))
        headers_sent = False

        def put_item(item) -> bool:
            """Enqueue from the pump thread; abandons quickly once the
            consumer stopped (a slow/gone client must not pin this pool
            thread for a long blocking put)."""
            while not stop.is_set():
                fut = asyncio.run_coroutine_threadsafe(q.put(item), loop)
                try:
                    fut.result(timeout=1.0)
                    return True
                except TimeoutError:
                    # cancel() returning False means the put WON the race
                    # with the timeout and (is) completing — retrying
                    # then would enqueue the item twice, corrupting the
                    # stream; wait out its final state instead
                    if not fut.cancel():
                        try:
                            fut.result(timeout=5.0)
                            return True
                        except Exception:  # noqa: BLE001
                            return False
                except Exception:  # noqa: BLE001 — loop closing
                    return False
            return False

        def pump():
            try:
                for item in gen:
                    if not put_item(item):
                        return
                put_item(done)
            except Exception as e:  # noqa: BLE001
                put_item(e)
            finally:
                gen.close()  # releases the replica slot

        self._stream_pool.submit(pump)
        try:
            while True:
                # bounded inter-item gap: a hung replica generator must
                # not hold this inflight slot forever (mirrors the
                # non-stream path's request timeout)
                item = await asyncio.wait_for(q.get(),
                                              _REQUEST_TIMEOUT_S)
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                if not headers_sent:
                    writer.write(b"HTTP/1.1 200 OK\r\n"
                                 b"Content-Type: application/x-ndjson\r\n"
                                 b"Transfer-Encoding: chunked\r\n\r\n")
                    headers_sent = True
                chunk = (json.dumps(item) + "\n").encode()
                writer.write(f"{len(chunk):x}\r\n".encode()
                             + chunk + b"\r\n")
                await writer.drain()  # slow-client backpressure
            if not headers_sent:
                writer.write(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Type: application/x-ndjson\r\n"
                             b"Transfer-Encoding: chunked\r\n\r\n")
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            raise
        except Exception as e:  # noqa: BLE001
            if not headers_sent:
                stop.set()
                raise  # no bytes on the wire yet: a clean 500 is fine
            # mid-stream failure: a second status line would desync the
            # chunked encoding — emit an error record, terminate the
            # encoding, and close the connection
            try:
                chunk = (json.dumps({"error": repr(e)}) + "\n").encode()
                writer.write(f"{len(chunk):x}\r\n".encode()
                             + chunk + b"\r\n" + b"0\r\n\r\n")
                await writer.drain()
            except Exception:  # noqa: BLE001
                pass
            raise _CloseConnection() from e
        finally:
            stop.set()

    # ------------------------------------------------------------- helpers

    def _controller_handle(self):
        if self._controller is None:
            from .controller import CONTROLLER_NAME

            self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller

    def _refresh_routes(self) -> dict:
        try:
            self._routes = ray_tpu_torch.get(
                self._controller_handle().get_routes.remote(), timeout=10)
            self._routes_at = time.monotonic()
            # ingress handles share the routes' freshness window; a
            # redeploy that changes an app's ingress is picked up on the
            # next refresh
            self._handles = {}
        except Exception:  # noqa: BLE001 — keep serving the stale table
            pass
        return self._routes

    async def _route_table_async(self) -> dict:
        if time.monotonic() - self._routes_at > _ROUTES_TTL_S:
            # coalesce: at most ONE controller RPC in flight no matter
            # how many requests cross the TTL boundary together
            if self._refresh_fut is None:
                loop = asyncio.get_running_loop()
                self._refresh_fut = loop.run_in_executor(
                    self._pool, self._refresh_routes)
                try:
                    return await self._refresh_fut
                finally:
                    self._refresh_fut = None
            return await asyncio.shield(self._refresh_fut)
        return self._routes

    @staticmethod
    def _match(table: dict, path: str) -> Optional[str]:
        best, best_len = None, -1
        for prefix, app in table.items():
            norm = prefix.rstrip("/") or "/"
            if (path == norm or path.startswith(norm.rstrip("/") + "/")
                    or norm == "/") and len(norm) > best_len:
                best, best_len = app, len(norm)
        return best

    def _app_handle(self, app: str):
        from .handle import DeploymentHandle

        handle = self._handles.get(app)
        if handle is None:
            # one controller RPC per app per routes-refresh window — NOT
            # per request (the per-request RPC dominated proxy latency)
            ingress = ray_tpu_torch.get(
                self._controller_handle().get_ingress.remote(app),
                timeout=10)
            handle = DeploymentHandle(ingress, app)
            self._handles[app] = handle
        return handle

    # -------------------------------------------------------------- public

    def port(self) -> int:
        return self._port

    def ready(self) -> bool:
        return True

    def stats(self) -> dict:
        return {"inflight": self._inflight, "queued": self._queued}

    def stop(self):
        def _shutdown():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_shutdown)
        self._pool.shutdown(wait=False)
        self._stream_pool.shutdown(wait=False)
        return True
