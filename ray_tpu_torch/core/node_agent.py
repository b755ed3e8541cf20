"""Node agent: joins a remote host to a head over TCP.

Ref analog: the raylet (src/ray/raylet/main.cc:113 — per-node daemon that
registers with the GCS, owns the local object store, and forks workers).
Re-designed small: the head keeps all scheduling state; the agent only
(1) creates the host-local shm object store, (2) forks/kills workers on
demand, (3) serves object reads/writes so the head can move objects
between hosts over the TCP control links.

Run:  python -m ray_tpu_torch.core.node_agent --address tcp:HEAD_IP:PORT \
          [--num-cpus N] [--num-gpus N]
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, Optional

from . import protocol as P
from .config import get_config, runtime_tmp_dir
from .ids import ObjectID
from .object_store import ShmObjectStore
from .resources import detect_node_resources


def _my_ip(head_host: str, head_port: int) -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((head_host, head_port))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


class NodeAgent:
    def __init__(self, head_addr: str, *, num_cpus=None, num_gpus=None,
                 object_store_memory=None, resources=None, labels=None):
        assert head_addr.startswith("tcp:"), "agents join over tcp:"
        _, host, port = head_addr.split(":")
        self.head_addr = head_addr
        self.node_ip = _my_ip(host, int(port))
        cfg = get_config()
        cap = object_store_memory or cfg.object_store_memory
        self.store_name = f"rtpu_agent_{uuid.uuid4().hex[:10]}"
        self.store = ShmObjectStore(self.store_name, cap, create=True)
        # agent-side arena evictions (pull/relay writes squeezing out LRU
        # objects) drop copies the head's object directory still lists —
        # report them so pulls stop targeting this host for those ids.
        # Async: evict() fires inside store.create on the allocating
        # thread (the puller IO thread included) and must not block there.
        self.store.on_evict = self._report_evictions_async
        self.session_dir = os.path.join(runtime_tmp_dir(),
                                        f"agent_{uuid.uuid4().hex[:8]}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.workers: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        # None until REGISTER_NODE's reply lands. The head may race a
        # SPAWN_WORKER onto the socket ahead of that reply (its keeper
        # thread fulfills queued leases the moment the node appears in
        # its tables); those spawns buffer here instead of being dropped.
        self.node_idx: Optional[int] = None
        self._pre_registration_spawns: list = []

        nr = detect_node_resources(num_cpus=num_cpus, num_gpus=num_gpus,
                                   object_store_memory=cap,
                                   resources=resources, labels=labels)
        self._node_resources = nr  # re-sent on re-registration
        self.io = P.IOLoop("agent-io")
        # Direct peer-to-peer object plane (object_transfer.py): this host
        # serves its arena to peers and pulls from theirs — payloads never
        # transit the head.
        from .object_transfer import ObjectPuller, TransferServer

        self.transfer_server = TransferServer(
            self.io, self._read_object, advertise_ip=self.node_ip,
            partial_fn=self.store.partial)
        self.puller = ObjectPuller(self.io, self.store)
        # Reconnecting head channel (GCS-FT analog: the raylet's GCS RPC
        # client retrying across a gcs_server restart): on socket loss
        # the agent re-dials up to head_reconnect_timeout_s, then
        # re-registers with its prior node id, live worker set, and a
        # full holder report so a restarted head rebuilds its node table
        # and object directory from this host's truth. on_close fires
        # only when the window expires — the pre-r12 fail-fast shutdown.
        self.head = P.ReconnectingConnection(
            head_addr, client_id=f"agent:{self.store_name}", peer="head",
            on_reattach=self._on_head_reattach)
        self.head.on_close = lambda c: self._shutdown.set()
        self.io.add_connection(self.head, self._on_head_message)
        self.io.start()
        reply = self.head.call(P.REGISTER_NODE, nr, self.store_name,
                               self.node_ip, self.session_dir,
                               self.transfer_server.addr, timeout=30)
        self.session_name = reply[1]
        with self._lock:
            self.node_idx = reply[0]
            buffered, self._pre_registration_spawns = \
                self._pre_registration_spawns, []
        for worker_id in buffered:
            self._spawn_worker(worker_id)
        # Tail THIS host's worker logs and publish them through the head's
        # "logs" channel so remote tasks' prints reach the driver too
        # (reference: one log_monitor per node, log_monitor.py:103).
        from .log_monitor import LogMonitor
        from .serialization import dumps as _dumps

        def _forward(ch, data):
            data = dict(data)
            data["source"] = f"node{self.node_idx}-" + data.get("source", "")
            try:
                self.head.send(P.PUBLISH, ch, _dumps(data))
            except P.ConnectionLost:
                pass

        self.log_monitor = LogMonitor(self.session_dir, _forward)
        self.log_monitor.start()
        # Physical telemetry for this host -> node.* gauges through the
        # head's metrics channel (reference: reporter_agent.py).
        from .reporter import NodeTelemetryReporter

        def _publish_metrics(batch):
            try:
                self.head.send(P.METRICS_REPORT, batch)
            except P.ConnectionLost:
                pass

        self.telemetry = NodeTelemetryReporter(
            _publish_metrics,
            lambda: [(self.node_idx, self.store)])
        self.telemetry.start()
        # Worker-crash watcher: the head only learns of a remote worker's
        # death via its socket close — the structured WHY (exit signal,
        # OOM kill) is only visible here, next to the process (reference:
        # the raylet's worker-death reporting + the reporter agent's OOM
        # detection feeding the event log).
        self._reaper = threading.Thread(target=self._reap_workers,
                                        daemon=True, name="agent-reaper")
        self._reaper.start()

    def _read_object(self, oid: ObjectID):
        got = self.store.get(oid)
        if got is None:
            return None
        data_v, meta_v = got
        return data_v, bytes(meta_v), lambda: self.store.release(oid)

    # -------------------------------------------------------- head messages

    def _on_head_message(self, conn: P.Connection, msg):
        mt, rid = msg[0], msg[1]
        try:
            if mt == P.SPAWN_WORKER:
                with self._lock:
                    if self.node_idx is None:
                        self._pre_registration_spawns.append(msg[2])
                        return
                self._spawn_worker(msg[2])
            elif mt == P.KILL_WORKER:
                self._kill_worker(msg[2])
            elif mt == P.AGENT_OBJ_GET:
                oid = ObjectID(msg[2])
                got = self.store.get(oid)
                if got is None:
                    conn.reply(rid, None, b"")
                else:
                    data_v, meta_v = got
                    try:
                        conn.reply(rid, bytes(data_v), bytes(meta_v))
                    finally:
                        del data_v, meta_v, got
                        self.store.release(oid)
            elif mt == P.AGENT_OBJ_PUT:
                oid = ObjectID(msg[2])
                payload, meta = msg[3], msg[4]
                if not self.store.contains(oid):
                    buf = self.store.create(oid, len(payload), len(meta))
                    buf[:len(payload)] = payload
                    buf[len(payload):] = meta
                    self.store.seal(oid)
                conn.reply(rid, True)
            elif mt == P.PULL_OBJECT:
                # head says: fetch this object straight from peer hosts —
                # msg carries the directory's holder-address list (or one
                # addr string), the object size for stripe planning, the
                # broadcast planner's stripe cap + relay markers, and the
                # r13 prefetch flag (speculative pull fired at lease
                # grant/dispatch: one-way, acked via PREFETCH_RESULT)
                oid, peers = ObjectID(msg[2]), msg[3]
                size = msg[4] if len(msg) > 4 else -1
                max_sources = msg[5] if len(msg) > 5 else 0
                relays = msg[6] if len(msg) > 6 else ()
                prefetch = bool(msg[7]) if len(msg) > 7 else False
                threading.Thread(
                    target=self._do_pull,
                    args=(conn, rid, oid, peers, size, max_sources,
                          relays, prefetch),
                    daemon=True).start()
            elif mt == P.PULL_ABORT:
                # stale speculation: the prefetched task was cancelled /
                # retried elsewhere — the puller honors this only for
                # prefetch-flagged pulls no demand get() has joined
                self.puller.abort(ObjectID(msg[2]))
            elif mt == P.AGENT_OBJ_FREE:
                for ob in msg[2]:
                    self.store.delete(ObjectID(ob))
            elif mt == P.SHUTDOWN_NODE:
                # deliberate eviction/cluster shutdown: die now — do
                # NOT ride the reconnect window (that is for head
                # CRASHES, where re-registration brings us back)
                self._shutdown.set()
            elif mt == P.PING:
                # health probe doubles as the clock-offset sampler: the
                # head takes the RTT midpoint of this call against our
                # monotonic clock to fold this host's task-event stamps
                # into its own timebase (wall clock rides along for
                # display-only diagnostics)
                conn.reply(rid, True, time.monotonic(), time.time())
        except Exception as e:  # noqa: BLE001
            if rid > 0:
                conn.reply_error(rid, e)

    def _do_pull(self, conn: P.Connection, rid: int, oid: ObjectID,
                 peers, size: int = -1, max_sources: int = 0,
                 relays=(), prefetch: bool = False):
        try:
            ok = self.puller.pull(oid, peers, size_hint=size,
                                  max_sources=max_sources,
                                  relay_addrs=relays, prefetch=prefetch)
            if ok and self.node_idx is not None:
                # report the gained copy so the directory lists this node
                # as a holder independent of the broker path's bookkeeping
                # (idempotent with the head's own _directory_add)
                try:
                    self.head.send(P.OBJ_LOCATION_ADD, oid.binary(),
                                   self.node_idx, max(size, 0))
                except P.ConnectionLost:
                    pass
            if prefetch:
                # one-way speculative pull: no blocked caller to reply
                # to — the result frame lets the head release the source
                # charges it registered at issue time
                try:
                    conn.send(P.PREFETCH_RESULT, oid.binary(),
                              self.node_idx if self.node_idx is not None
                              else -1, ok)
                except P.ConnectionLost:
                    pass
                return
            conn.reply(rid, ok)
        except Exception as e:  # noqa: BLE001
            if prefetch:
                try:
                    conn.send(P.PREFETCH_RESULT, oid.binary(),
                              self.node_idx if self.node_idx is not None
                              else -1, False)
                except P.ConnectionLost:
                    pass
            elif rid > 0:
                try:
                    conn.reply_error(rid, e)
                except P.ConnectionLost:
                    pass

    def _report_evictions_async(self, oids):
        """store.on_evict hook: report off-thread so the allocating thread
        never blocks on a head socket write."""
        from .object_transfer import send_eviction_report_async

        if self.node_idx is None or self._shutdown.is_set():
            return
        send_eviction_report_async(self.head, self.node_idx, oids)

    def _on_head_reattach(self, conn):
        """Reconnector-thread hook: the head channel came back (possibly
        to a RESTARTED head with empty tables) — re-register carrying
        our prior node id, the live worker set, and a holder report of
        every sealed object in this host's arena, so the head rebuilds
        its node table and object directory from holder truth
        (reference: raylet re-registration within
        gcs_rpc_server_reconnect_timeout_s)."""
        if self._shutdown.is_set():
            return
        with self._lock:
            prior = self.node_idx if self.node_idx is not None else -1
            wids = [wid for wid, p in self.workers.items()
                    if p.poll() is None]
        # full report: the native table holds at most 65536 entries, so
        # this cap is exhaustive; a report that FILLS it still warns —
        # a silent truncation would read as "directory rebuilt" while
        # pre-crash objects quietly went missing
        listed = self.store.list_objects(max_objects=65536)
        if len(listed) >= 65536:
            print("[ray_tpu] holder report hit the 65536-entry cap; "
                  "directory rebuild may be incomplete", flush=True)
        holders = [(oid.binary(), size) for oid, size in listed]
        reply = conn.call(P.REGISTER_NODE, self._node_resources,
                          self.store_name, self.node_ip, self.session_dir,
                          self.transfer_server.addr, prior, wids, holders,
                          timeout=30)
        with self._lock:
            self.node_idx = reply[0]
        self.session_name = reply[1]

    # ------------------------------------------------------------- workers

    def _spawn_worker(self, worker_id: str):
        env = dict(os.environ)
        import ray_tpu_torch

        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        entries = [p for p in sys.path if p] + [pkg_parent]
        pp = env.get("PYTHONPATH", "")
        have = set(pp.split(os.pathsep)) if pp else set()
        add = [p for p in entries if p not in have]
        if add:
            env["PYTHONPATH"] = os.pathsep.join(add + ([pp] if pp else []))
        env.update({
            "RAY_TPU_WORKER_ID": worker_id,
            "RAY_TPU_HEAD_ADDR": self.head_addr,
            "RAY_TPU_NODE_IDX": str(self.node_idx),
            "RAY_TPU_SESSION_DIR": self.session_dir,
            "RAY_TPU_NODE_IP": self.node_ip,
        })
        if self._node_resources.total.get("GPU") <= 0:
            # see head._popen_worker: no card for workers of a GPU-less node
            env["CUDA_VISIBLE_DEVICES"] = ""
        log_dir = os.path.join(self.session_dir, "logs")
        out = open(os.path.join(log_dir, f"worker-{worker_id[:8]}.out"),
                   "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        with self._lock:
            self.workers[worker_id] = proc

    def _kill_worker(self, worker_id: str):
        with self._lock:
            proc = self.workers.pop(worker_id, None)
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass

    def _reap_workers(self):
        """Emit a cluster event for every worker that dies WITHOUT the
        head asking (head-requested kills leave self.workers first, in
        _kill_worker). Exit by SIGKILL under host memory pressure is
        classified as an OOM kill — the kernel's oom-killer leaves no
        other trace than the signal. Pressure is judged by the RECENT
        PEAK of usage, not the instant of reaping: the kill itself frees
        the victim's memory, so by the time the poll sees the corpse the
        live reading is back below threshold."""
        import signal as _sig
        from collections import deque as _deque

        from .events import make_cluster_event
        from .memory_monitor import system_memory_usage_fraction

        oom_threshold = get_config().memory_usage_threshold
        recent_usage: "_deque" = _deque(maxlen=20)  # ~10s window
        while not self._shutdown.wait(0.5):
            recent_usage.append(system_memory_usage_fraction())
            with self._lock:
                dead = [(wid, p.returncode) for wid, p in
                        self.workers.items() if p.poll() is not None]
                for wid, _ in dead:
                    self.workers.pop(wid, None)
            for wid, rc in dead:
                if rc == 0:
                    continue  # clean exit (idle reap / graceful terminate)
                if rc == -_sig.SIGKILL and \
                        max(recent_usage, default=0.0) >= oom_threshold:
                    etype, msg = "worker_oom_kill", (
                        f"worker {wid[:8]} SIGKILLed under host memory "
                        "pressure (likely kernel oom-killer)")
                else:
                    etype, msg = "worker_crash", (
                        f"worker {wid[:8]} exited unexpectedly "
                        f"(code {rc})")
                ev = make_cluster_event(
                    "ERROR", "node_agent", etype, msg,
                    node_idx=self.node_idx if self.node_idx is not None
                    else -1,
                    entity_id=wid, extra={"exit_code": rc})
                try:
                    self.head.send(P.CLUSTER_EVENT, [ev], 0)
                except P.ConnectionLost:
                    pass

    # ------------------------------------------------------------ lifecycle

    def run_forever(self):
        try:
            while not self._shutdown.wait(0.5):
                pass
        finally:
            self.shutdown()

    def shutdown(self):
        self._shutdown.set()
        if getattr(self, "log_monitor", None) is not None:
            self.log_monitor.stop()
        if getattr(self, "telemetry", None) is not None:
            self.telemetry.stop()
        with self._lock:
            procs = list(self.workers.values())
            self.workers.clear()
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        try:
            self.head.close()
        except Exception:
            pass
        try:
            self.transfer_server.close()
            self.puller.close()
        except Exception:
            pass
        self.io.stop()
        try:
            self.store.close()
        except Exception:
            pass
        # belt-and-braces arena unlink (r19, ROADMAP 5c): close()
        # destroys the arena for creators, but if it raised (live
        # zero-copy borrows, a wedged native lock) the /dev/shm file
        # would outlive this process and pin its full capacity —
        # unlinking an already-destroyed name is a harmless ENOENT
        try:
            os.unlink(f"/dev/shm/{self.store_name}")
        except OSError:
            pass


def main(argv=None):
    ap = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    ap.add_argument("--address", required=True,
                    help="head address, tcp:HOST:PORT")
    ap.add_argument("--num-cpus", type=int, default=None)
    ap.add_argument("--num-gpus", type=int, default=None)
    ap.add_argument("--object-store-memory", type=int, default=None)
    ap.add_argument("--label", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="node label (repeatable; e.g. the autoscaler "
                         "tags its launches to reclaim them later)")
    args = ap.parse_args(argv)
    labels = dict(kv.split("=", 1) for kv in args.label)
    # SIGTERM/SIGINT are caught from the start: one that lands while the
    # agent is still joining (a launcher stopping its node right after
    # the cluster came up) is held until the agent is built, then shuts
    # it down like any other. The default action would end the process
    # with its arena created and never unlinked.
    stop_requested = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop_requested.set())
    signal.signal(signal.SIGINT, lambda *a: stop_requested.set())
    agent = NodeAgent(args.address, num_cpus=args.num_cpus,
                      num_gpus=args.num_gpus,
                      object_store_memory=args.object_store_memory,
                      labels=labels or None)
    print(f"node agent joined as node {agent.node_idx} "
          f"(store {agent.store_name})", flush=True)
    # Arena hygiene (r19, ROADMAP 5c): every exit path must unlink the
    # /dev/shm arena. SIGTERM/SIGINT flow through run_forever's finally
    # -> shutdown() -> store destroy; atexit catches a run_forever that
    # unwound via an exception without reaching shutdown(). Only
    # SIGKILL leaks, and Cluster's handle.terminate sweep +
    # doctor_warnings' orphan scan cover that.
    import atexit

    def _unlink_arena():
        try:
            os.unlink(f"/dev/shm/{agent.store_name}")
        except OSError:
            pass

    atexit.register(_unlink_arena)
    signal.signal(signal.SIGTERM, lambda *a: agent._shutdown.set())
    signal.signal(signal.SIGINT, lambda *a: agent._shutdown.set())
    if stop_requested.is_set():
        agent._shutdown.set()
    agent.run_forever()


if __name__ == "__main__":
    main()
