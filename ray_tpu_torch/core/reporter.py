"""Node telemetry reporter: /proc sampling -> per-node ``node_*`` gauges.

Ref parity: the reference's reporter agent
(dashboard/modules/reporter/reporter_agent.py — a per-node daemon sampling
psutil CPU/mem/disk/net every few seconds and exporting ``ray_node_*``
gauges through the metrics agent). Re-design: no psutil — the counters are
read straight from ``/proc`` (cpu percent from /proc/stat deltas, memory
from /proc/meminfo, network from /proc/net/dev, disk from /proc/diskstats)
plus the shm object-store fill, and published as plain gauge rows over the
existing METRICS_REPORT channel. The rows land in the head's metric table
(``/api/metrics``, ``/metrics`` Prometheus exposition, ``metrics_summary``)
and the head mirrors them into ``list_nodes()`` rows.

Runs as a daemon thread in every node_agent (one per remote host) and in
the head process (publishing one row-set per local logical node — same
host counters, per-node store fill).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


def _read_proc_stat() -> Optional[Tuple[float, float]]:
    """(busy_jiffies, total_jiffies) from the aggregate cpu line."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
    except OSError:
        return None
    if not parts or parts[0] != "cpu":
        return None
    vals = [float(x) for x in parts[1:]]
    total = sum(vals)
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle + iowait
    return total - idle, total




def _read_net_dev() -> Tuple[float, float]:
    """(rx_bytes, tx_bytes) summed over non-loopback interfaces."""
    rx = tx = 0.0
    try:
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                name, _, rest = line.partition(":")
                if name.strip() == "lo":
                    continue
                cols = rest.split()
                if len(cols) >= 9:
                    rx += float(cols[0])
                    tx += float(cols[8])
    except OSError:
        pass
    return rx, tx


def _read_diskstats() -> Tuple[float, float]:
    """(read_bytes, written_bytes) summed over whole devices (heuristic:
    names without a trailing partition digit, plus nvme/mmcblk whole
    disks), sectors * 512."""
    rd = wr = 0.0
    try:
        with open("/proc/diskstats") as f:
            for line in f:
                cols = line.split()
                if len(cols) < 10:
                    continue
                name = cols[2]
                if name.startswith(("loop", "ram", "dm-")):
                    continue
                # skip partitions so bytes aren't double-counted:
                # sda1 (trailing digit) and nvme0n1p2 / mmcblk0p1 (pN tail)
                if name.startswith(("nvme", "mmcblk")):
                    stem, _, tail = name.rpartition("p")
                    if stem and tail.isdigit():
                        continue
                elif name[-1].isdigit():
                    continue
                rd += float(cols[5]) * 512.0
                wr += float(cols[9]) * 512.0
    except OSError:
        pass
    return rd, wr


class NodeTelemetryReporter:
    """Daemon thread sampling host physical stats on a period and
    publishing ``node.*`` gauges tagged by node index.

    ``nodes_fn`` returns the current ``[(node_idx, store_or_None)]`` to
    publish for (an agent has one; the head has all its local nodes).
    ``publish_fn`` receives a METRICS_REPORT-shaped batch of gauge rows:
    ``(kind, name, desc, tag_keys, tags_key, value)``.
    """

    GAUGES = {
        "node.cpu_percent": "Host CPU utilization percent (/proc/stat)",
        "node.mem_used_bytes": "Host memory in use (MemTotal-MemAvailable)",
        "node.mem_total_bytes": "Host memory total (/proc/meminfo)",
        "node.net_rx_bytes": "Cumulative network bytes received",
        "node.net_tx_bytes": "Cumulative network bytes transmitted",
        "node.disk_read_bytes": "Cumulative disk bytes read",
        "node.disk_write_bytes": "Cumulative disk bytes written",
        "node.object_store_used_bytes": "Shm object store bytes in use",
        "node.object_store_capacity_bytes": "Shm object store capacity",
        # arena memory-observatory gauges (store.memory_stats()): one
        # native lock + table scan per sample, piggybacked on this same
        # heartbeat — no extra channel. Flow into the head's metric
        # table (Prometheus + flight-recorder timeseries) AND node rows.
        "object_plane.arena_capacity_bytes": "Arena capacity (bytes)",
        "object_plane.arena_used_bytes":
            "Arena bytes in use (blocks incl. headers)",
        "object_plane.arena_highwater_bytes":
            "Max arena bytes in use ever observed",
        "object_plane.arena_entries": "Live arena entries",
        "object_plane.arena_sealed_bytes":
            "Payload bytes of sealed objects",
        "object_plane.arena_sealed_data_bytes":
            "Sealed object data bytes only (the wire/directory size "
            "convention — per-node directory sums match this exactly)",
        "object_plane.arena_unsealed_bytes":
            "Payload bytes of created-but-unsealed objects",
        "object_plane.arena_pinned_bytes":
            "Payload bytes pinned by native readers",
        "object_plane.arena_borrow_pinned_bytes":
            "Payload bytes pinned by live zero-copy borrow views",
        "object_plane.arena_deferred_deletes":
            "Deletes deferred behind live borrow views",
        "object_plane.arena_deferred_delete_oldest_s":
            "Age of the oldest pending deferred delete (seconds)",
    }

    # memory_stats() key -> gauge name (sample_and_publish)
    _ARENA_GAUGES = {
        "capacity": "object_plane.arena_capacity_bytes",
        "used_bytes": "object_plane.arena_used_bytes",
        "highwater_bytes": "object_plane.arena_highwater_bytes",
        "entries": "object_plane.arena_entries",
        "sealed_bytes": "object_plane.arena_sealed_bytes",
        "sealed_data_bytes": "object_plane.arena_sealed_data_bytes",
        "unsealed_bytes": "object_plane.arena_unsealed_bytes",
        "pinned_bytes": "object_plane.arena_pinned_bytes",
        "borrow_pinned_bytes": "object_plane.arena_borrow_pinned_bytes",
        "deferred_deletes": "object_plane.arena_deferred_deletes",
        "deferred_delete_oldest_s":
            "object_plane.arena_deferred_delete_oldest_s",
    }

    def __init__(self, publish_fn: Callable[[list], None],
                 nodes_fn: Callable[[], List[tuple]],
                 period_s: Optional[float] = None):
        from .config import get_config

        self._publish = publish_fn
        self._nodes = nodes_fn
        self._period = (get_config().node_telemetry_period_s
                        if period_s is None else period_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-telemetry")
        self._prev_cpu: Optional[Tuple[float, float]] = None
        self.samples = 0  # observability + tests

    def start(self):
        if self._period > 0:
            self._thread.start()

    def stop(self):
        self._stop.set()

    def sample_host(self) -> Dict[str, float]:
        """One host-wide sample; cpu percent is over the interval since
        the previous call (0.0 on the first)."""
        out: Dict[str, float] = {}
        cur = _read_proc_stat()
        cpu = 0.0
        if cur is not None and self._prev_cpu is not None:
            dbusy = cur[0] - self._prev_cpu[0]
            dtotal = cur[1] - self._prev_cpu[1]
            if dtotal > 0:
                cpu = max(0.0, min(100.0, 100.0 * dbusy / dtotal))
        if cur is not None:
            self._prev_cpu = cur
        out["node.cpu_percent"] = cpu
        from .memory_monitor import read_meminfo_bytes

        total, avail = read_meminfo_bytes()
        out["node.mem_total_bytes"] = float(total)
        out["node.mem_used_bytes"] = float(max(total - avail, 0))
        rx, tx = _read_net_dev()
        out["node.net_rx_bytes"] = rx
        out["node.net_tx_bytes"] = tx
        rd, wr = _read_diskstats()
        out["node.disk_read_bytes"] = rd
        out["node.disk_write_bytes"] = wr
        return out

    def sample_and_publish(self):
        """One sampling round (callable from tests without the thread)."""
        host = self.sample_host()
        batch: list = []
        for node_idx, store in self._nodes():
            vals = dict(host)
            if store is not None:
                try:
                    vals["node.object_store_used_bytes"] = \
                        float(store.bytes_in_use())
                    vals["node.object_store_capacity_bytes"] = \
                        float(store.capacity())
                    mem = store.memory_stats()
                    for key, gname in self._ARENA_GAUGES.items():
                        if key in mem:
                            vals[gname] = float(mem[key])
                except Exception:  # noqa: BLE001 — store closing
                    pass
            tags_key = (str(node_idx),)
            for name, value in vals.items():
                batch.append(("gauge", name, self.GAUGES.get(name, ""),
                              ("node",), tags_key, value))
        if batch:
            self._publish(batch)
            self.samples += 1

    def _loop(self):
        # prime the cpu-delta baseline so the first published percent is
        # over a real interval
        self.sample_host()
        while not self._stop.wait(self._period):
            try:
                self.sample_and_publish()
            except Exception:  # noqa: BLE001 — telemetry must not die
                pass
