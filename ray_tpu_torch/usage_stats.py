"""Usage stats: opt-out feature-usage telemetry (collection side).

Ref parity: ray._private.usage.usage_lib (usage_lib.py:92
UsageStatsToReport, record_library_usage :190, report generation :455):
libraries record which features a cluster exercised; a periodic reporter
assembles a schema'd payload. Redesign notes: collection and transport
are split — this sealed-image build has zero egress, so the transport is
a file sink under the session dir (plus an injectable reporter hook for
deployments that have one), while the collection API and report schema
match the reference's shape. Opt-out via RAY_TPU_USAGE_STATS_ENABLED=0,
same default-on-with-notice policy as the reference.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_libraries: Dict[str, float] = {}   # name -> first-use unix time
_tags: Dict[str, str] = {}
_notice_printed = [False]


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False")


def print_usage_stats_notice(out=None) -> None:
    """One-line collection notice on cluster start (ref prints the same
    from usage_lib's head-node hook)."""
    if _notice_printed[0] or not usage_stats_enabled():
        return
    _notice_printed[0] = True
    import sys

    print("Usage stats collection is enabled (local file sink only on "
          "this build). Disable with RAY_TPU_USAGE_STATS_ENABLED=0.",
          file=out or sys.stderr)


def record_library_usage(name: str) -> None:
    """Mark a library/feature as used (ref: record_library_usage).
    Cheap and always safe to call; a no-op when disabled."""
    if not usage_stats_enabled():
        return
    with _lock:
        _libraries.setdefault(name, time.time())


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    with _lock:
        _tags[str(key)] = str(value)


def _cluster_metadata() -> dict:
    from ray_tpu_torch._version import __version__

    meta = {
        "ray_tpu_version": __version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
    }
    torch_mod = sys.modules.get("torch")  # never imported for this
    if torch_mod is not None:
        meta["torch_version"] = torch_mod.__version__
    return meta


def generate_report() -> dict:
    """Assemble the report payload (ref: generate_report's
    UsageStatsToReport schema, trimmed to what exists here)."""
    with _lock:
        libs = sorted(_libraries)
        tags = dict(_tags)
    return {
        "schema_version": "0.1",
        "collected_at": int(time.time()),
        "library_usages": libs,
        "extra_usage_tags": tags,
        **_cluster_metadata(),
    }


def write_report(session_dir: str) -> Optional[str]:
    """File sink: usage_stats.json under the session dir. Returns the
    path, or None when disabled/unwritable."""
    if not usage_stats_enabled():
        return None
    try:
        os.makedirs(session_dir, exist_ok=True)
        path = os.path.join(session_dir, "usage_stats.json")
        with open(path, "w") as f:
            json.dump(generate_report(), f, indent=1)
        return path
    except OSError:
        return None


def report_via(reporter: Callable[[dict], None]) -> bool:
    """Injectable transport (the seam a network uploader would fill;
    ref posts to a usage server — zero-egress builds pass a collector).
    Returns False when disabled, True after the reporter ran."""
    if not usage_stats_enabled():
        return False
    reporter(generate_report())
    return True


def reset_for_testing() -> None:
    with _lock:
        _libraries.clear()
        _tags.clear()
    _notice_printed[0] = False
