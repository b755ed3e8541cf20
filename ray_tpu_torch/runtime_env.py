"""Runtime environments: per-job/task/actor execution environment.

Ref parity: ray runtime_env (python/ray/_private/runtime_env/ — the agent
at runtime_env_agent.py:159 materializes env_vars / working_dir /
py_modules / pip per task). Re-designed for a pre-baked TPU image:

- ``env_vars``: dict applied around task execution (saved/restored).
- ``working_dir``: a local directory, packed and shipped through the
  head KV store (the reference uploads to GCS the same way); workers
  extract once per content digest and chdir into it for the task.
- ``py_modules``: list of local package dirs shipped the same way and
  prepended to sys.path.
- ``pip``: a venv-overlay (ref: runtime_env/pip.py). A virtualenv with
  ``--system-site-packages`` is created per requirements digest; unmet
  requirements are installed **offline** with ``pip install --no-index
  --find-links <RAY_TPU_WHEEL_DIRS>`` (colon-separated local wheel
  dirs). Requirements already satisfied by the baked image are
  verified, not reinstalled. The venv's site-packages is prepended to
  ``sys.path`` around task execution. No-network installs only: a
  requirement that is neither baked in nor available as a local wheel
  fails with a clear error (this is a sealed TPU image — there is no
  package index at runtime).
- ``conda``: rejected with a clear error — no conda on the image.

Size cap: packed archives ride the control-plane KV, so each is capped
(default 64 MiB) — big data belongs in the object store, not the env.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional

MAX_ARCHIVE_BYTES = 64 * 1024 * 1024
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

KV_NS = "runtime_env"


def validate(env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not env:
        return None
    known = {"env_vars", "working_dir", "py_modules", "pip", "conda"}
    unknown = set(env) - known
    if unknown:
        raise ValueError(f"unknown runtime_env keys: {sorted(unknown)}")
    if env.get("conda"):
        raise ValueError(
            "runtime_env conda is not supported on this sealed image; "
            "use pip (offline venv overlay) or pre-bake dependencies")
    pip = env.get("pip")
    if pip is not None:
        if isinstance(pip, dict):
            pip = pip.get("packages", [])
        if not (isinstance(pip, list) and
                all(isinstance(r, str) for r in pip)):
            raise ValueError(
                "runtime_env pip must be a list of requirement strings "
                "or {'packages': [...]}")
    ev = env.get("env_vars")
    if ev is not None and not (
            isinstance(ev, dict) and
            all(isinstance(k, str) and isinstance(v, str)
                for k, v in ev.items())):
        raise ValueError("env_vars must be a Dict[str, str]")
    return env


def _pack_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, path))
    blob = buf.getvalue()
    if len(blob) > MAX_ARCHIVE_BYTES:
        raise ValueError(
            f"runtime_env directory {path!r} packs to "
            f"{len(blob) >> 20} MiB (cap {MAX_ARCHIVE_BYTES >> 20} MiB); "
            f"ship large data through the object store instead")
    return blob


def upload(ctx, env: Dict[str, Any]) -> Dict[str, Any]:
    """Driver side: pack local dirs into the head KV, rewrite the env to
    digest URIs (reference: working_dir upload + GCS URIs)."""
    out = dict(env)
    for key in ("working_dir", "py_modules"):
        val = env.get(key)
        if not val:
            continue
        paths: List[str] = [val] if isinstance(val, str) else list(val)
        uris = []
        for p in paths:
            if p.startswith("kv://"):
                uris.append(p)
                continue
            if not os.path.isdir(p):
                raise ValueError(f"runtime_env {key}: {p!r} is not a "
                                 f"directory")
            blob = _pack_dir(p)
            digest = hashlib.sha256(blob).hexdigest()[:16]
            uri = f"kv://{digest}"
            ctx.kv_put(KV_NS, digest, blob, overwrite=False)
            uris.append(uri)
        out[key] = uris[0] if key == "working_dir" else uris
    return out


def _materialize(ctx, uri: str) -> str:
    """Worker side: fetch + extract an archive once per digest."""
    digest = uri[len("kv://"):]
    dest = os.path.join(ctx.session_dir, "runtime_envs", digest)
    if os.path.isdir(dest):
        return dest
    blob = ctx.kv_get(KV_NS, digest)
    if blob is None:
        raise ValueError(f"runtime_env archive {uri} not found in KV")
    # per-process tmp dir: concurrent workers materializing the same
    # digest must not extract into one shared staging path
    tmp = f"{dest}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:  # raced with another worker — theirs is identical
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _pip_requirements(env: Dict[str, Any]) -> List[str]:
    pip = env.get("pip")
    if not pip:
        return []
    if isinstance(pip, dict):
        pip = pip.get("packages", [])
    return list(pip)


def _satisfied(req: str, _depth: int = 0) -> bool:
    """True when the baked image already satisfies the requirement —
    including environment markers (a marker-excluded requirement is
    vacuously satisfied, not an install failure) and extras (each
    extra's own dependency set must be present too)."""
    from importlib import metadata

    from packaging.requirements import InvalidRequirement, Requirement

    try:
        r = Requirement(req)
    except InvalidRequirement:
        return False
    if r.marker is not None and not r.marker.evaluate():
        return True  # requirement does not apply on this platform
    try:
        installed = metadata.version(r.name)
    except metadata.PackageNotFoundError:
        return False
    if not r.specifier.contains(installed, prereleases=True):
        return False
    if r.extras and _depth < 4:
        for dep in metadata.requires(r.name) or []:
            try:
                d = Requirement(dep)
            except InvalidRequirement:
                continue
            if d.marker is None:
                continue  # base dep, already present with the package
            for extra in r.extras:
                if d.marker.evaluate({"extra": extra}):
                    base = str(d).split(";", 1)[0].strip()
                    if not _satisfied(base, _depth + 1):
                        return False
    return True


def _ensure_venv(ctx, reqs: List[str]) -> str:
    """Worker side: build (once per digest) the venv overlay for a pip
    requirements list; returns its site-packages dir.

    Offline by design: unmet requirements install from local wheel dirs
    (``RAY_TPU_WHEEL_DIRS``, colon-separated) with ``--no-index``."""
    import subprocess
    import venv as venv_mod

    digest = hashlib.sha256(
        ("\n".join(sorted(reqs))).encode()).hexdigest()[:16]
    dest = os.path.join(ctx.session_dir, "runtime_envs",
                        f"venv-{digest}")
    site = os.path.join(
        dest, "lib",
        f"python{sys.version_info.major}.{sys.version_info.minor}",
        "site-packages")
    if os.path.isdir(dest):
        return site
    unmet = [r for r in reqs if not _satisfied(r)]
    tmp = f"{dest}.tmp.{os.getpid()}"
    # with_pip (ensurepip) costs seconds; skip it when nothing installs
    venv_mod.EnvBuilder(system_site_packages=True, with_pip=bool(unmet),
                        symlinks=True).create(tmp)
    if unmet:
        wheel_dirs = [d for d in
                      os.environ.get("RAY_TPU_WHEEL_DIRS", "").split(":")
                      if d]
        cmd = [os.path.join(tmp, "bin", "python"), "-m", "pip",
               "install", "--quiet", "--no-index"]
        for d in wheel_dirs:
            cmd += ["--find-links", d]
        cmd += unmet
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            err, rc = proc.stderr, proc.returncode
        except subprocess.TimeoutExpired as e:
            err, rc = f"pip timed out after {e.timeout}s", -1
        if rc != 0:
            import shutil

            # a half-built tmp venv must not survive: a same-pid retry
            # would EnvBuilder.create() over it and cache the corruption
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip: cannot satisfy {unmet} offline — not "
                f"baked into the image and no matching wheel under "
                f"RAY_TPU_WHEEL_DIRS={wheel_dirs or '(unset)'}; this is "
                f"a sealed image with no package index.\n"
                f"{(err or '').strip()[-2000:]}")
    try:
        os.rename(tmp, dest)
    except OSError:  # raced with another worker — theirs is identical
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return site


def _overlay_top_level(site: str) -> List[str]:
    """Top-level importable names a pip venv overlay provides: the
    package dirs and modules pip installed into its site-packages
    (``--system-site-packages`` venvs start empty, so everything present
    was installed for THIS requirements digest), refined by each
    dist-info's ``top_level.txt`` when present."""
    names = set()
    try:
        entries = os.listdir(site)
    except OSError:
        return []
    for entry in entries:
        path = os.path.join(site, entry)
        if entry.endswith(".dist-info"):
            try:
                with open(os.path.join(path, "top_level.txt")) as f:
                    names.update(ln.strip() for ln in f if ln.strip())
            except OSError:
                pass
        elif entry.endswith(".py") and not entry.startswith("_"):
            names.add(entry[:-3])
        elif os.path.isdir(path) and not entry.startswith("_") \
                and "." not in entry:
            names.add(entry)
    return sorted(names)


def _purge_shadowed_modules(site: str):
    """Drop sys.modules entries for names the overlay provides whose
    cached import came from OUTSIDE the overlay (the baked image): the
    next import inside the task resolves through the overlay's
    site-packages at the head of sys.path, so the requested version
    actually loads."""
    root = os.path.abspath(site) + os.sep
    tops = set(_overlay_top_level(site))
    if not tops:
        return
    purged = []
    for name, mod in list(sys.modules.items()):
        if name.split(".", 1)[0] not in tops:
            continue
        f = getattr(mod, "__file__", None)
        under = bool(f and os.path.abspath(f).startswith(root))
        if not under:
            for p in list(getattr(mod, "__path__", None) or []):
                if os.path.abspath(p).startswith(root):
                    under = True
                    break
        if not under:
            del sys.modules[name]
            purged.append(name)
    if purged:
        roots = sorted({n.split('.', 1)[0] for n in purged})
        print(f"[ray_tpu] runtime_env pip overlay: purged "
              f"{len(purged)} cached baked-image modules shadowing the "
              f"requested versions ({', '.join(roots[:5])}"
              f"{'...' if len(roots) > 5 else ''})", file=sys.stderr)


class applied:
    """Context manager applying a runtime_env around one task execution
    (the reference applies per worker-process; our workers are pooled
    per scheduling class, so env application is scoped to the task)."""

    def __init__(self, ctx, env: Optional[Dict[str, Any]]):
        self._ctx = ctx
        self._env = env or {}
        self._saved_environ: Dict[str, Optional[str]] = {}
        self._saved_cwd: Optional[str] = None
        self._added_paths: List[str] = []

    def __enter__(self):
        # a failure mid-application (e.g. an unsatisfiable pip env) must
        # roll back what was already applied: the with-statement will not
        # call __exit__ after a raising __enter__, and a pooled worker
        # would otherwise keep the partial env forever
        try:
            env = self._env
            for k, v in (env.get("env_vars") or {}).items():
                self._saved_environ[k] = os.environ.get(k)
                os.environ[k] = v
            wd = env.get("working_dir")
            if wd:
                path = _materialize(self._ctx, wd)
                self._saved_cwd = os.getcwd()
                os.chdir(path)
                sys.path.insert(0, path)
                self._added_paths.append(path)
            for uri in env.get("py_modules") or []:
                path = _materialize(self._ctx, uri)
                sys.path.insert(0, path)
                self._added_paths.append(path)
            reqs = _pip_requirements(env)
            if reqs:
                site = _ensure_venv(self._ctx, reqs)
                sys.path.insert(0, site)
                self._added_paths.append(site)
                # Evict already-imported BAKED modules the overlay
                # provides: workers are pooled, so an earlier task may
                # have imported package X from the image — without this
                # a task requesting pip=['X==2.0'] silently keeps
                # running the cached baked version (sys.path order only
                # decides FUTURE imports). The __exit__ purge below then
                # removes the overlay-origin modules, so the next task
                # re-imports the baked ones cleanly.
                _purge_shadowed_modules(site)
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise
        return self

    def __exit__(self, *exc):
        # purge modules imported from overlay paths: workers are pooled,
        # so a cached import would leak this env's packages into later
        # tasks that did not request them
        if self._added_paths:
            roots = tuple(os.path.abspath(p) + os.sep
                          for p in self._added_paths)

            def _under(mod) -> bool:
                f = getattr(mod, "__file__", None)
                if f and os.path.abspath(f).startswith(roots):
                    return True
                # namespace packages have __file__=None but carry the
                # overlay in __path__
                for p in list(getattr(mod, "__path__", None) or []):
                    if os.path.abspath(p).startswith(roots):
                        return True
                return False

            for name, mod in list(sys.modules.items()):
                if _under(mod):
                    del sys.modules[name]
        for p in self._added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        if self._saved_cwd is not None:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass
        for k, old in self._saved_environ.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return False
