"""Runtime environments: per-task/actor env materialization (ref analog:
python/ray/_private/runtime_env/plugin.py + the runtime-env agent;
working_dir/py_modules URI packaging mirrors
_private/runtime_env/packaging.py's content-addressed zips in GCS KV).

Supported keys (anything else raises — silently dropping a
correctness-relevant option is worse than rejecting it):

* ``env_vars``:   {str: str} set in the worker before execution.
* ``working_dir``: local directory, zipped + content-addressed into GCS
  KV at submission; workers extract to a cache dir, chdir into it, and
  put it on sys.path.
* ``py_modules``: list of local module directories/files shipped the same
  way and prepended to sys.path.
* ``pip``: list of requirement strings (or {"packages": [...],
  "pip_install_options": [...]}). Workers build a content-addressed venv
  (``--system-site-packages`` so jax & friends stay visible) once per
  unique requirement set, then splice its site-packages ahead of
  sys.path for the task and export VIRTUAL_ENV/PATH so child processes
  resolve the venv's interpreter (ref: _private/runtime_env/pip.py —
  the reference launches dedicated workers from the venv interpreter;
  pooled workers here splice import paths instead and restore after).
* ``conda``: an existing env NAME (str) or an environment spec dict
  ({"dependencies": [...]}, the env.yaml shape). Spec dicts build a
  content-addressed env once per unique spec via the ``conda`` binary
  (override with RAYT_CONDA_EXE; clear error when absent); either form
  splices the env's site-packages ahead of sys.path and exports
  CONDA_PREFIX/PATH (ref: _private/runtime_env/conda.py — same splice
  model as pip above).
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import time
import zipfile

SUPPORTED_KEYS = {"env_vars", "working_dir", "py_modules", "pip",
                  "conda"}
KV_NAMESPACE = "runtime_env"

# -------------------------------------------------------------- plugin API
# Ref analog: _private/runtime_env/plugin.py RuntimeEnvPlugin — custom
# runtime_env keys handled by user-registered plugins. The plugin object
# itself rides the packaged spec (cloudpickled), so workers need no
# import-path coordination.
_PLUGINS: dict[str, "RuntimeEnvPlugin"] = {}


class RuntimeEnvPlugin:
    """Handle one custom runtime_env key.

    package(value, kv_put) runs on the DRIVER: validate + upload any
    payloads to GCS KV, return the wire value shipped in task specs.
    materialize(spec_value, kv_get) runs in the WORKER before the task:
    apply the env (sys.path, os.environ, files, ...).
    """

    def package(self, value, kv_put):
        return value

    def materialize(self, spec_value, kv_get) -> None:
        raise NotImplementedError


def register_runtime_env_plugin(key: str, plugin: RuntimeEnvPlugin):
    if key in SUPPORTED_KEYS:
        raise ValueError(f"{key!r} is a built-in runtime_env key")
    _PLUGINS[key] = plugin
# apart from the TPU build's /tmp/rayt_runtime_env: its venv LRU must not
# collect this package's venvs when both run on one host
_CACHE_ROOT = os.path.join(os.environ.get("TMPDIR") or "/tmp",
                           "rayt_torch_runtime_env")
_VENV_ROOT = os.path.join(_CACHE_ROOT, "venvs")
_CONDA_ROOT = os.path.join(_CACHE_ROOT, "conda")
# keep at most this many cached venvs (LRU by last-use mtime)
_VENV_GC_KEEP = 8
# skip bulky junk when zipping (ref: packaging.py excludes)
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_PACKAGE_BYTES = 100 * 1024 * 1024


def validate(renv: dict) -> None:
    if not isinstance(renv, dict):
        raise TypeError(f"runtime_env must be a dict, got {type(renv)}")
    unsupported = set(renv) - SUPPORTED_KEYS - set(_PLUGINS)
    if unsupported:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unsupported)}; "
            f"supported: {sorted(SUPPORTED_KEYS | set(_PLUGINS))}")
    env_vars = renv.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in env_vars.items()):
            raise TypeError("runtime_env['env_vars'] must be {str: str}")
    wd = renv.get("working_dir")
    if wd is not None and not os.path.isdir(wd):
        raise ValueError(f"runtime_env['working_dir'] {wd!r} is not a "
                         "directory")
    for m in renv.get("py_modules") or []:
        if not os.path.exists(m):
            raise ValueError(f"runtime_env['py_modules'] entry {m!r} does "
                             "not exist")
    pip = renv.get("pip")
    if pip is not None:
        if isinstance(pip, dict):
            unknown = set(pip) - {"packages", "pip_install_options"}
            if unknown:
                raise ValueError(
                    f"unsupported runtime_env['pip'] keys {sorted(unknown)}")
            pkgs = pip.get("packages")
        else:
            pkgs = pip
        if not isinstance(pkgs, (list, tuple)) or not all(
                isinstance(p, str) for p in pkgs):
            raise TypeError("runtime_env['pip'] must be a list of "
                            "requirement strings or {'packages': [...]}")
    conda = renv.get("conda")
    if conda is not None:
        if isinstance(conda, dict):
            deps = conda.get("dependencies")
            if not isinstance(deps, (list, tuple)):
                raise TypeError("runtime_env['conda'] spec dict needs a "
                                "'dependencies' list (env.yaml shape)")
            for d in deps:
                if isinstance(d, dict):
                    for k, v in d.items():
                        if not isinstance(v, (list, tuple)) or not all(
                                isinstance(x, str) for x in v):
                            raise TypeError(
                                f"runtime_env['conda'] nested dependency "
                                f"{k!r} must map to a list of strings, "
                                f"got {v!r}")
                elif not isinstance(d, str):
                    raise TypeError(
                        "runtime_env['conda'] dependencies must be "
                        f"strings or dicts, got {d!r}")
        elif not isinstance(conda, str):
            raise TypeError("runtime_env['conda'] must be an env name or "
                            "an environment spec dict")
    if renv.get("conda") is not None and renv.get("pip") is not None:
        raise ValueError("runtime_env: 'conda' and 'pip' are mutually "
                         "exclusive (put pip packages inside the conda "
                         "spec's dependencies)")


def _zip_path(path: str) -> bytes:
    buf = io.BytesIO()
    path = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            for root, dirs, files in os.walk(path):
                dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
                for f in files:
                    full = os.path.join(root, f)
                    rel = os.path.relpath(full, path)
                    zf.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PACKAGE_BYTES})")
    return data


def package(renv: dict, kv_put) -> dict:
    """Driver side: upload working_dir/py_modules zips, return the spec
    shipped inside TaskSpecs. `kv_put(key, value_bytes)` stores to GCS KV.

    Content-addressed keys -> repeat submissions with the same code are
    deduplicated, and workers can cache extractions forever.
    """
    validate(renv)
    spec: dict = {}
    if renv.get("env_vars"):
        spec["env_vars"] = dict(renv["env_vars"])
    if renv.get("working_dir"):
        data = _zip_path(renv["working_dir"])
        key = "wd_" + hashlib.sha256(data).hexdigest()[:32]
        kv_put(key, data)
        spec["working_dir"] = key
    mods = []
    for m in renv.get("py_modules") or []:
        data = _zip_path(m)
        key = "mod_" + hashlib.sha256(data).hexdigest()[:32]
        kv_put(key, data)
        # single .py files extract flat; packages extract into a dir named
        # after the module so `import <name>` works
        name = os.path.basename(os.path.abspath(m))
        mods.append((key, name, os.path.isdir(m)))
    if mods:
        spec["py_modules"] = mods
    pip = renv.get("pip")
    if pip:
        if isinstance(pip, dict):
            pkgs = sorted(pip.get("packages") or [])
            opts = list(pip.get("pip_install_options") or [])
        else:
            pkgs, opts = sorted(pip), []
        tag = hashlib.sha256(
            repr((pkgs, opts, sys.version_info[:2])).encode()
        ).hexdigest()[:16]
        spec["pip"] = {"packages": pkgs, "options": opts, "hash": tag}
    conda = renv.get("conda")
    if conda:
        if isinstance(conda, str):
            spec["conda"] = {"name": conda}
        else:
            canon = _canon_conda(conda)
            tag = hashlib.sha256(repr(canon).encode()).hexdigest()[:16]
            spec["conda"] = {"spec": canon, "hash": tag}
    plugin_entries = []
    for key, plugin in _PLUGINS.items():
        if key in renv:
            import cloudpickle

            packaged = plugin.package(renv[key], kv_put)
            plugin_entries.append(
                (key, cloudpickle.dumps(plugin), packaged))
    if plugin_entries:
        spec["_plugins"] = plugin_entries
    return spec


# ------------------------------------------------------------------- conda
def _canon_conda(spec: dict) -> dict:
    """Canonical spec: dependency ORDER must not change the hash. Nested
    pip blocks ({"pip": [...]}) canonicalize too."""
    deps = []
    for d in spec.get("dependencies") or []:
        if isinstance(d, dict):
            deps.append({k: sorted(v) for k, v in sorted(d.items())})
        else:
            deps.append(d)
    deps.sort(key=repr)
    out = {"dependencies": deps}
    if spec.get("channels"):
        out["channels"] = list(spec["channels"])
    return out


_NAMED_PREFIX_CACHE: dict[tuple, str] = {}


def _conda_exe() -> str:
    import shutil

    exe = os.environ.get("RAYT_CONDA_EXE") or shutil.which("conda")
    if not exe:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda binary on PATH "
            "(or RAYT_CONDA_EXE); none found on this node")
    return exe


def _spec_to_yaml(spec: dict) -> str:
    """Minimal env.yaml writer (no yaml dep): names, channels, deps,
    nested pip lists."""
    lines = ["name: rayt-env"]
    if spec.get("channels"):
        lines.append("channels:")
        lines += [f"  - {c}" for c in spec["channels"]]
    lines.append("dependencies:")
    for d in spec.get("dependencies") or []:
        if isinstance(d, dict):
            for k, vals in d.items():
                lines.append(f"  - {k}:")
                lines += [f"    - {v}" for v in vals]
        else:
            lines.append(f"  - {d}")
    return "\n".join(lines) + "\n"


def ensure_conda_env(conda_spec: dict) -> str:
    """Resolve a conda runtime env to its PREFIX directory.

    Named envs resolve through `conda run`; spec dicts build a
    content-addressed prefix once (same lock + .complete discipline as
    ensure_pip_venv). Ref: _private/runtime_env/conda.py get_or_create.
    """
    import fcntl
    import subprocess

    conda = _conda_exe()
    name = conda_spec.get("name")
    if name:
        # per-process cache: `conda run` costs seconds and the answer
        # never changes for a given name — pooled workers materialize
        # per TASK, not per process
        cached = _NAMED_PREFIX_CACHE.get((conda, name))
        if cached is not None:
            return cached
        r = subprocess.run(
            [conda, "run", "-n", name, "python", "-c",
             "import sys; print(sys.prefix)"],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"conda env {name!r} not usable: {r.stderr[-1000:]}")
        prefix = r.stdout.strip().splitlines()[-1]
        _NAMED_PREFIX_CACHE[(conda, name)] = prefix
        return prefix
    prefix = os.path.join(_CONDA_ROOT, conda_spec["hash"])
    marker = os.path.join(prefix, ".complete")
    if os.path.exists(marker):
        try:
            os.utime(prefix)
            return prefix
        except OSError:
            pass
    os.makedirs(_CONDA_ROOT, exist_ok=True)
    lock_path = prefix + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return prefix
            yaml_path = prefix + ".yaml"
            with open(yaml_path, "w") as f:
                f.write(_spec_to_yaml(conda_spec["spec"]))
            r = subprocess.run(
                [conda, "env", "create", "-p", prefix, "-f", yaml_path],
                capture_output=True, text=True)
            if r.returncode != 0:
                import shutil

                shutil.rmtree(prefix, ignore_errors=True)
                raise RuntimeError(
                    f"conda env create failed: {r.stderr[-2000:]}")
            with open(marker, "w") as f:
                f.write("ok")
            return prefix
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _conda_site_packages(prefix: str) -> str:
    lib = os.path.join(prefix, "lib")
    try:
        pys = sorted(d for d in os.listdir(lib)
                     if d.startswith("python"))
    except OSError:
        pys = []
    if pys:
        return os.path.join(lib, pys[-1], "site-packages")
    ver = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    return os.path.join(lib, ver, "site-packages")


# ------------------------------------------------------------------ pip/venv
def _venv_site_packages(venv_dir: str) -> str:
    ver = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    return os.path.join(venv_dir, "lib", ver, "site-packages")


def ensure_pip_venv(pip_spec: dict) -> str:
    """Build (or reuse) the cached venv for a pip spec; returns its path.

    Content-addressed by (sorted requirements, options, py version); an
    fcntl lock serializes concurrent workers building the same env, and a
    ``.complete`` marker makes reuse O(1) (ref: pip.py's URI cache + GC).
    """
    import fcntl
    import subprocess

    venv_dir = os.path.join(_VENV_ROOT, pip_spec["hash"])
    marker = os.path.join(venv_dir, ".complete")
    if os.path.exists(marker):
        try:
            os.utime(venv_dir)  # LRU touch + GC grace-window refresh
            return venv_dir
        except OSError:
            pass  # lost a GC race: fall through to the locked build path
    os.makedirs(_VENV_ROOT, exist_ok=True)
    lock_path = venv_dir + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return venv_dir
            _gc_venvs(keep=_VENV_GC_KEEP - 1)
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 venv_dir],
                check=True, capture_output=True, text=True)
            py = os.path.join(venv_dir, "bin", "python")
            cmd = ([py, "-m", "pip", "install", "--quiet",
                    "--disable-pip-version-check"]
                   + list(pip_spec.get("options") or [])
                   + list(pip_spec["packages"]))
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                import shutil

                shutil.rmtree(venv_dir, ignore_errors=True)
                raise RuntimeError(
                    f"pip install failed for runtime_env: {r.stderr[-2000:]}")
            with open(marker, "w") as f:
                f.write("ok")
            return venv_dir
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def mark_pip_venv_in_use(venv_dir: str):
    """Pin a venv against GC while this process has it on sys.path: a
    pid file under <venv>.inuse/ (liveness-checked by the collector, so
    a crashed worker can't pin forever)."""
    d = venv_dir + ".inuse"
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, str(os.getpid())), "w"):
            pass
    except OSError:
        pass


def release_pip_venv(pip_spec: dict):
    venv_dir = os.path.join(_VENV_ROOT, pip_spec["hash"])
    try:
        os.remove(os.path.join(venv_dir + ".inuse", str(os.getpid())))
    except OSError:
        pass


def _venv_in_use(venv_dir: str) -> bool:
    d = venv_dir + ".inuse"
    try:
        pids = os.listdir(d)
    except OSError:
        return False
    alive = False
    for p in pids:
        try:
            os.kill(int(p), 0)
            alive = True
        except (ProcessLookupError, ValueError):
            try:
                os.remove(os.path.join(d, p))  # stale pin: crashed worker
            except OSError:
                pass
        except OSError:
            alive = True
    return alive


def _gc_venvs(keep: int):
    """Drop the oldest cached venvs beyond `keep` (LRU by mtime), never
    collecting one a LIVE worker still has spliced into sys.path."""
    import shutil

    try:
        entries = [os.path.join(_VENV_ROOT, e) for e in os.listdir(_VENV_ROOT)
                   if os.path.isdir(os.path.join(_VENV_ROOT, e))
                   and not e.endswith(".inuse")]
    except OSError:
        return
    entries.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    for stale in entries[keep:]:
        if _venv_in_use(stale):
            continue
        # Grace window: ensure_pip_venv's marker fast path utime()s the dir
        # before returning, but the caller pins .inuse only afterwards — a
        # recently-touched venv may be on a reader's sys.path already.
        try:
            if time.time() - os.path.getmtime(stale) < 600.0:
                continue
        except OSError:
            continue
        # A mid-build venv has no .complete marker and no .inuse pins yet;
        # the builder holds LOCK_EX on <venv>.lock for the whole build, so
        # only delete if we can take the lock ourselves (non-blocking).
        import fcntl
        try:
            lock = open(stale + ".lock", "w")
        except OSError:
            continue
        try:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                continue  # builder active: skip this round
            try:
                # re-validate under the lock: a reader's utime or a fresh
                # .inuse pin may have landed since the pre-lock checks
                try:
                    if time.time() - os.path.getmtime(stale) < 600.0:
                        continue
                except OSError:
                    continue
                if _venv_in_use(stale):
                    continue
                shutil.rmtree(stale, ignore_errors=True)
                shutil.rmtree(stale + ".inuse", ignore_errors=True)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        finally:
            lock.close()


def _extract(key: str, data: bytes, subdir: str | None) -> str:
    dest = os.path.join(_CACHE_ROOT, key)
    target = os.path.join(dest, subdir) if subdir else dest
    marker = os.path.join(dest, ".complete")
    if not os.path.exists(marker):
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            zf.extractall(target)
        with open(marker, "w") as f:
            f.write("ok")
    return dest


def materialize(spec: dict, kv_get) -> None:
    """Worker side: apply a packaged runtime env to this process.
    `kv_get(key)` fetches from GCS KV."""
    for k, v in (spec.get("env_vars") or {}).items():
        os.environ[k] = v
    for key, name, is_dir in spec.get("py_modules") or []:
        data = kv_get(key)
        if data is None:
            raise RuntimeError(f"runtime_env package {key} missing from GCS")
        root = _extract(key, data, name if is_dir else None)
        if root not in sys.path:
            sys.path.insert(0, root)
    wd_key = spec.get("working_dir")
    if wd_key:
        data = kv_get(wd_key)
        if data is None:
            raise RuntimeError(f"runtime_env package {wd_key} missing")
        root = _extract(wd_key, data, None)
        os.chdir(root)
        if root not in sys.path:
            sys.path.insert(0, root)
    pip_spec = spec.get("pip")
    if pip_spec:
        venv_dir = ensure_pip_venv(pip_spec)
        mark_pip_venv_in_use(venv_dir)
        site = _venv_site_packages(venv_dir)
        if site not in sys.path:
            sys.path.insert(0, site)
        # child processes of the task resolve the venv interpreter
        os.environ["VIRTUAL_ENV"] = venv_dir
        os.environ["PATH"] = (os.path.join(venv_dir, "bin") + os.pathsep
                              + os.environ.get("PATH", ""))
        # a module imported under a previous env must not satisfy this
        # env's import of the same distribution
        import importlib

        importlib.invalidate_caches()
    conda_spec = spec.get("conda")
    if conda_spec:
        prefix = ensure_conda_env(conda_spec)
        site = _conda_site_packages(prefix)
        if site not in sys.path:
            sys.path.insert(0, site)
        os.environ["CONDA_PREFIX"] = prefix
        os.environ["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                              + os.environ.get("PATH", ""))
        import importlib

        importlib.invalidate_caches()
    for key, plugin_blob, packaged in spec.get("_plugins") or []:
        import cloudpickle

        cloudpickle.loads(plugin_blob).materialize(packaged, kv_get)
