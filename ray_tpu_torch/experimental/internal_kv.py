"""Internal KV helpers over the GCS (ref analog:
python/ray/experimental/internal_kv.py — the `_internal_kv_*` functions
libraries build rendezvous/metadata on)."""

from __future__ import annotations

from typing import Optional


def _client():
    from ray_tpu_torch.api import _core_worker

    return _core_worker()


def _internal_kv_initialized() -> bool:
    try:
        return _client() is not None
    except Exception:
        return False


def _internal_kv_put(key: bytes | str, value: bytes | str, *,
                     overwrite: bool = True,
                     namespace: str = "kv") -> bool:
    """Returns True iff the key was NEWLY added (reference semantics:
    False means it already existed)."""
    cw = _client()
    key = key.decode() if isinstance(key, bytes) else key
    value = value.encode() if isinstance(value, str) else value
    added = cw.io.run(cw.gcs.kv_put(key, value, namespace=namespace,
                                    overwrite=overwrite))
    return bool(added)


def _internal_kv_get(key: bytes | str, *,
                     namespace: str = "kv") -> Optional[bytes]:
    cw = _client()
    key = key.decode() if isinstance(key, bytes) else key
    return cw.io.run(cw.gcs.kv_get(key, namespace=namespace))


def _internal_kv_exists(key: bytes | str, *, namespace: str = "kv") -> bool:
    return _internal_kv_get(key, namespace=namespace) is not None


def _internal_kv_del(key: bytes | str, *, namespace: str = "kv") -> bool:
    cw = _client()
    key = key.decode() if isinstance(key, bytes) else key
    return bool(cw.io.run(cw.gcs.kv_del(key, namespace=namespace)))


def _internal_kv_list(prefix: bytes | str = "", *,
                      namespace: str = "kv") -> list[bytes]:
    cw = _client()
    prefix = prefix.decode() if isinstance(prefix, bytes) else prefix
    keys = cw.io.run(cw.gcs.kv_keys(prefix, namespace=namespace))
    return [k.encode() for k in keys]
