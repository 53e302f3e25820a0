"""Generic crash-safe on-disk content-addressed store.

Every persisted artifact of the stack — activity profiles
(``core.profile_store``) and sweep chunks (``core.sweep``) — shares ONE
audited implementation of the crash-safety machinery instead of
re-growing it per subsystem.

Design constraints, in priority order:

  1. **Never corrupt, never crash.**  Writes are atomic (temp file in the
     same directory + ``os.replace``); a process killed mid-write leaves
     only a temp file the next writer ignores, never a torn entry.  Reads
     verify a per-entry sha256 over the payload bytes; entries that fail
     verification (bit rot, torn bytes from pre-atomic tooling, tampering)
     are QUARANTINED — moved aside for forensics, counted, and reported as
     a miss so the caller recomputes and overwrites.  No store failure mode
     propagates: a broken disk degrades to compute, exactly like a cold
     cache.
  2. **Versioned keys.**  Entries live under a schema-version directory;
     a key-schema bump orphans old entries rather than mis-serving them.
  3. **Bounded size.**  ``max_bytes`` caps the store; eviction is
     LRU-by-mtime (reads touch their entry), oldest first.

Layout::

    <root>/<version>/<kk>/<keyhex>.json      kk = first key byte (fan-out)
    <root>/<version>/quarantine/<keyhex>.json
    <root>/<version>/.tmp-<pid>-<nonce>      in-flight writes

Entry format: JSON ``{"v", "sha256", "payload"}`` where ``sha256`` is over
the canonical (sorted-keys) JSON encoding of ``payload``.  JSON keeps
entries inspectable with a text editor during an incident; bulk array data
(sweep chunks) rides inside the payload as base64 fields.

``corrupt_site`` names the fault-injection site the read path exposes
(``runtime.faults`` bitflips): ``"store-read"`` for profiles,
``"chunk-store-read"`` for sweep chunks — chaos CI can aim at either store
independently.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading

__all__ = ["ContentStore", "atomic_write_bytes"]

_DEFAULT_MAX_BYTES = 256 << 20  # 256 MiB ~ hundreds of thousands of entries


def canonical_payload(payload: dict) -> bytes:
    """Canonical (sorted-keys, no-whitespace) JSON bytes of ``payload`` —
    the digest input shared by every store entry."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def atomic_write_bytes(
    path: str | os.PathLike, raw: bytes, *, tmp_dir: str | os.PathLike | None = None
) -> None:
    """Write ``raw`` to ``path`` atomically (tmp file + fsync +
    ``os.replace``).  ``tmp_dir`` (default: ``path``'s directory) must be on
    the same filesystem for the replace to stay atomic.  Raises ``OSError``
    on failure — callers decide whether a dropped write is fatal (checkpoint
    manifests) or degradable (store entries)."""
    path = os.fspath(path)
    d = os.fspath(tmp_dir) if tmp_dir is not None else (os.path.dirname(path) or ".")
    tmp = os.path.join(d, f".tmp-{os.getpid()}-{secrets.token_hex(8)}")
    try:
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ContentStore:
    """One on-disk store rooted at ``path`` (created on first use).

    Payloads are JSON dicts addressed by an opaque ``bytes`` key; subclasses
    add typed encode/decode on top of ``get_payload``/``put_payload``.
    Thread-safe; every method is total (no exception escapes a get or put —
    the worst outcome is a counted miss or a dropped write).
    """

    def __init__(
        self,
        path: str | os.PathLike,
        *,
        version: str,
        max_bytes: int = _DEFAULT_MAX_BYTES,
        corrupt_site: str = "store-read",
    ):
        self.root = os.fspath(path)
        self.version = version
        self.max_bytes = int(max_bytes)
        self.corrupt_site = corrupt_site
        self.stats = {
            "hits": 0,
            "misses": 0,
            "puts": 0,
            "evictions": 0,
            "integrity_failures": 0,
            "io_errors": 0,
        }
        self._lock = threading.Lock()
        self._approx_bytes: int | None = None  # lazily scanned
        self._quarantine_events: list[str] = []  # key hexes, drained by readers

    # -- paths ---------------------------------------------------------------

    @property
    def _vdir(self) -> str:
        return os.path.join(self.root, self.version)

    @property
    def quarantine_dir(self) -> str:
        return os.path.join(self._vdir, "quarantine")

    def entry_path(self, key: bytes) -> str:
        hexkey = key.hex()
        return os.path.join(self._vdir, hexkey[:2], hexkey + ".json")

    def _count(self, stat: str, n: int = 1) -> None:
        with self._lock:
            self.stats[stat] += n

    # -- encode / decode -----------------------------------------------------

    def encode_payload(self, payload: dict) -> bytes:
        body = canonical_payload(payload)
        doc = {
            "v": self.version,
            "sha256": hashlib.sha256(body).hexdigest(),
            "payload": payload,
        }
        return json.dumps(doc, sort_keys=True).encode()

    def decode_payload(self, raw: bytes) -> dict:
        """Verified payload dict, or raise (caller quarantines)."""
        doc = json.loads(raw)
        if doc["v"] != self.version:
            raise ValueError(f"entry version {doc['v']!r} != {self.version!r}")
        payload = doc["payload"]
        digest = hashlib.sha256(canonical_payload(payload)).hexdigest()
        if digest != doc["sha256"]:
            raise ValueError("payload sha256 mismatch")
        return payload

    # -- public API ----------------------------------------------------------

    def get_payload(self, key: bytes) -> dict | None:
        """Verified payload for ``key``, or None (miss / quarantined)."""
        path = self.entry_path(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self._count("misses")
            return None
        except OSError:
            self._count("io_errors")
            self._count("misses")
            return None

        from repro_torch.runtime import faults

        inj = faults.active()
        if inj is not None:
            raw = inj.maybe_corrupt(raw, self.corrupt_site, key.hex()[:16])

        try:
            payload = self.decode_payload(raw)
        except Exception:
            self._quarantine(key, path, raw)
            self._count("integrity_failures")
            self._count("misses")
            return None
        try:
            os.utime(path)  # LRU recency
        except OSError:
            pass
        self._count("hits")
        return payload

    def put_payload(self, key: bytes, payload: dict) -> bool:
        """Atomically persist ``payload`` under ``key``; True on success.

        Crash-safe by construction: the entry becomes visible only via the
        final ``os.replace`` — a writer killed at ANY earlier point leaves
        the previous entry (if any) untouched and at most a stray temp
        file.  I/O failures are counted and swallowed (a full disk must
        degrade to compute-only, not abort a workload).
        """
        path = self.entry_path(key)
        try:
            raw = self.encode_payload(payload)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write_bytes(path, raw, tmp_dir=self._vdir)
        except OSError:
            self._count("io_errors")
            return False
        self._count("puts")
        with self._lock:
            if self._approx_bytes is not None:
                self._approx_bytes += len(raw)
        self._evict_if_needed()
        return True

    def drain_quarantine_events(self) -> list[str]:
        """Key hexes quarantined since the last drain (failure reporting)."""
        with self._lock:
            out, self._quarantine_events = self._quarantine_events, []
        return out

    def _quarantine(self, key: bytes, path: str, raw: bytes) -> None:
        """Move a failed-verification entry aside; never raise."""
        with self._lock:
            self._quarantine_events.append(key.hex())
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            os.replace(
                path, os.path.join(self.quarantine_dir, os.path.basename(path))
            )
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- size bound ----------------------------------------------------------

    def _scan(self) -> list[tuple[float, int, str]]:
        """(mtime, size, path) for every live entry; also refreshes the
        approximate byte total and sweeps stale temp files."""
        out = []
        total = 0
        try:
            shards = os.listdir(self._vdir)
        except OSError:
            shards = []
        for shard in shards:
            sdir = os.path.join(self._vdir, shard)
            if shard.startswith(".tmp-"):
                try:  # stray temp from a crashed writer: sweep
                    os.unlink(sdir)
                except OSError:
                    pass
                continue
            if shard == "quarantine" or not os.path.isdir(sdir):
                continue
            try:
                names = os.listdir(sdir)
            except OSError:
                continue
            for name in names:
                p = os.path.join(sdir, name)
                if name.startswith(".tmp-"):
                    try:  # defensive: a temp that strayed into a shard dir
                        os.unlink(p)
                    except OSError:
                        pass
                    continue
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        with self._lock:
            self._approx_bytes = total
        return out

    def _evict_if_needed(self) -> None:
        with self._lock:
            approx = self._approx_bytes
        if approx is not None and approx <= self.max_bytes:
            return
        entries = self._scan()
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return
        evicted = 0
        for _, size, p in sorted(entries):  # oldest mtime first
            if total <= self.max_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= size
            evicted += 1
        with self._lock:
            self._approx_bytes = total
            self.stats["evictions"] += evicted

    # -- introspection -------------------------------------------------------

    def entries(self) -> list[str]:
        """Paths of every live entry (tests / incident tooling)."""
        return sorted(p for _, _, p in self._scan())

    def quarantined(self) -> list[str]:
        try:
            return sorted(
                os.path.join(self.quarantine_dir, n)
                for n in os.listdir(self.quarantine_dir)
            )
        except OSError:
            return []

    def info(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        return {
            "path": self.root,
            "version": self.version,
            "max_bytes": self.max_bytes,
            "entries": len(self.entries()),
            **stats,
        }

    def clear(self) -> None:
        """Delete every entry (incl. quarantine); keep the directories."""
        for p in self.entries() + self.quarantined():
            try:
                os.unlink(p)
            except OSError:
                pass
        with self._lock:
            self._approx_bytes = 0
