"""Crash-safe on-disk content-addressed store for activity profiles.

A profile is a pure function of (operands, geometry, dataflow, plan) — the
in-memory sha256 cache (``core.switching``) already exploits that within a
process.  This store extends the same keys across processes: a run
against a warm store does no profiling compute for anything an earlier run
measured.

The crash-safety machinery (atomic tmp+fsync+rename writes, per-entry
sha256 verification, quarantine-on-corruption, LRU-by-mtime eviction) lives
in the generic ``core.store.ContentStore``, and this module only adds the
``ActivityProfile`` encode/decode on top.  Entries are the reference
package's format (``{"v", "sha256", "payload"}`` under the ``v4`` version
directory).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.store import _DEFAULT_MAX_BYTES, ContentStore

__all__ = ["ProfileStore", "STORE_VERSION"]

# Must track the in-memory cache key schema (``switching._cache_key``): the
# store serves the SAME keys, so a schema bump there must orphan disk
# entries here too.
STORE_VERSION = "v4"


class ProfileStore(ContentStore):
    """One on-disk profile store rooted at ``path`` (created on first use).

    Thread-safe; every method is total (no exception escapes a ``get`` or
    ``put`` — the worst outcome is a counted miss or a dropped write).
    """

    def __init__(
        self,
        path,
        *,
        max_bytes: int = _DEFAULT_MAX_BYTES,
        version: str = STORE_VERSION,
    ):
        super().__init__(
            path, version=version, max_bytes=max_bytes, corrupt_site="store-read"
        )

    # -- profile payload codec ----------------------------------------------

    @staticmethod
    def _to_payload(profile) -> dict:
        payload = dataclasses.asdict(profile)
        for lane_field in ("h_lane_toggles", "v_lane_toggles"):
            if payload.get(lane_field) is not None:
                payload[lane_field] = list(payload[lane_field])
        return payload

    @staticmethod
    def _from_payload(payload: dict):
        from repro_torch.core.switching import ActivityProfile

        for lane_field in ("h_lane_toggles", "v_lane_toggles"):
            if payload.get(lane_field) is not None:
                payload[lane_field] = tuple(int(v) for v in payload[lane_field])
        return ActivityProfile(**payload)

    # -- public API ----------------------------------------------------------

    def get(self, key: bytes):
        """Verified profile for ``key``, or None (miss / quarantined)."""
        payload = self.get_payload(key)
        if payload is None:
            return None
        try:
            return self._from_payload(payload)
        except Exception:
            # A sha-valid entry that no longer decodes (schema drift inside
            # the same version) is as unusable as a corrupt one: quarantine
            # semantics without the file move — count and miss.
            self._count("integrity_failures")
            self._count("misses")
            return None

    def put(self, key: bytes, profile) -> bool:
        """Atomically persist ``profile`` under ``key``; True on success."""
        return self.put_payload(key, self._to_payload(profile))
