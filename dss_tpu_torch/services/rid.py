"""RID service: ISA + Subscription application logic and handlers.

Combines the reference's handler layer (pkg/rid/server) and application
layer (pkg/rid/application): version/ownership fencing prechecks,
AdjustTimeRange, the DSS0030 subscription quota, and notification-index
fanout over the union of old+new cells on ISA mutation.  Requests and
responses are proto-JSON-shaped dicts (the REST wire format).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dss_tpu_torch import errors
from dss_tpu_torch.clock import Clock
from dss_tpu_torch.dar.store import RIDStore
from dss_tpu_torch.geo import covering as geo_covering
from dss_tpu_torch.models import rid as ridm
from dss_tpu_torch.models.core import Version, validate_uuid
from dss_tpu_torch.obs import stages
from dss_tpu_torch.services import serialization as ser

MAX_SUBSCRIPTIONS_PER_AREA = 10  # DSS0030 (pkg/rid/application/subscription.go)


def _area_to_cells(area: str) -> np.ndarray:
    try:
        # canonical (sorted, deduped) at ingress: cache keying and the
        # pack path share one covering form (geo_covering.canonical_cells)
        return geo_covering.canonical_cells(
            geo_covering.area_to_cell_ids(area)
        )
    except geo_covering.AreaTooLargeError as e:
        raise errors.area_too_large(f"bad area: {e}")
    except geo_covering.BadAreaError as e:
        raise errors.bad_request(f"bad area: {e}")


def _parse_version(version: Optional[str]) -> Optional[Version]:
    if version is None:
        return None
    try:
        return Version.from_string(version)
    except ValueError as e:
        raise errors.bad_request(f"bad version: {e}")


class RIDService:
    def __init__(self, store: RIDStore, clock: Clock):
        self.store = store
        self.clock = clock

    # -- ISAs (pkg/rid/server/isa_handler.go + application/isa.go) ----------

    def get_isa(self, id: str) -> dict:
        validate_uuid(id)
        isa = self.store.get_isa(id)
        if isa is None:
            raise errors.not_found(id)
        return {"service_area": ser.isa_to_json(isa)}

    def _put_isa(
        self,
        id: str,
        version: Optional[Version],
        extents_json: dict,
        flights_url: str,
        owner: str,
    ) -> dict:
        validate_uuid(id)
        if not flights_url:
            raise errors.bad_request("missing required flightsURL")
        if extents_json is None:
            raise errors.bad_request("missing required extents")
        isa = ridm.IdentificationServiceArea(
            id=id, owner=owner, url=flights_url, version=version
        )
        try:
            with stages.stage("covering_ms"):
                isa.set_extents(ser.volume4d_from_rid_json(extents_json))
        except geo_covering.AreaTooLargeError as e:
            raise errors.area_too_large(f"bad extents: {e}")
        except geo_covering.BadAreaError as e:
            raise errors.bad_request(f"bad extents: {e}")

        with self.store.transaction():
            old = self.store.get_isa(isa.id)
            if old is None and isa.version is not None and not isa.version.empty:
                raise errors.not_found(isa.id)
            if old is not None and (isa.version is None or isa.version.empty):
                raise errors.already_exists(isa.id)
            if old is not None and not isa.version.matches(old.version):
                raise errors.version_mismatch("old version")
            if old is not None and old.owner != isa.owner:
                raise errors.permission_denied(f"ISA is owned by {old.owner}")
            isa.adjust_time_range(self.clock.now(), old)
            # fanout over union of old+new cells (application/isa.go:120-141)
            cells = isa.cells
            if old is not None:
                cells = np.union1d(
                    np.asarray(old.cells, np.uint64), np.asarray(isa.cells, np.uint64)
                )
            subs = self.store.update_notification_idxs_in_cells(
                cells, entity=isa
            )
            ret = self.store.insert_isa(isa)
            if ret is None:
                raise errors.version_mismatch("old version")
        return {
            "service_area": ser.isa_to_json(ret),
            "subscribers": [ser.rid_sub_to_notify_json(s) for s in subs],
        }

    @errors.retry_write_conflicts
    def create_isa(self, id: str, params: dict, owner: str) -> dict:
        return self._put_isa(
            id, None, params.get("extents"), params.get("flights_url", ""), owner
        )

    @errors.retry_write_conflicts
    def update_isa(self, id: str, version: str, params: dict, owner: str) -> dict:
        v = _parse_version(version or "")
        return self._put_isa(
            id, v, params.get("extents"), params.get("flights_url", ""), owner
        )

    @errors.retry_write_conflicts
    def delete_isa(self, id: str, version: str, owner: str) -> dict:
        validate_uuid(id)
        v = _parse_version(version or "")
        with self.store.transaction():
            old = self.store.get_isa(id)
            if old is None:
                raise errors.not_found(id)
            if v is not None and not v.empty and not v.matches(old.version):
                raise errors.version_mismatch("old version")
            if old.owner != owner:
                raise errors.permission_denied(f"ISA is owned by {old.owner}")
            subs = self.store.update_notification_idxs_in_cells(
                old.cells, entity=old, removed=True
            )
            isa = self.store.delete_isa(
                dataclasses.replace(old, owner=owner, version=old.version)
            )
            if isa is None:
                raise errors.version_mismatch("old version")
        return {
            "service_area": ser.isa_to_json(isa),
            "subscribers": [ser.rid_sub_to_notify_json(s) for s in subs],
        }

    def search_isas(
        self,
        area: str,
        earliest_time: Optional[str] = None,
        latest_time: Optional[str] = None,
    ) -> dict:
        with stages.stage("covering_ms"):
            cells = _area_to_cells(area or "")
        earliest = latest = None
        if earliest_time:
            try:
                earliest = ser.parse_time(earliest_time)
            except ValueError as e:
                raise errors.bad_request(f"bad earliest_time: {e}")
        if latest_time:
            try:
                latest = ser.parse_time(latest_time)
            except ValueError as e:
                raise errors.bad_request(f"bad latest_time: {e}")
        # clamp earliest to now (application/isa.go:38-45)
        now = self.clock.now()
        if earliest is None or earliest < now:
            earliest = now
        with stages.stage("store_ms"):
            # allow_stale: a public search may ride the mesh replica
            # when its batch is oversized and the replica is fresh
            isas = self.store.search_isas(
                cells, earliest, latest, allow_stale=True
            )
        with stages.stage("serialize_ms"):
            return {"service_areas": [ser.isa_to_json(i) for i in isas]}

    # -- Subscriptions (subscription_handler.go + application/subscription.go)

    def get_subscription(self, id: str) -> dict:
        validate_uuid(id)
        sub = self.store.get_subscription(id)
        if sub is None:
            raise errors.not_found(id)
        return {"subscription": ser.rid_sub_to_json(sub)}

    def _put_subscription(
        self,
        id: str,
        version: Optional[Version],
        callbacks: Optional[dict],
        extents_json: dict,
        owner: str,
    ) -> dict:
        validate_uuid(id)
        if callbacks is None:
            raise errors.bad_request("missing required callbacks")
        if extents_json is None:
            raise errors.bad_request("missing required extents")
        sub = ridm.Subscription(
            id=id,
            owner=owner,
            url=callbacks.get("identification_service_area_url", ""),
            version=version,
        )
        try:
            with stages.stage("covering_ms"):
                sub.set_extents(ser.volume4d_from_rid_json(extents_json))
        except geo_covering.AreaTooLargeError as e:
            raise errors.area_too_large(f"bad extents: {e}")
        except geo_covering.BadAreaError as e:
            raise errors.bad_request(f"bad extents: {e}")

        with self.store.transaction():
            old = self.store.get_subscription(sub.id)
            if old is None and sub.version is not None and not sub.version.empty:
                raise errors.not_found(sub.id)
            if old is not None and (sub.version is None or sub.version.empty):
                raise errors.already_exists(sub.id)
            if old is not None and not sub.version.matches(old.version):
                raise errors.version_mismatch("old version")
            if old is not None and old.owner != sub.owner:
                raise errors.permission_denied(f"s is owned by {old.owner}")
            sub.adjust_time_range(self.clock.now(), old)
            count = self.store.max_subscription_count_in_cells_by_owner(
                sub.cells, sub.owner
            )
            if count >= MAX_SUBSCRIPTIONS_PER_AREA:
                raise errors.exhausted(
                    "too many existing subscriptions in this area already"
                )
            inserted = self.store.insert_subscription(sub)
            if inserted is None:
                raise errors.version_mismatch("old version")
            # affected ISAs in the subscription's area (earliest clamps to now)
            isas = self.store.search_isas(sub.cells, self.clock.now(), None)
        return {
            "subscription": ser.rid_sub_to_json(inserted),
            "service_areas": [ser.isa_to_json(i) for i in isas],
        }

    @errors.retry_write_conflicts
    def create_subscription(self, id: str, params: dict, owner: str) -> dict:
        return self._put_subscription(
            id, None, params.get("callbacks"), params.get("extents"), owner
        )

    @errors.retry_write_conflicts
    def update_subscription(
        self, id: str, version: str, params: dict, owner: str
    ) -> dict:
        v = _parse_version(version or "")
        return self._put_subscription(
            id, v, params.get("callbacks"), params.get("extents"), owner
        )

    @errors.retry_write_conflicts
    def delete_subscription(self, id: str, version: str, owner: str) -> dict:
        validate_uuid(id)
        _parse_version(version or "")  # must parse; reference app ignores it
        with self.store.transaction():
            old = self.store.get_subscription(id)
            if old is None:
                raise errors.not_found(id)
            if old.owner != owner:
                raise errors.permission_denied(f"ISA is owned by {old.owner}")
            # the reference deletes at the *current* version regardless of
            # the supplied one (application/subscription.go:84-100)
            deleted = self.store.delete_subscription(old)
            if deleted is None:
                raise errors.version_mismatch("old version")
        return {"subscription": ser.rid_sub_to_json(deleted)}

    def search_subscriptions(self, area: str, owner: str) -> dict:
        with stages.stage("covering_ms"):
            cells = _area_to_cells(area or "")
        with stages.stage("store_ms"):
            subs = self.store.search_subscriptions_by_owner(cells, owner)
        with stages.stage("serialize_ms"):
            return {"subscriptions": [ser.rid_sub_to_json(s) for s in subs]}
