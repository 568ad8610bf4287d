"""SCD service: operation references + subscriptions + constraints.

Mirrors pkg/scd: PutOperationReference with multi-volume extent union,
implicit subscriptions, OVN key checks with the AirspaceConflict
response on missing OVNs (operations_handler.go:171-309), subscription
lifecycle (subscriptions_handler.go).  Constraint references go BEYOND
the reference (constraints_handler.go:12-30 raises "not yet
implemented" on all four endpoints): real CRUD/query with the same
owner/int32-version/OVN discipline as operations, notification fan-out
to notify_for_constraints subscriptions, and constraint-aware
operation deconfliction (docs/DESIGN.md "Constraint references").
"""

from __future__ import annotations

import contextlib
import uuid as uuidlib
from typing import List, Optional

import numpy as np

from dss_tpu_torch import errors
from dss_tpu_torch.clock import Clock
from dss_tpu_torch.dar.store import SCDStore
from dss_tpu_torch.geo import covering as geo_covering
from dss_tpu_torch.models import scd as scdm
from dss_tpu_torch.models.core import validate_uss_base_url
from dss_tpu_torch.models.volumes import union_volumes_4d
from dss_tpu_torch.obs import stages
from dss_tpu_torch.services import serialization as ser


def _area_error(e: Exception):
    if isinstance(e, geo_covering.AreaTooLargeError):
        return errors.area_too_large(str(e))
    return errors.bad_request(f"bad area: {e}")


def _missing_ovns_response(
    ops: List[scdm.Operation], csts: List[scdm.Constraint] = (),
) -> dict:
    """The AirspaceConflictResponse body (pkg/scd/errors/errors.go:22-53);
    OVNs of other owners' operations are included — that is the point of
    the response (the caller needs them for its key).  Constraint-aware
    upserts additionally list intersecting constraints the key missed —
    and the message names what is actually missing, so a client acting
    on it re-queries the right entity class."""
    missing = [w for w, lst in (
        ("operation", ops), ("constraint", csts),
    ) if lst]
    what = " or ".join(missing) if missing else "operation"
    return {
        "message": (
            f"at least one current {what} is missing from the key; "
            "no changes have been made"
        ),
        "entity_conflicts": [
            {"operation_reference": ser.op_to_json(op)} for op in ops
        ]
        + [
            {"constraint_reference": ser.constraint_to_json(c)}
            for c in csts
        ],
    }


def _extents_to_covering(params: dict):
    """Union a PUT's multi-volume `extents` and compute the covering —
    the shared ingress path of operation AND constraint upserts.
    Returns (union Volume4D, cells); raises the same wire errors for
    both entity classes so a fix to one cannot miss the other."""
    extents_json = params.get("extents") or []
    extents = [ser.volume4d_from_scd_json(e) for e in extents_json]
    try:
        u_extent = union_volumes_4d(extents)
    except geo_covering.AreaTooLargeError as e:
        raise errors.area_too_large(str(e))
    except (geo_covering.BadAreaError, ValueError) as e:
        raise errors.bad_request(f"failed to union extents: {e}")
    if u_extent.start_time is None:
        raise errors.bad_request("missing time_start from extents")
    if u_extent.end_time is None:
        raise errors.bad_request("missing time_end from extents")
    try:
        with stages.stage("covering_ms"):
            cells = u_extent.calculate_spatial_covering()
    except (
        geo_covering.AreaTooLargeError,
        geo_covering.BadAreaError,
        ValueError,
    ) as e:
        raise _area_error(e)
    return u_extent, cells


def _aoi_to_covering(params: dict):
    """Parse a query's `area_of_interest` and compute the covering —
    the shared ingress path of every SCD search/query endpoint."""
    aoi = params.get("area_of_interest")
    if aoi is None:
        raise errors.bad_request("missing area_of_interest")
    vol4 = ser.volume4d_from_scd_json(aoi)
    try:
        with stages.stage("covering_ms"):
            cells = vol4.calculate_spatial_covering()
    except (
        geo_covering.AreaTooLargeError,
        geo_covering.BadAreaError,
        ValueError,
    ) as e:
        raise _area_error(e)
    return vol4, cells


class SCDService:
    def __init__(self, store: SCDStore, clock: Clock):
        self.store = store
        self.clock = clock

    # -- Operation references ------------------------------------------------

    @errors.retry_write_conflicts
    def put_operation(self, entity_uuid: str, params: dict, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Operation ID")
        if not params.get("uss_base_url"):
            raise errors.bad_request("missing required UssBaseUrl")
        u_extent, cells = _extents_to_covering(params)

        subscription_id = params.get("subscription_id") or ""
        key = [str(k) for k in (params.get("key") or [])]

        op = scdm.Operation(
            id=entity_uuid,
            owner=owner,
            version=ser.int_field(params.get("old_version"), "old_version"),
            start_time=u_extent.start_time,
            end_time=u_extent.end_time,
            altitude_lower=u_extent.spatial_volume.altitude_lo,
            altitude_upper=u_extent.spatial_volume.altitude_hi,
            cells=cells,
            uss_base_url=params["uss_base_url"],
            subscription_id=subscription_id,
            state=params.get("state", ""),
        )

        new_sub = params.get("new_subscription") or {}
        if not subscription_id:
            try:
                validate_uss_base_url(new_sub.get("uss_base_url", ""))
            except ValueError as e:
                raise errors.bad_request(str(e))
            # constraint awareness rides the subscription the op rides:
            # a USS that asked for constraint notifications consumes
            # constraint updates and must key against them
            op.constraint_aware = bool(
                new_sub.get("notify_for_constraints", False)
            )

        @contextlib.contextmanager
        def conflict_details():
            """On MISSING_OVNS, attach the AirspaceConflictResponse
            payload with the full conflict set
            (operations_handler.go:268-280) — operations always,
            intersecting constraints when the op is constraint-aware."""
            try:
                yield
            except errors.StatusError as e:
                if e.code == errors.Code.MISSING_OVNS:
                    ops = self.store.search_operations(
                        cells,
                        u_extent.spatial_volume.altitude_lo,
                        u_extent.spatial_volume.altitude_hi,
                        u_extent.start_time,
                        u_extent.end_time,
                    )
                    csts = (
                        self.store.search_constraints(
                            cells,
                            u_extent.spatial_volume.altitude_lo,
                            u_extent.spatial_volume.altitude_hi,
                            u_extent.start_time,
                            u_extent.end_time,
                        )
                        if op.constraint_aware
                        else []
                    )
                    e.details = _missing_ovns_response(ops, csts)
                raise

        with self.store.transaction():
            if subscription_id:
                # explicit subscription: awareness comes from ITS
                # notify_for_constraints, resolved inside the txn so
                # the precheck and the flag agree on one sub version.
                # A missing/foreign subscription propagates (404): a
                # typoed id must not silently downgrade the op to
                # non-aware AND persist a dangling reference the USS
                # thinks is delivering its notifications.
                op.constraint_aware = self.store.get_subscription(
                    subscription_id, owner
                ).notify_for_constraints
            with conflict_details():
                # Validate (incl. the OVN key check) BEFORE journaling
                # the implicit subscription: a rejected conflict is a
                # routine outcome and must leave nothing to roll back.
                self.store.validate_operation_upsert(op, key)

            if not subscription_id:
                sub, _ = self.store.upsert_subscription(
                    scdm.Subscription(
                        id=str(uuidlib.uuid4()),
                        owner=owner,
                        start_time=u_extent.start_time,
                        end_time=u_extent.end_time,
                        altitude_lo=u_extent.spatial_volume.altitude_lo,
                        altitude_hi=u_extent.spatial_volume.altitude_hi,
                        cells=cells,
                        base_url=new_sub.get("uss_base_url", ""),
                        notify_for_operations=True,
                        notify_for_constraints=new_sub.get(
                            "notify_for_constraints", False
                        ),
                        implicit_subscription=True,
                    )
                )
                op.subscription_id = sub.id

            with conflict_details():
                # key_checked: the OVN search already ran in this txn
                # scope (pinned timestamp -> same visibility answers)
                stored, subs = self.store.upsert_operation(
                    op, key, key_checked=True
                )
        return {
            "operation_reference": ser.op_to_json(stored),
            "subscribers": ser.scd_subscribers_to_notify_json(subs),
        }

    def get_operation(self, entity_uuid: str, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Operation ID")
        op = self.store.get_operation(entity_uuid)
        if op.owner != owner:
            op.ovn = ""  # OVNs are private to the owner
        return {"operation_reference": ser.op_to_json(op)}

    @errors.retry_write_conflicts
    def delete_operation(self, entity_uuid: str, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Operation ID")
        with self.store.transaction():
            op, subs = self.store.delete_operation(entity_uuid, owner)
        return {
            "operation_reference": ser.op_to_json(op),
            "subscribers": ser.scd_subscribers_to_notify_json(subs),
        }

    def search_operations(self, params: dict, owner: str) -> dict:
        vol4, cells = _aoi_to_covering(params)
        sv = vol4.spatial_volume
        # allow_stale: public search may ride the mesh replica for
        # oversized batches (the conflict-response listing at :117 must
        # NOT — it feeds the OVN key the client will retry with)
        ops = self.store.search_operations(
            cells, sv.altitude_lo, sv.altitude_hi, vol4.start_time,
            vol4.end_time, allow_stale=True,
        )
        out = []
        for op in ops:
            if op.owner != owner:
                op.ovn = ""
            out.append(ser.op_to_json(op))
        return {"operation_references": out}

    # -- Subscriptions -------------------------------------------------------

    @errors.retry_write_conflicts
    def put_subscription(self, subscription_id: str, params: dict, owner: str) -> dict:
        if not subscription_id:
            raise errors.bad_request("missing Subscription ID")
        extents = ser.volume4d_from_scd_json(params.get("extents") or {})
        try:
            cells = (
                extents.calculate_spatial_covering()
                if extents.spatial_volume and extents.spatial_volume.footprint
                else np.array([], np.uint64)
            )
        except (
            geo_covering.AreaTooLargeError,
            geo_covering.BadAreaError,
            ValueError,
        ) as e:
            raise _area_error(e)
        sub = scdm.Subscription(
            id=subscription_id,
            owner=owner,
            version=ser.int_field(params.get("old_version"), "old_version"),
            start_time=extents.start_time,
            end_time=extents.end_time,
            altitude_lo=(
                extents.spatial_volume.altitude_lo if extents.spatial_volume else None
            ),
            altitude_hi=(
                extents.spatial_volume.altitude_hi if extents.spatial_volume else None
            ),
            cells=cells,
            base_url=params.get("uss_base_url", ""),
            notify_for_operations=bool(params.get("notify_for_operations", False)),
            notify_for_constraints=bool(params.get("notify_for_constraints", False)),
        )
        if not sub.notify_for_operations and not sub.notify_for_constraints:
            raise errors.bad_request(
                "no notification triggers requested for Subscription"
            )
        # NOTE: the reference passes the new subscription as its own `old`
        # here (subscriptions_handler.go:76), which nil-derefs when
        # time_start is omitted; we use the sane old=None defaulting.
        sub.adjust_time_range(self.clock.now(), None)
        with self.store.transaction():
            stored, ops = self.store.upsert_subscription(sub)
        result = {"subscription": ser.scd_sub_to_json(stored), "operations": []}
        for op in ops:
            if op.owner != owner:
                op.ovn = ""
            result["operations"].append(ser.op_to_json(op))
        return result

    def get_subscription(self, subscription_id: str, owner: str) -> dict:
        if not subscription_id:
            raise errors.bad_request("missing Subscription ID")
        sub = self.store.get_subscription(subscription_id, owner)
        return {"subscription": ser.scd_sub_to_json(sub)}

    def query_subscriptions(self, params: dict, owner: str) -> dict:
        _, cells = _aoi_to_covering(params)
        subs = self.store.search_subscriptions(cells, owner)
        return {"subscriptions": [ser.scd_sub_to_json(s) for s in subs]}

    @errors.retry_write_conflicts
    def delete_subscription(self, subscription_id: str, owner: str) -> dict:
        if not subscription_id:
            raise errors.bad_request("missing Subscription ID")
        with self.store.transaction():
            sub = self.store.delete_subscription(subscription_id, owner, 0)
        return {"subscription": ser.scd_sub_to_json(sub)}

    # -- Constraints (beyond the reference, which stubs these:
    # constraints_handler.go:12-30) ------------------------------------------

    @errors.retry_write_conflicts
    def put_constraint(self, entity_uuid: str, params: dict, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Constraint ID")
        if not params.get("uss_base_url"):
            raise errors.bad_request("missing required UssBaseUrl")
        u_extent, cells = _extents_to_covering(params)

        cst = scdm.Constraint(
            id=entity_uuid,
            owner=owner,
            version=ser.int_field(params.get("old_version"), "old_version"),
            start_time=u_extent.start_time,
            end_time=u_extent.end_time,
            altitude_lower=u_extent.spatial_volume.altitude_lo,
            altitude_upper=u_extent.spatial_volume.altitude_hi,
            cells=cells,
            uss_base_url=params["uss_base_url"],
        )
        with self.store.transaction():
            stored, subs = self.store.upsert_constraint(cst)
        return {
            "constraint_reference": ser.constraint_to_json(stored),
            "subscribers": ser.scd_subscribers_to_notify_json(subs),
        }

    def get_constraint(self, entity_uuid: str, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Constraint ID")
        cst = self.store.get_constraint(entity_uuid)
        if cst.owner != owner:
            cst.ovn = ""  # OVNs are private to the owner
        return {"constraint_reference": ser.constraint_to_json(cst)}

    @errors.retry_write_conflicts
    def delete_constraint(self, entity_uuid: str, owner: str) -> dict:
        if not entity_uuid:
            raise errors.bad_request("missing Constraint ID")
        with self.store.transaction():
            cst, subs = self.store.delete_constraint(entity_uuid, owner)
        return {
            "constraint_reference": ser.constraint_to_json(cst),
            "subscribers": ser.scd_subscribers_to_notify_json(subs),
        }

    def query_constraints(self, params: dict, owner: str) -> dict:
        vol4, cells = _aoi_to_covering(params)
        sv = vol4.spatial_volume
        # allow_stale: public QUERY may ride the mesh replica; the
        # constraint-aware precheck listing never sets it (it feeds
        # the OVN key the client will retry with)
        csts = self.store.search_constraints(
            cells, sv.altitude_lo, sv.altitude_hi, vol4.start_time,
            vol4.end_time, allow_stale=True,
        )
        out = []
        for cst in csts:
            if cst.owner != owner:
                cst.ovn = ""
            out.append(ser.constraint_to_json(cst))
        return {"constraint_references": out}

    def make_dss_report(self, *_args, **_kw):
        raise errors.bad_request("not yet implemented")
