"""Entity <-> plain-dict codecs, used by the WAL and checkpoints.

Documents are JSON-serializable: datetimes as unix nanoseconds, cells
as lists of ints (Python json handles uint64 exactly).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dss_tpu_torch.clock import from_nanos, to_nanos
from dss_tpu_torch.models import rid as ridm
from dss_tpu_torch.models import scd as scdm
from dss_tpu_torch.models.core import Version


def _t(dt) -> Optional[int]:
    return None if dt is None else to_nanos(dt)


def _dt(ns) -> Optional[object]:
    return None if ns is None else from_nanos(ns)


def _cells(cells) -> list:
    return [int(c) for c in np.asarray(cells, dtype=np.uint64)]


def _uncells(lst) -> np.ndarray:
    return np.array([int(c) for c in (lst or [])], dtype=np.uint64)


def isa_to_doc(isa: ridm.IdentificationServiceArea) -> dict:
    return {
        "id": isa.id,
        "owner": isa.owner,
        "url": isa.url,
        "cells": _cells(isa.cells),
        "start_time": _t(isa.start_time),
        "end_time": _t(isa.end_time),
        "version": str(isa.version) if isa.version else None,
        "altitude_hi": isa.altitude_hi,
        "altitude_lo": isa.altitude_lo,
    }


def doc_to_isa(d: dict) -> ridm.IdentificationServiceArea:
    return ridm.IdentificationServiceArea(
        id=d["id"],
        owner=d["owner"],
        url=d.get("url", ""),
        cells=_uncells(d.get("cells")),
        start_time=_dt(d.get("start_time")),
        end_time=_dt(d.get("end_time")),
        version=Version.from_string(d["version"]) if d.get("version") else None,
        altitude_hi=d.get("altitude_hi"),
        altitude_lo=d.get("altitude_lo"),
    )


def rid_sub_to_doc(s: ridm.Subscription) -> dict:
    return {
        "id": s.id,
        "owner": s.owner,
        "url": s.url,
        "notification_index": s.notification_index,
        "cells": _cells(s.cells),
        "start_time": _t(s.start_time),
        "end_time": _t(s.end_time),
        "version": str(s.version) if s.version else None,
        "altitude_hi": s.altitude_hi,
        "altitude_lo": s.altitude_lo,
    }


def doc_to_rid_sub(d: dict) -> ridm.Subscription:
    return ridm.Subscription(
        id=d["id"],
        owner=d["owner"],
        url=d.get("url", ""),
        notification_index=d.get("notification_index", 0),
        cells=_uncells(d.get("cells")),
        start_time=_dt(d.get("start_time")),
        end_time=_dt(d.get("end_time")),
        version=Version.from_string(d["version"]) if d.get("version") else None,
        altitude_hi=d.get("altitude_hi"),
        altitude_lo=d.get("altitude_lo"),
    )


def op_to_doc(o: scdm.Operation) -> dict:
    return {
        "id": o.id,
        "owner": o.owner,
        "version": o.version,
        "ovn": o.ovn,
        "start_time": _t(o.start_time),
        "end_time": _t(o.end_time),
        "altitude_lower": o.altitude_lower,
        "altitude_upper": o.altitude_upper,
        "uss_base_url": o.uss_base_url,
        "state": o.state,
        "cells": _cells(o.cells),
        "subscription_id": o.subscription_id,
        "constraint_aware": o.constraint_aware,
    }


def doc_to_op(d: dict) -> scdm.Operation:
    return scdm.Operation(
        id=d["id"],
        owner=d["owner"],
        version=d.get("version", 0),
        ovn=d.get("ovn", ""),
        start_time=_dt(d.get("start_time")),
        end_time=_dt(d.get("end_time")),
        altitude_lower=d.get("altitude_lower"),
        altitude_upper=d.get("altitude_upper"),
        uss_base_url=d.get("uss_base_url", ""),
        state=d.get("state", ""),
        cells=_uncells(d.get("cells")),
        subscription_id=d.get("subscription_id", ""),
        constraint_aware=d.get("constraint_aware", False),
    )


def constraint_to_doc(c: scdm.Constraint) -> dict:
    return {
        "id": c.id,
        "owner": c.owner,
        "version": c.version,
        "ovn": c.ovn,
        "start_time": _t(c.start_time),
        "end_time": _t(c.end_time),
        "altitude_lower": c.altitude_lower,
        "altitude_upper": c.altitude_upper,
        "uss_base_url": c.uss_base_url,
        "cells": _cells(c.cells),
    }


def doc_to_constraint(d: dict) -> scdm.Constraint:
    return scdm.Constraint(
        id=d["id"],
        owner=d["owner"],
        version=d.get("version", 0),
        ovn=d.get("ovn", ""),
        start_time=_dt(d.get("start_time")),
        end_time=_dt(d.get("end_time")),
        altitude_lower=d.get("altitude_lower"),
        altitude_upper=d.get("altitude_upper"),
        uss_base_url=d.get("uss_base_url", ""),
        cells=_uncells(d.get("cells")),
    )


def scd_sub_to_doc(s: scdm.Subscription) -> dict:
    return {
        "id": s.id,
        "owner": s.owner,
        "version": s.version,
        "notification_index": s.notification_index,
        "start_time": _t(s.start_time),
        "end_time": _t(s.end_time),
        "altitude_hi": s.altitude_hi,
        "altitude_lo": s.altitude_lo,
        "base_url": s.base_url,
        "notify_for_operations": s.notify_for_operations,
        "notify_for_constraints": s.notify_for_constraints,
        "implicit_subscription": s.implicit_subscription,
        "dependent_operations": list(s.dependent_operations),
        "cells": _cells(s.cells),
    }


def doc_to_scd_sub(d: dict) -> scdm.Subscription:
    return scdm.Subscription(
        id=d["id"],
        owner=d["owner"],
        version=d.get("version", 0),
        notification_index=d.get("notification_index", 0),
        start_time=_dt(d.get("start_time")),
        end_time=_dt(d.get("end_time")),
        altitude_hi=d.get("altitude_hi"),
        altitude_lo=d.get("altitude_lo"),
        base_url=d.get("base_url", ""),
        notify_for_operations=d.get("notify_for_operations", False),
        notify_for_constraints=d.get("notify_for_constraints", False),
        implicit_subscription=d.get("implicit_subscription", False),
        dependent_operations=list(d.get("dependent_operations", [])),
        cells=_uncells(d.get("cells")),
    )
