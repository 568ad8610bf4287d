"""Repository interfaces — the storage seam.

Mirrors the seam in the reference where a new backend plugs in
(pkg/rid/repos/repo.go:6-18, pkg/scd/store/store.go:53-130).  Two
implementations ship:

  - MemoryStore (memory_store.py): pure-python linear scans, the analog
    of the reference's in-memory test fakes
    (pkg/rid/application/isa_test.go:29-77) — also the oracle in store
    contract tests.
  - DarStore (dar_store.py): host-authoritative dicts + write-ahead log
    + the device DarTable spatial index for every search (the
    storage="cuda" backend).

Concurrency model: the reference pushes races into CockroachDB
serializable transactions; here each store serializes logical
transactions through a re-entrant lock exposed as `transaction()`.
Handlers run their whole action inside it, which gives the same
read-your-writes + fencing behavior as the reference's
InTxnRetrier/PerformOperationWithRetries without needing retries.
"""

from __future__ import annotations

import abc
import contextlib
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np

from dss_tpu_torch.models import rid as ridm
from dss_tpu_torch.models import scd as scdm


class RIDStore(abc.ABC):
    """Storage for RID ISAs + subscriptions (pkg/rid/repos)."""

    @abc.abstractmethod
    def transaction(self) -> contextlib.AbstractContextManager:
        ...

    # ISAs
    @abc.abstractmethod
    def get_isa(self, id: str) -> Optional[ridm.IdentificationServiceArea]:
        ...

    @abc.abstractmethod
    def insert_isa(
        self, isa: ridm.IdentificationServiceArea
    ) -> Optional[ridm.IdentificationServiceArea]:
        """Insert (version empty) or fenced update (version set); returns
        None when the fencing predicate matches no row (stale version)."""

    @abc.abstractmethod
    def delete_isa(
        self, isa: ridm.IdentificationServiceArea
    ) -> Optional[ridm.IdentificationServiceArea]:
        """Fenced delete; None when no row matches id/owner/version."""

    @abc.abstractmethod
    def search_isas(
        self,
        cells: np.ndarray,
        earliest: datetime,
        latest: Optional[datetime],
    ) -> List[ridm.IdentificationServiceArea]:
        """ISAs intersecting cells with ends_at >= earliest and
        (starts_at <= latest or latest is None)."""

    # Subscriptions
    @abc.abstractmethod
    def get_subscription(self, id: str) -> Optional[ridm.Subscription]:
        ...

    @abc.abstractmethod
    def insert_subscription(
        self, sub: ridm.Subscription
    ) -> Optional[ridm.Subscription]:
        ...

    @abc.abstractmethod
    def delete_subscription(
        self, sub: ridm.Subscription
    ) -> Optional[ridm.Subscription]:
        ...

    @abc.abstractmethod
    def search_subscriptions(self, cells: np.ndarray) -> List[ridm.Subscription]:
        """Live (non-expired) subscriptions intersecting cells."""

    @abc.abstractmethod
    def search_subscriptions_by_owner(
        self, cells: np.ndarray, owner: str
    ) -> List[ridm.Subscription]:
        ...

    @abc.abstractmethod
    def max_subscription_count_in_cells_by_owner(
        self, cells: np.ndarray, owner: str
    ) -> int:
        """DSS0030: max per-cell count of the owner's live subscriptions."""

    @abc.abstractmethod
    def update_notification_idxs_in_cells(
        self, cells: np.ndarray, *, entity=None, removed: bool = False
    ) -> List[ridm.Subscription]:
        """Bump notification_index of all live subscriptions intersecting
        cells; return them post-bump.  `entity`/`removed` describe the
        triggering ISA for the push pipeline's fan-out (push/) — the
        bump + returned list are unchanged whether or not they are
        given."""


class SCDStore(abc.ABC):
    """Storage for SCD operations + subscriptions (pkg/scd/store)."""

    @abc.abstractmethod
    def transaction(self) -> contextlib.AbstractContextManager:
        ...

    # Operations
    @abc.abstractmethod
    def get_operation(self, id: str) -> Optional[scdm.Operation]:
        """By id, only while ends_at >= now (expired ops are invisible,
        operations.go:103-112)."""

    @abc.abstractmethod
    def upsert_operation(
        self, op: scdm.Operation, key: List[str], *, key_checked: bool = False
    ) -> Tuple[scdm.Operation, List[scdm.Subscription]]:
        """Fenced upsert with the OVN key check for Accepted/Activated
        states; returns (op, subscriptions-to-notify, post-bump).
        key_checked=True skips the OVN conflict search — only valid
        when validate_operation_upsert already ran inside the same
        transaction (the pinned txn timestamp keeps answers equal)."""

    @abc.abstractmethod
    def validate_operation_upsert(self, op: scdm.Operation, key: List[str]) -> None:
        """Read-only run of upsert_operation's preconditions (version
        fencing, ownership, time range, OVN key check).  Must be called
        inside the same transaction as the upsert so the answers agree;
        lets the service reject conflicts before journaling anything."""

    @abc.abstractmethod
    def delete_operation(
        self, id: str, owner: str
    ) -> Tuple[scdm.Operation, List[scdm.Subscription]]:
        ...

    @abc.abstractmethod
    def search_operations(
        self,
        cells: np.ndarray,
        alt_lo: Optional[float],
        alt_hi: Optional[float],
        earliest: Optional[datetime],
        latest: Optional[datetime],
    ) -> List[scdm.Operation]:
        ...

    # Subscriptions
    @abc.abstractmethod
    def get_subscription(self, id: str, owner: str) -> scdm.Subscription:
        ...

    @abc.abstractmethod
    def upsert_subscription(
        self, sub: scdm.Subscription
    ) -> Tuple[scdm.Subscription, List[scdm.Operation]]:
        ...

    @abc.abstractmethod
    def delete_subscription(
        self, id: str, owner: str, version: int
    ) -> scdm.Subscription:
        ...

    @abc.abstractmethod
    def search_subscriptions(
        self, cells: np.ndarray, owner: str
    ) -> List[scdm.Subscription]:
        ...

    # Constraints (beyond the reference: constraints_handler.go:12-30
    # stubs these; here they are a first-class fifth entity class)
    @abc.abstractmethod
    def get_constraint(self, id: str) -> scdm.Constraint:
        """By id, only while ends_at >= now (same visibility rule as
        operations)."""

    @abc.abstractmethod
    def upsert_constraint(
        self, cst: scdm.Constraint
    ) -> Tuple[scdm.Constraint, List[scdm.Subscription]]:
        """Fenced upsert (int32 version; 0 = insert).  Returns
        (constraint, notify_for_constraints subscriptions whose 4D
        volumes intersect the write, post-bump).  No OVN key check —
        constraints deconflict operations, not each other."""

    @abc.abstractmethod
    def delete_constraint(
        self, id: str, owner: str
    ) -> Tuple[scdm.Constraint, List[scdm.Subscription]]:
        ...

    @abc.abstractmethod
    def search_constraints(
        self,
        cells: np.ndarray,
        alt_lo: Optional[float],
        alt_hi: Optional[float],
        earliest: Optional[datetime],
        latest: Optional[datetime],
    ) -> List[scdm.Constraint]:
        ...
