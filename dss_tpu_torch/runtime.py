"""Process-level runtime hygiene shared by the server binaries."""

from __future__ import annotations

import gc
import logging

log = logging.getLogger("dss.runtime")


def freeze_boot_heap() -> int:
    """Park the boot-time heap outside GC scans and return the frozen
    object count.

    The objects alive once a binary finishes booting (store records
    replayed from the WAL, packed index arrays, compiled-code caches)
    dominate the process object count; every gen2 collection rescans
    them and stalls serving ~8 ms at the 1M-intent scale (measured:
    closed-loop serving 8.2k -> 9.5k qps with the scan removed).
    gc.freeze() moves them to the permanent generation: refcounting
    still frees dead ones, only CYCLES among frozen objects would
    leak, and the stores' records are acyclic (dicts/arrays/
    dataclasses) — the Instagram-style trade.

    Call AFTER boot work has finished (WAL replay, replica start,
    warmup compile): freezing mid-boot both pins boot transients
    forever and leaves the still-growing heap unfrozen.
    """
    gc.collect()
    gc.freeze()
    n = gc.get_freeze_count()
    log.info("gc: froze %d boot objects out of collection scans", n)
    return n
