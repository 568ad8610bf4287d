"""A kernel's share of its roofline over the traced window, in %: the
least time its batches' bytes take at the card's peak bandwidth
(portbench/bounds.py, peaks.json), over its device time per launch
from torch.profiler.  None where the trace holds no launch of it, or
the card is not in the table of peaks."""

from portbench import bounds, device, gen


def filter_bound(run, i: int) -> dict:
    """bounds.filter_bytes of pool batch i (computed once a run)."""
    cache = run.cache.setdefault("filter_bytes", {})
    if i not in cache:
        cache[i] = bounds.filter_bytes(run.ref, run.pool[i], gen.NOW)
    return cache[i]


def share(run, kernel: str, bound_bytes):
    """`bound_bytes(run, pool index)` -> the least bytes of one launch
    on that batch."""
    if run.trace is None or not run.batches:
        return None
    peak = bounds.peak_bytes_per_s(run.kind)
    n, seconds = device.kernel_time(run.trace, kernel)
    if not n or peak is None:
        return None
    least = sum(bound_bytes(run, i) for i in run.batches) / len(run.batches)
    return 100.0 * (least / peak) / (seconds / n)
