"""card_us_per_search: the card's time a search costs, in us: the union
of device activity over the window, from torch.profiler, over the
searches answered in it.  None where the trace holds no device
activity (no card)."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0 or not run.answered:
        return None
    return 1e6 * t["busy_s"] / run.answered
