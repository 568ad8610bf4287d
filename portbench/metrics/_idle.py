"""The device's idle share of the traced window, in %: 100 x (1 - the
union of device activity over the window), from torch.profiler."""


def idle_share(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
