"""Readers of the program's own spans that a traced window collected
with their attributes (`run.program_spans`, `portbench/drivers/churn.py`),
on the harness's clock.  None where the run holds no span of the name:
a program without it, or a window not traced."""


def of(run, name: str, **attrs) -> list:
    """(start s, end s) of the spans `name` whose attributes hold
    `attrs`, clipped to the window; None where the run collected no
    span `name` at all."""
    got = [s for s in getattr(run, "program_spans", ()) if s.name == name]
    if not got:
        return None
    return [(max(s.start, run.t_open), min(s.end, run.t_close))
            for s in got
            if all(s.attrs.get(k) == v for k, v in attrs.items())
            and min(s.end, run.t_close) > max(s.start, run.t_open)]


def share(run, name: str):
    """% of the window inside the spans `name` (the program's folds and
    polls do not nest in themselves, so their lengths add)."""
    spans = of(run, name)
    if spans is None:
        return None
    return 100.0 * sum(b - a for a, b in spans) / run.window_s
