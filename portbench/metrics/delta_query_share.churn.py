"""delta_query_share.churn: % of the `query_batch` calls' time inside
the program's spans tagged `tier=delta` (the delta tier's mesh.pad,
mesh.launch, mesh.wait, mesh.decode and replica.ids, which lie flat
and apart), from a traced window (portbench/metrics/_program.py)."""

from portbench.metrics._program import of


def read(run):
    spans = [s for s in getattr(run, "program_spans", ())
             if "tier" in s.attrs]
    calls = [(max(a, run.t_open), min(b, run.t_close))
             for a, b in run.spans.of(run.entry_span)]
    total = sum(b - a for a, b in calls if b > a)
    if not spans or total <= 0:
        return None
    delta = sum(b - a for name in {s.name for s in spans}
                for a, b in of(run, name, tier="delta"))
    return 100.0 * delta / total
