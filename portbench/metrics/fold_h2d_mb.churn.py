"""fold_h2d_mb.churn: MB (1e6 B) copied from the host to the card a
minor fold over the window: the delta of the program's counter
`replica_fold_h2d_bytes` (the built dars' nbytes) over the delta of
`replica_delta_refreshes`.  None where the program has no such
counter or the window folded nothing."""


def read(run):
    if "replica_fold_h2d_bytes" not in run.counters1:
        return None
    folds = run.counter_delta("replica_delta_refreshes")
    if folds <= 0:
        return None
    return run.counter_delta("replica_fold_h2d_bytes") / folds / 1e6
