"""gc_pause_share.bulk: % of the window the interpreter spent in
collections of its oldest generation, which walk every live object
(the program's host records among them) and stop the dispatcher; the
host clock, from the harness's `gc.callbacks`, installed for the
window only.  The harness keeps its sample of answers as strings and
NumPy arrays, which no collection walks."""


def read(run):
    return 100.0 * run.gc_s / run.window_s
