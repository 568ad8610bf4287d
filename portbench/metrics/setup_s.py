"""setup_s: seconds from the process's start to the window's, on the
host clock: the intents made, the program loaded, every kernel built
(the first run of a checkout compiles) and the mix's shapes warmed."""


def read(run):
    return run.setup_s
