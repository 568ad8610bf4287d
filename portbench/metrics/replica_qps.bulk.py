"""replica_qps.bulk: searches answered over the whole window, on the
host clock (the window closes when its last call has returned): the
host-paced rate of the replica's route, in queries/s."""


def read(run):
    return run.answered / run.window_s
