"""Readers of the harness's own spans (host clock, in ms)."""

import math

import numpy as np


def p95_ms(run, name):
    d = np.sort([b - a for a, b in run.spans.of(name)])
    return None if not len(d) else 1e3 * float(d[math.ceil(0.95 * len(d)) - 1])
