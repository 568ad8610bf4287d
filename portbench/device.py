"""What the benchmark reads of the card: its identity, the diagnostics
beside a window, and the device trace of a `--trace 1` run.

The trace is `torch.profiler` (CUPTI) over the measured window.  The
harness's own spans (`Spans`, on the host's `perf_counter`) are placed
on the profiler's clock through an anchor: a `record_function` entered
at a known `perf_counter` reading.  From the trace the benchmark takes
every device activity (kernels, copies, memsets): the union of their
intervals inside the window is `busy_s`; the rest of the window is idle,
and each idle gap is named by the harness span that covers most of it
(what the host was doing while the card waited).
"""

from __future__ import annotations

import os
import resource
import subprocess
import threading
import time
from collections import defaultdict

SMI_FIELDS = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def diagnostics(when: str) -> dict:
    """The host's load, this process's CPU seconds and the card's clocks
    and power at `when` (`before` or `after` the window): the noise of
    a shared host, told apart from the program's own."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"when": when, "loadavg": list(os.getloadavg()),
           "cpus": os.cpu_count(),
           "cpus_usable": len(os.sched_getaffinity(0)),
           "process_cpu_s": process_cpu_s(),
           "user_s": ru.ru_utime, "system_s": ru.ru_stime,
           "minor_faults": ru.ru_minflt, "major_faults": ru.ru_majflt,
           "yields": ru.ru_nvcsw, "preemptions": ru.ru_nivcsw,
           "on_cpu": _proc_field("/proc/thread-self/stat", 38),
           "host_steal_ticks": _proc_field("/proc/stat", 8, stat=True),
           "anon_huge_kb": _anon_huge_kb()}
    out.update(host_probe())
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        out["smi"] = smi.stdout.strip() or smi.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["smi"] = f"not read: {e!r}"
    return out


def _proc_field(path: str, k: int, stat: bool = False):
    """Field `k` (from 0) of a stat line under /proc: of this thread's
    (after the name in parentheses), or of the host's first cpu line."""
    try:
        text = open(path).readline()
        fields = text.split() if stat else text.rpartition(")")[2].split()
        return int(fields[k] if stat else fields[k - 2])
    except (OSError, ValueError, IndexError):
        return None


def _anon_huge_kb():
    """This process's anonymous memory in transparent huge pages, kB."""
    try:
        for line in open("/proc/self/smaps_rollup"):
            if line.startswith("AnonHugePages:"):
                return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


def host_probe() -> dict:
    """The host's pace outside the window, by two fixed loads: pure
    interpreter work (ALU and cache) and random reads over 256 MiB
    (memory latency), each in ms.  Diagnostics only."""
    import numpy as np

    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    alu = time.perf_counter() - t
    a = np.arange(1 << 25, dtype=np.int64)
    idx = np.random.default_rng(7).integers(0, 1 << 25, 1 << 22)
    t = time.perf_counter()
    a[idx].sum()
    mem = time.perf_counter() - t
    return {"probe_alu_ms": 1e3 * alu, "probe_mem_ms": 1e3 * mem}


def process_cpu_s() -> float:
    """This process's CPU seconds so far (user and system)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Spans:
    """The harness's spans: (name, start s, end s) on perf_counter, from
    any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def of(self, name: str) -> list:
        return [(a, b) for n, a, b in self.items if n == name]


def _union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """torch.profiler over one window; `summary()` once it has stopped.
    Times inside are ns on the profiler's clock."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._anchor = None
        self.t0 = self.t1 = None  # the window on perf_counter

    def start(self) -> None:
        from torch.profiler import record_function

        self._prof.start()
        for tag in ("portbench.anchor0", "portbench.anchor"):
            t = time.perf_counter_ns()
            with record_function(tag):
                pass
        self._anchor = t

    def open(self) -> None:
        self.t0 = time.perf_counter()

    def close(self) -> None:
        self.t1 = time.perf_counter()

    def stop(self) -> None:
        self._prof.stop()

    def summary(self, spans: Spans) -> dict:
        """-> busy_s, window_s, per device op name (launches, seconds),
        and the longest idle gaps named by the harness's spans."""
        from torch.autograd import DeviceType

        evs = self._prof.profiler.kineto_results.events()
        anchor = next(e.start_ns() for e in evs
                      if e.name() == "portbench.anchor")
        off = anchor - self._anchor  # perf_counter ns -> profiler ns
        w0 = int(self.t0 * 1e9) + off
        w1 = int(self.t1 * 1e9) + off
        ops = defaultdict(lambda: [0, 0.0])
        spans_dev = []
        for e in evs:
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b <= w0 or a >= w1:
                continue
            a, b = max(a, w0), min(b, w1)
            op = ops[e.name()]
            op[0] += 1
            op[1] += (b - a) / 1e9
            spans_dev.append((a, b))
        busy = _union(spans_dev)
        busy_ns = sum(b - a for a, b in busy)
        gaps, last = [], w0
        for a, b in busy + [[w1, w1]]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        host = [(n, int(a * 1e9) + off, int(b * 1e9) + off)
                for n, a, b in spans.items]
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            cover = defaultdict(int)
            for n, ha, hb in host:
                o = min(b, hb) - max(a, ha)
                if o > 0:
                    cover[n] += o
            name = max(cover, key=cover.get) if cover else "host"
            named.append([name, (b - a) / 1e9])
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "idle_gaps": named,
        }


def kernel_time(summary: dict, substring: str):
    """(launches, seconds) of the device ops whose name holds
    `substring`; (0, 0.0) when the trace holds none."""
    n, s = 0, 0.0
    for name, (k, sec) in summary["ops"].items():
        if substring in name:
            n += k
            s += sec
    return n, s
