"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Everything that belongs to one
configuration, traffic mix or metric is found by name.  The cell's
entry in BENCHMARK.json names its configuration file
(`portbench/configs/<config>.json`), which names its data `recipe`
(`portbench/recipes/<recipe>.py`), its `entry`
(`portbench/entries/<entry>.py`, which builds the system under test)
and its `reference` (`portbench/reference/<reference>.py`, the plain
answers and the limits of the check); and its traffic mix
(`portbench/traffic/<traffic>.json`), which names its `driver`
(`portbench/drivers/<driver>.py`).  A run draws the data from the
seed, builds the entry and hands both to the driver, which warms the
mix's shapes and measures for `--seconds`.  Once the window has closed
the program is freed and the reference judges a seeded sample of the
window's answers.  Each metric of the cell is read by its own reader,
`portbench/metrics/<name>.py`: with `--trace 0` the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics.  The window is traced
by torch.profiler with `--trace 1`, and with `--trace 0` where an
end-to-end metric of the cell is read from the device trace.

The last line of standard output is the result object; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.  Without the CUDA cards the cell asks for,
the run prints no result and exits 2; with jax, jaxlib, flax or the
JAX package loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


from portbench import check, device  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dss_tpu")


def pin_environment(root: Path = ROOT) -> None:
    """Every cache at a fixed path inside the checkout, and no DSS_*
    knob from the caller's environment: the configuration file states
    the system's settings.  The port's own build directories
    (build/torch_kernels, build/native) already sit in the checkout."""
    for k in [k for k in os.environ if k.startswith("DSS_")]:
        del os.environ[k]
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, its
    traffic and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def reader(name: str):
    """The `read(run)` of `portbench/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run's state: what the driver leaves for the readers and the
    check."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 dev: str):
        self.cell = cell
        self.cfg = cell["config"]
        self.data = self.cfg["data"]  # the recipe's parameters
        self.recipe = importlib.import_module(
            f"portbench.recipes.{self.cfg['recipe']}")
        self.traffic = cell["traffic"]
        self.seed = seed
        self.seconds = float(seconds)
        self.cuda = dev.startswith("cuda")
        self.entry = None
        self.entry_span = None
        self.spans = device.Spans()
        self.traced = trace  # --trace 1: the per-layer metrics
        self.tracer = device.Trace(self.cuda) if trace or any(
            m["source"] == "device_trace" for m in cell["end_to_end"]) \
            else None
        self.trace = None  # the tracer's summary once the window closed
        self.attempted = self.answered = self.failed = 0
        self.kept = []  # what the driver kept of the window's answers
        self.batches = []  # pool index of each batch of the window
        self.pool = None
        self.ref = None  # the reference, once the window has closed
        self.cache = {}  # the readers' own
        self.kind = "cpu"  # the card's name, once the window has closed
        self.setup_s = self.t_open = self.t_close = None
        self.counters0 = self.counters1 = {}
        self.gc_s = 0.0  # seconds in full collections inside the window
        self._gc_at = None
        self.diag = []

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def sync(self) -> None:
        """Wait for the card (set-up's warm-up)."""
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def open(self) -> float:
        """The window starts now; -> the time it is due to end."""
        self.diag.append(device.diagnostics("before"))
        self.counters0 = self.entry.counters()
        if self.tracer is not None:
            self.tracer.start()
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - _T0
        if self.tracer is not None:
            self.tracer.open()
        gc.callbacks.append(self._on_gc)
        return self.t_open + self.seconds

    def _on_gc(self, phase: str, info: dict) -> None:
        """The interpreter's collections of its oldest generation (they
        walk every live object, the program's host records too; the
        harness keeps nothing in the window that they walk): a span
        `gc` each, and their seconds."""
        if info["generation"] != 2:
            return
        t = time.perf_counter()
        if phase == "start":
            self._gc_at = t
        elif self._gc_at is not None:
            self.gc_s += t - self._gc_at
            self.spans.add("gc", self._gc_at, t)
            self._gc_at = None

    def close(self) -> None:
        """The window's last request has returned (its answers are on
        the host)."""
        self.t_close = time.perf_counter()
        gc.callbacks.remove(self._on_gc)
        if self.tracer is not None:
            self.tracer.close()
            self.tracer.stop()
        self.counters1 = self.entry.counters()
        self.diag.append(device.diagnostics("after"))

    def counter_delta(self, key: str) -> int:
        return self.counters1.get(key, 0) - self.counters0.get(key, 0)


def call_ms_by_part(run, parts: int = 3) -> list:
    """The median ms of the driver's timed call in each of `parts`
    equal parts of the window: whether the host's pace drifted inside
    the run."""
    spans = run.spans.of(run.entry_span)
    if not spans:
        return []
    edges = [run.t_open + k * run.window_s / parts for k in range(1, parts)]
    out = [[] for _ in range(parts)]
    for a, b in spans:
        out[sum(a >= e for e in edges)].append(1e3 * (b - a))
    return [statistics.median(t) if t else None for t in out]


def device_info(run: Run, chips: int, memory_peak: int) -> dict:
    out = {"platform": "gpu" if run.cuda else "cpu", "kind": run.kind,
           "count": chips, "memory_peak_bytes": memory_peak}
    if run.traced:
        out["busy_s"] = run.trace["busy_s"]
        out["window_s"] = run.trace["window_s"]
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             dev: str = "cuda", root: Path = ROOT, overrides=None) -> tuple:
    """Run the cell -> (result object, the run's account for an earlier
    line, the check's lines for standard error).
    `overrides` ({"data": {...}, "traffic": {...}}) shrinks a cell for
    the CPU tests."""
    cell = load_cell(name, root)
    cell["config"]["data"].update((overrides or {}).get("data", {}))
    cell["traffic"].update((overrides or {}).get("traffic", {}))
    run = Run(cell, seed, seconds, trace, dev)
    cfg = cell["config"]
    data = run.recipe.intents(cfg["data"], seed)
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    run.entry = entry.Entry(cfg, data, dev)
    run.entry_span = run.entry.span
    importlib.import_module(
        f"portbench.drivers.{cell['traffic']['driver']}").drive(run)

    memory_peak = 0
    if run.cuda:
        import torch

        memory_peak = int(torch.cuda.max_memory_allocated())
        run.kind = torch.cuda.get_device_name(0)
    if run.tracer is not None:
        run.trace = run.tracer.summary(run.spans)
        run.tracer = None
    run.entry.close()
    run.entry = None
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    compared, readings = ref.judge(run, data)
    correct, chk, lines = check.verdict(readings, ref.LIMITS, compared)
    check_s = time.perf_counter() - t

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run, cell["workload"]["chips"],
                                    memory_peak)}
    if run.traced:
        ops = sorted(run.trace["ops"].items(), key=lambda kv: -kv[1][1])
        result["breakdown"] = {
            "device_ops": [[n, s] for n, (_, s) in ops[:10]],
            "idle_gaps": run.trace["idle_gaps"],
        }
    result["check"] = chk
    info = {
        "workload": name, "seed": seed, "trace": int(trace),
        "setup_s": run.setup_s, "window_s": run.window_s,
        "attempted": run.attempted, "answered": run.answered,
        "failed": run.failed, "batches": len(run.batches),
        "check_s": check_s, "compared": compared, "gc_s": run.gc_s,
        "counters": {k: run.counter_delta(k) for k in run.counters1},
        "process_cpu_share": (run.diag[1]["process_cpu_s"]
                              - run.diag[0]["process_cpu_s"]) / run.window_s,
        "call_ms_by_third": call_ms_by_part(run),
        "call_ms_by_tenth": call_ms_by_part(run, 10),
        "diag": run.diag,
    }
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["trace_ops"] = {n: list(v) for n, v in run.trace["ops"].items()}
    return result, info, lines


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    import torch

    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, info, lines = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the measuring "
              "process; no result", file=sys.stderr)
        return 3
    print(json.dumps({"portbench": info}), flush=True)
    for d in info["diag"]:
        print(f"diag {json.dumps(d)}", file=sys.stderr)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
