#!/usr/bin/env python3
"""K1's and K2's device times for one copy of dss_tpu_torch, at the mesh
headline of chip_smoke.py, and with --variants the same for builds of
this checkout's K1 that each leave one design choice out.

    python3 mesh_device_time.py [--root DIR] [--variants]
                                [--variant NAME=CONST:VALUE,...]

DIR holds the `dss_tpu_torch` package to time (default: this checkout).
It loads chip_smoke.py's 1M records (before the main path's writes),
builds that copy's ShardedDar on a 1x1 mesh and on a virtual 2x4 mesh of
the card, and on dp row 0 of each times that copy's K1 (`mesh_query`)
on the smoke's first mesh batch (8,192 queries of 8 cells in a key
width of 16) and its K2 (`mesh_merge`) on K1's lists: the device time
of one call with the L2 flushed (`cold_ms`) and without (`warm_ms`),
by chip_smoke.device_ms; and the device time of one whole
`ShardedDar.query_batch`.  K1's and K2's answers are held against their
plain versions.  To hold one copy against another, unpack the other's
package where git does not look and run both in turns in one call on
the card:

    mkdir -p build/parent
    git archive <commit> dss_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 mesh_device_time.py --root "$r"; done

Then the shapes that launch K1 and K2 off the headline (`shapes`): the
skew leg's one query (chip_smoke.skew_pass) over its 3,120 records on a
virtual 1x8 mesh (max_results 256, shard_results 48; the hot area of
64 cells and a cold one of 24, open bounds, now 0), and a batch of 64
(MH_BATCH) searches, each the cells of a seeded record with open
bounds as the multihost leg's, over the http phase's 20,000
operational intents (HTTP_OPS, chip_smoke.store_columns seed 9: the
ops class of its 24,800 records) on a virtual 1x2 mesh (the server's
--sharded_replica) and 1x4 (the multihost leg's mesh).  For each, K1
and K2 on dp row 0 against their plain versions, their device time
cold and warm and their call time (chip_smoke.timings), their bounds
(chip_smoke.k1_bound, k2_bound, as the headline uses them) and the
share, and the device and call time of the whole query_batch.

With --variants (this checkout only) each variant of VARIANTS is
compiled from csrc/mesh_query.cu with one constant changed, into
build/mesh_variants/, and its library stands in for the package's while
K1 and K2 are timed, in turns: the package's build, each variant, then
the same in reverse; each --variant (repeatable) replaces that list,
e.g. `--variant u1=kUnroll:1,kMinBlocks:8`.  `nvcc -Xptxas -v` gives
each build's registers, shared memory and spills.  Prints one JSON
line; exits 1 without a card or when a kernel disagrees with its plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from b1_device_time import load_smoke

HERE = Path(__file__).resolve().parent
MESHES = ((1, 1), (2, 4))
# variant -> the constants of csrc/mesh_query.cu it changes: each leaves
# out, or changes, one choice of K1's design
VARIANTS = {
    "tile_2048": {"kTile": 2048, "kMinBlocks": 6},  # PR 14's 8 KB a warp
    "search_per_lane": {"kMaxGroup": 1},  # one lane a key, log2 steps
    "unroll_1": {"kUnroll": 1},  # one candidate a lane a round
    "unroll_4": {"kUnroll": 4},  # four
    "min_blocks_10": {"kMinBlocks": 10},  # 40 warps an SM, 48 registers
    "min_blocks_12": {"kMinBlocks": 12},  # 48 warps an SM, 40 registers
}


def variant_source(text: str, consts: dict) -> str:
    """csrc/mesh_query.cu with each named `constexpr int` changed."""
    for name, value in consts.items():
        pat = re.compile(rf"(constexpr int {name} = )[^;]+;")
        text, n = pat.subn(rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"constant {name} found {n} times")
    return text


def ptxas(cs, src: Path) -> dict:
    """nvcc -Xptxas -v of one source -> {kernel: its ptxas lines}."""
    out = subprocess.run(
        [cs.cuda_build._nvcc(), *cs.cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-c", "-o", "/dev/null", str(src)],
        capture_output=True, text=True, check=True).stderr
    info, kernel = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '\w*(mesh_\w+_kernel)",
                      line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("Used" in line or "spill" in line):
            info.setdefault(kernel, []).append(line.split("info    :")[-1]
                                               .strip())
    return info


def parse_variant(arg: str) -> tuple:
    """'NAME=CONST:VALUE,...' -> (name, {const: value})."""
    name, _, spec = arg.partition("=")
    consts = dict(item.split(":") for item in spec.split(","))
    return name, {k: int(v) for k, v in consts.items()}


def build_variants(cs, variants) -> dict:
    """{variant: library path}, compiled at once."""
    text = (cs.cuda_build.CSRC / "mesh_query.cu").read_text()
    root = HERE / "build" / "mesh_variants"
    jobs = {}
    for name, consts in variants.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "mesh_query.cu").write_text(variant_source(text, consts))
        jobs[name] = d
    nvcc = cs.cuda_build._nvcc()

    def one(d):
        lib = d / "libmesh.so"
        subprocess.run([nvcc, *cs.cuda_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), str(d / "mesh_query.cu")], check=True)
        return lib

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(zip(jobs, ex.map(one, jobs.values())))


def row_args(cs, dar, q):
    """K1's arguments for dp row 0 of `dar` on batch q, as the copy's
    sharded path builds them (its prebuilt rows where it has them)."""
    from dss_tpu_torch.ops import conflict as oc

    torch = cs.torch
    keys = cs.np.pad(q[0], ((0, 0), (0, 16 - q[0].shape[1])),
                     constant_values=-1)
    qloc = len(keys) // dar.dp
    (dev, shards), = dar.mesh.row_groups(0)
    spec = oc.query_spec(keys[:qloc], *(a[:qloc] for a in q[1:]), dev)
    args = (dar.post_key.rows(dev, shards), dar.post_ent.rows(dev, shards),
            None, None, oc._u8(dar.ents[dev]), spec,
            torch.full((qloc,), cs.NOW, dtype=torch.int64, device=dev),
            None)
    kw = {"cap": dar.cap, "delta_cap": 0, "max_results": dar.shard_results}
    if "rows" in inspect.signature(cs.mc.mesh_query).parameters:
        kw["rows"] = dar.rows[dev]
    return args, kw, {"shard_results": dar.shard_results,
                      "max_results": dar.max_results}


def measure(cs, dars, q, flush) -> tuple:
    """K1 and K2 on each mesh's dp row 0 -> ({mesh: times}, mismatches)."""
    mc, bad, out = cs.mc, 0, {}
    for name, dar in dars.items():
        args, kw, mkw = row_args(cs, dar, q)
        got = mc.mesh_query(*args, **kw)
        want = mc.mesh_query_torch(*args, **kw)
        merged = mc.mesh_merge(*got, **mkw)
        bad += sum(not cs.torch.equal(g, w) for g, w in zip(got, want))
        bad += sum(not cs.torch.equal(g, w) for g, w in
                   zip(merged, mc.mesh_merge_torch(*got, **mkw)))
        row = {}
        for kernel, fn in (("mesh_query", lambda: mc.mesh_query(*args, **kw)),
                           ("mesh_merge", lambda: mc.mesh_merge(*got, **mkw))):
            cold, _, cold_src = cs.device_ms(fn, flush)
            warm, _, warm_src = cs.device_ms(fn)
            row[kernel] = {"cold_ms": cold, "warm_ms": warm,
                           "ms_source": [cold_src, warm_src]}
        out[name] = row
    return out, bad


def shape_row(cs, dar, q, now, flush, label) -> tuple:
    """K1 and K2 on dp row 0 of `dar` for batch `q`, held against their
    plain versions, with their times beside their bounds, and the whole
    query_batch's device and call time.  -> (row, mismatches)."""
    mc = cs.mc
    bad0 = cs.MESH_TALLY.mismatches
    rows = cs.dar_kernel_checks(dar, q, label, now)
    _, _, args, kw = cs.dar_row_args(dar, q, 0, now)[0]
    cols, mkw = rows[0]
    b1 = cs.k1_bound(args[0].cpu().numpy(), args[1].cpu().numpy(),
                     args[5].keys.cpu().numpy(), dar.cap, dar.shard_results)
    width = int(mc.mesh_merge(*cols, **mkw)[3][-1])
    b2 = cs.k2_bound(cols[1].cpu().numpy(), dar.shard_results,
                     dar.max_results, width)
    out = {"queries": int(len(q[0])), "key_width": int(args[5].keys.shape[1]),
           "records": len(dar.records), "mesh": f"{dar.dp}x{dar.n_sp}",
           "cap": dar.cap, "shard_results": dar.shard_results,
           "max_results": dar.max_results}
    for name, fn, plain, b in (
            ("mesh_query", lambda: mc.mesh_query(*args, **kw),
             lambda: mc.mesh_query_torch(*args, **kw), b1),
            ("mesh_merge", lambda: mc.mesh_merge(*cols, **mkw),
             lambda: mc.mesh_merge_torch(*cols, **mkw), b2)):
        t = cs.timings(f"{name}_{label}", fn, plain, flush)
        out[name] = {**t, "bound_ms": b["ms"], "bound_bytes": b["bytes"],
                     "share_of_bound": b["ms"] / t["ms"]}
    out["mesh_query"]["candidates"] = b1["candidates"]
    out["mesh_merge"]["width"] = width

    def batch():
        return dar.query_batch(*q, now=now)

    out["batch_device_ms"] = cs.device_ms(batch, flush, n=10)[0]
    out["batch_call_ms"] = cs.call_ms(batch)
    return out, cs.MESH_TALLY.mismatches - bad0


def shapes(cs, dev, flush) -> tuple:
    """K1 and K2 at the skew leg's one query on 1x8 and at 64 searches
    over the http phase's operational intents on 1x2 and 1x4.
    -> ({shape: row}, mismatches)."""
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    np = cs.np
    out, bad = {}, 0
    recs, areas = cs.skew_fixture()
    dar = ps.ShardedDar(recs, make_mesh(8, dp=1, sp=8,
                                        devices=virtual_devices(dev, 8)),
                        max_results=256, shard_results=48)
    one = (np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32),
           np.full(1, -(2**62), np.int64), np.full(1, 2**62, np.int64))
    for label, area in (("skew_1x8_hot", areas[0]),
                        ("skew_1x8_cold", areas[1])):
        out[label], b = shape_row(cs, dar, (area[None, :], *one), 0, flush,
                                  label)
        bad += b
    del dar
    keys, alo, ahi, t0, t1 = cs.store_columns(cs.HTTP_OPS, seed=9,
                                              now=cs.NOW + cs.HOUR // 2)
    ops = [cs.Record(f"op{i}", keys[i], float(alo[i]), float(ahi[i]),
                     int(t0[i]), int(t1[i]), i % 8)
           for i in range(len(keys))]
    rng = np.random.default_rng(31)
    picks = rng.integers(0, len(ops), cs.MH_BATCH)
    b = cs.MH_BATCH
    q = (np.stack([ops[int(i)].keys for i in picks]).astype(np.int32),
         np.full(b, -np.inf, np.float32), np.full(b, np.inf, np.float32),
         np.full(b, cs.NO_TIME_LO, np.int64),
         np.full(b, cs.NO_TIME_HI, np.int64))
    for sp in (2, 4):
        dar = ps.ShardedDar(ops, make_mesh(sp, dp=1, sp=sp,
                                           devices=virtual_devices(dev, sp)),
                            max_results=cs.MESH_MAX_RESULTS)
        label = f"http_{b}_1x{sp}"
        out[label], bad_row = shape_row(cs, dar, q, cs.NOW, flush, label)
        bad += bad_row
        del dar
    return out, bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the dss_tpu_torch to time")
    ap.add_argument("--variants", action="store_true",
                    help="also time this checkout's K1 variants in turns")
    ap.add_argument("--variant", action="append", type=parse_variant,
                    help="a variant to time instead of VARIANTS")
    args = ap.parse_args()
    chosen = dict(args.variant) if args.variant else VARIANTS
    root = Path(args.root).resolve()
    cs = load_smoke(root)
    if not cs.torch.cuda.is_available():
        print("mesh_device_time: no CUDA card", file=sys.stderr)
        return 1
    if args.variants and root != HERE:
        print("mesh_device_time: --variants times this checkout only",
              file=sys.stderr)
        return 1
    from dss_tpu_torch.parallel import sharded as ps
    from dss_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = cs.torch.device("cuda")
    cs.cuda_build.build()
    variants = build_variants(cs, chosen) if args.variants else {}
    recs, _ = cs.make_records(cs.N_ENTITIES, cs.N_CELLS, cs.KPE)
    q = cs.make_batch(500, cs.BATCH, cs.N_CELLS, cs.WIDTH)
    dars = {f"{dp}x{sp}": ps.ShardedDar(
        recs, make_mesh(dp * sp, dp=dp, sp=sp,
                        devices=virtual_devices(dev, dp * sp)),
        max_results=cs.MESH_MAX_RESULTS) for dp, sp in MESHES}
    flush = cs.Flush(dev)
    rows, bad = measure(cs, dars, q, flush)
    shape_rows, bad_shapes = shapes(cs, dev, flush)
    bad += bad_shapes
    out = {"package": str(root / "dss_tpu_torch"), "kernels": rows,
           "shapes": shape_rows,
           "batch_device_ms": {
               name: cs.device_ms(lambda: dar.query_batch(*q, now=cs.NOW),
                                  flush, n=10)[0]
               for name, dar in dars.items()},
           "ptxas": ptxas(cs, cs.cuda_build.CSRC / "mesh_query.cu")}
    if hasattr(cs.mc, "occupancy"):
        out["occupancy"] = cs.mc.occupancy()
    if variants:
        package_lib = cs.cuda_build._lib
        order = ["package", *variants, *reversed(variants), "package"]
        turns, occupancy = {}, {}
        for name in order:
            cs.cuda_build._lib = (package_lib if name == "package"
                                  else ctypes.CDLL(str(variants[name])))
            got, b = measure(cs, dars, q, flush)
            bad += b
            turns.setdefault(name, []).append(got)
            occupancy[name] = cs.mc.occupancy()
        cs.cuda_build._lib = package_lib
        out["variants"] = {
            "order": order, "turns": turns, "occupancy": occupancy,
            "consts": chosen,
            "ptxas": {n: ptxas(cs, p.parent / "mesh_query.cu")
                      for n, p in variants.items()}}
    out["mismatches"] = bad
    out["card"] = smi
    print(json.dumps({"mesh_device_time": out}), flush=True)
    if bad:
        print(f"mesh_device_time: {bad} outputs differ from the plain "
              f"versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
