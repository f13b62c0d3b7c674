"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python -m portbench --workload chain_gl_2e23x8.serial --seed 17 \
        --seconds 51 --trace 0

A run sets up (imports, the port's kernel library, the configuration's
circuit and a ring of host traces from the seed, the const tree and the
starkinfo compile, one warm-up proof), then proves back to back for
`--seconds` (the window closes at the end of the first proof that ends
after them), then judges the proofs by the plain reference (reference/),
and prints one JSON line.  With `--trace 1` the window runs
under torch.profiler with EIGEN_ZKVM_SYNC=1 and the line carries the
per-layer metrics instead of the end-to-end ones.

Everything a cell names is found by name: the configuration in
configs/<config>.py, the traffic mix in traffic/<traffic>.json, each
metric's reader in metrics/<metric>.py.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded when the result prints
FOREIGN = ("jax", "jaxlib", "flax", "eigen_zkvm_tpu")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, trace: bool) -> list:
    """The metrics a run of this kind reports."""
    return bench["per_layer" if trace else "end_to_end"]


def traffic_of(cell: dict) -> dict:
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        return json.load(f)


def foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def window(prover, ring, seconds: float, traced: bool, device):
    """Prove back to back until `seconds` have passed, each proof on the
    next ring entry (ring[0] was the warm-up's).  Returns the proofs
    [(slot, json or None)], each proof's ticks and wall, and the window's
    bounds (perf_counter seconds and wall-clock ns)."""
    import torch

    from .port import TickProf

    proofs, ticks, walls = [], [], []
    t_open, ns_open = time.perf_counter(), time.time_ns()
    while True:
        t = time.perf_counter()
        slot = (len(proofs) + 1) % len(ring)
        prof = TickProf(device) if traced else None
        try:
            js = prover.prove(ring[slot], prof)
        except Exception:  # a failed proof counts against the run
            traceback.print_exc()
            js = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        proofs.append((slot, js))
        walls.append(time.perf_counter() - t)
        if prof is not None:
            ticks.append((prof.stages, prof.start_ns, prof.ends_ns))
        if time.perf_counter() - t_open >= seconds:
            break
    return proofs, ticks, walls, (t_open, time.perf_counter(), ns_open,
                                  time.time_ns())


def check(c, lay, bufs, proofs, seed: int, slots: int, device) -> dict:
    """Judge the window's proofs by the reference (reference/): every
    completed proof verified against the constants' root the reference
    commits itself and the publics of its trace, its stage-1 openings held
    to the reference's extension of that trace, and every proof of `slots`
    ring entries (drawn from the seed among those proved) held to the root
    the reference commits that trace to."""
    from .reference import verify as ref

    s = c.struct_json
    nb, ne = s["nBits"], s["nBitsExt"]
    const_root = ref.commit_root(c.const, nb, ne, device)
    proved = sorted({slot for slot, js in proofs if js is not None})
    rng = np.random.default_rng([seed % 2**63, 1])
    chosen = {int(k) for k in rng.choice(proved, size=min(slots, len(proved)),
                                         replace=False)}
    wrong = checked = bound = 0
    for slot in proved:
        ext = ref.extension(bufs[slot], nb, ne, device)
        root1 = ref.merkle.root(ext) if slot in chosen else None
        for i, (k, js) in enumerate(proofs):
            if k != slot or js is None:
                continue
            checked += 1
            bad = ref.verify(js, lay, s, const_root,
                             ref.publics_of(c.pil_json, bufs[slot]),
                             ref.rows_of(ext))
            if root1 is not None:
                bound += 1
                if [int(x) for x in json.loads(js)["root1"]] != root1:
                    bad.append("root1 is not the root of the proof's trace")
            if bad:
                wrong += 1
                print(f"portbench: window proof {i} (ring entry {slot}) "
                      f"rejected: {'; '.join(bad)}", file=sys.stderr)
        del ext
    failed = sum(js is None for _, js in proofs)
    return {"failed_proofs": {"value": failed, "limit": 0},
            "wrong_proofs": {"value": wrong, "limit": 0},
            "checked_proofs": {"value": checked, "at_least": 1},
            "bound_proofs": {"value": bound, "at_least": 1}}


def passed(checks: dict) -> bool:
    return all(v["value"] <= v["limit"] if "limit" in v
               else v["value"] >= v["at_least"] for v in checks.values())


def run(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
        device, t0: float, nbits: int | None = None) -> dict:
    """One run of `cell` on `device`; `nbits` overrides the
    configuration's rows (the CPU tests' small sizes)."""
    import torch

    from . import port
    from .record import Run, Shapes
    from .reference.layout import Layout
    from .trace import Window, device_events

    cuda = device.type == "cuda"
    diag = {"imports_s": time.perf_counter() - t0}

    def lap(key: str, t: float) -> float:
        if cuda:
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        diag[key] = now - t
        return now

    cfg = importlib.import_module(f"portbench.configs.{cell['config']}")
    mix = traffic_of(cell)
    t = time.perf_counter()
    built = port.build_kernels(device)
    t = lap("kernels_s", t)
    c = cfg.circuit() if nbits is None else cfg.circuit(nbits)
    bufs = cfg.traces(c, seed % 2**63, mix["ring"], device)
    lay = Layout.of(c.pil_json, c.struct_json)
    t = lap("inputs_s", t)
    prover = port.Prover(c, device)
    ring = [prover.trace(b) for b in bufs]
    t = lap("const_tree_and_starkinfo_s", t)
    prover.prove(ring[0])
    t = lap("warmup_proof_s", t)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    profiler = contextlib.nullcontext()
    if traced and cuda:
        from torch.profiler import ProfilerActivity, profile

        os.environ["EIGEN_ZKVM_SYNC"] = "1"  # stage ticks drain the device
        profiler = profile(activities=[ProfilerActivity.CUDA])
    with profiler as tp:
        proofs, ticks, walls, (t_open, t_close, ns_open, ns_close) = window(
            prover, ring, seconds, traced, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    win = None
    t = time.perf_counter()
    if tp is not None:
        win = Window(ns_open, ns_close, device_events(tp))
        for stages, start, ends in ticks:
            bounds = [start] + ends
            win.stages += [(name, bounds[i], bounds[i + 1])
                           for i, (name, _) in enumerate(stages)]
        del tp
    prover.close()
    del prover, ring
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = lap("trace_read_and_free_s", t)
    checks = check(c, lay, bufs, proofs, seed, mix["check_slots"], device)
    t = lap("reference_check_s", t)
    done = sum(js is not None for _, js in proofs)
    rec = Run(setup_s, t_close - t_open, done, peak,
              Shapes.of(lay, c.struct_json),
              [stages for stages, _, _ in ticks], win)
    metrics = {}
    for m in metrics_of(bench, traced):
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": passed(checks), "attempted": len(proofs),
           "failed": checks["failed_proofs"]["value"]
           + checks["wrong_proofs"]["value"],
           "metrics": metrics, "device": dev}
    if rec.window is not None:
        dev["busy_s"] = rec.window.busy_seconds()
        dev["window_s"] = rec.window.seconds
        out["breakdown"] = {"device_ops": rec.window.top_ops(),
                            "idle_gaps": rec.window.idle_by_stage()}
    # a run that compiled the kernels has its set-up recorded apart here
    out["setup"] = {"compiled": built, "kernels_s": diag["kernels_s"]}
    out["checks"] = checks
    diag["metrics_s"] = time.perf_counter() - t
    diag["proof_walls_s"] = {"n": len(walls), "min": min(walls),
                             "median": float(np.median(walls)),
                             "max": max(walls)}
    print(f"portbench: {json.dumps(diag)}", file=sys.stderr)
    return out


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="the port's benchmark: one run "
                                 "of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell = cell_of(bench, args.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    res = run(bench, cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t0)
    foreign = foreign_modules()
    if foreign:
        print(f"portbench: JAX-package modules loaded: {foreign}",
              file=sys.stderr)
        return 3
    for name, v in res["checks"].items():
        bound = (f"<= {v['limit']}" if "limit" in v
                 else f">= {v['at_least']}")
        print(f"check {name}: {v['value']} (limit {bound})",
              file=sys.stderr)
    print(f"check correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0
