"""The control of the check that decides `correct`, at a cell's own size:
the program with one guarantee of the configuration broken, judged as a
run judges the program's proofs.  The configuration states nQueries FRI
queries; the control proves with one fewer (less query work, a weaker
proof), the step a later change could be tempted by.  Beside it the sound
program's proof of the same trace is judged too.  The benchmark's own runs
never run it.

    python -m portbench.control --workload chain_gl_2e23x8.serial \
        --seeds 11 12 13

One JSON line a seed: the numbers the check compares for the sound proof
and for the control's, each of the trace a run's first window proof
takes (ring entry 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import time

import torch

from . import port, run
from .reference import verify as ref
from .reference.layout import Layout


def control_circuit(c):
    """The circuit with one FRI query fewer than it states."""
    struct = dict(c.struct_json, nQueries=c.struct_json["nQueries"] - 1)
    return dataclasses.replace(c, struct_json=struct)


def judge(c, lay, const_root, root1, js, trace) -> dict:
    bad = ref.verify(js, lay, c.struct_json, const_root,
                     ref.publics_of(c.pil_json, trace))
    if [int(x) for x in json.loads(js)["root1"]] != root1:
        bad.append("root1 is not the root of the proof's trace")
    return {"wrong_proofs": int(bool(bad)), "rejected_by": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_benchmark()
    cell = run.cell_of(bench, args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.control: no CUDA device")
    dev = torch.device("cuda", 0)
    port.build_kernels(dev)
    cfg = importlib.import_module(f"portbench.configs.{cell['config']}")
    c = cfg.circuit()
    s = c.struct_json
    lay = Layout.of(c.pil_json, s)
    ring = run.traffic_of(cell)["ring"]
    sound, weak = port.Prover(c, dev), port.Prover(control_circuit(c), dev)
    const_root = ref.commit_root(c.const, s["nBits"], s["nBitsExt"], dev)
    for seed in args.seeds:
        buf = cfg.traces(c, seed % 2**63, ring, dev)[1]
        t0 = time.perf_counter()
        got = sound.prove(sound.trace(buf))
        t1 = time.perf_counter()
        ctl = weak.prove(weak.trace(buf))
        t2 = time.perf_counter()
        root1 = ref.commit_root(buf, s["nBits"], s["nBitsExt"], dev)
        t3 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": judge(c, lay, const_root, root1, got,
                                           buf),
                          "control": judge(c, lay, const_root, root1, ctl,
                                           buf),
                          "prove_s": t1 - t0, "control_s": t2 - t1,
                          "root1_s": t3 - t2,
                          "judge_s": time.perf_counter() - t3}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
