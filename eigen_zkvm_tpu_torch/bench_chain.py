"""Chain-AIR prove benchmark of the port on one CUDA device.

Port of scripts/bench_big.py: the repo's benchmark AIR (`build_chain_air`:
W columns of multiplicative chains over 2^nbits rows, pinned by public
inputs), blowup 2, GL hash, and that script's FRI steps.

    python -m eigen_zkvm_tpu_torch.bench_chain --nbits 20 --width 8 \\
        --runs 3 --trace prove_trace.json

The kernels build first and setup runs once.  Each run proves with
Engine(cuda), device-resident; every proof's JSON must be byte-identical
and the first must verify.  EIGEN_ZKVM_SYNC=1 drains the device at every
stage tick.  (The same-call comparison with eigen_zkvm_tpu's host engine is
tests/test_torch_prove.py::test_port_on_the_card_matches_host_engine_at_smoke_size.)

With --trace, one more prove runs under torch.profiler and its Chrome
trace is written to the path given.  Device time is the sum over the
trace's device-side events (kernels, memcpy, memset), by name; the busy
share is that sum over the profiled prove's wall.  The sum of
`key_averages()`'s self_device_time_total is printed beside it: that
reading counts each copy twice (on the memcpy and on the CPU op that issued
it, `aten::copy_`) and includes the profiler's own buffer requests.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

# device-side rows of a trace that are the profiler's own work
_PROFILER_ROWS = ("Activity Buffer Request",)


def build_chain_air(nbits: int, width: int):
    """(pil, const_pols, cm_pols) of scripts/bench_big.py::build_chain_air:
    W commit pols with c_j' = k_j * c_j off the last row (k_j = j + 2),
    pinned by public inputs c_j(N - 1)."""
    from .ops import gl
    from .stark.pil_builder import PilBuilder
    from .stark.polsarray import PolsArray

    p = PilBuilder(nbits)
    islast = p.const_pol("Chain.ISLAST")
    cols = [p.cm_pol(f"Chain.c{j}") for j in range(width)]
    N = 1 << nbits

    one_m = p.sub(p.num(1), p.const(islast))
    for j, c in enumerate(cols):
        end = p.public_input(f"end{j}", p.cm(c), N - 1)
        p.identity(p.sub(p.mul(one_m,
                               p.sub(p.cm(c, True),
                                     p.mul(p.num(j + 2), p.cm(c)))),
                         p.num(0)), "chain.pil", j)
        p.identity(p.sub(p.mul(p.const(islast), p.sub(p.cm(c), end)),
                         p.num(0)), "chain.pil", width + j)
    pil = p.build()

    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    const_pols.buffer[N - 1, islast] = 1

    cm = PolsArray(pil, PolsArray.COMMIT)
    for j, c in enumerate(cols):
        cm.buffer[:, c] = gl.to_u64(gl.powers(j + 2, N))  # k^0 .. k^(N-1)
    return pil, const_pols, cm


def pil_to_json(pil) -> dict:
    """The PIL JSON that stark/types.py::load_pil reads: the writer of
    eigen_zkvm_tpu/cli.py (`_pil_to_json`), which leaves the plookup and
    permutation identities out, with them written too."""
    def expr(e):
        d = {"op": e.op, "deg": e.deg}
        if e.id is not None:
            d["id"] = e.id
        if e.next is not None:
            d["next"] = bool(e.next)
        if e.value is not None:
            d["value"] = e.value
        if e.values is not None:
            d["values"] = [expr(v) for v in e.values]
        if e.idQ is not None:
            d["idQ"] = e.idQ
        if e.keep is not None:
            d["keep"] = e.keep
        return d

    def lookup(p):
        return {"f": p.f, "t": p.t, "selF": p.selF, "selT": p.selT,
                "fileName": p.fileName, "line": p.line}

    refs = {}
    for k, v in pil.references.items():
        r = {"type": v.type_, "id": v.id, "polDeg": v.polDeg,
             "isArray": v.isArray}
        if v.isArray:
            r["len"] = v.len
        refs[k] = r
    return {
        "nCommitments": pil.nCommitments, "nQ": pil.nQ, "nIm": pil.nIm,
        "nConstants": pil.nConstants,
        "publics": [{"polType": p.polType, "polId": p.polId, "idx": p.idx,
                     "id": p.id, "name": p.name} for p in pil.publics],
        "references": refs,
        "expressions": [expr(e) for e in pil.expressions],
        "polIdentities": [{"e": p.e, "fileName": p.fileName, "line": p.line}
                          for p in pil.polIdentities],
        "plookupIdentities": [lookup(p) for p in pil.plookupIdentities],
        "permutationIdentities": [lookup(p)
                                  for p in pil.permutationIdentities],
        "connectionIdentities": [
            {"pols": c.pols, "connections": c.connections,
             "fileName": c.fileName, "line": c.line}
            for c in pil.connectionIdentities],
    }


def chain_struct_json(nbits: int, queries: int) -> dict:
    """The starkStruct of scripts/bench_big.py: blowup 2, FRI steps from
    nbits + 1 down by 5 while above 4."""
    steps, cur = [], nbits + 1
    while cur > 4:
        steps.append(cur)
        cur -= 5
    steps.append(cur)
    return {"nBits": nbits, "nBitsExt": nbits + 1, "nQueries": queries,
            "verificationHashType": "GL",
            "steps": [{"nBits": s} for s in steps]}


def chain_struct(nbits: int, queries: int):
    from .stark.types import StarkStruct

    return StarkStruct.from_json(chain_struct_json(nbits, queries))


def write_chain_files(directory: str, nbits: int, width: int,
                      queries: int) -> dict:
    """The chain AIR as the files stark/prove.py::stark_prove reads:
    {"stark_struct", "pil", "const", "cm"} -> path."""
    pil, const_pols, cm_pols = build_chain_air(nbits, width)
    files = {k: os.path.join(directory, f"chain.{k}")
             for k in ("stark_struct", "pil", "const", "cm")}
    with open(files["stark_struct"], "w") as f:
        json.dump(chain_struct_json(nbits, queries), f)
    with open(files["pil"], "w") as f:
        json.dump(pil_to_json(pil), f)
    const_pols.save(files["const"])
    cm_pols.save(files["cm"])
    return files


def device_time(prof) -> dict:
    """Device time of a finished torch.profiler run, in ms (see the module
    docstring for what is counted)."""
    from torch.autograd import DeviceType

    rows: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = rows.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    work = {k: v for k, v in rows.items() if k not in _PROFILER_ROWS}
    return {"device_ms": sum(ms for ms, _ in work.values()),
            "rows": sorted(([k, ms, n] for k, (ms, n) in work.items()),
                           key=lambda r: -r[1]),
            "profiler_rows": {k: v for k, v in rows.items()
                              if k in _PROFILER_ROWS},
            "key_averages_ms": sum(a.self_device_time_total
                                   for a in prof.key_averages()) / 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nbits", type=int, default=20)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace", metavar="PATH",
                    help="profile one more prove; Chrome trace to PATH")
    args = ap.parse_args(argv)

    import torch

    from . import kernels
    from .stark.engine import Engine
    from .stark.serializer import stark_proof_to_json
    from .stark.stark_gen import stark_gen
    from .stark.stark_setup import StarkSetup
    from .stark.stark_verify import stark_verify
    from .utils.devices import card_line, cuda_device
    from .utils.profiler import Prof

    dev = cuda_device(0)
    report = {"card": card_line(), "nbits": args.nbits, "width": args.width,
              "queries": args.queries}
    print(f"card: {report['card']}", flush=True)
    report["build_s"] = kernels.build()["seconds"]
    kernels.library()

    pil, const_pols, cm_pols = build_chain_air(args.nbits, args.width)
    ss = chain_struct(args.nbits, args.queries)
    engine = Engine(dev)
    torch.cuda.init()  # the allocator's stats exist only after CUDA's init
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup = StarkSetup(const_pols, pil, ss, engine)
    torch.cuda.synchronize(dev)
    report["setup_s"] = time.perf_counter() - t0

    def prove(prof=None):
        prof = prof or Prof("stark_gen", dev, on=True)
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = stark_gen(cm_pols, const_pols, setup.const_tree,
                          setup.starkinfo, setup.program, ss, engine=engine,
                          prof=prof)
        torch.cuda.synchronize(dev)
        return proof, time.perf_counter() - t0, prof.stages

    runs, jsons = [], set()
    for i in range(args.runs):
        proof, wall, stages = prove()
        if not runs:
            report["verified"] = bool(stark_verify(
                proof, setup.const_root, setup.starkinfo, ss, setup.program))
        jsons.add(stark_proof_to_json(proof, "GL"))
        runs.append({"run": i, "prove_s": wall, "stages": stages,
                     "launches": kernels.counts()})
        print(f"prove {i}: {wall:.3f} s "
              + " ".join(f"{k}={v:.3f}" for k, v in stages)
              + f" launches {kernels.counts()}", flush=True)
    report["runs"] = runs
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["identical"] = len(jsons) == 1
    report["proof_sha256"] = sorted(hashlib.sha256(t.encode()).hexdigest()
                                    for t in jsons)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            _, wall, _ = prove()
        tp.export_chrome_trace(args.trace)
        dt = device_time(tp)
        dt["wall_ms"] = wall * 1e3
        dt["busy_share"] = dt["device_ms"] / dt["wall_ms"]
        report["trace"] = dt
        print(f"profiled prove: wall {dt['wall_ms']:.3f} ms, device events "
              f"{dt['device_ms']:.3f} ms (busy share {dt['busy_share']:.4f}),"
              f" key_averages self device time {dt['key_averages_ms']:.3f} "
              f"ms, profiler rows {dt['profiler_rows']}")
        for name, ms, n in dt["rows"][:12]:
            print(f"  {ms:10.3f} ms {n:6d}  {name[:70]}")

    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(f"peak device memory {report['peak_bytes'] / 2**30:.3f} GiB; "
          f"proofs identical {report['identical']}; verified "
          f"{report['verified']}; JAX-package modules loaded "
          f"{report['foreign_modules']}")
    print(json.dumps(report), flush=True)
    ok = report["identical"] and report["verified"] \
        and not report["foreign_modules"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
