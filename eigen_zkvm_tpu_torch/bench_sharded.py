"""Sharded chain-AIR prove benchmark: one rank, four ranks on one card over
gloo, and one rank a card over NCCL.

    python -m eigen_zkvm_tpu_torch.bench_sharded --nbits 20 23 --runs 2

For each size the chain AIR of bench_chain (8 columns, blowup 2, 8
queries, its FRI steps) is written to files, and each configuration
spawns its ranks (parallel/launch.py), which load the files, build the
setup on their device and prove `--runs` times:
  one    one rank, the single-device `stark_gen` (no mesh);
  gloo   `--ranks` ranks sharing card 0, `sharded_prove` over gloo (every
         collective staged through host buffers);
  nccl   one rank a card over NCCL, when the host has `--ranks` cards.
Each configuration prints the last prove's wall and its stage walls (rank
0's, `EIGEN_ZKVM_SYNC=1`: each stage drained), the collectives' calls,
seconds and bytes by kind (rank 0's, and the bytes of all ranks), each
rank's peak device memory and its kernel launches, and the proof's
sha256, which must be the same in every configuration, on every rank and
in every run; rank 0 verifies its proof.  The kernels (ntt.cu and
poseidon_gl.cu) build once, before the ranks start.  `--device cpu` runs
the configurations on CPU ranks (plain versions, no card), a rehearsal.
The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

SOURCES = ["ntt.cu", "poseidon_gl.cu"]   # the GL prover's kernels


def _load(files):
    from .stark.polsarray import PolsArray
    from .stark.types import load_pil, load_starkstruct

    pil = load_pil(files["pil"])
    ss = load_starkstruct(files["stark_struct"])
    const_pols = PolsArray(pil, PolsArray.CONSTANT).load(files["const"])
    cm_pols = PolsArray(pil, PolsArray.COMMIT).load(files["cm"])
    return pil, ss, const_pols, cm_pols


def prove_files(mesh, files: dict, runs: int, sharded: bool,
                sources=SOURCES) -> dict:
    """One rank's part of a configuration: load the chain files, build the
    setup on the rank's device, prove `runs` times (`sharded_prove` over
    the mesh, or `stark_gen` on the rank's device alone) and return the
    last prove's record; the model axis' rank 0 verifies its proof.
    `sources`: the kernel library to load (None: the whole one)."""
    import torch

    from . import kernels
    from .parallel.sharded_prove import sharded_prove
    from .stark.engine import Engine
    from .stark.serializer import stark_proof_to_json
    from .stark.stark_gen import stark_gen
    from .stark.stark_setup import StarkSetup
    from .stark.stark_verify import stark_verify
    from .utils.profiler import Prof

    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        kernels.load(sources)
        torch.cuda.reset_peak_memory_stats(dev)
    pil, ss, const_pols, cm_pols = _load(files)
    engine = Engine(dev)
    t0 = time.perf_counter()
    setup = StarkSetup(const_pols, pil, ss, engine)
    setup_s = time.perf_counter() - t0
    walls, digests = [], set()
    for _ in range(runs):
        mesh.stats.clear()
        kernels.reset_counts()
        prof = Prof("stark_gen", dev, on=True)
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if sharded:
            proof = sharded_prove(cm_pols, const_pols, setup, ss, mesh,
                                  prof=prof)
        else:
            proof = stark_gen(cm_pols, const_pols, setup.const_tree,
                              setup.starkinfo, setup.program, ss,
                              engine=engine, prof=prof)
        if cuda:
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        digests.add(hashlib.sha256(
            stark_proof_to_json(proof).encode()).hexdigest())
    verified = None
    if mesh.coords[1] == 0:
        verified = bool(stark_verify(proof, setup.const_root,
                                     setup.starkinfo, ss, setup.program))
    return {"rank": mesh.rank, "device": str(dev), "setup_s": setup_s,
            "walls": walls, "stages": prof.stages,
            "collectives": {k: list(v) for k, v in mesh.stats.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None, "launches": kernels.counts(),
            "sha256": sorted(digests), "verified": verified}


def _seeded_traces(seed: int, batch: int, nbits: int, width: int):
    import numpy as np

    from .ops import gl

    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=(batch, 1 << nbits, width),
                        dtype=np.uint64) % np.uint64(gl.P_INT)


def commit_traces(mesh, seed: int, batch: int, nbits: int,
                  width: int) -> dict:
    """One rank's part of make_sharded_commit on seeded traces [batch,
    2^nbits, width] (its data row's traces, its model rank's pols) over
    blowup 2, on the whole kernel library: its roots, collectives and peak
    memory (chip_smoke.py phase 16)."""
    import torch

    from . import kernels
    from .ops import gl
    from .parallel.sharded import make_sharded_commit

    dev = mesh.device
    if dev.type == "cuda":
        kernels.library()
        torch.cuda.reset_peak_memory_stats(dev)
    vals = _seeded_traces(seed, batch, nbits, width)
    d, j = mesh.coords
    b_l, p_l = batch // mesh.data, width // mesh.model
    local = gl.from_u64(vals[d * b_l : (d + 1) * b_l, :,
                             j * p_l : (j + 1) * p_l], dev)
    del vals
    mesh.stats.clear()
    kernels.reset_counts()
    t0 = time.perf_counter()
    roots = make_sharded_commit(mesh, nbits, nbits + 1, width)(local)
    roots = gl.to_u64(roots)
    return {"rank": mesh.rank, "coords": mesh.coords, "roots": roots,
            "seconds": time.perf_counter() - t0,
            "collectives": {k: list(v) for k, v in mesh.stats.items()},
            "launches": kernels.counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def commit_reference(seed: int, batch: int, nbits: int, width: int,
                     device):
    """The single-device roots of commit_traces' traces
    (ops/commit.extend_and_merkelize), [batch, 4] u64."""
    import numpy as np

    from .ops import commit, gl

    vals = _seeded_traces(seed, batch, nbits, width)
    return np.stack([commit.extend_and_merkelize(
        gl.from_u64(vals[b], device), nbits, nbits + 1).root()
        for b in range(batch)])


def collectives_line(stats: dict) -> str:
    return ", ".join(f"{k} {n} calls {s:.3f} s {b / 2**20:.1f} MiB"
                     for k, (n, s, b) in sorted(stats.items())) or "none"


def run_config(name: str, world: int, backend: str, device, files: dict,
               runs: int, sharded: bool) -> dict:
    """One configuration: spawn its ranks, prove, and summarise."""
    from .parallel import launch

    t0 = time.perf_counter()
    recs = launch.spawn(world, prove_files, files, runs, sharded,
                        backend=backend, device=device)
    return summarise(name, backend, recs, time.perf_counter() - t0)


def summarise(name: str, backend: str, recs: list, seconds: float) -> dict:
    """A configuration's record from its ranks' prove_files records."""
    r0 = recs[0]
    all_bytes = {}
    for r in recs:
        for k, (_, _, b) in r["collectives"].items():
            all_bytes[k] = all_bytes.get(k, 0) + b
    return {"config": name, "ranks": len(recs), "backend": backend,
            "wall_s": r0["walls"][-1], "walls": r0["walls"],
            "stages": r0["stages"], "setup_s": r0["setup_s"],
            "collectives": r0["collectives"],
            "collective_bytes_all_ranks": all_bytes,
            "peak_bytes": [r["peak_bytes"] for r in recs],
            "launches": [r["launches"] for r in recs],
            "sha256": sorted({h for r in recs for h in r["sha256"]}),
            "verified": r0["verified"], "devices": [r["device"] for r in recs],
            "spawn_to_end_s": seconds}


def print_config(nbits: int, width: int, c: dict):
    peaks = ", ".join("n/a" if p is None else f"{p / 2**30:.3f}"
                      for p in c["peak_bytes"])
    print(f"2^{nbits} x {width}, {c['config']} ({c['ranks']} rank(s), "
          f"{c['backend']}, {c['devices'][0]}): prove {c['wall_s']:.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in c['walls'])}), setup "
          f"{c['setup_s']:.3f} s, spawn to end {c['spawn_to_end_s']:.1f} s; "
          f"sha256 {c['sha256']}; verified {c['verified']}", flush=True)
    print("  stages (rank 0): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in c["stages"]))
    print(f"  collectives (rank 0): {collectives_line(c['collectives'])}; "
          f"bytes of all ranks: " + ", ".join(
              f"{k} {b / 2**20:.1f} MiB" for k, b in
              sorted(c["collective_bytes_all_ranks"].items())))
    print(f"  peak device memory by rank, GiB: {peaks}; launches (rank 0): "
          f"{ {k: n for k, n in c['launches'][0].items() if n} }",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nbits", type=int, nargs="+", default=[20, 23])
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    import torch

    from . import bench_chain, kernels

    report = {"width": args.width, "queries": args.queries,
              "ranks": args.ranks, "runs": args.runs, "sizes": []}
    if args.device == "cuda":
        from .utils.devices import card_line, cuda_device

        cuda_device(0)   # raises without a card
        report["card"] = card_line()
        report["cards"] = torch.cuda.device_count()
        print(f"card: {report['card']} (x{report['cards']})", flush=True)
        report["build_s"] = kernels.load(SOURCES)["seconds"]
        one_card = "cuda:0"
    else:
        report["card"] = "cpu (a rehearsal: no device numbers)"
        one_card = "cpu"
    configs = [("one", 1, "gloo", one_card, False),
               ("gloo", args.ranks, "gloo", one_card, True)]
    if args.device == "cuda" and torch.cuda.device_count() >= args.ranks:
        configs.append(("nccl", args.ranks, "nccl", None, True))
    else:
        print(f"nccl: not run ({report.get('cards', 0)} card(s), "
              f"{args.ranks} needed)", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for nbits in args.nbits:
            files = bench_chain.write_chain_files(tmp, nbits, args.width,
                                                  args.queries)
            size = {"nbits": nbits, "configs": []}
            for name, world, backend, device, sharded in configs:
                c = run_config(name, world, backend, device, files,
                               args.runs, sharded)
                print_config(nbits, args.width, c)
                size["configs"].append(c)
            shas = {h for c in size["configs"] for h in c["sha256"]}
            size["identical"] = len(shas) == 1
            print(f"2^{nbits}: one proof sha256 in every configuration: "
                  f"{size['identical']}", flush=True)
            ok = ok and size["identical"] and all(
                c["verified"] for c in size["configs"])
            report["sizes"].append(size)
    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(json.dumps(report), flush=True)
    return 0 if ok and not report["foreign_modules"] else 1


if __name__ == "__main__":
    sys.exit(main())
