"""GL recursion layers of the port on one CUDA device, over zkVM chunks.

    python -m eigen_zkvm_tpu_torch.bench_recursion --chunks 0 1 --queries 4 --force 18

The executable specification is scripts/zkvm_e2e.py:135-179.  The
ecrecover guest's chunks asked for (consecutive; bench_zkvm: 2^16 rows,
the RV32IM machine, `default_struct(16, queries)`) are proved on the card,
then each goes through two recursion layers, each a verifier circuit
(recursion/stark_verifier_circuit.build_main) packed into the 12-column
compressor PIL and proved on the card (recursion/compressor12.py
`prove_compressed`):
  c12         skip_main: the chunk proof's verifier, at its natural size;
  recursive1  the c12 proof's verifier, forced to 2^force rows;
and the recursive1 proofs fold pairwise into one (recursion/aggregation.py
`aggregate_recursive1`, the ChainMap of the machine: chunk k's out-state
publics equal chunk k+1's in-state publics inside the circuit).  The
aggregated proof's publics are the super-chunk's: its mem_in* must equal
the first chunk's incoming RAM-image digest, its mem_out* the last
chunk's outgoing one.

Each layer's wall is split by `Prof` ticks: build_main, PlonkSetup,
exec_witness, the StarkSetup's const tree and starkinfo compile,
stark_gen's stages, and stark_verify (the self-verification on the host).
EIGEN_ZKVM_SYNC=1 (set here) drains the device at every tick, so the
stage walls are device walls.  Beside them: the layer's n_bits, used rows
and constant columns, peak device memory, the NTT and Poseidon kernels'
launches (counts set to 0 just before the layer, read just after) and the
sha256 of its zkin JSON.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

QUERIES, FORCE = 4, 18
GL_SOURCES = ("ntt.cu", "poseidon_gl.cu")   # the kernels this path runs


def zkin_sha256(zkin: dict) -> str:
    """sha256 of a zkin dict's JSON as stark_proof_to_json writes it."""
    return hashlib.sha256(
        json.dumps(zkin, separators=(",", ":")).encode()).hexdigest()


def run_layer(label: str, engine, fn):
    """fn(prof) with the kernels' counts set to 0 just before and read just
    after; (fn's result, {layer, wall_s, stages, launches, peak_bytes})."""
    import torch

    from . import kernels
    from .utils.profiler import Prof

    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        torch.cuda.reset_peak_memory_stats(engine.device)
    kernels.reset_counts()
    prof = Prof(label, engine.device, on=True)
    t0 = time.perf_counter()
    out = fn(prof)
    if cuda:
        torch.cuda.synchronize(engine.device)
    rec = dict(layer=label, wall_s=time.perf_counter() - t0,
               stages=prof.stages, launches=kernels.counts(),
               peak_bytes=(torch.cuda.max_memory_allocated(engine.device)
                           if cuda else None))
    return out, rec


SECTIONS = ("cm1_2ns", "cm2_2ns", "cm3_2ns", "cm4_2ns")


def _shape(rec: dict, bundle, zkin: dict):
    """The layer's rows, constant columns, committed section widths (the
    LDE's and the leaves' shapes) and its zkin's digest into `rec`."""
    st_setup, _, psetup = bundle
    sn = st_setup.starkinfo.map_sectionsN
    rec.update(n_bits=psetup.n_bits, n_used=psetup.n_used,
               n_const=psetup.pil.nConstants,
               widths={s: sn.get(s) for s in SECTIONS},
               zkin_sha256=zkin_sha256(zkin))


def run_layers(zkins: list, setup, ss, engine, queries: int = QUERIES,
               force: int = FORCE, chain_map=None, log=print, on_layer=None):
    """c12 and recursive1 for each zkin (proofs of one PIL: `setup`, `ss`),
    then the aggregation of the recursive1 proofs (chained by `chain_map`
    when given).  Returns (layer records, {"c12": [zkin], "recursive1":
    [zkin], "aggregation": zkin, "aggregation_setup": (StarkSetup, struct,
    PlonkSetup)}), the last the next layer's inputs.  `on_layer(label,
    (StarkSetup, struct, PlonkSetup))` is called after each layer's
    record, outside its kernel counts."""
    from .recursion.aggregation import aggregate_recursive1
    from .recursion.compressor12 import StarkOption, prove_compressed
    from .stark.serializer import stark_proof_to_dict

    records = []
    out = {"c12": [], "recursive1": []}

    def report(rec, bundle):
        records.append(rec)
        if on_layer:
            on_layer(rec["layer"], bundle)
        if log:
            log(f"  {rec['layer']}: 2^{rec['n_bits']} rows ({rec['n_used']} "
                f"used, {rec['n_const']} constant columns, sections "
                f"{rec['widths']}), "
                f"{rec['wall_s']:.3f} s: "
                + ", ".join(f"{st} {t:.3f}" for st, t in rec["stages"])
                + f"; launches {rec['launches']}; peak device memory "
                f"{(rec['peak_bytes'] or 0) / 2**30:.3f} GiB; zkin sha256 "
                f"{rec['zkin_sha256'][:16]}...")

    r1_bundle = None
    for k, z in enumerate(zkins):
        (proof, c12_bundle), rec = run_layer(
            f"c12 {k}", engine, lambda prof: prove_compressed(
                z, setup, ss, StarkOption(skip_main=True),
                n_queries=queries, engine=engine, prof=prof))
        cz = stark_proof_to_dict(proof, "GL")
        _shape(rec, c12_bundle, cz)
        report(rec, c12_bundle)
        out["c12"].append(cz)
        (proof, r1_bundle), rec = run_layer(
            f"recursive1 {k}", engine, lambda prof: prove_compressed(
                cz, c12_bundle[0], c12_bundle[1], StarkOption(),
                n_queries=queries, force_n_bits=force, engine=engine,
                prof=prof))
        rz = stark_proof_to_dict(proof, "GL")
        _shape(rec, r1_bundle, rz)
        report(rec, r1_bundle)
        out["recursive1"].append(rz)
    r1_setup, r1_ss, _ = r1_bundle
    (final, agg_bundle), rec = run_layer(
        "aggregation", engine, lambda prof: aggregate_recursive1(
            out["recursive1"], r1_setup, r1_ss, force_n_bits=force,
            n_queries=queries, chain_map=chain_map, engine=engine,
            prof=prof))
    _shape(rec, agg_bundle, final)
    report(rec, agg_bundle)
    out["aggregation"] = final
    out["aggregation_setup"] = agg_bundle
    return records, out


def super_publics_hold(guest, machine, zkin: dict, first: int,
                       last: int) -> bool:
    """An aggregated zkin's mem_in* equal chunk `first`'s incoming RAM-image
    digest and its mem_out* chunk `last`'s outgoing one
    (scripts/zkvm_e2e.py:171-179)."""
    from .zkvm.continuations import ram_digest

    names = [p.name for p in machine.pil.publics]
    got = {nm: int(v) for nm, v in zip(names, zkin["publics"])}
    d_in = ram_digest(guest.chunker.chunks[first].image_in)
    d_out = ram_digest(guest.image_out(last))
    return all(got[f"mem_in{j}"] == d_in[j] and got[f"mem_out{j}"] == d_out[j]
               for j in range(4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[0, 1],
                    help="consecutive chunks of the ecrecover guest")
    ap.add_argument("--queries", type=int, default=QUERIES,
                    help="queries of every layer (zkvm_e2e.py's default)")
    ap.add_argument("--force", type=int, default=FORCE,
                    help="log2 rows of recursive1 and the aggregation "
                         "(the reference forces 18)")
    args = ap.parse_args(argv)
    if [k - args.chunks[0] for k in args.chunks] != list(
            range(len(args.chunks))) or len(args.chunks) < 2:
        ap.error("--chunks: two or more consecutive chunks")
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    from . import bench_zkvm, kernels
    from .recursion.compressor12 import ChainMap
    from .stark.engine import Engine
    from .utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    engine = Engine(dev)
    report = {"card": card_line(), "nbits": bench_zkvm.NBITS,
              "queries": args.queries, "force": args.force,
              "chunks": args.chunks}
    print(f"card: {report['card']}", flush=True)
    report["build_s"] = kernels.load(GL_SOURCES)["seconds"]
    guest = bench_zkvm.Guest()
    machine, setup, ss, times = bench_zkvm.setup_machine(
        guest, args.queries, engine)
    report.update(times, cycles=guest.chunker.total_cycles)
    print(f"guest {guest.execute_s:.3f} s, machine {times['machine_s']:.3f} "
          f"s, setup {times['setup_s']:.3f} s", flush=True)
    zkins, chunks = [], []
    for k in args.chunks:
        r = bench_zkvm.prove_chunk(guest, machine, setup, ss, k, engine,
                                   keep_zkin=True)
        zkins.append(r.pop("zkin"))
        chunks.append({key: r[key] for key in (
            "chunk", "wall_s", "launches", "digests_hold", "zkin_sha256")})
        print(f"chunk {k}: {r['wall_s']:.3f} s, zkin sha256 "
              f"{r['zkin_sha256']}", flush=True)
    report["chunk_proofs"] = chunks

    print("recursion layers:", flush=True)
    records, out = run_layers(zkins, setup, ss, engine, args.queries,
                              args.force, ChainMap.for_machine(machine))
    report["layers"] = records
    report["super_publics_hold"] = super_publics_hold(
        guest, machine, out["aggregation"], args.chunks[0], args.chunks[-1])
    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(f"super-chunk publics hold {report['super_publics_hold']}; "
          f"total of the layers "
          f"{sum(r['wall_s'] for r in records):.3f} s; JAX-package modules "
          f"loaded {report['foreign_modules']}", flush=True)
    print(json.dumps(report), flush=True)
    ok = report["super_publics_hold"] and not report["foreign_modules"] \
        and all(r["digests_hold"] for r in chunks)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
