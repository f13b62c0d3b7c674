"""The zkVM chain end to end on one CUDA device: chunks to Groth16.

    python -m eigen_zkvm_tpu_torch.bench_e2e --chunks 2 --queries 4 \\
        --force 18 [--curve bls12381]

The port's counterpart of scripts/zkvm_e2e.py, its executable
specification, with the same stages and the same JSON keys:

  guest        the in-guest secp256k1 ecrecover (bench_zkvm.Guest) run to
               its end by the native executor, in 2^nbits-row chunks;
  chunks       the first --chunks of them proved on the card
               (bench_zkvm.prove_chunk: RV32IM machine, default_struct);
  c12, recursive1, aggregation
               bench_recursion.run_layers: c12 and recursive1 of each chunk
               proof, then the chained aggregation (ChainMap), whose
               publics must be the super-chunk's;
  final        `final_layer`: the aggregated proof's verifier circuit
               (compressor12_setup with verkey_input) proved under the
               snark curve's transcript and 16-ary Poseidon-over-Fr trees
               (`final_struct`: BN128, or BLS12381 with --curve bls12381),
               then verified on the host;
  wrap         `snark_wrap`: the circuit over the snark curve's r that
               verifies the final proof
               (recursion/stark_verifier_circuit_bn.build_final_main, one
               public: sha256(proverAddr || publics) mod r), checked, then
               a Groth16 setup, prove and verify (groth16/groth16.py) on
               the card at that curve, and the verify of a changed public,
               which must be False.
--curve bls12381 is the simple_bls.sh branch of the JAX package's
scripts/full_chain_demo.py (:121-174): the final layer under the
BLS12381 transcript and trees, its BLS12-381 Groth16 wrap.

Beside zkvm_e2e.py's keys, each stage's `Prof` split, its peak device
memory and the kernels' launches (counts set to 0 just before the stage,
read just after), the final layer's rows and section widths, and the
digests `wrap_digests` gives.  Groth16's setup draws from
bench_groth16.seeded(G16_SEED) and the prove from seeded(G16_SEED + 1)
(`run_final_and_wrap`, which chip_smoke.py's phase 11 runs too), so a
run's proof bytes are reproducible.  The last line is one JSON object; -o
also writes it to a file (nothing is written by default).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass

from .curves import bls12_381, bn254
from .stark.types import StarkStruct, Step
from .utils.profiler import Prof

# The Groth16 draws of the wrap: setup from bench_groth16.seeded(G16_SEED),
# prove from seeded(G16_SEED + 1).
G16_SEED = 1
# The snark curve's Groth16 name -> (its final layer's verificationHashType,
# its curve module)
SNARK_CURVES = {"bn128": ("BN128", bn254), "bls12381": ("BLS12381", bls12_381)}


def final_struct(n_bits: int, n_queries: int, hash_type: str = "BN128"
                 ) -> StarkStruct:
    """The final layer's struct (scripts/zkvm_e2e.py:182-189): blowup 2,
    FRI steps from n_bits + 1 down by 4 while above 5, then the last."""
    steps, nb = [], n_bits + 1
    while nb > 5:
        steps.append(Step(nb))
        nb -= 4
    steps.append(Step(nb))
    return StarkStruct(nBits=n_bits, nBitsExt=n_bits + 1, nQueries=n_queries,
                       verificationHashType=hash_type, steps=steps)


def final_layer(agg_zkin: dict, agg_setup, agg_ss, engine=None,
                prof: Prof | None = None, curve: str = "bn128"):
    """The final big-field eSTARK of an aggregated (or any GL) proof
    (scripts/zkvm_e2e.py:177-198; full_chain_demo.py:121-146 for
    BLS12-381): its verifier circuit with the constant root as an input,
    packed into the compressor PIL and proved on `engine` (None: the
    current CUDA device, raising without one) under the snark `curve`'s
    transcript and trees (BN128 or BLS12381) at the inner proof's query
    count; self-verified on the host.  Returns (zkin dict, StarkSetup,
    struct, PlonkSetup)."""
    from .recursion.compressor12 import (StarkOption, compressor12_setup,
                                         exec_witness)
    from .stark.engine import Engine
    from .stark.serializer import stark_proof_to_dict
    from .stark.stark_gen import stark_gen
    from .stark.stark_setup import StarkSetup
    from .stark.stark_verify import stark_verify

    engine = engine or Engine()
    circuit, psetup = compressor12_setup(
        agg_zkin, agg_setup, agg_ss, StarkOption(verkey_input=True),
        prof=prof)
    cm_pols = exec_witness(circuit, psetup)
    if prof:
        prof.tick("exec_witness")
    hash_type = SNARK_CURVES[curve][0]
    ss = final_struct(psetup.n_bits, agg_ss.nQueries, hash_type)
    setup = StarkSetup(psetup.const_pols, psetup.pil, ss, engine, prof=prof)
    proof = stark_gen(cm_pols, psetup.const_pols, setup.const_tree,
                      setup.starkinfo, setup.program, ss, engine=engine,
                      prof=prof)
    ok = stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                      setup.program)
    if prof:
        prof.tick("stark_verify")
    if not ok:
        raise RuntimeError("the final layer's proof failed self-"
                           "verification")
    return stark_proof_to_dict(proof, hash_type), setup, ss, psetup


@dataclass
class Wrap:
    """What `snark_wrap` made: the circuit (a CircuitBuilder), the keys, the
    proof and its publics, the two verifies, and the kernels' launches in
    the Groth16 setup and in the prove ({"setup": {name: n}, "prove":
    ...})."""
    circuit: object
    pk: object
    vk: object
    proof: object
    publics: list
    verified: bool
    tampered_rejected: bool
    launches: dict


def snark_wrap(zkin: dict, setup, ss, device=None, rng_setup=None,
               rng_prove=None, prof: Prof | None = None,
               curve: str = "bn128") -> Wrap:
    """The Groth16 wrap of a final proof under `curve`'s transcript
    (scripts/zkvm_e2e.py:200-220, full_chain_demo.py:148-165):
    build_final_main over the zkin with that curve's Poseidon and r,
    check(), then Groth16 setup, prove and verify at that curve on `device`
    (None: the current CUDA device, raising without one; "cpu" runs the
    kernels' plain versions), and the verify of the public plus one.
    `rng_setup` / `rng_prove` are the draws' sources (None: `secrets`)."""
    from . import kernels
    from .groth16 import groth16 as g16
    from .hash import poseidon_bls12381, poseidon_bn128
    from .recursion.stark_verifier_circuit_bn import build_final_main

    dev = g16.resolve_device(device)
    prof = prof or Prof("snark_wrap", dev)
    r = SNARK_CURVES[curve][1].R
    pos = poseidon_bn128 if curve == "bn128" else poseidon_bls12381
    b = build_final_main(zkin, setup.starkinfo, setup.program, ss,
                         setup.const_root, pos, curve_r=r)
    prof.tick("build_final_main")
    if not b.check():
        raise RuntimeError("the final circuit's witness does not satisfy "
                           "its constraints")
    prof.tick("check")
    counts = [kernels.counts()]
    pk, vk = g16.setup(b.constraints, b.n_vars, b.n_publics, rng=rng_setup,
                       device=dev, prof=prof, curve=curve)
    counts.append(kernels.counts())
    proof, publics = g16.prove(pk, b.constraints, b.w, rng=rng_prove,
                               prof=prof)
    counts.append(kernels.counts())
    ok = g16.verify(vk, proof, publics)
    prof.tick("verify")
    rejected = not g16.verify(vk, proof, [(publics[0] + 1) % r])
    prof.tick("verify (changed public)")
    launches = {step: {k: after[k] - before[k] for k in after}
                for step, before, after in (("setup", *counts[:2]),
                                            ("prove", *counts[1:]))}
    return Wrap(b, pk, vk, proof, publics, ok, rejected, launches)


def publics_hash(zkin: dict, r: int = bn254.R) -> int:
    """sha256(proverAddr_160 || publics, 64 bits each, big-endian) mod r:
    the final circuit's one public."""
    addr = zkin.get("proverAddr", 0) or 0
    addr = int(addr, 0) if isinstance(addr, str) else int(addr)
    msg = (addr % (1 << 160)).to_bytes(20, "big")
    for v in zkin["publics"]:
        msg += (int(v) % 0xFFFFFFFF00000001).to_bytes(8, "big")
    return int.from_bytes(hashlib.sha256(msg).digest(), "big") % r


def circuit_sha256(circuit) -> str:
    """sha256 of a circuit's .r1cs bytes (algebraic/r1cs_file.py) followed
    by its witness's .wtns bytes: its constraints and witness, canonical."""
    from .algebraic import r1cs_file, witness

    h = hashlib.sha256(r1cs_file.to_bytes(r1cs_file.circuit_to_r1cs(circuit)))
    h.update(witness.witness_to_bytes(circuit.w, circuit.P))
    return h.hexdigest()


def wrap_digests(zkin: dict, wrap: Wrap) -> dict:
    """{"final zkin", "circuit", "proof", "verifier.sol"}: sha256 of the
    final zkin's JSON (as stark_proof_to_json writes it), of the circuit
    (`circuit_sha256`), of the Groth16 proof's JSON (groth16/api.py
    proof_to_json) and of the Solidity verifier rendered from the vk."""
    from .bench_recursion import zkin_sha256
    from .groth16 import api

    return {
        "final zkin": zkin_sha256(zkin),
        "circuit": circuit_sha256(wrap.circuit),
        "proof": hashlib.sha256(api.proof_to_json(
            wrap.proof, wrap.pk.curve_name).encode()).hexdigest(),
        "verifier.sol": hashlib.sha256(
            api.generate_verifier_from_vk(wrap.vk).encode()).hexdigest()}


def run_final_and_wrap(agg: dict, engine, dev, on_layer=None,
                       curve: str = "bn128") -> tuple:
    """The chain's last two stages over bench_recursion.run_layers' output
    `agg` (its "aggregation" zkin and "aggregation_setup"), each under
    bench_recursion.run_layer (its Prof split, peak device memory and
    launches), with a line printed for each: `final_layer` on `engine`,
    recorded with its rows, constant columns, section widths, FRI steps and
    zkin sha256; then `snark_wrap` on `dev`, setup drawing from
    bench_groth16.seeded(G16_SEED) and the prove from seeded(G16_SEED + 1),
    recorded with its constraints, wires and domain, the two verifies,
    whether the public is `publics_hash`, the launches by step and
    `wrap_digests` (and its seconds).  `on_layer("final", (StarkSetup,
    struct, PlonkSetup))` is called after the final layer's record, as
    bench_recursion.run_layers calls it.  `curve`: the snark curve
    (`SNARK_CURVES`).  Returns (final record, wrap record, final zkin,
    Wrap)."""
    from . import bench_groth16, bench_recursion

    agg_setup, agg_ss, _ = agg["aggregation_setup"]
    (zkin4, setup4, ss4, ps4), final = bench_recursion.run_layer(
        "final", engine, lambda prof: final_layer(
            agg["aggregation"], agg_setup, agg_ss, engine=engine,
            prof=prof, curve=curve))
    sn = setup4.starkinfo.map_sectionsN
    final.update(n_bits=ps4.n_bits, n_used=ps4.n_used,
                 n_const=ps4.pil.nConstants,
                 widths={s: sn.get(s) for s in bench_recursion.SECTIONS},
                 steps=[s.nBits for s in ss4.steps],
                 zkin_sha256=bench_recursion.zkin_sha256(zkin4))
    print(f"  final layer: 2^{final['n_bits']} rows ({final['n_used']} "
          f"used, {final['n_const']} constant columns, sections "
          f"{final['widths']}, FRI steps {final['steps']}), "
          f"{final['wall_s']:.3f} s: "
          + ", ".join(f"{st} {t:.3f}" for st, t in final["stages"])
          + f"; launches {final['launches']}; peak device memory "
          f"{final['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    if on_layer:
        on_layer("final", (setup4, ss4, ps4))
    wrap, rec = bench_recursion.run_layer(
        "wrap", engine, lambda prof: snark_wrap(
            zkin4, setup4, ss4, device=dev,
            rng_setup=bench_groth16.seeded(G16_SEED),
            rng_prove=bench_groth16.seeded(G16_SEED + 1), prof=prof,
            curve=curve))
    t0 = time.perf_counter()
    digests = wrap_digests(zkin4, wrap)
    rec.update(digests_s=time.perf_counter() - t0, digests=digests,
               constraints=len(wrap.circuit.constraints),
               wires=wrap.circuit.n_vars, domain=wrap.pk.domain_size,
               verified=wrap.verified,
               tampered_rejected=wrap.tampered_rejected,
               publics_hash_ok=wrap.publics == [publics_hash(
                   zkin4, SNARK_CURVES[curve][1].R)],
               by_step=wrap.launches)
    print(f"  wrap: {rec['constraints']} constraints, {rec['wires']} wires, "
          f"domain 2^{rec['domain'].bit_length() - 1}, "
          f"{rec['wall_s']:.3f} s: "
          + ", ".join(f"{st} {t:.3f}" for st, t in rec["stages"])
          + f"; launches: setup {wrap.launches['setup']}, prove "
          f"{wrap.launches['prove']}; peak device memory "
          f"{rec['peak_bytes'] / 2**30:.3f} GiB; verified {wrap.verified}, "
          f"a changed public rejected {wrap.tampered_rejected}, the public "
          f"is sha256(proverAddr || publics) mod r: {rec['publics_hash_ok']}"
          f"; digests ({rec['digests_s']:.3f} s) {digests}", flush=True)
    return final, rec, zkin4, wrap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=2,
                    help="chunks proved (the first ones; two or more)")
    ap.add_argument("--nbits", type=int, default=16, help="log2 chunk rows")
    ap.add_argument("--queries", type=int, default=4,
                    help="queries of every layer (zkvm_e2e.py's default)")
    ap.add_argument("--force", type=int, default=18,
                    help="log2 rows of recursive1 and the aggregation")
    ap.add_argument("--curve", default="bn128", choices=sorted(SNARK_CURVES),
                    help="the snark curve of the final layer and the wrap")
    ap.add_argument("-o", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.chunks < 2:
        ap.error("--chunks: two or more")
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    from . import bench_recursion, bench_zkvm, kernels
    from .recursion.compressor12 import ChainMap
    from .stark.engine import Engine
    from .utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    engine = Engine(dev)
    res: dict = {"metric": "zkvm_e2e_chain", "unit": "s", "curve": args.curve,
                 "chunk_rows": 1 << args.nbits, "n_queries": args.queries,
                 "force_n_bits": args.force, "card": card_line()}
    print(f"card: {res['card']}", flush=True)
    t_all = time.perf_counter()
    res["build_s"] = kernels.build()["seconds"]
    kernels.library()
    print(f"kernels built in {res['build_s']:.1f} s", flush=True)
    t_chain = time.perf_counter()

    guest = bench_zkvm.Guest(nbits=args.nbits)
    res.update(guest_cycles=guest.chunker.total_cycles,
               n_chunks_total=len(guest.chunker.chunks),
               trace_s=guest.execute_s)
    K = min(args.chunks, len(guest.chunker.chunks))
    res["n_chunks_proven"] = K
    print(f"guest: {res['guest_cycles']} cycles, {res['n_chunks_total']} "
          f"chunks in {guest.execute_s:.3f} s; proving {K}", flush=True)
    machine, setup, ss, times = bench_zkvm.setup_machine(
        guest, args.queries, engine)
    res["engine"] = repr(engine)
    res["setup_s"] = times["machine_s"] + times["setup_s"]
    zkins, chunks = [], []
    for k in range(K):
        r = bench_zkvm.prove_chunk(guest, machine, setup, ss, k, engine,
                                   keep_zkin=True)
        zkins.append(r.pop("zkin"))
        r.pop("publics")
        chunks.append(r)
        print(f"chunk {k}: {r['wall_s']:.3f} s, digests hold "
              f"{r['digests_hold']}, zkin sha256 {r['zkin_sha256']}",
              flush=True)
    res["chunks"] = chunks
    res["chunk_prove_s"] = [r["wall_s"] for r in chunks]
    res["chunk_prove_total_s"] = sum(res["chunk_prove_s"])

    print("recursion layers:", flush=True)
    records, out = bench_recursion.run_layers(
        zkins, setup, ss, engine, args.queries, args.force,
        ChainMap.for_machine(machine))
    del zkins
    res["layers"] = records
    res["c12_s"] = [r["wall_s"] for r in records
                    if r["layer"].startswith("c12")]
    res["recursive1_s"] = [r["wall_s"] for r in records
                           if r["layer"].startswith("recursive1")]
    res["aggregation_s"] = records[-1]["wall_s"]
    res["super_boundary_publics_verified"] = \
        bench_recursion.super_publics_hold(guest, machine, out["aggregation"],
                                           0, K - 1)
    print("final layer and wrap:", flush=True)
    final, rec, zkin4, wrap = run_final_and_wrap(out, engine, dev,
                                                 curve=args.curve)
    del out
    res["final"] = final
    res["final_bn128_s"] = final["wall_s"]
    st = dict(rec["stages"])
    res["wrap"] = rec
    res["snark_circuit_s"] = st["build_final_main"] + st["check"]
    res["snark_constraints"] = rec["constraints"]
    res["snark_wires"] = rec["wires"]
    res["snark_domain"] = rec["domain"]
    res["groth16_setup_s"] = st["qap"] + st["fixed-base batches"]
    res["groth16_prove_s"] = sum(t for s, t in rec["stages"] if s not in (
        "build_final_main", "check", "qap", "fixed-base batches", "verify",
        "verify (changed public)"))
    res["groth16_verify_s"] = st["verify"]
    res["groth16_launches"] = rec["by_step"]
    res["publics_hash_holds"] = rec["publics_hash_ok"]
    res["digests"] = rec["digests"]

    res["value"] = time.perf_counter() - t_chain
    res["wall_with_build_s"] = time.perf_counter() - t_all
    per_chunk = (res["chunk_prove_total_s"] + sum(res["c12_s"])
                 + sum(res["recursive1_s"]) + res["aggregation_s"]) / K
    res["projected_full_guest_s"] = (
        per_chunk * res["n_chunks_total"] + res["final_bn128_s"]
        + res["snark_circuit_s"] + res["groth16_setup_s"]
        + res["groth16_prove_s"])
    res["verified"] = bool(
        wrap.verified and wrap.tampered_rejected
        and res["super_boundary_publics_verified"]
        and res["publics_hash_holds"]
        and all(r["digests_hold"] for r in chunks))
    res["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    text = json.dumps(res)
    if args.o:
        with open(args.o, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if res["verified"] and not res["foreign_modules"] else 1


if __name__ == "__main__":
    sys.exit(main())
