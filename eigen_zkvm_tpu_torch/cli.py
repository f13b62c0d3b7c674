"""The port's command line: the eigen-zkit commands of eigen_zkvm_tpu/cli.py
(reference: zkit/src/main.rs:232-255) that the port serves, on the card.

Usage: python -m eigen_zkvm_tpu_torch.cli <command> [options]

Commands:
  stark_prove         prove a PIL trace, self-verify, write zkin.json
  stark_verify        verify a zkin.json proof against PIL + struct + const
  join_zkin           merge two recursive zkin inputs for aggregation
  groth16_setup       circuit-specific SNARK setup -> pk file / vk json
  groth16_prove       SNARK proof of a circuit and its witness
  groth16_verify      verify a SNARK proof json
  generate_verifier   render the Solidity verifier from a vk json

The flags, names and output files are the JAX package's, with three
differences:
  - groth16_setup and groth16_prove take --circuit as a circom .r1cs file,
    not a pickle, and groth16_prove takes --witness (.wtns or a JSON list),
    since the JAX package's pickle carries the witness inside the circuit;
  - --pk is the port's proving-key file (groth16/api.py, save_pk /
    load_pk), not a pickle;
  - stark_prove parses --circom, --agg_stage, --norm_stage and --skip_main
    and raises NotImplementedError for them (the verifier-circuit render,
    ROADMAP queue 1 item 4); --curve_type BLS12381 raises
    NotImplementedError (BN254 only).
stark_prove, stark_verify, groth16_setup and groth16_prove run on the
current CUDA device and raise without one; their --device flag is for the
tests (--device cpu runs the kernels' plain versions).  groth16_verify,
join_zkin and generate_verifier are host work.  `main` returns the exit
code: 1 when a verifier rejects.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

NOT_PORTED = ("the STARK-verifier circuit render (circom_out, agg_stage, "
              "norm_stage, skip_main) is not ported yet: ROADMAP queue 1 "
              "item 4")


def _cmd_stark_prove(args) -> int:
    from .stark.prove import stark_prove

    if args.circom or args.agg_stage or args.norm_stage or args.skip_main:
        raise NotImplementedError(NOT_PORTED)
    t0 = time.perf_counter()
    stark_prove(args.stark_struct, args.piljson, args.const_pols,
                args.cm_pols, zkin_out=args.output,
                prover_addr=args.prover_addr, device=args.device,
                prof=args.prof)
    print(f"stark_prove done in {time.perf_counter() - t0:.3f}s -> "
          f"{args.output}")
    return 0


def _cmd_stark_verify(args) -> int:
    from .stark.engine import Engine
    from .stark.polsarray import PolsArray
    from .stark.serializer import stark_proof_from_json
    from .stark.stark_setup import StarkSetup
    from .stark.stark_verify import stark_verify
    from .stark.types import load_pil, load_starkstruct

    engine = Engine(args.device)
    pil = load_pil(args.piljson)
    ss = load_starkstruct(args.stark_struct)
    const_pols = PolsArray(pil, PolsArray.CONSTANT).load(args.const_pols)
    setup = StarkSetup(const_pols, pil, ss, engine)
    with open(args.proof) as f:
        proof = stark_proof_from_json(f.read())
    ok = stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                      setup.program)
    print("verify:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _cmd_join_zkin(args) -> int:
    from .stark.serializer import join_zkin

    with open(args.zkin1) as f:
        z1 = json.load(f)
    with open(args.zkin2) as f:
        z2 = json.load(f)
    with open(args.zkinout, "w") as f:
        json.dump(join_zkin(z1, z2), f, separators=(",", ":"))
    print(f"join_zkin -> {args.zkinout}")
    return 0


def _load_circuit(path: str):
    """(constraints, n_vars, n_publics) of a BN254 .r1cs file."""
    from .algebraic.r1cs_file import load_r1cs, r1cs_to_circuit_inputs
    from .groth16.groth16 import R

    r1cs = load_r1cs(path)
    if r1cs.prime != R:
        raise ValueError(f"{path}: field {r1cs.prime} is not BN254's Fr")
    if r1cs.custom_gates or r1cs.custom_gates_uses:
        raise ValueError(f"{path}: custom gates are not R1CS constraints")
    constraints, _, n_vars, n_publics = r1cs_to_circuit_inputs(r1cs)
    return constraints, n_vars, n_publics


def _cmd_groth16_setup(args) -> int:
    from .groth16 import groth16 as core
    from .groth16.api import _curve, save_pk, vk_to_json

    _curve(args.curve_type)
    constraints, n_vars, n_publics = _load_circuit(args.circuit)
    pk, vk = core.setup(constraints, n_vars, n_publics, device=args.device)
    save_pk(args.pk, pk)
    with open(args.vk, "w") as f:
        f.write(vk_to_json(vk, to_hex=args.to_hex))
    print(f"groth16_setup -> {args.pk} / {args.vk}")
    return 0


def _cmd_groth16_prove(args) -> int:
    from .algebraic.witness import load_witness
    from .groth16 import groth16 as core
    from .groth16.api import (_curve, load_pk, proof_to_json,
                              publics_to_json)
    from .utils.profiler import Prof

    cname = _curve(args.curve_type)
    dev = core._device(args.device)
    prof = args.prof or Prof("cli.groth16_prove", dev)
    constraints, n_vars, n_publics = _load_circuit(args.circuit)
    prof.tick("load r1cs")
    witness = load_witness(args.witness)
    if len(witness) != n_vars:
        raise ValueError(f"{args.witness}: {len(witness)} values for "
                         f"{n_vars} wires")
    prof.tick("load witness")
    pk = load_pk(args.pk, dev)
    if (pk.n_vars, pk.n_public) != (n_vars, n_publics):
        raise ValueError(f"{args.pk} is a key for another circuit")
    prof.tick("load pk")
    proof, publics = core.prove(pk, constraints, witness, prof=prof)
    with open(args.proof, "w") as f:
        f.write(proof_to_json(proof, cname, to_hex=args.to_hex))
    with open(args.public_input, "w") as f:
        f.write(publics_to_json(publics))
    print(f"groth16_prove -> {args.proof} / {args.public_input}")
    return 0


def _cmd_groth16_verify(args) -> int:
    from .groth16 import groth16 as core
    from .groth16.api import (_curve, proof_from_json, publics_from_json,
                              vk_from_json)

    _curve(args.curve_type)
    with open(args.vk) as f:
        vk = vk_from_json(f.read())
    with open(args.proof) as f:
        proof = proof_from_json(f.read())
    with open(args.public_input) as f:
        publics = publics_from_json(f.read())
    ok = core.verify(vk, proof, publics)
    print("groth16_verify:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _cmd_generate_verifier(args) -> int:
    from .groth16.api import generate_verifier

    generate_verifier(args.vk, args.sol)
    print(f"generate_verifier -> {args.sol}")
    return 0


def _device_flag(p):
    p.add_argument("--device", default=None,
                   help="for the tests: 'cpu' runs the kernels' plain "
                        "versions (default: the current CUDA device)")


def main(argv=None, prof=None) -> int:
    """Run one command; returns its exit code.  `prof` (utils/profiler.Prof)
    receives stark_prove's and groth16_prove's stage ticks (groth16_prove:
    the file loads, then the prover's own)."""
    ap = argparse.ArgumentParser(prog="eigen-zkit (PyTorch/CUDA port)",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("stark_prove", help="prove a PIL trace")
    p.add_argument("--stark_struct", "-s", required=True)
    p.add_argument("--piljson", "-p", required=True)
    p.add_argument("--const_pols", "-c", required=True)
    p.add_argument("--cm_pols", "-m", required=True)
    p.add_argument("--output", "-o", required=True, help="zkin.json output")
    p.add_argument("--circom", help="verifier .circom output (not ported)")
    p.add_argument("--prover_addr", default="")
    p.add_argument("--agg_stage", action="store_true", help="not ported")
    p.add_argument("--norm_stage", action="store_true", help="not ported")
    p.add_argument("--skip_main", action="store_true", help="not ported")
    _device_flag(p)
    p.set_defaults(func=_cmd_stark_prove)

    p = sub.add_parser("stark_verify", help="verify a zkin.json proof")
    p.add_argument("--stark_struct", "-s", required=True)
    p.add_argument("--piljson", "-p", required=True)
    p.add_argument("--const_pols", "-c", required=True)
    p.add_argument("--proof", "-f", required=True)
    _device_flag(p)
    p.set_defaults(func=_cmd_stark_verify)

    p = sub.add_parser("join_zkin", help="merge two zkin inputs")
    p.add_argument("--zkin1", required=True)
    p.add_argument("--zkin2", required=True)
    p.add_argument("--zkinout", required=True)
    p.set_defaults(func=_cmd_join_zkin)

    p = sub.add_parser("groth16_setup")
    p.add_argument("--curve_type", default="BN128")
    p.add_argument("--circuit", required=True, help="circom .r1cs file")
    p.add_argument("--pk", required=True, help="proving-key file output")
    p.add_argument("--vk", required=True)
    p.add_argument("--to_hex", action="store_true")
    _device_flag(p)
    p.set_defaults(func=_cmd_groth16_setup)

    p = sub.add_parser("groth16_prove")
    p.add_argument("--curve_type", default="BN128")
    p.add_argument("--circuit", required=True, help="circom .r1cs file")
    p.add_argument("--witness", required=True,
                   help=".wtns file or JSON list of the wire values")
    p.add_argument("--pk", required=True, help="proving-key file")
    p.add_argument("--proof", required=True)
    p.add_argument("--public_input", required=True)
    p.add_argument("--to_hex", action="store_true")
    _device_flag(p)
    p.set_defaults(func=_cmd_groth16_prove)

    p = sub.add_parser("groth16_verify")
    p.add_argument("--curve_type", default="BN128")
    p.add_argument("--vk", required=True)
    p.add_argument("--proof", required=True)
    p.add_argument("--public_input", required=True)
    p.set_defaults(func=_cmd_groth16_verify)

    p = sub.add_parser("generate_verifier")
    p.add_argument("--vk", required=True)
    p.add_argument("--sol", required=True)
    p.set_defaults(func=_cmd_generate_verifier)

    args = ap.parse_args(argv)
    args.prof = prof
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
