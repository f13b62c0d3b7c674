"""The port's command line: the eigen-zkit commands of eigen_zkvm_tpu/cli.py
(reference: zkit/src/main.rs:232-255) that the port serves, on the card.

Usage: python -m eigen_zkvm_tpu_torch.cli <command> [options]

Commands:
  stark_prove         prove a PIL trace, self-verify, write zkin.json/.circom
  stark_verify        verify a zkin.json proof against PIL + struct + const
  compressor12_setup  verifier circuit (zkin or .r1cs) -> .pil.json/.const/.exec
  compressor12_exec   witness pass -> .cm commit file
  join_zkin           merge two recursive zkin inputs for aggregation
  groth16_setup       circuit-specific SNARK setup -> pk file / vk json
  groth16_prove       SNARK proof of a circuit and its witness
  groth16_verify      verify a SNARK proof json
  bls_wrap            wrap a BN254 Groth16 proof into a BLS12-381 one (the
                      gnark bridge: its verifier circuit, proved)
  generate_verifier   render the Solidity verifier from a vk json
  compile             compile a circom source (supported subset) to
                      .r1cs/.wtns/.sym

The flags, names and output files are the JAX package's, with four
differences:
  - groth16_setup and groth16_prove take --circuit as a circom .r1cs file,
    not a pickle, and groth16_prove takes --witness (.wtns or a JSON list),
    since the JAX package's pickle carries the witness inside the circuit;
    the .r1cs file's prime must be the --curve_type's r (BN128, the
    default, or BLS12381);
  - --pk is the port's proving-key file (groth16/api.py, save_pk /
    load_pk), not a pickle;
  - bls_wrap's --reuse_setup keeps the outer key in output_dir as the
    port's key file (wrap_pk.bin, beside wrap_vk.json), not as a pickle;
  - compressor12_setup keeps, beside the .pil.json, `<pil>.setup.pkl`: the
    inner proof's starkinfo, program and const root (host objects, no
    tensor), its starkStruct and the circuit options, which
    compressor12_exec reads with the .pil.json and the .exec (the JAX
    package pickles its whole StarkSetup and PlonkSetup instead).
stark_prove and stark_verify take a starkStruct of any verificationHashType
the JAX package serves: GL, BN128 or BLS12381 (the big-field Merkle trees
hash on the Poseidon-over-Fr kernel, csrc/poseidon_fr.cu).  stark_prove's
--circom writes the verifier's circom text (stark/pil2circom.py) with
--agg_stage, --norm_stage and --skip_main as the JAX CLI passes them:
--norm_stage is off unless given, so the const root is a constant of the
text by default.
stark_prove, stark_verify, compressor12_setup (for the inner const tree),
groth16_setup, groth16_prove and bls_wrap run on the current CUDA device
and raise without one; their --device flag is for the
tests (--device cpu runs the kernels' plain versions).  groth16_verify,
compressor12_exec, join_zkin, generate_verifier and compile are host work.
`main` returns the exit code: 1 when a verifier rejects.
"""
from __future__ import annotations

import argparse
import json
import pickle
import sys
import time

def _cmd_stark_prove(args) -> int:
    from .stark.prove import stark_prove

    t0 = time.perf_counter()
    stark_prove(args.stark_struct, args.piljson, args.const_pols,
                args.cm_pols, zkin_out=args.output, circom_out=args.circom,
                prover_addr=args.prover_addr, agg_stage=args.agg_stage,
                norm_stage=args.norm_stage, skip_main=args.skip_main,
                device=args.device, prof=args.prof)
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


def _cmd_compressor12_setup(args) -> int:
    """The verifier circuit of an inner proof (its zkin and the inner PIL,
    struct and constants), or a circom .r1cs with custom gates, packed
    into the 12-column PIL: .pil.json, .const and .exec files."""
    from .bench_chain import pil_to_json
    from .recursion.compressor12 import (StarkOption, compressor12_setup,
                                         write_exec_file)
    from .recursion.plonk_setup import PlonkSetup
    from .stark.engine import Engine
    from .stark.polsarray import PolsArray
    from .stark.stark_setup import StarkSetup
    from .stark.types import load_pil, load_starkstruct

    if args.r1cs:
        from types import SimpleNamespace

        from .algebraic.r1cs_file import load_r1cs, r1cs_to_circuit_inputs

        constraints, gates, n_vars, n_pub = r1cs_to_circuit_inputs(
            load_r1cs(args.r1cs))
        shape = SimpleNamespace(constraints=constraints, custom_gates=gates,
                                n_vars=n_vars, n_publics=n_pub)
        psetup = PlonkSetup(shape, force_n_bits=args.force_n_bits)
    else:
        engine = Engine(args.device)
        inner_pil = load_pil(args.inner_pil)
        inner_ss = load_starkstruct(args.inner_struct)
        const_pols = PolsArray(inner_pil, PolsArray.CONSTANT).load(
            args.inner_const)
        setup = StarkSetup(const_pols, inner_pil, inner_ss, engine)
        with open(args.input) as f:
            zkin = json.load(f)
        opt = StarkOption(verkey_input=args.norm_stage,
                          agg_stage=args.agg_stage,
                          skip_main=args.skip_main)
        _, psetup = compressor12_setup(zkin, setup, inner_ss, opt,
                                       force_n_bits=args.force_n_bits)
        inner = {"starkinfo": setup.starkinfo, "program": setup.program,
                 "const_root": [int(x) for x in setup.const_root],
                 "stark_struct": inner_ss, "options": opt}
        with open(args.pil + ".setup.pkl", "wb") as f:
            pickle.dump(inner, f, protocol=pickle.HIGHEST_PROTOCOL)

    with open(args.pil, "w") as f:
        json.dump(pil_to_json(psetup.pil), f)
    psetup.const_pols.save(args.const)
    write_exec_file(args.exec, psetup)
    print(f"compressor12_setup -> {args.pil} / {args.const} / {args.exec} "
          f"(n_bits={psetup.n_bits}, n_used={psetup.n_used})")
    return 0


def _cmd_compressor12_exec(args) -> int:
    """The witness pass of compressor12_setup's circuit on a zkin: the
    12 committed columns as a .cm file."""
    from types import SimpleNamespace

    import numpy as np

    from .recursion.compressor12 import compressor12_exec, read_exec_file
    from .recursion.plonk_setup import PlonkSetup
    from .stark.types import load_pil

    with open(args.pil + ".setup.pkl", "rb") as f:
        inner = pickle.load(f)
    setup = SimpleNamespace(
        starkinfo=inner["starkinfo"], program=inner["program"],
        const_root=np.array(inner["const_root"], dtype=np.uint64))
    adds, s_map = read_exec_file(args.exec)
    psetup = PlonkSetup.from_exec(load_pil(args.pil), adds, s_map)
    with open(args.input) as f:
        zkin = json.load(f)
    cm = compressor12_exec(zkin, setup, inner["stark_struct"],
                           inner["options"], psetup)
    cm.save(args.commit)
    print(f"compressor12_exec -> {args.commit}")
    return 0


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


def _load_circuit(path: str, curve: str = "bn128"):
    """(constraints, n_vars, n_publics) of a .r1cs file over `curve`'s r
    (a groth16/api.py curve name)."""
    from .algebraic.r1cs_file import load_r1cs, r1cs_to_circuit_inputs
    from .groth16.groth16 import curve_of

    r1cs = load_r1cs(path)
    if r1cs.prime != curve_of(curve).fr.modulus:
        raise ValueError(f"{path}: field {r1cs.prime} is not the {curve} "
                         f"scalar field")
    if r1cs.custom_gates or r1cs.custom_gates_uses:
        raise ValueError(f"{path}: custom gates are not R1CS constraints")
    constraints, _, n_vars, n_publics = r1cs_to_circuit_inputs(r1cs)
    return constraints, n_vars, n_publics


def _cmd_groth16_setup(args) -> int:
    from .groth16 import groth16 as core
    from .groth16.api import _curve, save_pk, vk_to_json

    cname = _curve(args.curve_type)
    constraints, n_vars, n_publics = _load_circuit(args.circuit, cname)
    pk, vk = core.setup(constraints, n_vars, n_publics, device=args.device,
                        curve=cname)
    save_pk(args.pk, pk)
    with open(args.vk, "w") as f:
        f.write(vk_to_json(vk, to_hex=args.to_hex))
    print(f"groth16_setup -> {args.pk} / {args.vk}")
    return 0


def _cmd_groth16_prove(args) -> int:
    from .algebraic.witness import load_witness
    from .groth16 import groth16 as core
    from .groth16.api import (_curve, _same_curve, load_pk, proof_to_json,
                              publics_to_json)
    from .utils.profiler import Prof

    cname = _curve(args.curve_type)
    dev = core.resolve_device(args.device)
    prof = args.prof or Prof("cli.groth16_prove", dev)
    constraints, n_vars, n_publics = _load_circuit(args.circuit, cname)
    prof.tick("load r1cs")
    witness = load_witness(args.witness)
    if len(witness) != n_vars:
        raise ValueError(f"{args.witness}: {len(witness)} values for "
                         f"{n_vars} wires")
    prof.tick("load witness")
    pk = load_pk(args.pk, dev)
    _same_curve(cname, pk.curve_name)
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
    from .groth16.api import (_curve, _same_curve, proof_from_json,
                              publics_from_json, vk_from_json)

    cname = _curve(args.curve_type)
    with open(args.vk) as f:
        vk = vk_from_json(f.read())
    _same_curve(cname, vk.curve_name)
    with open(args.proof) as f:
        proof = proof_from_json(f.read())
    with open(args.public_input) as f:
        publics = publics_from_json(f.read())
    ok = core.verify(vk, proof, publics)
    print("groth16_verify:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _cmd_bls_wrap(args) -> int:
    """Wrap a BN254 Groth16 proof into a BLS12-381 Groth16 proof (the
    reference's gnark bridge: recursion-gnark/cli/src/main.rs:32-46,
    ffi/go/eigen/recursion.go:30-82): the inner proof's verifier circuit
    over BLS12-381's r (recursion/gnark_bridge.py), its setup or the key
    kept in output_dir, the prove, a verify of it, then wrap_vk.json,
    wrap_proof.json and wrap_public.json."""
    import os

    from .groth16 import groth16 as core
    from .groth16.api import (_same_curve, load_pk, proof_from_json,
                              proof_to_json, publics_from_json,
                              publics_to_json, save_pk, vk_from_json,
                              vk_to_json)
    from .recursion.gnark_bridge import build_verifier_circuit
    from .utils.profiler import Prof

    dev = core.resolve_device(args.device)
    prof = args.prof or Prof("cli.bls_wrap", dev)
    with open(args.vk) as f:
        ivk = vk_from_json(f.read())
    _same_curve("bn128", ivk.curve_name)
    with open(args.proof) as f:
        iproof = proof_from_json(f.read())
    with open(args.public_input) as f:
        ipubs = publics_from_json(f.read())
    prof.tick("load inner")
    bc = build_verifier_circuit(ivk, iproof, ipubs)
    prof.tick("build")
    print(f"bls_wrap: verifier circuit {len(bc.constraints)} constraints")
    os.makedirs(args.output_dir, exist_ok=True)
    pk_path = os.path.join(args.output_dir, "wrap_pk.bin")
    vk_path = os.path.join(args.output_dir, "wrap_vk.json")
    if args.reuse_setup and os.path.exists(pk_path) \
            and os.path.exists(vk_path):
        opk = load_pk(pk_path, dev)
        with open(vk_path) as f:
            ovk = vk_from_json(f.read())
        _same_curve("bls12381", opk.curve_name)
        if (opk.n_vars, opk.n_public) != (bc.n_vars, bc.n_publics):
            raise ValueError(f"{pk_path} is a key for another circuit")
        prof.tick("load pk")
    else:
        opk, ovk = core.setup(bc.constraints, bc.n_vars, bc.n_publics,
                              rng=args.rng, device=dev, prof=prof,
                              curve="bls12381")
        if args.reuse_setup:
            save_pk(pk_path, opk)
            prof.tick("save pk")
    oproof, opubs = core.prove(opk, bc.constraints, bc.w, rng=args.rng,
                               prof=prof)
    if not core.verify(ovk, oproof, opubs):
        raise RuntimeError("bls_wrap: the outer proof does not verify")
    prof.tick("verify")
    with open(vk_path, "w") as f:
        f.write(vk_to_json(ovk))
    with open(os.path.join(args.output_dir, "wrap_proof.json"), "w") as f:
        f.write(proof_to_json(oproof, "bls12381"))
    with open(os.path.join(args.output_dir, "wrap_public.json"), "w") as f:
        f.write(publics_to_json(opubs))
    print(f"bls_wrap -> {args.output_dir}/wrap_{{vk,proof,public}}.json")
    return 0


def _cmd_generate_verifier(args) -> int:
    from .groth16.api import generate_verifier

    generate_verifier(args.vk, args.sol)
    print(f"generate_verifier -> {args.sol}")
    return 0


def compile_files(text: str, inputs: dict, prime: int, base: str,
                  opt: int = 2, search_paths=(), prof=None):
    """Compile a circom source (the subset dsl/circom.py parses) with the
    given inputs, simplify it at `opt` (0: not at all), and write its
    .r1cs, .wtns and .sym files at `base`; `prof` gets a tick after each
    of the three steps.  (the builder, simplify's statistics or None)"""
    from .algebraic.r1cs_file import circuit_to_r1cs, save_r1cs
    from .algebraic.witness import save_witness
    from .dsl.elaborate import compile_circom, write_sym
    from .dsl.simplify import simplify

    circuit = compile_circom(text, inputs, search_paths=search_paths,
                             prime=prime)
    if prof:
        prof.tick("compile")
    stats = simplify(circuit, level=opt) if opt else None
    if prof:
        prof.tick(f"simplify O{opt}")
    save_r1cs(base + ".r1cs", circuit_to_r1cs(circuit))
    save_witness(base + ".wtns", circuit.w, circuit.P)
    write_sym(circuit, base + ".sym")
    if prof:
        prof.tick("write")
    return circuit, stats


def _cmd_compile(args) -> int:
    from .algebraic.r1cs_file import BLS12381_R, BN254_R

    prime = {"goldilocks": 0xFFFFFFFF00000001, "bn128": BN254_R,
             "bls12381": BLS12381_R}[args.prime]
    inputs = {}
    if args.input:
        with open(args.input) as f:
            inputs = {k: int(v) if not isinstance(v, list) else v
                      for k, v in json.load(f).items()}
    with open(args.circuit) as f:
        src_text = f.read()
    base = args.output or args.circuit.rsplit(".", 1)[0]
    circuit, st = compile_files(src_text, inputs, prime, base, args.opt,
                                args.link or [])
    if st:
        print(f"simplify O{args.opt}: {st['constraints_before']} -> "
              f"{st['constraints_after']} constraints, "
              f"{st['signals_before']} -> {st['signals_after']} signals")
    print(f"compile -> {base}.r1cs / {base}.wtns / {base}.sym "
          f"({len(circuit.constraints)} constraints, {circuit.n_vars} wires)")
    return 0


def _device_flag(p):
    p.add_argument("--device", default=None,
                   help="for the tests: 'cpu' runs the kernels' plain "
                        "versions (default: the current CUDA device)")


def main(argv=None, prof=None, rng=None) -> int:
    """Run one command; returns its exit code.  `prof` (utils/profiler.Prof)
    receives stark_prove's, groth16_prove's and bls_wrap's stage ticks
    (groth16_prove: the file loads, then the prover's own; bls_wrap: the
    inner files' load, the circuit's build, setup's, prove's, the verify).
    `rng` is the source of bls_wrap's setup and prove draws, setup first
    (None: `secrets`, as the JAX CLI draws)."""
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
    p.add_argument("--circom", help="verifier .circom output")
    p.add_argument("--prover_addr", default="")
    p.add_argument("--agg_stage", action="store_true")
    p.add_argument("--norm_stage", action="store_true")
    p.add_argument("--skip_main", action="store_true")
    _device_flag(p)
    p.set_defaults(func=_cmd_stark_prove)

    p = sub.add_parser("stark_verify", help="verify a zkin.json proof")
    p.add_argument("--stark_struct", "-s", required=True)
    p.add_argument("--piljson", "-p", required=True)
    p.add_argument("--const_pols", "-c", required=True)
    p.add_argument("--proof", "-f", required=True)
    _device_flag(p)
    p.set_defaults(func=_cmd_stark_verify)

    p = sub.add_parser("compressor12_setup",
                       help="verifier circuit -> c12 PIL/const/exec")
    p.add_argument("--r1cs", "-r", help="circom .r1cs input (interop path)")
    p.add_argument("--input", "-i", help="inner proof zkin.json (native path)")
    p.add_argument("--inner_pil", help="inner PIL json (native path)")
    p.add_argument("--inner_struct", help="inner starkStruct (native path)")
    p.add_argument("--inner_const", help="inner .const (native path)")
    p.add_argument("--pil", "-p", required=True, help="output c12 .pil.json")
    p.add_argument("--const", "-c", required=True, help="output .const")
    p.add_argument("--exec", "-e", required=True, help="output .exec")
    p.add_argument("--force_n_bits", "--force-n-bits", type=int, default=0)
    p.add_argument("--norm_stage", action="store_true")
    p.add_argument("--agg_stage", action="store_true")
    p.add_argument("--skip_main", action="store_true")
    _device_flag(p)
    p.set_defaults(func=_cmd_compressor12_setup)

    p = sub.add_parser("compressor12_exec", help="witness pass -> .cm")
    p.add_argument("--input", "-i", required=True, help="zkin.json")
    p.add_argument("--pil", "-p", required=True)
    p.add_argument("--exec", "-e", required=True)
    p.add_argument("--commit", "-m", required=True, help="output .cm")
    p.set_defaults(func=_cmd_compressor12_exec)

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

    p = sub.add_parser("bls_wrap", help="wrap a BN254 Groth16 proof into a "
                       "BLS12-381 Groth16 proof (gnark-bridge equivalent)")
    p.add_argument("--vk", required=True)
    p.add_argument("--proof", required=True)
    p.add_argument("--public_input", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--reuse_setup", action="store_true",
                   help="cache/reuse the outer setup in output_dir")
    _device_flag(p)
    p.set_defaults(func=_cmd_bls_wrap)

    p = sub.add_parser("generate_verifier")
    p.add_argument("--vk", required=True)
    p.add_argument("--sol", required=True)
    p.set_defaults(func=_cmd_generate_verifier)

    p = sub.add_parser("compile",
                       help="compile a circom source (supported subset)")
    p.add_argument("--circuit", "-i", required=True, help=".circom source")
    p.add_argument("--prime", "-p", default="bn128",
                   choices=["bn128", "bls12381", "goldilocks"])
    p.add_argument("--input", help="inputs json (for the witness)")
    p.add_argument("--link", "-l", action="append", help="include dirs")
    p.add_argument("--output", "-o", help="output basename")
    p.add_argument("--opt", "-O", type=int, default=2, choices=[0, 1, 2],
                   help="constraint simplification level (circom "
                        "--O0/--O1/--O2; default O2, like circom)")
    p.set_defaults(func=_cmd_compile)

    args = ap.parse_args(argv)
    args.prof = prof
    args.rng = rng
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
