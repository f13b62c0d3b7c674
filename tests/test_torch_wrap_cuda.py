"""The final BN128 layer and the Groth16 wrap of the port on the card
(marked cuda; skipped without one), and the JAX host engine's digests they
are held to (marked slow).  The card test imports nothing of JAX: run it on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_wrap_cuda.py

The fibonacci AIR at 2^10 rows and 2 queries (examples/fibonacci.py, inputs
(1, 2)) is proved on the card under the GL hash, then
bench_e2e.final_layer proves its verifier circuit under BN128 (2^13 rows)
and bench_e2e.snark_wrap builds the BN254 circuit that verifies that proof
and runs Groth16 setup (draws from
bench_groth16.seeded(bench_e2e.G16_SEED)), prove (seeded(G16_SEED + 1))
and verify on the card.  The final layer launches
the NTT and Poseidon-Fr kernels, the wrap the four Groth16 kernels; the
final zkin, the circuit (bench_e2e.circuit_sha256), the proof JSON and the
Solidity verifier are the JAX package's host engine's (FIB_WRAP_SHA256;
`test_host_engine_gives_the_pinned_fibonacci_wrap_digests` recomputes them
on the CPU, and `test_host_engine_gives_the_pinned_wrap_digests` those of
chip_smoke.py's phase 11, the ecrecover chain's).
"""
import hashlib
import importlib.util
import os

import pytest
import torch

FIB_NBITS, FIB_QUERIES = 10, 2
FIB_WRAP_CONSTRAINTS = 1_074_873
FIB_WRAP_SHA256 = {
    "final zkin":
        "60f630e068798aae3f3de8f2a4474e3493d92d7a880d7914aa27fd2db0235e1a",
    "circuit":
        "40105dba192573f269753e0dd917c9ad6b159d571fea3b5b1b11ac144a70262c",
    "proof":
        "4c1c31f2f3554d4599695e6e29174f8f1b18ab047b686c6a9c45f6293e565a02",
    "verifier.sol":
        "28df934cd1441769aee6dec66cc31d7c43c919dc3bd3e9c2ee3259cefa26c679",
}


def _smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fib_struct(mod):
    return mod.StarkStruct(nBits=FIB_NBITS, nBitsExt=FIB_NBITS + 1,
                           nQueries=FIB_QUERIES, verificationHashType="GL",
                           steps=[mod.Step(FIB_NBITS + 1), mod.Step(5)])


@pytest.mark.cuda
def test_fibonacci_final_layer_and_wrap_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eigen_zkvm_tpu_torch import bench_e2e, bench_groth16, kernels
    from eigen_zkvm_tpu_torch.examples import fibonacci
    from eigen_zkvm_tpu_torch.stark import types
    from eigen_zkvm_tpu_torch.stark.engine import Engine
    from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

    engine = Engine()
    pil, cp, mk = fibonacci.build(FIB_NBITS)
    ss = _fib_struct(types)
    setup = StarkSetup(cp, pil, ss, engine)
    zkin = stark_proof_to_dict(stark_gen(
        mk((1, 2)), cp, setup.const_tree, setup.starkinfo, setup.program, ss,
        engine=engine), "GL")
    kernels.reset_counts()
    zkin4, setup4, ss4, _ = bench_e2e.final_layer(zkin, setup, ss,
                                                  engine=engine)
    final = kernels.counts()
    kernels.reset_counts()
    wrap = bench_e2e.snark_wrap(
        zkin4, setup4, ss4,
        rng_setup=bench_groth16.seeded(bench_e2e.G16_SEED),
        rng_prove=bench_groth16.seeded(bench_e2e.G16_SEED + 1))
    launches = kernels.counts()
    print(f"final layer launches {final}; wrap launches {launches}; "
          f"{len(wrap.circuit.constraints)} constraints")
    assert final[kernels.NTT.name] > 0 and final[kernels.POSEIDON_FR.name] > 0
    assert all(launches[k.name] > 0 for k in (
        kernels.MSM, kernels.EC_BATCH, kernels.FR_NTT, kernels.R1CS))
    assert wrap.verified and wrap.tampered_rejected
    assert wrap.publics == [bench_e2e.publics_hash(zkin4)]
    assert len(wrap.circuit.constraints) == FIB_WRAP_CONSTRAINTS
    got = bench_e2e.wrap_digests(zkin4, wrap)
    assert got == FIB_WRAP_SHA256, got


def _host_wrap(zkin, setup, ss, queries: int) -> tuple:
    """scripts/zkvm_e2e.py:177-220 on the JAX package's host engine, over
    a GL proof: the final BN128 layer, build_final_main, check, Groth16
    setup (seeded(G16_SEED)), prove (seeded(G16_SEED + 1)) and verify.
    (bench_e2e.wrap_digests's dict, constraint count, public)."""
    from eigen_zkvm_tpu.curves import bn254 as j_bn254
    from eigen_zkvm_tpu.groth16 import api as j_api
    from eigen_zkvm_tpu.groth16 import groth16 as j_g16
    from eigen_zkvm_tpu.hash import poseidon_bn128 as j_pbn
    from eigen_zkvm_tpu.recursion import compressor12 as j_c12
    from eigen_zkvm_tpu.recursion.stark_verifier_circuit_bn import \
        build_final_main
    from eigen_zkvm_tpu.stark import types as j_types
    from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu.stark.stark_setup import StarkSetup
    from eigen_zkvm_tpu.stark.stark_verify import stark_verify
    from eigen_zkvm_tpu_torch import bench_e2e, bench_groth16
    from eigen_zkvm_tpu_torch.bench_recursion import zkin_sha256

    circuit4, ps4 = j_c12.compressor12_setup(
        zkin, setup, ss, j_c12.StarkOption(verkey_input=True))
    cm4 = j_c12.exec_witness(circuit4, ps4)
    steps = []
    nb = ps4.n_bits + 1
    while nb > 5:
        steps.append(j_types.Step(nb))
        nb -= 4
    steps.append(j_types.Step(nb))
    ss4 = j_types.StarkStruct(nBits=ps4.n_bits, nBitsExt=ps4.n_bits + 1,
                              nQueries=queries, verificationHashType="BN128",
                              steps=steps)
    setup4 = StarkSetup(ps4.const_pols, ps4.pil, ss4)
    p4 = stark_gen(cm4, ps4.const_pols, setup4.const_tree, setup4.starkinfo,
                   setup4.program, ss4)
    assert stark_verify(p4, setup4.const_root, setup4.starkinfo, ss4,
                        setup4.program)
    zkin4 = stark_proof_to_dict(p4, "BN128")
    sn = setup4.starkinfo.map_sectionsN
    print(f"final layer: 2^{ps4.n_bits} rows, {ps4.pil.nConstants} "
          f"constants, sections {[sn.get(f'cm{i}_2ns') for i in range(1, 5)]}"
          f", steps {[s.nBits for s in steps]}", flush=True)
    del cm4, circuit4
    b = build_final_main(zkin4, setup4.starkinfo, setup4.program, ss4,
                         setup4.const_root, j_pbn, curve_r=j_bn254.R)
    assert b.check()
    pk, vk = j_g16.setup(j_bn254, b.constraints, b.n_vars, b.n_publics,
                         rng=bench_groth16.seeded(bench_e2e.G16_SEED))
    proof, pubs = j_g16.prove(j_bn254, pk, b.constraints, b.w,
                              rng=bench_groth16.seeded(bench_e2e.G16_SEED + 1))
    assert j_g16.verify(j_bn254, vk, proof, pubs)
    assert not j_g16.verify(j_bn254, vk, proof,
                            [(pubs[0] + 1) % j_bn254.R])
    assert pubs == [bench_e2e.publics_hash(zkin4)]
    digests = {
        "final zkin": zkin_sha256(zkin4),
        "circuit": bench_e2e.circuit_sha256(b),
        "proof": hashlib.sha256(
            j_api.proof_to_json(proof, "bn128").encode()).hexdigest(),
        "verifier.sol": hashlib.sha256(
            j_api.generate_verifier_from_vk(vk).encode()).hexdigest()}
    return digests, len(b.constraints), pubs[0]


@pytest.mark.slow
def test_host_engine_gives_the_pinned_fibonacci_wrap_digests(monkeypatch):
    """FIB_WRAP_SHA256: the JAX package's host engine over the same
    fibonacci proof, printed."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    from eigen_zkvm_tpu.examples import fibonacci as j_fib
    from eigen_zkvm_tpu.stark import types as j_types
    from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu.stark.stark_setup import StarkSetup

    pil, cp, mk = j_fib.build(FIB_NBITS)
    ss = _fib_struct(j_types)
    setup = StarkSetup(cp, pil, ss)
    zkin = stark_proof_to_dict(stark_gen(
        mk((1, 2)), cp, setup.const_tree, setup.starkinfo, setup.program,
        ss), "GL")
    got, n_constraints, _ = _host_wrap(zkin, setup, ss, FIB_QUERIES)
    print(got, n_constraints)
    assert got == FIB_WRAP_SHA256
    assert n_constraints == FIB_WRAP_CONSTRAINTS


@pytest.mark.slow
def test_host_engine_gives_the_pinned_wrap_digests(monkeypatch):
    """chip_smoke.py's WRAP_SHA256 and WRAP_CONSTRAINTS: the JAX package's
    host engine proves the ecrecover guest's chunks 0 and 1
    (default_struct(16, 4)), then c12, recursive1 at 2^18 and the chained
    aggregation of the two, 4 queries each (scripts/zkvm_e2e.py:135-170),
    then the final layer and the wrap (:177-220); printed.  About twenty
    minutes and 25 GB on the CPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    from eigen_zkvm_tpu.recursion import aggregation as j_agg
    from eigen_zkvm_tpu.recursion import compressor12 as j_c12
    from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu.stark.stark_setup import StarkSetup
    from eigen_zkvm_tpu.zkvm import elf as j_elf
    from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
    from eigen_zkvm_tpu.zkvm import rv32_native as j_native
    from eigen_zkvm_tpu.zkvm.lib import default_struct
    from eigen_zkvm_tpu_torch import bench_zkvm

    smoke = _smoke()
    q, force = smoke.RECURSION_QUERIES, smoke.RECURSION_FORCE
    program, entry, image0, ram_words, mem_base = j_elf.load_elf(
        bench_zkvm.read_guest(), include_exec_in_image=False)
    nc = j_native.NativeChunker(program, entry, n_bits=bench_zkvm.NBITS,
                                ram_words=ram_words, image0=image0,
                                mem_base=mem_base)
    m = j_rv32.Rv32Machine(program, bench_zkvm.NBITS, ram_words=ram_words,
                           mem_base=mem_base)
    ss = default_struct(bench_zkvm.NBITS, q)
    setup = StarkSetup(m.const_pols, m.pil, ss)
    r1 = []
    for k in smoke.ZKVM_CHUNKS:
        states, image_in = nc.states_for(k)
        z = stark_proof_to_dict(stark_gen(
            m.trace(states, image_in=image_in), m.const_pols,
            setup.const_tree, setup.starkinfo, setup.program, ss), "GL")
        del states
        proof, (st, c_ss, _) = j_c12.prove_compressed(
            z, setup, ss, j_c12.StarkOption(skip_main=True), n_queries=q)
        proof, (r1_setup, r1_ss, _) = j_c12.prove_compressed(
            stark_proof_to_dict(proof, "GL"), st, c_ss, j_c12.StarkOption(),
            n_queries=q, force_n_bits=force)
        r1.append(stark_proof_to_dict(proof, "GL"))
        print(f"chunk {k} through recursive1", flush=True)
    final, (agg_setup, agg_ss, _) = j_agg.aggregate_recursive1(
        r1, r1_setup, r1_ss, force_n_bits=force, n_queries=q,
        chain_map=j_c12.ChainMap.for_machine(m))
    print("aggregated", flush=True)
    del setup, nc
    got, n_constraints, _ = _host_wrap(final, agg_setup, agg_ss, q)
    print(got, n_constraints)
    assert got == smoke.WRAP_SHA256
    assert n_constraints == smoke.WRAP_CONSTRAINTS
