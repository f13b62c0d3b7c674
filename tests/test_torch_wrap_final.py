"""The port's on-chain verifier circuit
(eigen_zkvm_tpu_torch/recursion/stark_verifier_circuit_bn.py) and final
layer (bench_e2e.final_layer) on the CPU, against the JAX package's,
tolerance 0: every value is a field element.

On big-field proofs of the fibonacci AIR (examples/fibonacci.py, both
packages' copies) at 2^10 rows, 2 queries, FRI steps 11 and 5, with a
prover address: the port's proof is the JAX host engine's, and
build_final_main over it gives the JAX package's constraints, wire count,
publics and witness, for BN254 (BN128 proof) and for BLS12-381 (BLS12381
proof, `curve_r`); check() holds, a tampered witness fails it, and the one
public is sha256(proverAddr || publics) mod r.  Then the final layer of
the smallest GL fibonacci proof (2^5 rows, 1 query, FRI steps 6 and 3:
compressor12 with verkey_input at 2^11 rows, BN128 struct of
bench_e2e.final_struct): its zkin is the JAX host engine's, byte for byte,
and its circuit the JAX package's.  (The final layer of the 2^10 proof,
2^13 rows, is tests/test_torch_wrap_cuda.py's, on the card.)  The JAX
package proves on its host engine (EIGEN_ZKVM_ENGINE=host); the port on
Engine("cpu"), one torch thread.
"""
import json

import pytest
import torch

from eigen_zkvm_tpu.curves import bls12_381 as j_bls
from eigen_zkvm_tpu.curves import bn254 as j_bn254
from eigen_zkvm_tpu.examples import fibonacci as j_fib
from eigen_zkvm_tpu.hash import poseidon_bls12381 as j_pbls
from eigen_zkvm_tpu.hash import poseidon_bn128 as j_pbn
from eigen_zkvm_tpu.recursion import compressor12 as j_c12
from eigen_zkvm_tpu.recursion import stark_verifier_circuit_bn as j_svc
from eigen_zkvm_tpu.stark import stark_gen as j_gen
from eigen_zkvm_tpu.stark import stark_setup as j_setup
from eigen_zkvm_tpu.stark import stark_verify as j_verify
from eigen_zkvm_tpu.stark import types as j_types
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict as j_dict
from eigen_zkvm_tpu_torch import bench_e2e
from eigen_zkvm_tpu_torch.curves import bn254
from eigen_zkvm_tpu_torch.examples import fibonacci
from eigen_zkvm_tpu_torch.hash import poseidon_bls12381, poseidon_bn128
from eigen_zkvm_tpu_torch.ops import bigint
from eigen_zkvm_tpu_torch.recursion.stark_verifier_circuit_bn import \
    build_final_main
from eigen_zkvm_tpu_torch.stark import types
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_dict
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

FIB_NBITS, FIB_QUERIES = 10, 2
SMALL = (5, 1, (6, 3))   # the final layer's input: nBits, queries, steps
ADDR = "0x2ab9a8a45559e7bc6e29a1b1af63824b0b6b4d99"
CPU = Engine("cpu")
# hash type -> (port hash module, JAX hash module, r)
CURVES = {"BN128": (poseidon_bn128, j_pbn, bn254.R),
          "BLS12381": (poseidon_bls12381, j_pbls, bigint.FR_BLS.modulus)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, so as not to contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _host_engine():
    """The JAX package's host engine: it never probes for a TPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EIGEN_ZKVM_ENGINE", "host")
        yield


def fib_struct(mod, hash_type: str, n_bits: int = FIB_NBITS,
               queries: int = FIB_QUERIES, steps=(FIB_NBITS + 1, 5)):
    """2^n_bits -> 2^(n_bits + 1) rows (2^10, FIB_QUERIES queries and FRI
    steps 11 and 5 by default), in the JAX package's or the port's
    types."""
    return mod.StarkStruct(nBits=n_bits, nBitsExt=n_bits + 1,
                           nQueries=queries, verificationHashType=hash_type,
                           steps=[mod.Step(s) for s in steps])


class FibProof:
    """The fibonacci proof of both packages under one hash type, with
    their setups and structs (`shape`: fib_struct's n_bits, queries,
    steps)."""

    def __init__(self, hash_type: str, prover_addr: str = "",
                 shape=(FIB_NBITS, FIB_QUERIES, (FIB_NBITS + 1, 5))):
        n_bits = shape[0]
        pil, cp, mk = j_fib.build(n_bits)
        self.j_ss = fib_struct(j_types, hash_type, *shape)
        self.j_setup = j_setup.StarkSetup(cp, pil, self.j_ss)
        self.j_zkin = j_dict(j_gen.stark_gen(
            mk((1, 2)), cp, self.j_setup.const_tree, self.j_setup.starkinfo,
            self.j_setup.program, self.j_ss, prover_addr=prover_addr),
            hash_type)
        pil, cp, mk = fibonacci.build(n_bits)
        self.ss = fib_struct(types, hash_type, *shape)
        self.setup = StarkSetup(cp, pil, self.ss, CPU)
        self.zkin = stark_proof_to_dict(stark_gen(
            mk((1, 2)), cp, self.setup.const_tree, self.setup.starkinfo,
            self.setup.program, self.ss, engine=CPU,
            prover_addr=prover_addr), hash_type)


def _circuits(zkin, setup, ss, j_zkin, j_setup_, j_ss, hash_type):
    """build_final_main of both packages: (port builder, JAX builder)."""
    pmod, jmod, r = CURVES[hash_type]
    b = build_final_main(zkin, setup.starkinfo, setup.program, ss,
                         setup.const_root, pmod, curve_r=r)
    jb = j_svc.build_final_main(j_zkin, j_setup_.starkinfo, j_setup_.program,
                                j_ss, j_setup_.const_root, jmod, curve_r=r)
    return b, jb


def _assert_same_circuit(b, jb):
    assert b.n_vars == jb.n_vars
    assert b.n_publics == jb.n_publics == 1
    assert len(b.constraints) == len(jb.constraints)
    assert b.constraints == jb.constraints
    assert b.w == jb.w


@pytest.mark.parametrize("hash_type", sorted(CURVES))
def test_build_final_main_is_the_jax_packages(hash_type):
    assert CURVES["BLS12381"][2] == j_bls.R and bn254.R == j_bn254.R
    fib = FibProof(hash_type, ADDR)
    assert fib.zkin == fib.j_zkin
    assert str(fib.setup.const_root) == str(fib.j_setup.const_root)
    b, jb = _circuits(fib.zkin, fib.setup, fib.ss, fib.j_zkin, fib.j_setup,
                      fib.j_ss, hash_type)
    _assert_same_circuit(b, jb)
    del jb
    r = CURVES[hash_type][2]
    assert b.w[1] == bench_e2e.publics_hash(fib.zkin, r)
    assert b.check()
    b.w[5] = (b.w[5] + 1) % r
    assert not b.check()


def test_final_layer_is_the_jax_host_engines():
    """The final layer of the smallest GL fibonacci proof: the port's on
    the CPU against the JAX host engine's (scripts/zkvm_e2e.py:177-198),
    then the wrap's circuit over both."""
    fib_gl = FibProof("GL", shape=SMALL)
    assert fib_gl.zkin == fib_gl.j_zkin
    zkin4, setup4, ss4, ps4 = bench_e2e.final_layer(
        fib_gl.zkin, fib_gl.setup, fib_gl.ss, engine=CPU)
    circuit4, jps4 = j_c12.compressor12_setup(
        fib_gl.j_zkin, fib_gl.j_setup, fib_gl.j_ss,
        j_c12.StarkOption(verkey_input=True))
    cm4 = j_c12.exec_witness(circuit4, jps4)
    steps = []
    nb = jps4.n_bits + 1
    while nb > 5:
        steps.append(j_types.Step(nb))
        nb -= 4
    steps.append(j_types.Step(nb))
    j_ss4 = j_types.StarkStruct(
        nBits=jps4.n_bits, nBitsExt=jps4.n_bits + 1, nQueries=SMALL[1],
        verificationHashType="BN128", steps=steps)
    j_setup4 = j_setup.StarkSetup(jps4.const_pols, jps4.pil, j_ss4)
    p4 = j_gen.stark_gen(cm4, jps4.const_pols, j_setup4.const_tree,
                         j_setup4.starkinfo, j_setup4.program, j_ss4)
    assert j_verify.stark_verify(p4, j_setup4.const_root, j_setup4.starkinfo,
                                 j_ss4, j_setup4.program)
    j_zkin4 = j_dict(p4, "BN128")
    assert ps4.n_bits == jps4.n_bits
    assert [s.nBits for s in ss4.steps] == [s.nBits for s in j_ss4.steps]
    sn = setup4.starkinfo.map_sectionsN
    print(f"final layer: 2^{ps4.n_bits} rows, sections "
          f"{[sn.get(f'cm{i}_2ns') for i in range(1, 5)]}, "
          f"{ps4.pil.nConstants} constants")
    assert json.dumps(zkin4) == json.dumps(j_zkin4)
    b, jb = _circuits(zkin4, setup4, ss4, j_zkin4, j_setup4, j_ss4, "BN128")
    _assert_same_circuit(b, jb)
    del jb
    assert b.w[1] == bench_e2e.publics_hash(zkin4)
    assert b.check()
