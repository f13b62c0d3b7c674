"""The port's snark-field gadgets (eigen_zkvm_tpu_torch/recursion/gl_in_fr.py)
and the final layer's struct on the CPU, against the JAX package's,
tolerance 0: every value is a field element.

Each gadget runs on both packages' CircuitBuilder over the same seeded
inputs: its value is the port's host function's (ops/f3.py, the host
Poseidon-over-Fr hashes, hash/transcript_big.py, hashlib), and the port's
constraints and witness are the JAX builder's.  `final_struct`'s steps are
scripts/zkvm_e2e.py's; `final_layer` and `snark_wrap` raise without a card
unless given the CPU.  build_final_main and the final layer on a proof are
in test_torch_wrap_final.py, the wrap on the card in test_torch_wrap_cuda.py.
"""
import hashlib
import random

import pytest
import torch

from eigen_zkvm_tpu.curves import bls12_381 as j_bls
from eigen_zkvm_tpu.curves import bn254 as j_bn254
from eigen_zkvm_tpu.hash import poseidon_bls12381 as j_pbls
from eigen_zkvm_tpu.hash import poseidon_bn128 as j_pbn
from eigen_zkvm_tpu.recursion import circuit as j_circuit
from eigen_zkvm_tpu.recursion import gl_in_fr as j_gl_in_fr
from eigen_zkvm_tpu_torch import bench_e2e
from eigen_zkvm_tpu_torch.curves import bn254
from eigen_zkvm_tpu_torch.hash import poseidon_bls12381, poseidon_bn128
from eigen_zkvm_tpu_torch.hash.transcript_big import (TranscriptBLS12381,
                                                      TranscriptBN128)
from eigen_zkvm_tpu_torch.ops import bigint, f3
from eigen_zkvm_tpu_torch.recursion import circuit, gl_in_fr

GL_P = gl_in_fr.GL_P
R_BLS = bigint.FR_BLS.modulus
# (port hash module, JAX hash module, r, port transcript)
FIELDS = {"BN128": (poseidon_bn128, j_pbn, bn254.R, TranscriptBN128),
          "BLS12381": (poseidon_bls12381, j_pbls, R_BLS, TranscriptBLS12381)}


def test_the_snark_fields_are_the_jax_packages():
    assert bn254.R == j_bn254.R and R_BLS == j_bls.R
    assert gl_in_fr.GL_P == j_gl_in_fr.GL_P


def _both(fn, r: int = bn254.R):
    """fn(builder, gadget module) on the port's builder and on the JAX
    package's, over the snark field r: (port builder, port result)."""
    b = circuit.CircuitBuilder(prime=r)
    got = fn(b, gl_in_fr)
    jb = j_circuit.CircuitBuilder(prime=r)
    fn(jb, j_gl_in_fr)
    assert b.constraints == jb.constraints
    assert b.w == jb.w
    assert b.n_publics == jb.n_publics
    return b, got


def test_gl_f3_mul_inv_and_base_ops():
    rng = random.Random(11)
    av = tuple(rng.randrange(GL_P) for _ in range(3))
    bv = tuple(rng.randrange(GL_P) for _ in range(3))
    xv = rng.randrange(1, GL_P)

    def gadget(b, mod):
        gl = mod.GlCircuit(b)
        a3, b3 = gl.f3_input(av), gl.f3_input(bv)
        prod = gl.f3_mul(a3, b3)
        muladd = gl.f3_mul(a3, b3, gl.f3_const(7, 8, 9))
        inv = gl.f3_inv(a3)
        x = gl.input64(xv)
        xi = gl.inv(x)
        one = gl.mul(x, xi)
        y = gl.norm(gl.sub(gl.scale(x, GL_P - 3), gl.const(5)))
        bit = b.bits(b.wire(b.sig(1)), 1, strict=False)[0]
        m = gl.mux(bit, x, y)
        gl.assert_eq(gl.norm(m), y)
        return [tuple(v.ival % GL_P for v in t)
                for t in (prod, muladd, inv)] + [one.ival, y.ival]

    b, got = _both(gadget)
    assert got[0] == f3.mul_int(av, bv)
    assert got[1] == f3.add_int(f3.mul_int(av, bv), (7, 8, 9))
    assert got[2] == f3.inv_int(av)
    assert got[3] == 1
    assert got[4] == (-3 * xv - 5) % GL_P
    assert b.check()


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_poseidon_fr_circuit_every_width(field):
    """hash_ex at t = 2..17 (the 16-ary tree's widths and the sponge's
    partial groups), against the host hash; the orientation of M and Pm
    comes from PoseidonBig.tables()."""
    pmod, jmod, r, _ = FIELDS[field]
    rng = random.Random(12)
    ins = {t: ([rng.randrange(r) for _ in range(t - 1)], rng.randrange(r))
           for t in range(2, 18)}

    def gadget(b, mod):
        pos = mod.PoseidonFrCircuit(b, pmod if mod is gl_in_fr else jmod)
        out = {}
        for t, (inp, init) in ins.items():
            ws = [b.wire(b.sig(v)) for v in inp]
            out[t] = [b.val(o) for o in pos.hash_ex(ws, b.wire(b.sig(init)),
                                                     t)]
            out[t].append(b.val(pos.hash_fr(ws, b.W())))
        return out

    b, got = _both(gadget, r)
    for t, (inp, init) in ins.items():
        assert got[t][:-1] == pmod.hash_ex(inp, init, t)
        assert got[t][-1] == pmod.hash_fr(inp, 0)
    assert b.check()


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_transcript_big_circuit(field):
    pmod, jmod, r, Transcript = FIELDS[field]
    rng = random.Random(13)
    vals = [rng.randrange(GL_P) for _ in range(21)]

    def gadget(b, mod):
        gl = mod.GlCircuit(b)
        pos = mod.PoseidonFrCircuit(b, pmod if mod is gl_in_fr else jmod)
        tc = mod.TranscriptBigCircuit(b, pos, gl)
        for v in vals[:5]:
            tc.put(b.wire(b.sig(v)))
        ch = [c.ival % GL_P for c in tc.get_field()]
        for v in vals[5:]:
            tc.put(b.wire(b.sig(v)))
        ch2 = [c.ival % GL_P for c in tc.get_field()]
        f253 = b.val(tc.get_fields253())
        perms = [sum(b.val(bit) << i for i, bit in enumerate(bits))
                 for bits in tc.get_permutations(3, 11)]
        return ch, ch2, f253, perms

    b, (ch, ch2, f253, perms) = _both(gadget, r)
    tn = Transcript()
    tn.put_elements(vals[:5])
    assert ch == [int(x) for x in tn.get_field()]
    tn.put_elements(vals[5:])
    assert ch2 == [int(x) for x in tn.get_field()]
    assert f253 == tn._get_fields253()
    assert perms == tn.get_permutations(3, 11)
    assert b.check()


@pytest.mark.parametrize("n_bytes", [0, 52, 55, 64, 100])
def test_sha256_gadget(n_bytes):
    """The message lengths around the padding's block edges."""
    rng = random.Random(n_bytes)
    msg = bytes(rng.randrange(256) for _ in range(n_bytes))

    def gadget(b, mod):
        bits = [b.wire(b.sig((byte >> i) & 1)) for byte in msg
                for i in range(7, -1, -1)]
        digest = 0
        for bit in mod.sha256_bits(b, bits):
            digest = (digest << 1) | b.val(bit)
        return digest

    b, got = _both(gadget)
    assert got == int.from_bytes(hashlib.sha256(msg).digest(), "big")
    assert b.check()


def test_assert_lt_const_at_the_edge():
    def gadget(b, mod):
        bits = b.bits(b.wire(b.sig(GL_P - 1)), 64, strict=False)
        mod._assert_lt_const(b, bits, GL_P)    # GL_P - 1 < GL_P holds

    b, _ = _both(gadget)
    assert b.check()
    for mod, Builder in ((gl_in_fr, circuit.CircuitBuilder),
                         (j_gl_in_fr, j_circuit.CircuitBuilder)):
        b = Builder(prime=bn254.R)
        bits = b.bits(b.wire(b.sig(GL_P)), 64, strict=False)
        with pytest.raises(AssertionError):
            mod._assert_lt_const(b, bits, GL_P)


def test_a_tampered_witness_fails_check():
    rng = random.Random(14)
    b = circuit.CircuitBuilder(prime=bn254.R)
    gl = gl_in_fr.GlCircuit(b)
    a3 = gl.f3_input([rng.randrange(GL_P) for _ in range(3)])
    gl.f3_inv(a3)
    assert b.check()
    b.w[5] = (b.w[5] + 1) % bn254.R
    assert not b.check()


def _reference_steps(n_bits: int) -> list[int]:
    """scripts/zkvm_e2e.py:182-187."""
    steps = []
    nb = n_bits + 1
    while nb > 5:
        steps.append(nb)
        nb -= 4
    steps.append(nb)
    return steps


@pytest.mark.parametrize("n_bits", range(5, 21))
def test_final_struct_steps(n_bits):
    ss = bench_e2e.final_struct(n_bits, 4)
    assert [s.nBits for s in ss.steps] == _reference_steps(n_bits)
    assert (ss.nBits, ss.nBitsExt, ss.nQueries, ss.verificationHashType) \
        == (n_bits, n_bits + 1, 4, "BN128")


def test_final_layer_and_wrap_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_e2e.final_layer({}, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_e2e.snark_wrap({}, None, None)
