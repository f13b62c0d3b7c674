"""The port's BLS12-381 Groth16 (eigen_zkvm_tpu_torch at curve "bls12381")
against the JAX package's on the CPU, exactly (field arithmetic: tolerance
0).  Each layer on seeded inputs: the 12-limb base field Fq381 and its Fq2
against Python ints on the edge operands (0, 1, q - 1, q - 2, R mod q) and
random pairs; the G1 / G2 point formulas, the MSM (the plain Pippenger
stages and the double-and-add) and the fixed-base batch against
eigen_zkvm_tpu's curves/bls12_381.py, curves/msm.py and
groth16._fixed_base_all; the Fr NTT at BLS12-381's r against groth16._ntt /
_intt and _witness_h's coset steps; the R1CS rows; then setup, prove and
verify against eigen_zkvm_tpu.groth16 with the same seeded draws (keys
point for point, the proof JSON byte for byte, each verifier on the
other's proof, rejections), keys carried across by convert, and both
CLIs with --curve_type BLS12381 on .r1cs / .wtns files over BLS12-381's r.
The port runs its kernels' plain versions (device="cpu").

The CUDA test proves chip_smoke.py's phase-14 circuit on the card and
holds the proof to chip_smoke.BLS_GROTH16_HOST_SHA256; the slow test
recomputes that digest with the JAX package's host engine (its native
BLS12-381 C++ path, about a minute).
"""
import hashlib
import importlib.util
import os
import pickle
import random
import secrets

import pytest
import torch

from eigen_zkvm_tpu import cli as jcli
from eigen_zkvm_tpu.curves import bls12_381 as jbls
from eigen_zkvm_tpu.curves import msm as jmsm
from eigen_zkvm_tpu.groth16 import api as japi
from eigen_zkvm_tpu.groth16 import groth16 as jg
from eigen_zkvm_tpu.recursion.circuit import CircuitBuilder
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch import cli, convert, kernels
from eigen_zkvm_tpu_torch.algebraic import r1cs_file, witness
from eigen_zkvm_tpu_torch.curves import bls12_381
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
from eigen_zkvm_tpu_torch.kernels import bn254_check
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, P = jbls.R, jbls.P
G1, G2 = ec.G1_BLS, ec.G2_BLS
FR = bi.FR_BLS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    """The JAX package's host engine: it never probes for a TPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")


# ---- the curve module and the fields ----

def test_curve_module_is_the_jax_packages():
    for name in ("P", "R", "B", "X_BLS", "G1_GEN", "G2_GEN", "B2", "XI"):
        assert getattr(bls12_381, name) == getattr(jbls, name), name
    rng = random.Random(5)
    for k in (0, 1, R - 1, rng.randrange(R)):
        assert bls12_381.g1_to_affine(bls12_381.g1_mul(
            bls12_381.g1_from_affine(bls12_381.G1_GEN), k)) == \
            jbls.g1_to_affine(jbls.g1_mul(jbls.g1_from_affine(jbls.G1_GEN),
                                          k))
    pts = [jbls.g2_mul(jbls.g2_from_affine(jbls.G2_GEN), k)
           for k in (3, 0, 77)]
    assert bls12_381.g2_to_affine_all(pts) == [jbls.g2_to_affine(p)
                                                for p in pts]


def _operands(m: int, rbits: int):
    rng = random.Random(13)
    edges = [0, 1, m - 1, m - 2, (1 << rbits) % m]
    xs = [rng.randrange(m) for _ in range(48)] + edges
    ys = [rng.randrange(m) for _ in range(48)] + edges[::-1]
    return xs, ys


@pytest.mark.parametrize("field", [bi.FQ381, bi.FR_BLS],
                         ids=["Fq381", "Fr381"])
def test_field_ops_match_python_ints(field):
    m, w = field.modulus, field.words
    xs, ys = _operands(m, field.rbits)
    a, b = bi.to_tensor(xs, words=w), bi.to_tensor(ys, words=w)
    assert a.shape == (len(xs), w) and bi.to_ints(a) == xs
    assert bi.to_ints(bi.add_w(field, a, b)) == [(x + y) % m
                                                  for x, y in zip(xs, ys)]
    assert bi.to_ints(bi.sub_w(field, a, b)) == [(x - y) % m
                                                  for x, y in zip(xs, ys)]
    am, bm = bi.to_mont(field, a), bi.to_mont(field, b)
    assert bi.to_ints(am) == [(x << field.rbits) % m for x in xs]
    assert torch.equal(am, bi.mont_ints(field, xs))
    assert bi.to_ints(bi.from_mont(field, bi.mul_w(field, am, bm))) == \
        [x * y % m for x, y in zip(xs, ys)]
    assert bi.to_ints(bi.from_mont(field, bi.sqr_w(field, am))) == \
        [x * x % m for x in xs]
    assert bi.to_ints(bi.from_mont(field, bi.inv_w(field, am[-9:]))) == \
        [pow(x, m - 2, m) for x in xs[-9:]]


@pytest.mark.parametrize("op", sorted(bn254_check.OPS))
def test_device_check_expectations_agree_with_plain_ops(op):
    """kernels/bn254_check.py's expected values for csrc/bn254.cuh's row 3
    (Python ints, the raw-word semantics of its CUDA test entry) equal the
    plain tensor ops on the edge pairs and random pairs: Fq381 and its
    Fq2."""
    field = bi.FQ381
    w = field.words
    a, b = bn254_check.operands(op, field, 16, seed=7)
    want = bn254_check.expected(op, field, a, b)
    if op.startswith("f2_"):
        ta = bi.to_tensor([c for p in a for c in p], words=w).view(-1, 2, w)
        tb = bi.to_tensor([c for p in b for c in p], words=w).view(-1, 2, w)
        fn = {"f2_mul": lambda: bi.f2_mul_w(field, ta, tb),
              "f2_sqr": lambda: bi.f2_mul_w(field, ta, ta),
              "f2_inv": lambda: bi.f2_inv_w(field, ta)}[op]
        v = bi.to_ints(fn())
        got = list(zip(v[::2], v[1::2]))
    else:
        ta, tb = bi.to_tensor(a, words=w), bi.to_tensor(b, words=w)
        fn = {"mul": lambda: bi.mul_w(field, ta, tb),
              "sqr": lambda: bi.sqr_w(field, ta),
              "add": lambda: bi.add_w(field, ta, tb),
              "sub": lambda: bi.sub_w(field, ta, tb),
              "neg": lambda: bi.words(bi.neg(field, bi.limbs(ta))),
              "inv": lambda: bi.inv_w(field, ta)}[op]
        got = bi.to_ints(fn())
    assert got == want


# ---- the groups ----

def _jcurve(g):
    """(mul, from_affine, to_affine, add, double, neg) of the JAX curve."""
    if g.deg == 1:
        return (jbls.g1_mul, jbls.g1_from_affine, jbls.g1_to_affine,
                jbls.g1_add, jbls.g1_double, jbls.g1_neg)
    return (jbls.g2_mul, jbls.g2_from_affine, jbls.g2_to_affine,
            jbls.g2_add, jbls.g2_double, jbls.g2_neg)


@pytest.mark.parametrize("g", [G1, G2], ids=["G1", "G2"])
def test_point_formulas_match_the_jax_curve(g):
    """ec.add, ec.add_affine and ec.dbl on batches holding random points,
    infinity, P + P and P + (-P), against curves/bls12_381.py."""
    mul, from_a, to_a, add, dbl, neg = _jcurve(g)
    rng = random.Random(17)
    base = from_a(ec.generator(g))
    ps = [to_a(mul(base, rng.randrange(1, R))) for _ in range(4)]
    pairs = [(ps[0], ps[1]), (ps[2], ps[2]), (ps[3], to_a(neg(from_a(ps[3])))),
             (None, ps[0]), (ps[1], None), (None, None)]
    lhs = ec.affine_tensor(g, [p for p, _ in pairs])
    rhs = ec.affine_tensor(g, [q for _, q in pairs])
    want_add = [to_a(add(from_a(p), from_a(q))) for p, q in pairs]
    assert ec.affine_ints(g, ec.to_affine(g, ec.add(
        g, ec.from_affine(g, lhs), ec.from_affine(g, rhs)))) == want_add
    assert ec.affine_ints(g, ec.to_affine(g, ec.add_affine(
        g, ec.from_affine(g, lhs), ec.affine_limbs(g, rhs)))) == want_add
    assert ec.affine_ints(g, ec.to_affine(g, ec.dbl(
        g, ec.from_affine(g, lhs)))) == [to_a(dbl(from_a(p)))
                                         for p, _ in pairs]


@pytest.mark.parametrize("c", range(2, 15))
def test_signed_digits_cover_the_255_bit_scalars(c):
    """BLS12-381's r is 255 bits: its signed digits cover 256 bits (the top
    window takes the carry of the one below; at c = 3, 5 and 15 the top
    window starts at bit 255), each in (-2^(c-1), 2^(c-1)], and they sum
    back to the scalar."""
    rng = random.Random(c)
    ks = [0, 1, R - 1, (1 << 254) | 1, (1 << 255) - 1 - (1 << 200),
          sum((1 << (c - 1)) << (c * w) for w in range(255 // c))
          % (1 << 255)] + [rng.randrange(R) for _ in range(20)]
    W = ec.n_windows(c, 255)
    assert c * W >= 256 and c * (W - 1) <= 255
    d = ec.signed_digits(bi.to_tensor(ks), c, 255)
    assert d.shape == (len(ks), W)
    half = 1 << (c - 1)
    assert bool((d > -half).all()) and bool((d <= half).all())
    assert [sum(int(v) << (c * w) for w, v in enumerate(row))
            for row in d.tolist()] == ks


def _msm_inputs(g, n: int, seed: int):
    """n points (kernel 2's plain version of random scalars) with infinity
    at 5 and 100-102 and a duplicate at 9, and scalars 0, 1, r - 1, digits
    at +2^(c-1) and 2^(c-1) + 1 (carries), bit 254 set, a hot bucket (a
    quarter of them 1, a quarter 0) and random ones."""
    rng = random.Random(seed)
    pts = ec.scalar_mul_batch(g, ec.generator(g), bi.to_tensor(
        [rng.randrange(1, R) for _ in range(n)]))
    pts[5] = 0
    pts[100:103] = 0
    pts[9] = pts[8]
    c = ec.window_bits(n)
    half, W = 1 << (c - 1), ec.n_windows(c, 255)
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 1, R - 1
    ks[3] = sum(half << (c * w) for w in range(W - 1)) % (1 << 254)
    ks[4] = sum((half + 1) << (c * w) for w in range(W - 1)) % (1 << 254)
    ks[6] = (1 << 254) | (1 << 253)
    ks[7] = (1 << 254) + rng.randrange(R - (1 << 254))
    for i in range(10, n // 2):
        ks[i] = i & 1
    return pts, ks


@pytest.mark.parametrize("g", [G1, G2], ids=["G1", "G2"])
def test_msm_matches_the_jax_msm(g):
    """msm_stages_plain (kernel 1's stages' plain versions, what ec.msm runs
    for CPU tensors) on 200 points and msm_plain (the double-and-add) on the
    first 16 (edges included) against curves/msm.py's Pippenger over
    curves/bls12_381.py."""
    pts, ks = _msm_inputs(g, 200, 3)
    jf = jmsm.msm_g1 if g.deg == 1 else jmsm.msm_g2
    plist = ec.affine_ints(g, pts)
    S = bi.to_tensor(ks)
    assert ec.affine_ints(g, ec.msm_stages_plain(g, pts, S)) == \
        [jf(jbls, plist, ks)]
    assert ec.affine_ints(g, ec.msm_plain(g, pts[:16], S[:16])) == \
        [jf(jbls, plist[:16], ks[:16])]


@pytest.mark.parametrize("g", [G1, G2], ids=["G1", "G2"])
def test_fixed_base_batch_matches_the_jax_setup(g):
    """Kernel 2's plain version against groth16._fixed_base_all at
    BLS12-381 (the JAX package's native batch), zeros, 1, r - 1 and bit 254
    included."""
    rng = random.Random(4)
    ks = [0, 1, 2, R - 1, (1 << 254) | 3, 0] + \
        [rng.randrange(R) for _ in range(58)]
    gen = ec.generator(g)
    want = jg._fixed_base_all(jbls, gen, ks, g1=g.deg == 1)
    got = ec.affine_ints(g, ec.scalar_mul_batch(g, gen, bi.to_tensor(ks)))
    assert got == [want[i] for i in range(len(ks))]


# ---- the scalar field's transforms and rows ----

@pytest.mark.parametrize("tile_bits", [3, 11])
@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_fr_transforms_match_groth16_ntt(tile_bits, log_n):
    """fr_ntt at BLS12-381's r (the passes of plan(log_n, tile_bits) and
    the ntt_plain ladder) against groth16._ntt / _intt with bls12_381.R,
    and the coset round trip and the quotient against _witness_h's
    steps."""
    m = 1 << log_n
    rng = random.Random(tile_bits * 100 + log_n)
    abc = [[rng.randrange(R) for _ in range(m)] for _ in range(3)]
    w = jg._find_root(R, m)
    assert fr_ntt.find_root(R, m) == w
    x = [bi.mont_ints(FR, v) for v in abc]

    def ints(t):
        return [FR.from_mont_int(v) for v in bi.to_ints(t)]

    assert ints(fr_ntt.ntt(x[0], log_n, tile_bits=tile_bits, field=FR)) == \
        jg._ntt(abc[0], w, R)
    assert ints(fr_ntt.ntt_plain(x[0], log_n, field=FR)) == \
        jg._ntt(abc[0], w, R)
    n_inv = pow(m, R - 2, R)
    assert [v * n_inv % R for v in ints(fr_ntt.ntt(
        x[0], log_n, inverse=True, tile_bits=tile_bits, field=FR))] == \
        jg._intt(abc[0], w, R)

    def coset(vals):  # _witness_h's to_coset
        coeffs = jg._intt(vals, w, R)
        return jg._ntt([c * pow(5, i, R) % R for i, c in enumerate(coeffs)],
                       w, R)

    want = [coset(v) for v in abc]
    got = [fr_ntt.to_coset(v, log_n, tile_bits=tile_bits, field=FR)
           for v in x]
    assert [ints(t) for t in got] == want
    assert ints(fr_ntt.to_coset_plain(x[0], log_n, field=FR)) == want[0]
    z_inv = fr_ntt.z_coset_inv(m, FR)
    k = fr_ntt.mont_const(z_inv, torch.device("cpu"), FR)
    hc = [(a * b - c) % R * z_inv % R for a, b, c in zip(*want)]
    s_inv = pow(5, R - 2, R)
    coeffs = [c * pow(s_inv, i, R) % R
              for i, c in enumerate(jg._intt(hc, w, R))]
    assert ints(fr_ntt.from_coset(fr_ntt.quotient(*got, k, field=FR), log_n,
                                  tile_bits=tile_bits, field=FR)) == coeffs


def test_r1cs_rows_match_python_sums():
    circ = bg.synthetic(200, 2, seed=9, prime=R)
    assert circ.P == R and bg.check(circ)
    wit = fr_ntt.to_mont(bi.to_tensor(circ.w), field=FR)
    rows = r1cs.build(circ.constraints, "cpu", FR)
    assert bi.to_ints(rows.coefs[:2]) == [FR.to_mont_int(1),
                                          FR.to_mont_int(R - 1)]
    m, n_pub = 256, 3
    out = r1cs.evaluate(rows, wit, m, n_pub)
    for sel in range(3):
        got = [FR.from_mont_int(v) for v in bi.to_ints(out[sel])]
        want = [sum(circ.w[s] * c for s, c in row[sel].items()) % R
                for row in circ.constraints]
        want += [0] * (m - len(want))
        if sel == 0:
            want[200 : 200 + n_pub] = [v % R for v in circ.w[:n_pub]]
        assert got == want


# ---- Groth16 end to end ----

def _interop_circuit():
    """tests/test_interop.py::test_groth16_bls12_381's circuit."""
    b = CircuitBuilder(prime=R)
    o = b.public(1007)
    x = b.wire(b.sig(19))
    y = b.wire(b.sig(53))
    b.assert_eq(b.mul(x, y), o)
    assert b.check()
    return b


_RUNS: dict = {}


def _run(name: str):
    """(circuit, JAX keys and proof, port keys and proof) from the same
    draws: setup from seeded(11), prove from seeded(12); once a module."""
    if name not in _RUNS:
        circ = _interop_circuit() if name == "interop" else \
            bg.synthetic((1 << 8) - 3, 2, seed=4, prime=R)
        jpk, jvk = jg.setup(jbls, circ.constraints, circ.n_vars,
                            circ.n_publics, rng=bg.seeded(11))
        jproof, jpubs = jg.prove(jbls, jpk, circ.constraints, circ.w,
                                 rng=bg.seeded(12))
        pk, vk = api.groth16_setup_inplace("BLS12381", circ,
                                           rng=bg.seeded(11), device="cpu")
        proof, pubs = api.groth16_prove_inplace("bls12381", circ, pk,
                                                rng=bg.seeded(12))
        _RUNS[name] = (circ, (jpk, jvk, jproof, jpubs), (pk, vk, proof, pubs))
    return _RUNS[name]


@pytest.fixture(scope="module", params=["interop", "synthetic_2^8"])
def both(request):
    return _run(request.param)


def test_proving_key_equals_the_jax_package_point_for_point(both):
    _, (jpk, jvk, _, _), (pk, vk, _, _) = both
    assert pk.curve_name == vk.curve_name == jpk.curve_name == "bls12381"
    assert (pk.n_public, pk.n_vars, pk.domain_size) == \
        (jpk.n_public, jpk.n_vars, jpk.domain_size)
    assert (pk.alpha1, pk.beta1, pk.beta2, pk.delta1, pk.delta2) == \
        (jpk.alpha1, jpk.beta1, jpk.beta2, jpk.delta1, jpk.delta2)
    for name in ("a_query", "b1_query", "l_query", "h_query"):
        q = getattr(jpk, name)
        assert getattr(pk, name).shape[1:] == (2, 6)
        assert ec.affine_ints(G1, getattr(pk, name)) == \
            [q[i] for i in range(len(q))], name
    assert ec.affine_ints(G2, pk.b2_query) == \
        [jpk.b2_query[i] for i in range(len(jpk.b2_query))]
    assert api.vk_to_json(vk) == japi.vk_to_json(jvk)
    assert api.vk_to_json(vk, to_hex=True) == japi.vk_to_json(jvk, True)


def test_proof_json_is_byte_identical(both):
    _, (_, _, jproof, jpubs), (_, _, proof, pubs) = both
    assert pubs == jpubs
    for to_hex in (False, True):
        assert api.proof_to_json(proof, "bls12381", to_hex) == \
            japi.proof_to_json(jproof, "bls12381", to_hex)
    assert api.publics_to_json(pubs) == japi.publics_to_json(jpubs)


def test_each_verifier_accepts_the_others_proof(both):
    _, (_, jvk, jproof, jpubs), (_, vk, proof, pubs) = both
    assert jg.verify(jbls, jvk, japi.proof_from_json(
        api.proof_to_json(proof, "bls12381")), pubs)
    assert api.groth16_verify_inplace("BLS12381", api.vk_from_json(
        japi.vk_to_json(jvk)), api.proof_from_json(
        japi.proof_to_json(jproof, "bls12381")), jpubs)


def test_verifier_rejects_tampering_and_changed_publics():
    _, _, (_, vk, proof, pubs) = _run("interop")
    assert pubs == [1007]
    assert api.groth16_verify_inplace("bls12381", vk, proof, pubs)
    assert not api.groth16_verify_inplace("bls12381", vk, proof, [1008])
    assert not api.groth16_verify_inplace("bls12381", vk, proof, [])
    bad = g16.Proof(proof.a, proof.b, (proof.c[0], (-proof.c[1]) % P))
    assert not api.groth16_verify_inplace("bls12381", vk, bad, pubs)
    assert api.proof_from_json(api.proof_to_json(
        proof, "bls12381", to_hex=True)) == proof
    assert api.vk_from_json(api.vk_to_json(vk, to_hex=True)) == vk
    with pytest.raises(ValueError, match="bls12381 key"):
        api.groth16_verify_inplace("bn128", vk, proof, pubs)


def test_keys_carried_from_the_jax_package_prove_to_the_same_bytes(
        tmp_path):
    """convert.groth16_keys_from_jax of the JAX keys, through the port's
    key file (which keeps the curve and the 6-word coordinates), proves to
    the JAX package's bytes."""
    b, (jpk, jvk, jproof, _), (pk, _, _, _) = _run("interop")
    cpk, vk = convert.groth16_keys_from_jax(jpk, jvk, "cpu")
    assert api.vk_to_json(vk) == japi.vk_to_json(jvk)
    path = str(tmp_path / "pk.bin")
    api.save_pk(path, cpk)
    back = api.load_pk(path, "cpu")
    assert back.curve_name == "bls12381"
    assert back.a_query.shape[1:] == (2, 6) and \
        back.b2_query.shape[1:] == (2, 2, 6)
    for name in ("a_query", "b1_query", "b2_query", "l_query", "h_query"):
        assert torch.equal(getattr(back, name), getattr(pk, name)), name
    proof, pubs = api.groth16_prove_inplace("bls12381", b, back,
                                            rng=bg.seeded(12))
    assert api.proof_to_json(proof, "bls12381") == \
        japi.proof_to_json(jproof, "bls12381")
    assert api.groth16_verify_inplace("bls12381", vk, proof, pubs)
    with pytest.raises(ValueError, match="bls12381 key"):
        api.groth16_prove_inplace("bn128", b, back)


def _patch_draws(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rng.randrange(n))


def test_cli_round_trip_writes_the_jax_cli_bytes(monkeypatch, tmp_path):
    """groth16_setup, groth16_prove and groth16_verify --curve_type
    BLS12381 through both CLIs, secrets.randbelow one seeded draw in both:
    the port reads the circuit as a .r1cs over BLS12-381's r and its
    witness as a .wtns, the JAX CLI a pickle of the same circuit; the vk,
    proof and public JSON are the same bytes; a changed public fails the
    port's verify (exit 1); a BN254 .r1cs is refused at this curve."""
    circ = _interop_circuit()
    files = {k: str(tmp_path / f"circuit.{k}") for k in ("r1cs", "wtns",
                                                          "pkl")}
    r1cs_file.save_r1cs(files["r1cs"], r1cs_file.circuit_to_r1cs(circ))
    witness.save_witness(files["wtns"], circ.w, circ.P)
    with open(files["pkl"], "wb") as f:
        pickle.dump(bg.Circuit(list(circ.constraints), circ.n_vars,
                               circ.n_publics, list(circ.w), R), f)
    assert r1cs_file.load_r1cs(files["r1cs"]).prime == R
    curve = ["--curve_type", "BLS12381"]
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        o = {k: str(d / k) for k in ("pk", "vk.json", "proof.json",
                                      "public.json")}
        _patch_draws(monkeypatch, 29)
        if side == "jax":
            jcli.main(["groth16_setup", "--circuit", files["pkl"], "--pk",
                       o["pk"], "--vk", o["vk.json"], *curve])
            jcli.main(["groth16_prove", "--circuit", files["pkl"], "--pk",
                       o["pk"], "--proof", o["proof.json"],
                       "--public_input", o["public.json"], *curve])
        else:
            assert cli.main(["groth16_setup", "--circuit", files["r1cs"],
                             "--pk", o["pk"], "--vk", o["vk.json"],
                             "--device", "cpu", *curve]) == 0
            assert cli.main(["groth16_prove", "--circuit", files["r1cs"],
                             "--witness", files["wtns"], "--pk", o["pk"],
                             "--proof", o["proof.json"], "--public_input",
                             o["public.json"], "--device", "cpu",
                             *curve]) == 0
            verify = ["groth16_verify", "--vk", o["vk.json"], "--proof",
                      o["proof.json"], "--public_input", o["public.json"],
                      *curve]
            assert cli.main(verify) == 0
            with pytest.raises(ValueError, match="bls12381 key"):
                cli.main(verify[:-2])   # the default curve, BN128
        out[side] = {}
        for k in ("vk.json", "proof.json", "public.json"):
            with open(o[k], "rb") as f:
                out[side][k] = f.read()
    assert out["port"] == out["jax"]
    port = tmp_path / "port"
    with open(port / "public.json", "w") as f:
        f.write('["1008"]')
    assert cli.main(["groth16_verify", "--vk", str(port / "vk.json"),
                     "--proof", str(port / "proof.json"), "--public_input",
                     str(port / "public.json"), *curve]) == 1
    bn = CircuitBuilder(prime=bg.R)
    six = bn.public(6)
    bn.assert_eq(bn.mul(bn.wire(bn.sig(2)), bn.wire(bn.sig(3))), six)
    r1cs_file.save_r1cs(files["r1cs"], r1cs_file.circuit_to_r1cs(bn))
    with pytest.raises(ValueError, match="bls12381 scalar field"):
        cli.main(["groth16_setup", "--circuit", files["r1cs"], "--pk",
                  str(tmp_path / "pk"), "--vk", str(tmp_path / "vk.json"),
                  "--device", "cpu", *curve])


def test_entry_points_refuse_a_field_of_another_curve():
    with pytest.raises(ValueError, match="bls12381 scalar field"):
        api.groth16_setup_inplace("bls12381", bg.synthetic(5, 1, seed=1),
                                  device="cpu")
    with pytest.raises(ValueError, match="bn128 scalar field"):
        api.groth16_setup_inplace("bn128", _interop_circuit(), device="cpu")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_port_on_the_card_matches_the_pinned_bls_digest():
    """chip_smoke.py's phase-14 circuit (BLS12-381's r, 2^18 - 3 rows,
    domain 2^18) set up, proved and verified by the port on the card: its
    BLS12-381 kernels launch, and the proof's sha256 is
    chip_smoke.BLS_GROTH16_HOST_SHA256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    circ = bg.synthetic(smoke.G16_CONSTRAINTS, 2, smoke.G16_SEED, prime=R)
    kernels.reset_counts()
    pk, vk = api.groth16_setup_inplace("bls12381", circ,
                                       rng=bg.seeded(smoke.G16_SEED))
    proof, pubs = api.groth16_prove_inplace(
        "bls12381", circ, pk, rng=bg.seeded(smoke.G16_SEED + 1))
    assert all(kernels.counts()[k.name] > 0 for k in (
        kernels.MSM_BLS, kernels.EC_BATCH_BLS, kernels.FR_NTT_BLS,
        kernels.R1CS_BLS))
    text = api.proof_to_json(proof, "bls12381")
    assert hashlib.sha256(text.encode()).hexdigest() == \
        smoke.BLS_GROTH16_HOST_SHA256
    assert api.groth16_verify_inplace("bls12381", vk, proof, pubs)


@pytest.mark.slow
def test_host_engine_gives_the_pinned_bls_digest():
    """The JAX package's host engine (native.ec_bls12381) on chip_smoke.py's
    phase-14 circuit with its draws: the proof JSON's sha256 is
    chip_smoke.BLS_GROTH16_HOST_SHA256 (printed, to pin a new one)."""
    smoke = _smoke()
    circ = bg.synthetic(smoke.G16_CONSTRAINTS, 2, smoke.G16_SEED, prime=R)
    jpk, jvk = jg.setup(jbls, circ.constraints, circ.n_vars, circ.n_publics,
                        rng=bg.seeded(smoke.G16_SEED))
    jproof, pubs = jg.prove(jbls, jpk, circ.constraints, circ.w,
                            rng=bg.seeded(smoke.G16_SEED + 1))
    assert jg.verify(jbls, jvk, jproof, pubs)
    digest = hashlib.sha256(japi.proof_to_json(
        jproof, "bls12381").encode()).hexdigest()
    print(f"BLS_GROTH16_HOST_SHA256 = {digest}")
    assert digest == smoke.BLS_GROTH16_HOST_SHA256
