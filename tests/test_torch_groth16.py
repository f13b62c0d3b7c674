"""The port's Groth16 (eigen_zkvm_tpu_torch/groth16) against the JAX
package's on the CPU: with the same seeded draws the proving keys are equal
point for point and the proof JSON is byte-identical, each verifier accepts
the other's proof, and the port's verifier rejects a tampered proof and
wrong publics.  Two circuits: tests/test_groth16.py's toy circuit and a
2^10-row synthetic one from bench_groth16.  The port runs its kernels'
plain versions (device="cpu").

The CUDA test at the end proves chip_smoke.py's circuit with both packages
on the card's machine and holds both to chip_smoke.GROTH16_HOST_SHA256.
"""
import hashlib
import importlib.util
import os
import random
import time

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.groth16 import api as japi
from eigen_zkvm_tpu.groth16 import groth16 as jg
from eigen_zkvm_tpu.recursion.circuit import CircuitBuilder
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch import convert, kernels
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_circuit():
    """tests/test_groth16.py::_toy_circuit."""
    b = CircuitBuilder(prime=jbn.R)
    out1 = b.public(35)
    out2 = b.public(12)
    x = b.wire(b.sig(5))
    y = b.wire(b.sig(7))
    b.assert_eq(b.mul(x, y), out1)
    b.assert_eq(x + y, out2)
    assert b.check()
    return b


_RUNS: dict = {}


def _run(name: str):
    """(circuit, JAX keys and proof, port keys and proof) from the same
    draws: setup from seeded(11), prove from seeded(12); once a module."""
    if name not in _RUNS:
        circ = _toy_circuit() if name == "toy" else \
            bg.synthetic((1 << 10) - 3, 2, seed=4)
        jpk, jvk = jg.setup(jbn, circ.constraints, circ.n_vars,
                            circ.n_publics, rng=bg.seeded(11))
        jproof, jpubs = jg.prove(jbn, jpk, circ.constraints, circ.w,
                                 rng=bg.seeded(12))
        pk, vk = api.groth16_setup_inplace("bn128", circ, rng=bg.seeded(11),
                                           device="cpu")
        proof, pubs = api.groth16_prove_inplace("bn128", circ, pk,
                                                rng=bg.seeded(12))
        _RUNS[name] = (circ, (jpk, jvk, jproof, jpubs), (pk, vk, proof, pubs))
    return _RUNS[name]


@pytest.fixture(scope="module", params=["toy", "synthetic_2^10"])
def both(request):
    return _run(request.param)


def test_proving_key_equals_the_jax_package_point_for_point(both):
    _, (jpk, jvk, _, _), (pk, vk, _, _) = both
    assert (pk.n_public, pk.n_vars, pk.domain_size) == \
        (jpk.n_public, jpk.n_vars, jpk.domain_size)
    assert (pk.alpha1, pk.beta1, pk.beta2, pk.delta1, pk.delta2) == \
        (jpk.alpha1, jpk.beta1, jpk.beta2, jpk.delta1, jpk.delta2)
    for name in ("a_query", "b1_query", "l_query", "h_query"):
        assert ec.affine_ints(ec.G1, getattr(pk, name)) == \
            list(getattr(jpk, name)), name
    assert ec.affine_ints(ec.G2, pk.b2_query) == list(jpk.b2_query)
    assert api.vk_to_json(vk) == japi.vk_to_json(jvk)


def test_proof_json_is_byte_identical(both):
    _, (_, _, jproof, jpubs), (_, _, proof, pubs) = both
    assert pubs == jpubs
    assert api.proof_to_json(proof, "bn128") == \
        japi.proof_to_json(jproof, "bn128")
    assert api.proof_to_json(proof, "bn128", to_hex=True) == \
        japi.proof_to_json(jproof, "bn128", to_hex=True)
    assert api.publics_to_json(pubs) == japi.publics_to_json(jpubs)


def test_each_verifier_accepts_the_others_proof(both):
    _, (_, jvk, jproof, jpubs), (_, vk, proof, pubs) = both
    assert jg.verify(jbn, jvk, japi.proof_from_json(
        api.proof_to_json(proof, "bn128")), pubs)
    assert api.groth16_verify_inplace("bn128", api.vk_from_json(
        japi.vk_to_json(jvk)), api.proof_from_json(
        japi.proof_to_json(jproof, "bn128")), jpubs)


def test_port_verifier_rejects_tampering_and_wrong_publics():
    _, _, (_, vk, proof, pubs) = _run("toy")
    assert pubs == [35, 12]
    assert api.groth16_verify_inplace("bn128", vk, proof, pubs)
    assert not api.groth16_verify_inplace("bn128", vk, proof, [35, 13])
    assert not api.groth16_verify_inplace("bn128", vk, proof, [35])
    bad = g16.Proof(proof.a, proof.b, (proof.c[0], (-proof.c[1]) % jbn.P))
    assert not api.groth16_verify_inplace("bn128", vk, bad, pubs)
    text = api.proof_to_json(proof, "bn128", to_hex=True)
    assert api.proof_from_json(text) == proof
    assert api.vk_from_json(api.vk_to_json(vk, to_hex=True)) == vk


def test_keys_carried_from_the_jax_package_prove_to_the_same_bytes():
    b, (jpk, jvk, jproof, _), _ = _run("toy")
    pk, vk = convert.groth16_keys_from_jax(jpk, jvk, "cpu")
    assert api.vk_to_json(vk) == japi.vk_to_json(jvk)
    proof, pubs = api.groth16_prove_inplace("bn128", b, pk, rng=bg.seeded(12))
    assert api.proof_to_json(proof, "bn128") == \
        japi.proof_to_json(jproof, "bn128")
    assert api.groth16_verify_inplace("bn128", vk, proof, pubs)


def test_quotient_transforms_match_groth16_ntt():
    """fr_ntt's plain transforms against the JAX package's _ntt / _intt on
    Python ints, and its coset steps against _witness_h's."""
    r = jbn.R
    rng = random.Random(8)
    m = 1 << 6
    vals = [rng.randrange(r) for _ in range(m)]
    w = jg._find_root(r, m)
    assert fr_ntt.find_root(r, m) == w
    x = bi.mont_ints(bi.FR, vals)

    def ints(t):
        return [bi.FR.from_mont_int(v) for v in bi.to_ints(t)]

    assert ints(fr_ntt.ntt(x, 6)) == jg._ntt(vals, w, r)
    n_inv = pow(m, r - 2, r)
    assert [v * n_inv % r for v in ints(fr_ntt.ntt(x, 6, inverse=True))] == \
        jg._intt(vals, w, r)
    coeffs = jg._intt(vals, w, r)
    want = jg._ntt([c * pow(5, i, r) % r for i, c in enumerate(coeffs)], w, r)
    assert ints(fr_ntt.to_coset(x, 6)) == want
    assert ints(fr_ntt.from_coset(fr_ntt.to_coset(x, 6), 6)) == coeffs


@pytest.mark.parametrize("tile_bits", [2, 3])
@pytest.mark.parametrize("log_n", range(1, 10))
def test_passes_match_groth16_ntt(tile_bits, log_n):
    """The kernel's pass decomposition (`pass_plain` composed over
    `plan(log_n, tile_bits)`: 1 to 5 passes, uneven splits) against the JAX
    package's _ntt / _intt and _witness_h's coset steps on Python ints,
    word for word: forward, inverse, the coset transforms with the scale on
    the inverse's last pass, the quotient and the way back."""
    r, m = jbn.R, 1 << log_n
    rng = random.Random(100 * tile_bits + log_n)
    abc = [[rng.randrange(r) for _ in range(m)] for _ in range(3)]
    w = jg._find_root(r, m)
    x = [bi.mont_ints(bi.FR, v) for v in abc]

    def ints(t):
        return [bi.FR.from_mont_int(v) for v in bi.to_ints(t)]

    assert len(fr_ntt.plan(log_n, tile_bits)) == -(-log_n // tile_bits)
    assert ints(fr_ntt.ntt(x[0], log_n, tile_bits=tile_bits)) == \
        jg._ntt(abc[0], w, r)
    n_inv = pow(m, r - 2, r)
    assert [v * n_inv % r for v in ints(fr_ntt.ntt(
        x[0], log_n, inverse=True, tile_bits=tile_bits))] == \
        jg._intt(abc[0], w, r)

    def coset(vals):  # _witness_h's to_coset
        coeffs = jg._intt(vals, w, r)
        return jg._ntt([c * pow(5, i, r) % r for i, c in enumerate(coeffs)],
                       w, r)

    want = [coset(v) for v in abc]
    got = [fr_ntt.to_coset(v, log_n, tile_bits=tile_bits) for v in x]
    assert [ints(g) for g in got] == want
    z_inv = fr_ntt.z_coset_inv(m)
    k = fr_ntt.mont_const(z_inv, torch.device("cpu"))
    hc = [(a * b - c) % r * z_inv % r for a, b, c in zip(*want)]
    s_inv = pow(5, r - 2, r)
    coeffs = [c * pow(s_inv, i, r) % r
              for i, c in enumerate(jg._intt(hc, w, r))]
    assert ints(fr_ntt.from_coset(fr_ntt.quotient(*got, k), log_n,
                                  tile_bits=tile_bits)) == coeffs


def test_r1cs_rows_match_python_sums():
    circ = bg.synthetic(200, 2, seed=9)
    assert bg.check(circ)
    wit = fr_ntt.to_mont(bi.to_tensor(circ.w))
    rows = r1cs.build(circ.constraints, "cpu")
    m, n_pub = 256, 3
    out = r1cs.evaluate(rows, wit, m, n_pub)
    assert out.shape == (3, m, 4)
    for sel in range(3):
        got = [bi.FR.from_mont_int(v) for v in bi.to_ints(out[sel])]
        want = [sum(circ.w[s] * c for s, c in row[sel].items()) % jbn.R
                for row in circ.constraints]
        want += [0] * (m - len(want))
        if sel == 0:
            want[200 : 200 + n_pub] = [v % jbn.R for v in circ.w[:n_pub]]
        assert got == want


@pytest.mark.parametrize("name", ["toy", "synthetic_61"])
def test_fused_rows_match_the_jax_native_rows(monkeypatch, name):
    """K4's plain version ([3, m, 4]: the three matrices, the zero padding,
    the publics in A's tail) against the JAX package's `_r1cs_csr`, its
    native `r1cs_eval` and `_witness_h`'s padding and publics
    (groth16.py:283-341), word for word."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    circ = _toy_circuit() if name == "toy" else bg.synthetic(61, 2, seed=3)
    n_pub = circ.n_publics + 1
    nc = len(circ.constraints)
    m = 1 << (nc + n_pub - 1).bit_length()
    nat = jg._native_ec(jbn)
    wit_l = jg._int_limbs(circ.w, jbn.R)
    want = []
    for indptr, wires, coefs_m in jg._r1cs_csr(nat, circ.constraints, jbn.R):
        full = np.zeros((m, 4), dtype=np.uint64)
        full[:nc] = nat.r1cs_eval(indptr, wires, coefs_m, wit_l)
        want.append(full)
    want[0][nc : nc + n_pub] = wit_l[:n_pub]
    rows = r1cs.build(circ.constraints, "cpu")
    wit = bi.to_tensor([int(v) % jbn.R for v in circ.w])
    got = fr_ntt.from_mont(r1cs.evaluate(rows, fr_ntt.to_mont(wit), m, n_pub)
                           .reshape(3 * m, 4)).reshape(3, m, 4)
    assert np.array_equal(got.numpy().view(np.uint64), np.stack(want))


def test_long_rows_match_python_sums():
    """Rows of 0 to 4,096 terms (bench_groth16.long_rows: 254 and 4,096 at
    fixed strides, the rest around the kernel's thread/warp threshold),
    coefficients 1, -1 or random, against Python sums."""
    circ = bg.long_rows(1 << 9, seed=7)
    rows = r1cs.build(circ.constraints, "cpu")
    lens = rows.indptr.diff()
    assert {0, 1, 254, 4096} <= set(lens.tolist())
    # the stored order: short rows by products then length, long rows last,
    # a row's products before its +-1 terms
    assert bool((lens[: rows.n_short] <= r1cs.SHORT_MAX).all())
    assert bool((lens[rows.n_short :] > r1cs.SHORT_MAX).all())
    assert sorted(rows.dest.tolist()) == list(range(3 * rows.nc))
    ptr = rows.indptr.tolist()
    prods = [(rows.cidx[ptr[t] : ptr[t + 1]] >= 2).long() for t in
             range(3 * rows.nc)]
    assert all(bool((p[:-1] >= p[1:]).all()) for p in prods if len(p) > 1)
    key = [(int(p.sum()), len(p)) for p in prods[: rows.n_short]]
    assert key == sorted(key)
    assert bi.to_ints(rows.coefs[:2]) == [bi.FR.to_mont_int(1),
                                          bi.FR.to_mont_int(jbn.R - 1)]
    m, n_pub = (1 << 9) + 3, 3
    out = r1cs.evaluate(rows, fr_ntt.to_mont(bi.to_tensor(circ.w)), m, n_pub)
    for sel in range(3):
        got = [bi.FR.from_mont_int(v) for v in bi.to_ints(out[sel])]
        want = [sum(circ.w[s] * c for s, c in row[sel].items()) % jbn.R
                for row in circ.constraints]
        want += circ.w[:n_pub] if sel == 0 else [0] * n_pub
        assert got == want


def test_synthetic_circuit_is_deterministic_and_half_boolean():
    a = bg.synthetic(600, 2, seed=2)
    b = bg.synthetic(600, 2, seed=2)
    assert a.constraints == b.constraints and a.w == b.w
    assert bg.check(a)
    assert a.n_vars == len(a.w) == 600 + 1 + 2 + bg.N_RANDOM_INPUTS
    boolean = sum(1 for v in a.w if v in (0, 1)) / len(a.w)
    assert 0.4 < boolean < 0.6
    assert all(1 <= len(side) <= 3 for row in a.constraints for side in row)


def test_h_degree_overflow_still_raises():
    b, _, (pk, _, _, _) = _run("toy")
    w = list(b.w)
    w[3] += 1   # the witness no longer satisfies x * y = 35
    with pytest.raises(AssertionError, match="H degree overflow"):
        g16.prove(pk, b.constraints, w, rng=bg.seeded(4))


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = _toy_circuit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.groth16_setup_inplace("bn128", b)
    with pytest.raises(ValueError, match="bls12381 scalar field"):
        api.groth16_setup_inplace("bls12381", b, device="cpu")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_port_on_the_card_and_host_engine_match_the_pinned_digest(
        monkeypatch):
    """chip_smoke.py's circuit (2^18 - 3 rows, domain 2^18) through the
    port on the card and through the JAX package's host engine (its native
    C++ path); both walls and the host's Prof ticks are printed.  Both
    proofs' sha256 must be chip_smoke.GROTH16_HOST_SHA256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("EIGEN_ZKVM_PROFILE", "1")
    smoke = _smoke()
    circ = bg.synthetic(smoke.G16_CONSTRAINTS, 2, smoke.G16_SEED)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bn128", circ,
                                       rng=bg.seeded(smoke.G16_SEED))
    proof, pubs = api.groth16_prove_inplace(
        "bn128", circ, pk, rng=bg.seeded(smoke.G16_SEED + 1))
    t1 = time.perf_counter()
    assert all(kernels.counts()[k.name] > 0 for k in
               (kernels.MSM, kernels.EC_BATCH, kernels.FR_NTT, kernels.R1CS))
    jpk, jvk = jg.setup(jbn, circ.constraints, circ.n_vars, circ.n_publics,
                        rng=bg.seeded(smoke.G16_SEED))
    t2 = time.perf_counter()
    jproof, _ = jg.prove(jbn, jpk, circ.constraints, circ.w,
                         rng=bg.seeded(smoke.G16_SEED + 1))
    t3 = time.perf_counter()
    print(f"setup + prove: port {t1 - t0:.3f} s; host engine setup "
          f"{t2 - t1:.3f} s, prove {t3 - t2:.3f} s")
    port = hashlib.sha256(api.proof_to_json(proof, "bn128").encode())
    host = hashlib.sha256(japi.proof_to_json(jproof, "bn128").encode())
    assert host.hexdigest() == smoke.GROTH16_HOST_SHA256, host.hexdigest()
    assert port.hexdigest() == host.hexdigest()
    assert api.groth16_verify_inplace("bn128", vk, proof, pubs)
