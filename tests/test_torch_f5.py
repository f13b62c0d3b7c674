"""GF(p^5) of the port (eigen_zkvm_tpu_torch/ops/f5.py) and FRI over it
(stark/fri.py `FRI(..., dim=5)`, the folds of ops/fri.py) against the JAX
package's fields/f5g.py and host FRI(..., dim=5), on the CPU.  Inputs are
seeded numpy draws; bit-exact (tolerance 0), and proofs byte for byte
(stark/fri.proof_json, the JSON chip_smoke.py's phase 17 hashes).

The slow test recomputes chip_smoke.F5G_SHA256 with the JAX host FRI at
the smoke's shape (2^20 -> 2^21):

    JAX_PLATFORMS=cpu python -m pytest -p no:cacheprovider -m slow -s \
        tests/test_torch_f5.py
"""
import hashlib
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.fields import f5g
from eigen_zkvm_tpu.fields import gl64
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.hash.transcript_gl import TranscriptGL
from eigen_zkvm_tpu.poly import ntt as jntt
from eigen_zkvm_tpu.stark import fri as jfri
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch import bench_chain, bench_fri
from eigen_zkvm_tpu_torch.ops import commit, f5, gl
from eigen_zkvm_tpu_torch.ops import fri as fri_ops
from eigen_zkvm_tpu_torch.stark import fri as pfri
from eigen_zkvm_tpu_torch.stark.backends import get_backend
from eigen_zkvm_tpu_torch.stark.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = gl.P_INT
EDGE = np.array([0, 1, P - 1, 2**32 - 1, 2**32, 2**63], dtype=np.uint64)
GOLDEN_A = [9788683869780751860, 18176307314149915536, 17581807048943060475,
            16706651231658143014, 424516324638612383]
GOLDEN_B = [1541862605911742196, 5168181287870979863, 10854086836664484156,
            11043707160649157424, 943499178011708365]
GOLDEN_AB = [5924286846078684570, 12564682493825924142,
             17116577152380521223, 5260948460973948760,
             15673927150284637712]
NBITS, NBITS_EXT = 5, 10   # tests/test_fri_f5g.py's shape


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _elems(seed, n=301):
    """n seeded elements, then every edge value in every coordinate."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, size=(n, 5), dtype=np.uint64) % np.uint64(P)
    edges = np.repeat(EDGE[:, None], 5, axis=1)
    mixed = np.stack([np.roll(EDGE, k)[:5] for k in range(len(EDGE))])
    return np.concatenate([a, edges, mixed])


def _t(a):
    return gl.from_u64(a)


def _tuples(a):
    return [tuple(int(x) for x in r) for r in a]


# ---- the field


def test_mul_golden_vector():
    """starky/src/f5g.rs test_f5g_mul, as tests/test_f5g_pallas.py."""
    a = np.array(GOLDEN_A, dtype=np.uint64)
    b = np.array(GOLDEN_B, dtype=np.uint64)
    assert [int(x) for x in gl.to_u64(f5.mul(_t(a), _t(b)))] == GOLDEN_AB
    assert f5.mul_int(GOLDEN_A, GOLDEN_B) == tuple(GOLDEN_AB)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_f5g(op):
    a, b = _elems(1), _elems(2)[::-1].copy()
    want = getattr(f5g, op)(a, b)
    assert np.array_equal(gl.to_u64(getattr(f5, op)(_t(a), _t(b))), want)
    if op != "sub":   # the verifier's int forms
        assert [getattr(f5, f"{op}_int")(x, y) for x, y in
                zip(_tuples(a), _tuples(b))] == _tuples(want)


def test_neg_square_and_mul_base_match_f5g():
    a = _elems(3)
    s = np.concatenate([EDGE, _elems(4)[:, 0]])[: a.shape[0]]
    s = np.resize(s, a.shape[0])
    assert np.array_equal(gl.to_u64(f5.neg(_t(a))), f5g.neg(a))
    assert np.array_equal(gl.to_u64(f5.square(_t(a))), f5g.square(a))
    want = np.stack([f5g.mul_base(a[i], int(s[i])) for i in range(len(s))])
    assert np.array_equal(gl.to_u64(f5.mul_base(_t(a), _t(s))), want)
    assert [f5.mul_base_int(x, int(k)) for x, k in
            zip(_tuples(a), s)] == _tuples(want)
    assert np.array_equal(
        gl.to_u64(f5.mul_base(_t(a), gl.as_i64(P - 1))),
        np.stack([f5g.mul_base(r, P - 1) for r in a]))


def test_from_ints_broadcasts_a_point():
    x = (P - 1, 0, 1, 2**32, 7)
    a = _elems(5)
    got = f5.mul(_t(a), f5.from_ints(x, "cpu")[None, :])
    assert np.array_equal(gl.to_u64(got),
                          f5g.mul(a, np.array(x, dtype=np.uint64)))


@pytest.mark.parametrize("e", [0, 1, 5, 2**64 - 1, P**5 - 2])
def test_exp_and_inv_match_f5g(e):
    rows = _tuples(_elems(6, n=3)[[0, 1, 2, 5, -2]])
    for r in rows:
        want = f5g.exp(np.array(r, dtype=np.uint64), e)
        assert f5.exp_int(r, e) == tuple(int(x) for x in want)
    nz = [r for r in rows if any(r)]
    for r in nz:
        inv = f5.inv_int(r)
        assert inv == tuple(int(x) for x in f5g.inv(
            np.array(r, dtype=np.uint64)))
        assert f5.mul_int(r, inv) == f5.ONE_INT
    assert f5.add_int(f5.ZERO_INT, nz[0]) == nz[0]


# ---- FRI over GF(p^5)


def _struct():
    return StarkStruct(nBits=NBITS, nBitsExt=NBITS_EXT, nQueries=4,
                       verificationHashType="GL",
                       steps=[Step(NBITS_EXT), Step(6), Step(3)])


def _pol(seed, deg_bits=NBITS, dim=5):
    """tests/test_fri_f5g.py's draw and coset evaluation."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(0, gl64.P_INT, size=(1 << deg_bits, dim),
                          dtype=np.uint64)
    padded = np.zeros((1 << NBITS_EXT, dim), dtype=np.uint64)
    padded[: coeffs.shape[0]] = coeffs
    scaled = gl64.mul(padded, jntt.shift_powers(NBITS_EXT)[:, None])
    return coeffs, jntt.ntt(scaled, NBITS_EXT)


def _jax(pol, dim=5):
    fri = jfri.FRI(_struct(), dim=dim)
    tree = MerkleTreeGL().merkelize(np.ascontiguousarray(pol), dim,
                                    pol.shape[0])
    t = TranscriptGL()
    t.put_root(tree.root())
    return fri, tree, fri.prove(t, pol, lambda y: [tree.get_group_proof(y)])


def _jax_verify(fri, root, proof, dim=5):
    t = TranscriptGL()
    t.put_root(root)

    def check_query(query, idx):
        vals, mp = query[0]
        if not MerkleTreeGL.verify_group_proof(root, mp, idx, vals):
            return None
        return np.asarray(vals, dtype=np.uint64).reshape(1, dim)

    return fri.verify(t, proof, check_query)


def _port(pol):
    x = gl.from_u64(pol, Engine("cpu").device)
    tree = commit.merkelize(x)
    fri = pfri.FRI(_struct(), get_backend("GL"), dim=5)
    return fri, tree, pfri.prove_pol(fri, x, tree)


@pytest.mark.parametrize("pol_bits,step_nbits", [(6, 3), (7, 2)])
def test_fold_matches_the_host_fold_over_f5g(pol_bits, step_nbits):
    """ops/fri.fold with ext=f5 against stark/fri.py's host fold (group
    iNTT, power matrix, Horner in f5g)."""
    P_ = gl64.P_INT
    rng = np.random.default_rng(pol_bits)
    pol = rng.integers(0, P_, size=(1 << pol_bits, 5), dtype=np.uint64)
    sx = rng.integers(0, P_, size=5, dtype=np.uint64)
    sinv = pow(gl64.SHIFT, P_ - 2, P_) ** 2 % P_
    n_x, pol2_n = 1 << (pol_bits - step_nbits), 1 << step_nbits
    coeffs = jntt.intt(pol.reshape(n_x, pol2_n, 5))
    wi = gl64.inv(np.uint64(gl64.root_of_unity(pol_bits)))
    sinv_g = gl64.mul(np.uint64(sinv), gl64.exp_vec(
        wi, np.arange(pol2_n, dtype=np.uint64)))
    coeffs = gl64.mul(coeffs, jfri._pow_matrix(sinv_g, n_x)[:, :, None])
    want = jfri._eval_pol_batched(coeffs, sx, f5g)
    got = fri_ops.fold(gl.from_u64(pol), tuple(int(x) for x in sx),
                       pol_bits, step_nbits, sinv, ext=f5)
    assert np.array_equal(gl.to_u64(got), want)


@pytest.mark.parametrize("seed", [55, 56])
def test_fri_dim5_proof_is_byte_identical_to_jax(seed):
    _, pol = _pol(seed)
    jf, jtree, jproof = _jax(pol)
    fri, tree, proof = _port(pol)
    assert np.array_equal(tree.root(), jtree.root())
    assert proof.last.shape == (1 << 3, 5)
    assert pfri.proof_json(proof) == pfri.proof_json(jproof)
    assert pfri.verify_pol(fri, tree.root(), proof)
    assert _jax_verify(jf, jtree.root(), jproof)


def test_fri_dim5_both_verifiers_reject_a_tampered_last_layer():
    _, pol = _pol(56)
    jf, jtree, jproof = _jax(pol)
    fri, tree, proof = _port(pol)
    for p in (proof, jproof):
        p.last = np.array(p.last, dtype=np.uint64)
        p.last[0, 2] ^= np.uint64(1)
    assert not pfri.verify_pol(fri, tree.root(), proof)
    assert not _jax_verify(jf, jtree.root(), jproof)


def test_fri_dim5_both_verifiers_reject_a_high_degree_polynomial():
    _, pol = _pol(57, deg_bits=NBITS_EXT)
    jf, jtree, jproof = _jax(pol)
    fri, tree, proof = _port(pol)
    assert pfri.proof_json(proof) == pfri.proof_json(jproof)
    assert not pfri.verify_pol(fri, tree.root(), proof)
    assert not _jax_verify(jf, jtree.root(), jproof)


def test_fri_dim_mismatch_and_mesh_raise():
    rng = np.random.default_rng(58)
    pol = rng.integers(0, P, size=(1 << NBITS_EXT, 5), dtype=np.uint64)
    backend = get_backend("GL")
    with pytest.raises(ValueError, match=r"\[2\^10, 3\]"):
        pfri.FRI(_struct(), backend, dim=3).prove(
            backend.transcript(), gl.from_u64(pol), lambda y: [])
    with pytest.raises(ValueError, match="unsupported extension dim 4"):
        pfri.FRI(_struct(), backend, dim=4)
    with pytest.raises(AssertionError):
        jfri.FRI(_struct(), dim=3).prove(TranscriptGL(), pol, lambda y: [])
    with pytest.raises(AssertionError):
        jfri.FRI(_struct(), dim=4)
    with pytest.raises(ValueError, match="no sharded path"):
        pfri.FRI(_struct(), backend, mesh=object(), dim=5)


# sha256 of proof_json of the port's FRI (dim 3) on _pol(59, dim=3), from
# the tree before FRI took `dim` (its stark/fri.py and ops/fri.py)
DIM3_SHA256 = \
    "3176cd8bf113455ca8253f258f0d480f531d9ea2db971a2ffd13e6e6763e9f38"


def test_fri_dim3_proof_bytes_are_unchanged():
    _, pol = _pol(59, dim=3)
    x = gl.from_u64(pol)
    tree = commit.merkelize(x)
    backend = get_backend("GL")
    t = backend.transcript()
    t.put_root(tree.root())
    proof = pfri.FRI(_struct(), backend).prove(
        t, x, lambda y: [tree.get_group_proof(y)])
    text = pfri.proof_json(proof)
    assert hashlib.sha256(text.encode()).hexdigest() == DIM3_SHA256
    assert text == pfri.proof_json(_jax(pol, dim=3)[2])


def test_bench_fri_draws_and_extends_as_the_jax_test():
    """bench_fri.coeffs is tests/test_fri_f5g.py's draw, and
    bench_fri.coset_eval (the port's LDE of the values) its coset
    evaluation."""
    coeffs, pol = _pol(55)
    assert np.array_equal(bench_fri.coeffs(NBITS, 55), coeffs)
    got = bench_fri.coset_eval(coeffs, NBITS, NBITS_EXT, "cpu")
    assert np.array_equal(gl.to_u64(got), pol)


@pytest.mark.parametrize("dim", [3, 5])
def test_bench_fri_run_verifies_and_repeats_its_bytes(dim):
    """bench_fri.run on the CPU: the same proof bytes every run, verified,
    and the dim-5 proof the JAX host FRI's on the same coset evaluation."""
    r = bench_fri.run(dim, 6, 4, 2, torch.device("cpu"), seed=60)
    assert r["verified"] and r["identical"] and len(r["runs"]) == 2
    cs = bench_fri.coeffs(6, 60, dim)
    padded = np.zeros((1 << 7, dim), dtype=np.uint64)
    padded[: cs.shape[0]] = cs
    pol = jntt.ntt(gl64.mul(padded, jntt.shift_powers(7)[:, None]), 7)
    tree = MerkleTreeGL().merkelize(pol, dim, pol.shape[0])
    t = TranscriptGL()
    t.put_root(tree.root())
    d = bench_chain.chain_struct_json(6, 4)
    ss = StarkStruct(nBits=6, nBitsExt=7, nQueries=d["nQueries"],
                     verificationHashType="GL",
                     steps=[Step(s["nBits"]) for s in d["steps"]])
    proof = jfri.FRI(ss, dim=dim).prove(
        t, pol, lambda y: [tree.get_group_proof(y)])
    want = hashlib.sha256(pfri.proof_json(proof).encode()).hexdigest()
    assert r["sha256"] == [want]


@pytest.mark.slow
def test_jax_host_gives_the_pinned_f5g_digest():
    """chip_smoke.py phase 17 (a): the JAX package's host FRI(..., dim=5)
    at the smoke's struct on the same coset evaluation; its proof_json's
    sha256 is F5G_SHA256."""
    smoke = _smoke()
    nbits, ext = smoke.NBITS, smoke.NBITS + 1
    d = bench_chain.chain_struct_json(nbits, smoke.QUERIES)
    ss = StarkStruct(nBits=nbits, nBitsExt=ext, nQueries=d["nQueries"],
                     verificationHashType="GL",
                     steps=[Step(s["nBits"]) for s in d["steps"]])
    t0 = time.perf_counter()
    coeffs = bench_fri.coeffs(nbits, smoke.F5G_SEED)
    padded = np.zeros((1 << ext, 5), dtype=np.uint64)
    padded[: coeffs.shape[0]] = coeffs
    pol = jntt.ntt(gl64.mul(padded, jntt.shift_powers(ext)[:, None]), ext)
    t1 = time.perf_counter()
    tree = MerkleTreeGL().merkelize(pol, 5, pol.shape[0])
    t = TranscriptGL()
    t.put_root(tree.root())
    fri = jfri.FRI(ss, dim=5)
    proof = fri.prove(t, pol, lambda y: [tree.get_group_proof(y)])
    t2 = time.perf_counter()
    digest = hashlib.sha256(pfri.proof_json(proof).encode()).hexdigest()
    print(f"JAX host F5G at 2^{nbits} -> 2^{ext}: coset evaluation "
          f"{t1 - t0:.1f} s, tree + FRI prove {t2 - t1:.1f} s, sha256 "
          f"{digest}")
    assert _jax_verify(fri, tree.root(), proof)
    assert digest == smoke.F5G_SHA256, digest
