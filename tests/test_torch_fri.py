"""The port's FRI fold chain and quotient split on CPU tensors against the
JAX package's device code on JAX's CPU backend: ops/fri.py `fold` /
`fold_tree` against ops/fri_jax.py, ops/commit.py `q_split` against
ops/commit_tpu.py `_q_split`, and stark/fri.py's fold against the host
stark/fri.py fold.  Inputs are random field values made with numpy from a
seed; bit-exact (tolerance 0)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zkvm_tpu.fields import f3g
from eigen_zkvm_tpu.fields import gl64
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.ops import commit_tpu as ct
from eigen_zkvm_tpu.ops import fri_jax
from eigen_zkvm_tpu.poly import ntt as ntt_np
from eigen_zkvm_tpu.stark import fri as host_fri
from eigen_zkvm_tpu_torch.hash import merkle
from eigen_zkvm_tpu_torch.ops import commit, gl
from eigen_zkvm_tpu_torch.ops import fri as fri_ops

P = 0xFFFFFFFF00000001


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _pair(a):
    lo, hi = ct._split(a)
    return jnp.asarray(lo), jnp.asarray(hi)


def _shift_inv(reductions: int) -> int:
    """SHIFT^-1 squared once per bit folded so far (the FRI chain's)."""
    s = pow(gl64.SHIFT, P - 2, P)
    for _ in range(reductions):
        s = s * s % P
    return s


@pytest.mark.parametrize("pol_bits,step_nbits", [(7, 4), (5, 3)])
def test_fold_matches_fri_jax(pol_bits, step_nbits):
    pol = _rand(pol_bits, 1 << pol_bits, 3)
    sx = _rand(pol_bits + 1, 3)
    sinv = _shift_inv(1)
    got = fri_ops.fold(gl.from_u64(pol), tuple(int(x) for x in sx),
                       pol_bits, step_nbits, sinv)
    want = ct._join(*fri_jax.fold(_pair(pol), sx, pol_bits, step_nbits, sinv))
    assert np.array_equal(gl.to_u64(got), want)


def test_fold_matches_host_fri_fold():
    """The host fold of stark/fri.py (group iNTT, power matrix, Horner)."""
    pol_bits, step_nbits = 6, 3
    pol = _rand(9, 1 << pol_bits, 3)
    sx = _rand(10, 3)
    sinv = _shift_inv(0)
    n_x, pol2_n = 1 << (pol_bits - step_nbits), 1 << step_nbits
    coeffs = ntt_np.intt(pol.reshape(n_x, pol2_n, 3))
    wi = gl64.inv(np.uint64(gl64.root_of_unity(pol_bits)))
    sinv_g = gl64.mul(np.uint64(sinv), gl64.exp_vec(
        wi, np.arange(pol2_n, dtype=np.uint64)))
    coeffs = gl64.mul(coeffs, host_fri._pow_matrix(sinv_g, n_x)[:, :, None])
    want = host_fri._eval_pol_batched(coeffs, sx, f3g)
    got = fri_ops.fold(gl.from_u64(pol), tuple(int(x) for x in sx),
                       pol_bits, step_nbits, sinv)
    assert np.array_equal(gl.to_u64(got), want)


def test_fold_tree_matches_fri_jax():
    step_nbits, next_nbits = 6, 3
    pol = _rand(11, 1 << step_nbits, 3)
    tree = fri_ops.fold_tree(gl.from_u64(pol), step_nbits, next_nbits)
    jtree = fri_jax.fold_tree(_pair(pol), step_nbits, next_nbits)
    assert np.array_equal(tree.root(), jtree.root())
    assert tree.height == jtree.height == 1 << next_nbits
    assert tree.width == jtree.width == 3 << (step_nbits - next_nbits)
    for idx in (0, 5, 7):
        v, mp = tree.get_group_proof(idx)
        jv, jmp = jtree.get_group_proof(idx)
        assert np.array_equal(v, jv)
        assert all(np.array_equal(a, b) for a, b in zip(mp, jmp))
        assert merkle.verify_group_proof(tree.root(), mp, idx, v)
        assert MerkleTreeGL.verify_group_proof(tree.root(), mp, idx, v)


@pytest.mark.parametrize("q_dim,q_deg", [(3, 1), (3, 2)])
def test_q_split_matches_commit_tpu(q_dim, q_deg):
    nbits, nbits_ext = 4, 6
    q = _rand(q_deg, 1 << nbits_ext, q_dim)
    got = commit.q_split(gl.from_u64(q), q_dim, q_deg, nbits, nbits_ext)
    want = ct._join(*ct._q_split(*_pair(q), q_dim, q_deg, nbits, nbits_ext))
    assert got.shape == (1 << nbits_ext, q_dim * q_deg)
    assert np.array_equal(gl.to_u64(got), want)


def test_merkle_checks_reject_a_changed_row_or_index():
    tree = commit.merkelize(gl.from_u64(_rand(12, 16, 5)))
    v, mp = tree.get_group_proof(6)
    assert merkle.verify_group_proof(tree.root(), mp, 6, v)
    bad = v.copy()
    bad[2] ^= np.uint64(1)
    assert not merkle.verify_group_proof(tree.root(), mp, 6, bad)
    assert not merkle.verify_group_proof(tree.root(), mp, 7, v)
