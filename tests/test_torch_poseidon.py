"""The port's Poseidon-GL (eigen_zkvm_tpu_torch/ops/poseidon.py) on the CPU,
where `permute`/`hash_n` run the kernel's plain version.  Held bit-exact
(tolerance 0) against hash/poseidon_gl.py (golden-tested against the
reference), ops/poseidon_jax.py and the pure-jnp twin of the MXU Pallas
kernel (ops/poseidon_mxu.py::permute_ref); the VPU Pallas kernel is too slow
under the interpreter to run here."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zkvm_tpu.hash import linearhash_gl
from eigen_zkvm_tpu.hash import poseidon_gl as pnp
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.ops import gl_jax
from eigen_zkvm_tpu.ops import poseidon_jax as pj
from eigen_zkvm_tpu.ops import poseidon_mxu as pm
from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.ops import commit, gl, poseidon

P = 0xFFFFFFFF00000001
B = 68


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _mxu_ref(st):
    t = st.T
    lo, hi = pm.permute_ref(
        jnp.asarray((t & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((t >> np.uint64(32)).astype(np.uint32)))
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32))).T


def _edge_states():
    """tests/test_poseidon_mxu.py's edge states."""
    pm1 = np.uint64(P - 1)
    st = np.zeros((4, 12), dtype=np.uint64)
    st[1, :] = pm1
    st[2, ::2] = pm1
    st[3, :] = np.uint64(0xFFFFFFFF)
    return st


def test_permute_matches_numpy_jax_and_mxu_twin():
    """Random states and tests/test_poseidon_mxu.py's edge states, in one
    batch of B (one JAX compile for this and the next test)."""
    st = np.concatenate([_rand(5, B - 4, 12), _edge_states()])
    got = gl.to_u64(poseidon.permute(gl.from_u64(st)))
    assert np.array_equal(got, pnp.permute(st[:, :8], st[:, 8:]))
    assert np.array_equal(got, _mxu_ref(st))
    assert np.array_equal(
        got, gl_jax.to_u64(pj.permute(gl_jax.from_u64(st))))


def test_permute_plain_in_slices_of_rows():
    """More states than PLAIN_ROWS: the plain version permutes them a slice
    at a time on the CPU, with the numpy permutation's result."""
    n = poseidon.PLAIN_ROWS + 3
    st = np.concatenate([_rand(9, n - 4, 12), _edge_states()])
    got = gl.to_u64(poseidon.permute_plain(gl.from_u64(st)))
    assert np.array_equal(got, pnp.permute(st[:, :8], st[:, 8:]))


def test_hash_n_with_and_without_capacity():
    inp = _rand(6, B, 8)
    cap = _rand(7, B, 4)
    got = gl.to_u64(poseidon.hash_n(gl.from_u64(inp), gl.from_u64(cap)))
    assert np.array_equal(got, pnp.hash_n(inp, cap))
    assert np.array_equal(got, gl_jax.to_u64(pj.hash_n(
        gl_jax.from_u64(inp), gl_jax.from_u64(cap))))
    zero = np.zeros((B, 4), dtype=np.uint64)
    assert np.array_equal(gl.to_u64(poseidon.hash_n(gl.from_u64(inp))),
                          pnp.hash_n(inp, zero))
    # `out` receives the digests in place
    out = torch.empty((B, 4), dtype=torch.int64)
    assert poseidon.hash_n(gl.from_u64(inp), out=out) is out
    assert np.array_equal(gl.to_u64(out), pnp.hash_n(inp, zero))


@pytest.mark.parametrize("stride,offset", [(8, 0), (16, 4), (21, 5), (9, 1)])
def test_hash_n_rows_aligned_to_16_bytes_and_not(stride, offset):
    """`hash_n` reads its 8 lanes at any row stride: rows that start on a
    16-byte boundary (even stride and offset; the kernel reads those 16
    bytes at a time) and rows that do not (stride 21, as the leaf hash of a
    21-column section reads them)."""
    rows = gl.from_u64(_rand(stride, B, stride))
    cap = _rand(offset + 50, B, 4)
    inp = rows[:, offset : offset + 8]
    assert inp.stride(0) == stride
    got = gl.to_u64(poseidon.hash_n(inp, gl.from_u64(cap)))
    assert np.array_equal(got, pnp.hash_n(gl.to_u64(inp), cap))
    st = np.concatenate([gl.to_u64(inp), cap], axis=1)
    assert np.array_equal(got, pnp.permute(st[:, :8], st[:, 8:])[:, :4])


@pytest.mark.parametrize("w", [0, 3, 4, 8, 9, 12, 20, 37])
def test_hash_leaves_linearhash_chunking(w):
    """Against the native leaf hash and linearhash_gl's numpy path (forced
    by passing its chunk size).  ops/poseidon_jax.py's leaf hash meets the
    port through test_torch_commit.py's tree root (its eager XLA:CPU ops
    take seconds per width here)."""
    rows = _rand(w, 16, w)
    got = gl.to_u64(poseidon.hash_leaves(gl.from_u64(rows), w))
    assert np.array_equal(got, linearhash_gl.hash_leaves(rows))
    assert np.array_equal(got, linearhash_gl.hash_leaves(
        rows, batch_size=max(8, -(-w // 4))))


def test_hash_leaves_plain_at_the_fold_tree_width():
    """hash_leaves_plain, the reference chip_smoke.py holds the kernel to,
    at a fold tree's 96-wide leaves: four 24-wide chunks, each sponge call
    after the first taking the previous digest as its capacity."""
    rows = _rand(96, 16, 96)
    got = gl.to_u64(poseidon.hash_leaves_plain(gl.from_u64(rows), 96))
    assert np.array_equal(got, linearhash_gl.hash_leaves(rows))


@pytest.mark.parametrize("height,width", [(1, 5), (13, 3), (64, 8),
                                          (100, 12)])
def test_merkle_root_matches_host_tree(height, width):
    buf = _rand(height + width, height, width)
    sizes, offsets = commit.level_layout(height)
    nodes = commit.build_nodes(gl.from_u64(buf), width)
    host = MerkleTreeGL().merkelize(buf, width, height)
    assert np.array_equal(gl.to_u64(nodes[offsets[-1]]), host.root())
    for lvl, (s, o) in enumerate(zip(sizes, offsets)):
        assert np.array_equal(gl.to_u64(nodes[o : o + s]), host.levels[lvl])


def test_cpu_and_bad_inputs():
    before = kernels.counts()
    poseidon.permute(gl.from_u64(_rand(1, 4, 12)))
    assert kernels.counts() == before
    with pytest.raises(ValueError):
        poseidon.permute(torch.zeros((4, 11), dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon.hash_n(torch.zeros((4, 8), dtype=torch.int64, device="meta"))
