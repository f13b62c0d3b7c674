"""The port's NTT (eigen_zkvm_tpu_torch/ops/ntt.py) on the CPU, where each
leaf runs the kernel's plain version inside the same four-step composition
the CUDA path uses.  Held bit-exact (tolerance 0) against the Pallas kernel
under the interpreter (ops/ntt_pallas.py) and the numpy engine
(poly/ntt.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zkvm_tpu.ops import ntt_pallas as nt
from eigen_zkvm_tpu.poly import ntt as ntt_np
from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.ops import gl, ntt

P = 0xFFFFFFFF00000001


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _pair(x):
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _join(p):
    return (np.asarray(p[0]).astype(np.uint64)
            | (np.asarray(p[1]).astype(np.uint64) << np.uint64(32)))


def _port(fn, x, *args):
    return gl.to_u64(fn(gl.from_u64(x), *args))


@pytest.mark.parametrize("nbits,pcols", [(3, 2), (5, 3), (8, 1), (9, 8)])
def test_ntt_matches_pallas_and_numpy(nbits, pcols):
    """The numpy engine stands in for the Pallas kernel at these sizes:
    tests/test_ntt_pallas.py holds the interpreted kernel equal to it there.
    The interpreter runs here at one shape only (its XLA:CPU compile takes
    seconds per shape), in the intt/interpolate test below."""
    x = _rand(nbits, 1 << nbits, pcols)
    want = ntt_np.ntt(x, nbits)
    assert np.array_equal(_port(ntt.ntt, x, nbits), want)
    assert np.array_equal(_port(ntt.ntt_plain, x, nbits), want)


@pytest.mark.parametrize("nbits", [7, 9, 11])
def test_forced_four_step_matches_pallas_and_numpy(monkeypatch, nbits):
    """Lower the leaf cap so the four-step recursion (and a nested one)
    runs at small N, as tests/test_ntt_pallas.py does with the Pallas
    kernel's KMAX.  That test holds the interpreted Pallas four-step equal
    to the numpy engine at 7, 9 and 11, so the numpy engine stands in for
    it here (the interpreter's compile of the nested four-step alone takes
    seconds)."""
    monkeypatch.setattr(ntt, "KMAX", 4)
    x = _rand(100 + nbits, 1 << nbits, 2)
    assert np.array_equal(_port(ntt.ntt, x, nbits), ntt_np.ntt(x, nbits))
    assert np.array_equal(_port(ntt.intt, x, nbits), ntt_np.intt(x, nbits))


def test_intt_and_interpolate_match_pallas_and_numpy():
    """The interpreted Pallas kernel at one shape, [2^6, 8] (two radix-8
    levels): its intt, its forward ntt (the same compiled kernel with the
    other root) and its interpolate."""
    nbits = 6
    x = _rand(6, 1 << nbits, 8)
    got = _port(ntt.intt, x, nbits)
    assert np.array_equal(got, ntt_np.intt(x, nbits))
    assert np.array_equal(got, _join(nt.intt(_pair(x), nbits, interpret=True)))
    assert np.array_equal(_port(ntt.intt_plain, x, nbits), got)
    assert np.array_equal(_port(ntt.ntt, x, nbits),
                          _join(nt.ntt(_pair(x), nbits, interpret=True)))
    lde = _port(ntt.interpolate, x, nbits, nbits + 2)
    assert np.array_equal(lde, ntt_np.interpolate(x, nbits, nbits + 2))
    assert np.array_equal(
        lde, _join(nt.interpolate(_pair(x), nbits, nbits + 2, interpret=True)))
    assert np.array_equal(_port(ntt.interpolate_plain, x, nbits, nbits + 2),
                          lde)


def test_four_step_interpolate_at_the_commit_shape(monkeypatch):
    """The LDE the prover commits, [N, 8] -> [2N, 8], through two levels of
    four-step with the fused coset scale and zero-pad."""
    monkeypatch.setattr(ntt, "KMAX", 3)
    x = _rand(12, 1 << 10, 8)
    assert np.array_equal(_port(ntt.interpolate, x, 10, 11),
                          ntt_np.interpolate(x, 10, 11))


@pytest.mark.parametrize("fn,args", [("ntt", (13,)), ("intt", (13,)),
                                     ("interpolate", (12, 13)),
                                     ("interpolate", (13, 15))])
def test_four_step_at_the_kernel_leaf_cap(fn, args):
    """One size above 2^KMAX, so the two-pass composition the card runs at
    2^20-2^22 rows (first factor 2^7, second 2^6 at 2^13) runs on the CPU
    with the cap the kernel has."""
    assert ntt.KMAX == 11 and args[-1] > ntt.KMAX
    x = _rand(sum(args), 1 << args[0], 3)
    assert np.array_equal(_port(getattr(ntt, fn), x, *args),
                          getattr(ntt_np, fn)(x, *args))


def test_four_step_at_the_cap_matches_pallas_interpreter_shape():
    """The Pallas interpreter's one small shape ([2^6, 8]), with the port's
    leaf cap lowered so that it is a four-step with the zero half unread:
    held to the interpreted kernel's interpolate."""
    nbits = 6
    x = _rand(6, 1 << nbits, 8)
    want = _join(nt.interpolate(_pair(x), nbits, nbits + 2, interpret=True))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ntt, "KMAX", 5)
        assert np.array_equal(_port(ntt.interpolate, x, nbits, nbits + 2),
                              want)
    finally:
        mp.undo()


@pytest.mark.parametrize("nbits,ext,kmax", [(4, 5, 11), (6, 9, 4), (10, 11, 3),
                                            (2, 9, 4), (12, 14, 11)])
def test_interpolate_with_the_zero_half_unread(monkeypatch, nbits, ext, kmax):
    """`interpolate` hands the extended transform only the coefficient rows
    (or, where there are fewer than one row of the first factor, pads);
    `interpolate_plain` pads with zeros and runs one long ladder."""
    monkeypatch.setattr(ntt, "KMAX", kmax)
    x = _rand(nbits * 31 + ext, 1 << nbits, 3)
    assert np.array_equal(_port(ntt.interpolate, x, nbits, ext),
                          _port(ntt.interpolate_plain, x, nbits, ext))


@pytest.mark.parametrize("rows", [1, 4, 8, 16])
def test_leaf_takes_missing_rows_as_zero(rows):
    log_n, M = 4, 6
    x = _rand(rows, rows, M)
    full = np.zeros((1 << log_n, M), dtype=np.uint64)
    full[:rows] = x
    root = gl.root_of_unity(log_n)
    post = _rand(rows + 1, (1 << log_n) * 2)
    got = ntt._leaf(gl.from_u64(x), log_n, root, gl.from_u64(post), 3, True)
    want = ntt._leaf(gl.from_u64(full), log_n, root, gl.from_u64(post), 3,
                     True)
    assert torch.equal(got, want)
    assert np.array_equal(gl.to_u64(ntt._leaf(gl.from_u64(x), log_n, root)),
                          ntt_np.ntt(full, log_n))


def test_kernel_roots_are_the_canonical_ones_and_powers_of_two():
    """The kernel's inner twiddles: the canonical roots of order 2, 4, 8 and
    16 are 2^96, 2^48, 2^120 and 2^156, and 2 has order 192.  Any other root
    is refused."""
    for t, e in ((1, 96), (2, 48), (3, 120), (4, 156)):
        assert gl.root_of_unity(t) == pow(2, e, P)
    assert pow(2, 192, P) == 1 and pow(2, 96, P) == P - 1
    assert ntt._is_inverse(5, gl.root_of_unity(5)) is False
    assert ntt._is_inverse(5, gl.inv_int(gl.root_of_unity(5))) is True
    with pytest.raises(ValueError):
        ntt._is_inverse(5, pow(gl.root_of_unity(5), 3, P))


def test_leaf_post_and_transpose_layout():
    """The leaf's fused store, by the DFT's definition: element (r, c)
    times post[(r*M + c) // P], then out[(c // P) * n + r, c % P]."""
    log_n, M, Pw = 2, 6, 3
    n, G = 1 << log_n, M // 3
    root = pow(7, (P - 1) >> log_n, P)
    x = _rand(1, n, M)
    post = _rand(2, n * G)
    got = gl.to_u64(ntt.leaf_plain(gl.from_u64(x), log_n, root,
                                   gl.from_u64(post), Pw, transpose=True))
    want = np.zeros((G, n * Pw), dtype=np.uint64)
    for r in range(n):
        for c in range(M):
            v = sum(int(x[i, c]) * pow(root, i * r, P) for i in range(n)) % P
            v = v * int(post[(r * M + c) // Pw]) % P
            want[c // Pw, r * Pw + c % Pw] = v
    assert np.array_equal(got, want)


def test_cpu_tensors_take_the_plain_version_only():
    before = kernels.counts()
    ntt.interpolate(gl.from_u64(_rand(3, 16, 2)), 4, 5)
    assert kernels.counts() == before
    meta = torch.empty((8, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt.ntt(meta, 3)
    with pytest.raises(ValueError):
        ntt.ntt(gl.from_u64(_rand(4, 6, 2)), 3)
