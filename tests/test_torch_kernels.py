"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Comparisons are bit-exact (tolerance 0): all of it is integer arithmetic in
the Goldilocks field, in BN254's Fq, Fr and Fq2, or on its curves.
"""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.hash import linearhash_gl, poseidon_gl
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.poly import ntt as ntt_np
from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.curves.msm import msm_g1, msm_g2
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.groth16 import api as g16_api
from eigen_zkvm_tpu_torch.kernels import bn254_check, gl_check
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import (commit, ec, fr_ntt, gl, ntt, poseidon,
                                      r1cs)

P = 0xFFFFFFFF00000001
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(rng, *shape):
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _equal(got: torch.Tensor, want: torch.Tensor):
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want.cpu())


def test_device_field_primitives_match_python_integers(cuda):
    """mul, sqr, add, sub, mul_pow2 (every k < 192), the three-word dot
    product, add_nc and the S-box of csrc/gl.cuh on every ordered pair of
    their edge operands and 2^20 random pairs."""
    assert gl_check.failures(cuda) == []


@pytest.mark.parametrize("log_n,M,P_,transpose,post", [
    (0, 7, 7, False, False), (1, 5, 5, False, True), (5, 37, 37, False, True),
    (8, 64, 8, True, True), (8, 1000, 8, False, True), (7, 96, 3, True, False),
    (2, 9, 3, True, True), (3, 16, 8, False, False), (4, 40, 8, True, True),
    (6, 64, 8, True, False), (9, 24, 3, True, True), (10, 64, 8, True, True),
    (10, 9, 3, False, False), (11, 24, 8, True, True),
    (11, 16, 8, False, False)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_leaf_kernel_matches_plain(cuda, log_n, M, P_, transpose, post,
                                       inverse):
    """Every pass plan (radix 2, 4, 8, 16; one to three passes), both
    roots, 8- and 16-byte tile accesses, all rows given and only the lower
    half (the rest taken as zero)."""
    rng = np.random.default_rng(log_n * 1000 + M)
    host = _rand(rng, 1 << log_n, M)
    host[:, 0] = 0
    host[:, -1] = P - 1
    x = gl.from_u64(host, cuda)
    root = int(pow(7, (P - 1) >> log_n, P))
    if inverse:
        root = pow(root, P - 2, P)
    tab = gl.from_u64(_rand(rng, (1 << log_n) * (M // P_)), cuda) \
        if post else None
    before = kernels.NTT.launches
    got = ntt._leaf(x, log_n, root, tab, P_, transpose)
    assert kernels.NTT.launches == before + 1
    _equal(got, ntt.leaf_plain(x, log_n, root, tab, P_, transpose))
    half = x[: max(1, (1 << log_n) // 2)]
    _equal(ntt._leaf(half, log_n, root, tab, P_, transpose),
           ntt.leaf_plain(half, log_n, root, tab, P_, transpose))


def test_ntt_leaf_kernel_refuses_other_roots(cuda):
    x = torch.zeros((32, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ntt._leaf(x, 5, pow(gl.root_of_unity(5), 3, P))


@pytest.mark.parametrize("nbits,nbits_ext,P_", [(6, 8, 3), (12, 13, 8),
                                                (17, 18, 5), (13, 16, 2),
                                                (2, 13, 3), (21, 22, 3)])
def test_ntt_paths_kernel_matches_plain_and_host(cuda, nbits, nbits_ext, P_):
    rng = np.random.default_rng(nbits)
    host = _rand(rng, 1 << nbits, P_)
    x = gl.from_u64(host, cuda)
    _equal(ntt.ntt(x, nbits), ntt.ntt_plain(x, nbits))
    _equal(ntt.intt(x, nbits), ntt.intt_plain(x, nbits))
    lde = ntt.interpolate(x, nbits, nbits_ext)
    _equal(lde, ntt.interpolate_plain(x, nbits, nbits_ext))
    assert np.array_equal(gl.to_u64(lde),
                          ntt_np.interpolate(host, nbits, nbits_ext))


@pytest.mark.parametrize("B", [1, 130, 4096])
def test_poseidon_permute_kernel_matches_plain(cuda, B):
    rng = np.random.default_rng(B)
    st = _rand(rng, B, 12)
    st[0, :] = 0
    st[-1, :] = P - 1
    got = poseidon.permute(gl.from_u64(st, cuda))
    _equal(got, poseidon.permute_plain(gl.from_u64(st, cuda)))
    assert np.array_equal(gl.to_u64(got),
                          poseidon_gl.permute(st[:, :8], st[:, 8:]))


@pytest.mark.parametrize("stride,offset", [(21, 5), (16, 4), (8, 0), (9, 1)])
def test_poseidon_hash_n_strided_input_and_capacity(cuda, stride, offset):
    """Rows the kernel reads 8 bytes at a time (odd stride or offset) and
    rows it reads 16 bytes at a time."""
    rng = np.random.default_rng(3)
    rows = gl.from_u64(_rand(rng, 300, stride), cuda)
    cap = gl.from_u64(_rand(rng, 300, 4), cuda)
    inp = rows[:, offset : offset + 8]
    _equal(poseidon.hash_n(inp, cap), poseidon.hash_n_plain(inp, cap))
    _equal(poseidon.hash_n(inp), poseidon.hash_n_plain(inp))
    out = torch.empty((301, 4), dtype=torch.int64, device=cuda)[1:]
    _equal(poseidon.hash_n(inp, out=out), poseidon.hash_n_plain(inp))


@pytest.mark.parametrize("w", [0, 3, 4, 8, 9, 12, 20, 37, 96])
def test_hash_leaves_kernel_matches_host(cuda, w):
    rng = np.random.default_rng(w)
    rows = _rand(rng, 257, w)
    got = poseidon.hash_leaves(gl.from_u64(rows, cuda), w)
    assert np.array_equal(gl.to_u64(got),
                          linearhash_gl.hash_leaves(rows, batch_size=0))


@pytest.mark.parametrize("height,width", [(1, 3), (13, 5), (1 << 10, 8)])
def test_device_tree_matches_host(cuda, height, width):
    rng = np.random.default_rng(height)
    buf = _rand(rng, height, width)
    tree = commit.merkelize(gl.from_u64(buf, cuda))
    host = MerkleTreeGL().merkelize(buf, width, height)
    assert np.array_equal(tree.root(), host.root())
    for idx in sorted({0, 1 % height, height // 2, height - 1}):
        v, mp = tree.get_group_proof(idx)
        hv, hmp = host.get_group_proof(idx)
        assert np.array_equal(v, hv)
        assert all(np.array_equal(a, b) for a, b in zip(mp, hmp))


def test_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        poseidon.permute(torch.zeros((4, 12), dtype=torch.float32,
                                     device=cuda))
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((6, 2), dtype=torch.int64, device=cuda), 3)


def test_bn254_field_primitives_match_python_ints(cuda):
    """add, sub, neg, mul, sqr, inv of Fq and Fr and mul, sqr, inv of Fq2
    (csrc/bn254.cuh) on every ordered pair of their edge operands and
    2^14 random pairs."""
    assert bn254_check.failures(cuda, 1 << 14) == []


def _bn254_points(g, n, seed, device):
    import random

    rng = random.Random(seed)
    return ec.scalar_mul_batch(g, ec.generator(g), bi.to_tensor(
        [rng.randrange(1, jbn.R) for _ in range(n)], device))


@pytest.mark.parametrize("g,n", [(ec.G1, 1), (ec.G1, 300), (ec.G1, 4096),
                                 (ec.G2, 300)], ids=["G1-1", "G1-300",
                                                     "G1-4096", "G2-300"])
def test_msm_kernel_matches_plain_and_python(cuda, g, n):
    """Infinity points, a duplicated point, scalars 0, 1 and r - 1, and a
    hot bucket of scalar 1 and 0."""
    import random

    rng = random.Random(n)
    pts = _bn254_points(g, n, n, cuda)
    ks = [rng.randrange(jbn.R) for _ in range(n)]
    if n > 20:
        pts[3] = 0
        pts[9] = pts[8]
        ks[0], ks[1], ks[2] = 0, 1, jbn.R - 1
        for i in range(10, n // 2):
            ks[i] = i & 1
    S = bi.to_tensor(ks, cuda)
    before = kernels.MSM.launches
    got = ec.msm(g, pts, S)
    assert kernels.MSM.launches > before
    _equal(got, ec.msm_plain(g, pts, S))
    if n <= 300:
        want = (msm_g1 if g is ec.G1 else msm_g2)(
            jbn, ec.affine_ints(g, pts), ks)
        assert ec.affine_ints(g, got)[0] == want


def _signed_digit_scalars(c: int, count: int, seed: int) -> list:
    """Scalars whose digits sit at +2^(c-1) and carry (2^(c-1) + 1), 1,
    r - 1, 2^253, then random ones."""
    import random

    rng = random.Random(seed)
    half, W = 1 << (c - 1), ec.n_windows(c)
    return [1, jbn.R - 1, 1 << 253, (1 << 253) | (1 << 252),
            sum(half << (c * w) for w in range(W - 1)) % (1 << 253),
            sum((half + 1) << (c * w) for w in range(W - 1)) % (1 << 253)
            ] + [rng.randrange(jbn.R) for _ in range(count - 6)]


@pytest.mark.parametrize("c", [2, 4, 10, 14])
def test_msm_digits_kernel_matches_plain(cuda, c):
    """msm_digits' entries, as sorted (key, ref) pairs, equal
    entries_plain's: infinity points left out, digits at +-2^(c-1), the
    carry into the window above bit 253 at c = 2."""
    ks = _signed_digit_scalars(c, 3000, c)
    pts = _bn254_points(ec.G1, len(ks), 5, cuda)
    pts[7] = 0
    S = bi.to_tensor(ks, cuda)

    def pairs(k, r):
        return torch.sort(k.long() * (1 << 32) + r.long()).values.cpu()

    got = ec.entries(pts, S, c)
    want = ec.entries_plain(pts, S, c)
    assert torch.equal(pairs(*got), pairs(*want))


@pytest.mark.parametrize("g", [ec.G1, ec.G2], ids=["G1", "G2"])
def test_msm_level_kernel_matches_plain(cuda, g, monkeypatch):
    """msm_level's bucket sums and carries against level_plain's, as
    affine points, over small chunks: a hot key over many chunks, keys
    with one entry, a point twice, P + (-P)."""
    import random

    rng = random.Random(9)
    pts = _bn254_points(g, 64, 9, cuda)
    ents = sorted([(1, i % 64, i % 3 == 0) for i in range(300)]
                  + [(0, 5, False), (0, 5, False), (2, 7, False),
                     (2, 7, True)]
                  + [(rng.randrange(3, 40), rng.randrange(64),
                      rng.random() < 0.5) for _ in range(200)])
    keys = torch.tensor([k for k, _, _ in ents], dtype=torch.int32,
                        device=cuda)
    refs = torch.tensor([2 * i + n for _, i, n in ents], dtype=torch.int32,
                        device=cuda)

    def affine(t):
        return ec.affine_ints(g, ec.to_affine(g, ec.from_jacobian(t)))

    monkeypatch.setattr(ec, "LEVEL_CHUNK", 4)
    for L in (5, 64):
        got_sums = torch.zeros((40, 3, *g.coord_shape), dtype=torch.int64,
                               device=cuda)
        want_sums = torch.zeros_like(got_sums)
        gk, gp = ec.level(g, pts, refs, keys, L, got_sums)
        wk, wp = ec.level_plain(g, pts, refs, keys, L, want_sums)
        _equal(gk, wk)
        assert affine(gp) == affine(wp)
        assert affine(got_sums) == affine(want_sums)
        assert affine(ec.sum_by_key(g, ec.level, pts, refs, keys, 40)) == \
            affine(ec.sum_by_key(g, ec.level_plain, pts, refs, keys, 40))


@pytest.mark.parametrize("g", [ec.G1, ec.G2], ids=["G1", "G2"])
def test_msm_with_signed_digit_edges_matches_double_and_add(cuda, g):
    """The MSM (every kernel 1 stage) on scalars whose digits sit at
    +-2^(c-1) and carry, against ec_jax's double-and-add."""
    ks = _signed_digit_scalars(ec.window_bits(2048), 2048, 3)
    pts = _bn254_points(g, len(ks), 4, cuda)
    pts[9] = pts[8]
    S = bi.to_tensor(ks, cuda)
    _equal(ec.msm(g, pts, S), ec.msm_plain(g, pts, S))
    _equal(ec.msm(g, pts, S), ec.msm_stages_plain(g, pts, S))


def test_fixed_base_kernel_zero_lanes_among_one_threads_lanes(cuda):
    """More lanes than threads, so each thread's batch inversion spans
    several lanes, with zero scalars among them (every third lane and a
    run of 1000)."""
    import random

    rng = random.Random(6)
    n = 400_000
    ks = torch.randint(-2**63, 2**63 - 1, (n, 4), dtype=torch.int64,
                       device=cuda)
    ks[:, 3] &= (1 << 61) - 1
    ks[::3] = 0
    ks[5000:6000] = 0
    ks[:3] = bi.to_tensor([1, jbn.R - 1, rng.randrange(jbn.R)], cuda)
    got = ec.scalar_mul_batch(ec.G1, ec.generator(ec.G1), ks)
    _equal(got, ec.scalar_mul_batch_plain(ec.G1, ec.generator(ec.G1), ks))
    assert bool((got[3::3] == 0).all())


@pytest.mark.parametrize("g", [ec.G1, ec.G2], ids=["G1", "G2"])
def test_fixed_base_kernel_matches_plain(cuda, g):
    import random

    rng = random.Random(4)
    ks = [0, 1, 2, jbn.R - 1] + [rng.randrange(jbn.R) for _ in range(1000)]
    S = bi.to_tensor(ks, cuda)
    before = kernels.EC_BATCH.launches
    got = ec.scalar_mul_batch(g, ec.generator(g), S)
    assert kernels.EC_BATCH.launches == before + 1
    _equal(got, ec.scalar_mul_batch_plain(g, ec.generator(g), S))


@pytest.mark.parametrize("log_n", [1, 5, 12, 16, 21, 22, 23])
def test_fr_ntt_kernel_matches_plain(cuda, log_n):
    """The passes (one up to 2^11, two at 2^16-2^22, three at 2^23) against
    the reference ladder; x is left as it was; one launch a pass."""
    import random

    rng = random.Random(log_n)
    x = bi.mont_ints(bi.FR, [rng.randrange(jbn.R) for _ in range(1 << log_n)],
                     cuda)
    x0 = x.clone()
    for inverse in (False, True):
        before = kernels.FR_NTT.launches
        got = fr_ntt.ntt(x, log_n, inverse)
        assert kernels.FR_NTT.launches == before + len(fr_ntt.plan(log_n))
        _equal(got, fr_ntt.ntt_plain(x, log_n, inverse))
    _equal(x, x0)
    if log_n > 16:
        return
    k = fr_ntt.mont_const(12345, cuda)
    _equal(fr_ntt.quotient(x, x, x, k), fr_ntt.quotient_plain(x, x, x, k))
    _equal(fr_ntt.mul(x, x), fr_ntt.mul_plain(x, x))
    _equal(fr_ntt.mul(x, k), fr_ntt.mul_plain(x, k))


@pytest.mark.parametrize("log_n,tile_bits", [(0, 11), (7, 3), (9, 3), (9, 4),
                                             (12, 5), (16, 6), (21, 7)])
def test_fr_ntt_kernel_at_narrow_tiles_matches_plain(cuda, log_n, tile_bits):
    """Passes of fewer bits than the kernel's 11: uneven splits, three to
    five passes, tiles of many columns."""
    import random

    rng = random.Random(log_n + 100 * tile_bits)
    x = bi.mont_ints(bi.FR, [rng.randrange(jbn.R) for _ in range(1 << log_n)],
                     cuda)
    for inverse in (False, True):
        _equal(fr_ntt.ntt(x, log_n, inverse, tile_bits=tile_bits),
               fr_ntt.ntt_plain(x, log_n, inverse))
    _equal(fr_ntt.from_coset(x, log_n, tile_bits=tile_bits),
           fr_ntt.from_coset_plain(x, log_n))


@pytest.mark.parametrize("log_n", [1, 5, 16, 21])
def test_fr_coset_kernels_match_plain(cuda, log_n):
    """to_coset and from_coset (the scale on the inverse's last pass)
    against the ladder and a separate product."""
    import random

    rng = random.Random(log_n)
    x = bi.mont_ints(bi.FR, [rng.randrange(jbn.R) for _ in range(1 << log_n)],
                     cuda)
    before = kernels.FR_NTT.launches
    y = fr_ntt.to_coset(x, log_n)
    assert kernels.FR_NTT.launches == before + 2 * len(fr_ntt.plan(log_n))
    _equal(y, fr_ntt.to_coset_plain(x, log_n))
    _equal(fr_ntt.from_coset(y, log_n), fr_ntt.from_coset_plain(y, log_n))
    _equal(fr_ntt.ntt(fr_ntt.from_coset(y, log_n), log_n), x)


def test_r1cs_kernel_matches_plain(cuda):
    circ = bg.synthetic(3000, 2, seed=5)
    wit = fr_ntt.to_mont(bi.to_tensor(circ.w, cuda))
    rows = r1cs.build(circ.constraints, cuda)
    before = kernels.R1CS.launches
    got = r1cs.evaluate(rows, wit, 4096, 3)
    assert kernels.R1CS.launches == before + 1
    _equal(got, r1cs.evaluate_plain(rows, wit, 4096, 3))


@pytest.mark.parametrize("n_rows", [1 << 10, 1 << 14])
def test_r1cs_long_rows_kernel_matches_plain(cuda, n_rows):
    """Rows of 0 to 4,096 nonzeros (warps and threads in one launch), the
    coefficient index as int16 (2^10: fewer than 2^15 distinct values) and
    as int32 (2^14), publics in A's tail."""
    circ = bg.long_rows(n_rows, seed=7)
    rows = r1cs.build(circ.constraints, cuda)
    assert rows.n_short < 3 * rows.nc
    assert rows.cidx.dtype == (torch.int16 if n_rows == 1 << 10
                               else torch.int32)
    wit = fr_ntt.to_mont(bi.to_tensor(circ.w, cuda))
    m = n_rows + 5
    _equal(r1cs.evaluate(rows, wit, m, 5),
           r1cs.evaluate_plain(rows, wit, m, 5))


def test_groth16_on_the_card_writes_the_cpu_bytes(cuda):
    """A 2^10 synthetic circuit: setup and prove on the card (the default
    device) and on the CPU write the same proof JSON."""
    circ = bg.synthetic((1 << 10) - 3, 2, seed=4)
    out = []
    for device in (None, "cpu"):
        pk, vk = g16_api.groth16_setup_inplace("bn128", circ,
                                               rng=bg.seeded(11),
                                               device=device)
        proof, pubs = g16_api.groth16_prove_inplace("bn128", circ, pk,
                                                    rng=bg.seeded(12))
        assert g16_api.groth16_verify_inplace("bn128", vk, proof, pubs)
        out.append(g16_api.proof_to_json(proof, "bn128"))
    assert out[0] == out[1]
