"""The port's batched BN254 G1/G2 arithmetic (eigen_zkvm_tpu_torch/ops/ec.py,
the plain versions of csrc/msm.cu and csrc/ec_batch.cu) against the JAX
package's curves on the CPU: the MSM on tests/test_ec_jax.py's edge cases
(infinity, a duplicated point, scalars 0, 1 and r - 1) and on
tests/test_native_ec.py's hot buckets, the fixed-base batch against the
Python scalar multiply.  Exact: these are group elements."""
import random

import pytest
import torch

from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.curves.msm import msm_g1, msm_g2
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import ec

R = jbn.R


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g1_points(rng, n):
    g = jbn.g1_from_affine(jbn.G1_GEN)
    return [jbn.g1_to_affine(jbn.g1_mul(g, rng.randrange(1, R)))
            for _ in range(n)]


def _msm(g, pts, scalars):
    return ec.affine_ints(g, ec.msm(g, ec.affine_tensor(g, pts),
                                    bi.to_tensor(scalars)))[0]


@pytest.fixture(scope="module")
def ec_jax_case():
    return _ec_jax_inputs()


def _ec_jax_inputs():
    """tests/test_ec_jax.py::test_msm_differential's inputs."""
    rng = random.Random(7)
    pts = _g1_points(rng, 33)
    pts[3] = None            # infinity input
    pts[7] = pts[5]          # duplicate point (exercises doubling case)
    scalars = [rng.randrange(0, R) for _ in range(33)]
    scalars[11] = 0
    scalars[12] = 1
    scalars[13] = R - 1
    return pts, scalars


def test_g1_msm_edge_cases_match_msm_g1(ec_jax_case):
    pts, scalars = ec_jax_case
    assert _msm(ec.G1, pts, scalars) == msm_g1(jbn, pts, scalars)
    assert _msm(ec.G1, pts[:4], [0, 0, 0, 0]) is None


def test_double_and_add_reference_matches_msm_g1(ec_jax_case):
    """msm_plain, the reference the MSM kernel is held against on the card
    (ec_jax's double-and-add and tree reduce), on the edge cases: an odd
    batch, infinity, a duplicate, scalars 0, 1 and r - 1.  (Its G2 case
    runs on the card: tests/test_torch_kernels.py.)"""
    pts, scalars = ec_jax_case
    got = ec.msm_plain(ec.G1, ec.affine_tensor(ec.G1, pts),
                       bi.to_tensor(scalars))
    assert ec.affine_ints(ec.G1, got)[0] == msm_g1(jbn, pts, scalars)


def test_addition_without_the_host_check_is_the_same(ec_jax_case):
    """`add(..., check=False)`, which msm_plain's rounds replay from a
    CUDA graph on the card, always computes the doubling: the same sums
    where a lane adds a point to itself, to infinity or to another."""
    pts, _ = ec_jax_case
    g = ec.G1
    p = ec.from_affine(g, ec.affine_tensor(g, pts))
    q = tuple(v.flip(0) for v in p)
    for a, b in ((p, p), (p, q), (q, p)):
        want = ec.add(g, a, b)
        got = ec.add(g, a, b, check=False)
        assert ec.affine_ints(g, ec.to_affine(g, got)) == \
            ec.affine_ints(g, ec.to_affine(g, want))


@pytest.mark.parametrize("case", ["hot", "tiny", "doubling"])
def test_g1_msm_hot_buckets_match_msm_g1(case):
    """tests/test_native_ec.py's degenerate inputs: a hot bucket of
    repeated scalar 1, tiny scalars, the same scalar on repeated points."""
    rng = random.Random(13)
    pts = _g1_points(rng, 48)
    pts[7] = None
    pts[11] = pts[10]
    pts[12] = pts[10]
    scalars = {"hot": [1] * 30 + [rng.randrange(R) for _ in range(18)],
               "tiny": [rng.randrange(4) for _ in range(48)],
               "doubling": [R - 1] * 20 + [2] * 28}[case]
    assert _msm(ec.G1, pts, scalars) == msm_g1(jbn, pts, scalars)


def test_g2_msm_matches_msm_g2():
    rng = random.Random(23)
    base = jbn.g2_from_affine(jbn.G2_GEN)
    pts = [jbn.g2_to_affine(jbn.g2_mul(base, rng.randrange(1, R)))
           for _ in range(24)]
    pts[4] = None
    pts[9] = pts[8]
    scalars = [1] * 10 + [rng.randrange(R) for _ in range(12)] + [0, R - 1]
    assert _msm(ec.G2, pts, scalars) == msm_g2(jbn, pts, scalars)


@pytest.mark.parametrize("g", [ec.G1, ec.G2], ids=["G1", "G2"])
def test_fixed_base_batch_matches_scalar_multiply(g):
    rng = random.Random(17)
    scalars = [0, 1, 2, R - 1, R // 2] + [rng.randrange(R) for _ in range(11)]
    got = ec.affine_ints(g, ec.scalar_mul_batch(g, ec.generator(g),
                                                bi.to_tensor(scalars)))
    if g is ec.G1:
        gen = jbn.g1_from_affine(jbn.G1_GEN)
        want = [jbn.g1_to_affine(jbn.g1_mul(gen, s)) for s in scalars]
    else:
        gen = jbn.g2_from_affine(jbn.G2_GEN)
        want = [jbn.g2_to_affine(jbn.g2_mul(gen, s)) for s in scalars]
    assert got == want


def _py_sum(pts, ix):
    """sum of pts[i] over Python G1 points."""
    acc = jbn.G1_ZERO
    for i in ix:
        acc = jbn.g1_add(acc, jbn.g1_from_affine(pts[i]))
    return jbn.g1_to_affine(acc)


def _affine_sums(g, sums):
    return ec.affine_ints(g, ec.to_affine(g, ec.from_jacobian(sums)))


def test_segment_sums_and_digits():
    """The MSM's glue: c-bit digits recombine to the scalar, and a level's
    segment sums (runs of one key cut at chunk boundaries) equal the
    Python sums."""
    rng = random.Random(3)
    scalars = [0, 1, R - 1] + [rng.randrange(R) for _ in range(9)]
    for c in (4, 9, 14):
        d = ec.digits(bi.to_tensor(scalars), c).tolist()
        assert [sum(v << (c * w) for w, v in enumerate(row))
                for row in d] == scalars
    pts = _g1_points(rng, 5)
    refs = torch.tensor([0, 2, 4, 4, 6, 8, 0], dtype=torch.int32)
    start = torch.tensor([0, 4, 5])
    out = ec._segment_sums(ec.G1, ec.affine_tensor(ec.G1, pts), refs, start, 7)
    assert _affine_sums(ec.G1, out) == [
        _py_sum(pts, [0, 1, 2, 2]), _py_sum(pts, [3]), _py_sum(pts, [4, 0])]


@pytest.mark.parametrize("c", [2, 4, 9, 13, 14])
def test_signed_digits_recombine_within_half_a_window(c):
    """Digits in (-2^(c-1), 2^(c-1)] that recombine to the scalar: 1,
    r - 1, 2^253, digits at +2^(c-1) (kept) and 2^(c-1) + 1 (carried), and
    for c = 2, where c divides 254, the carry into the window above bit
    253 (n_windows(2) = 128 = ceil(254 / 2) + 1)."""
    rng = random.Random(c)
    half = 1 << (c - 1)
    W = ec.n_windows(c)
    scalars = [1, R - 1, 1 << 253, (1 << 253) | (1 << 252),
               sum(half << (c * w) for w in range(W - 1)) % (1 << 253),
               sum((half + 1) << (c * w) for w in range(W - 1)) % (1 << 253)
               ] + [rng.randrange(R) for _ in range(20)]
    d = ec.signed_digits(bi.to_tensor(scalars), c)
    assert d.shape == (len(scalars), W) and W * c >= 255
    assert int(d.max()) == half and int(d.min()) > -half
    assert int(d.min()) < 0
    assert [sum(v << (c * w) for w, v in enumerate(row))
            for row in d.tolist()] == scalars
    if c == 2:
        assert W == -(-254 // c) + 1
        assert d[3, W - 1] == 1       # 2^253 + 2^252: -1 then the carry


@pytest.mark.parametrize("case", ["hot", "one_key_chunk", "twice",
                                  "negated", "tiny_chunks"])
def test_level_sums_carry_runs_across_chunks(case, monkeypatch):
    """sum_by_key over level_plain (msm_level's twin) with small chunks:
    a hot key whose run crosses several chunk boundaries and levels, a
    chunk that holds only one key, a key that holds one point twice (the
    doubling), P + (-P) (infinity, left unwritten), and first-level
    chunks of 3 entries; every key's sum equals the Python sum."""
    monkeypatch.setattr(ec, "BUCKET_CHUNK", 3 if case == "tiny_chunks" else 4)
    monkeypatch.setattr(ec, "LEVEL_CHUNK", 4)
    rng = random.Random(11)
    pts = _g1_points(rng, 12)
    pts[5] = None
    if case == "hot":
        ents = [(1, i % 12, False) for i in range(29)] + [(2, 3, False)]
    elif case == "one_key_chunk":
        ents = [(0, 1, False)] * 3 + [(2, i, False) for i in range(4)] + \
            [(3, 7, True), (4, 8, False)]
    elif case == "twice":
        ents = [(0, 4, False), (0, 4, False), (1, 6, True), (1, 6, True),
                (1, 2, False)]
    elif case == "negated":
        ents = sorted([(0, 2, False), (0, 2, True), (3, 9, False),
                       (3, 9, True), (3, 9, False), (5, 1, False)] * 2)
    else:
        ents = sorted((rng.randrange(6), rng.randrange(12),
                       rng.random() < 0.5) for _ in range(40))
    keys = torch.tensor([k for k, _, _ in ents], dtype=torch.int32)
    refs = torch.tensor([2 * i + neg for _, i, neg in ents],
                        dtype=torch.int32)
    n_keys = 7
    got = _affine_sums(ec.G1, ec.sum_by_key(
        ec.G1, ec.level_plain, ec.affine_tensor(ec.G1, pts), refs, keys,
        n_keys))
    want = []
    for k in range(n_keys):
        acc = jbn.G1_ZERO
        for kk, i, neg in ents:
            if kk == k:
                p = jbn.g1_from_affine(pts[i])
                acc = jbn.g1_add(acc, jbn.g1_neg(p) if neg else p)
        want.append(jbn.g1_to_affine(acc))
    assert got == want
    if case == "negated":
        assert got[0] is None and got[3] is not None


@pytest.mark.parametrize("m,s", [(8, 1), (8, 2), (16, 4), (8, 8)])
def test_running_sums_match_direct_weights(m, s):
    """window_chunks_plain (msm_window_chunks' twin) and the window sums:
    each window's sum_d d B_d, against the weights applied directly on
    Python points; infinity buckets among them."""
    rng = random.Random(m * 10 + s)
    n_win = 3
    base = jbn.g1_from_affine(jbn.G1_GEN)
    ks = [0 if rng.random() < 0.2 else rng.randrange(R)
          for _ in range(n_win * m)]
    bucket_pts = [jbn.g1_to_affine(jbn.g1_mul(base, k)) for k in ks]
    buckets = torch.cat([ec.affine_tensor(ec.G1, bucket_pts),
                         torch.zeros((n_win * m, 1, 4), dtype=torch.int64)],
                        1)
    buckets[:, 2] = torch.where(
        (buckets[:, 0] == 0).all(1, keepdim=True), 0,
        bi.to_tensor([bi.FQ.one]))
    parts = ec.window_chunks_plain(ec.G1, buckets, m, s, n_win)
    wkeys = torch.arange(n_win, dtype=torch.int32).repeat_interleave(m // s)
    got = _affine_sums(ec.G1, ec.sum_by_key(ec.G1, ec.level_plain, parts,
                                            None, wkeys, n_win))
    want = [jbn.g1_to_affine(jbn.g1_mul(
        base, sum((b + 1) * ks[w * m + b] for b in range(m)) % R))
        for w in range(n_win)]
    assert got == want


def test_fixed_base_batch_with_zero_lanes_among_one_inversion():
    """Zero scalars (setup's wires missing from A or B) among the lanes
    that share one batch inversion: they come out (0, 0) and leave their
    neighbours right."""
    rng = random.Random(19)
    ks = [rng.randrange(R) if i % 3 else 0 for i in range(40)]
    ks[1] = R - 1
    got = ec.affine_ints(ec.G1, ec.scalar_mul_batch(
        ec.G1, ec.generator(ec.G1), bi.to_tensor(ks)))
    gen = jbn.g1_from_affine(jbn.G1_GEN)
    assert got == [jbn.g1_to_affine(jbn.g1_mul(gen, k)) for k in ks]
    assert all(p is None for p in got[::3])


def test_plain_batches_cut_into_chunks_give_the_same_points(monkeypatch):
    """The level's segment sums and the plain fixed-base batch cut their
    work into batches of PLAIN_CHUNK entries or lanes (the card's sizes);
    with a tiny chunk the sums and lanes come out as with one batch, and
    msm_stages_plain, which the kernel is held against at the prove's
    sizes, equals msm_g1 on the edge cases."""
    rng = random.Random(5)
    pts = ec.affine_tensor(ec.G1, _g1_points(rng, 6))
    refs = torch.tensor([0, 2, 4, 5, 6, 8, 0, 10, 10, 3, 6],
                        dtype=torch.int32)
    start = torch.tensor([0, 4, 5, 7, 9])
    scalars = bi.to_tensor([0, 1, R - 1] + [rng.randrange(R) for _ in range(4)])
    whole = ec._segment_sums(ec.G1, pts, refs, start, 11)
    lanes = ec.scalar_mul_batch_plain(ec.G1, ec.generator(ec.G1), scalars)
    edge_pts, edge_scalars = _ec_jax_inputs()
    got = ec.msm_stages_plain(ec.G1, ec.affine_tensor(ec.G1, edge_pts),
                              bi.to_tensor(edge_scalars))
    assert ec.affine_ints(ec.G1, got)[0] == msm_g1(jbn, edge_pts, edge_scalars)
    monkeypatch.setattr(ec, "PLAIN_CHUNK", 3)
    assert torch.equal(ec._segment_sums(ec.G1, pts, refs, start, 11), whole)
    assert torch.equal(ec.scalar_mul_batch_plain(
        ec.G1, ec.generator(ec.G1), scalars), lanes)


def test_msm_refuses_wrong_shapes():
    """msm checks its shapes before it dispatches."""
    with pytest.raises(ValueError):
        ec.msm(ec.G1, torch.zeros((3, 2, 4), dtype=torch.int64),
               torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ec.msm(ec.G2, torch.zeros((3, 2, 4), dtype=torch.int64),
               torch.zeros((3, 4), dtype=torch.int64))


@pytest.mark.slow
def test_g1_msm_matches_ec_jax(ec_jax_case):
    from eigen_zkvm_tpu.ops import ec_jax

    pts, scalars = ec_jax_case
    assert _msm(ec.G1, pts, scalars) == ec_jax.msm(pts, scalars)
