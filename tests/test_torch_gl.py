"""Goldilocks arithmetic of the port (eigen_zkvm_tpu_torch/ops/gl.py, the
plain version of csrc/gl.cuh) against fields/gl64.py and ops/gl_jax.py.
Bit-exact: tolerance 0."""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.fields import gl64
from eigen_zkvm_tpu.ops import gl_jax
from eigen_zkvm_tpu_torch.kernels import gl_check
from eigen_zkvm_tpu_torch.ops import gl

P = gl64.P_INT
EDGE = np.array([0, 1, P - 1, 2**32, 2**32 - 1, 2**63, P - 2**32],
                dtype=np.uint64)


def _operands(seed=7, n=512):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, size=n, dtype=np.uint64) % np.uint64(P)
    b = rng.integers(0, 2**64, size=n, dtype=np.uint64) % np.uint64(P)
    # every ordered pair of edge values
    a = np.concatenate([a, np.repeat(EDGE, EDGE.size)])
    b = np.concatenate([b, np.tile(EDGE, EDGE.size)])
    return a, b


def _jax(fn, *args):
    return gl_jax.to_u64(fn(*[gl_jax.from_u64(x) for x in args]))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_numpy_and_jax(op):
    a, b = _operands()
    got = gl.to_u64(getattr(gl, op)(gl.from_u64(a), gl.from_u64(b)))
    assert np.array_equal(got, getattr(gl64, op)(a, b))
    assert np.array_equal(got, _jax(getattr(gl_jax, op), a, b))


@pytest.mark.parametrize("op", ["neg", "square", "pow7"])
def test_unary_ops_match_numpy_and_jax(op):
    a, _ = _operands(seed=8)
    got = gl.to_u64(getattr(gl, op)(gl.from_u64(a)))
    assert np.array_equal(got, getattr(gl64, op)(a))
    assert np.array_equal(got, _jax(getattr(gl_jax, op), a))


def test_inv_and_exp_const():
    a, _ = _operands(seed=9, n=64)
    a = a[a != 0]
    t = gl.from_u64(a)
    got = gl.to_u64(gl.inv(t))
    assert np.array_equal(got, gl64.inv(a))
    assert np.array_equal(got, _jax(gl_jax.inv, a))
    assert np.array_equal(gl.to_u64(gl.mul(t, gl.inv(t))),
                          np.ones_like(a))
    for e in (0, 1, 7, 2**40 + 3):
        want = gl64.exp(a, e)
        assert np.array_equal(gl.to_u64(gl.exp_const(t, e)), want), e
        assert np.array_equal(
            gl_jax.to_u64(gl_jax.exp_const(gl_jax.from_u64(a), e)), want), e


def test_select_and_scalar_operands():
    a, b = _operands(seed=10)
    mask = (a & np.uint64(1)).astype(bool)
    got = gl.select(torch.from_numpy(mask), gl.from_u64(a), gl.from_u64(b))
    assert np.array_equal(gl.to_u64(got), np.where(mask, a, b))
    # a u64 constant passes as its int64 bit pattern
    for c in (0, 1, P - 1, 2**63 + 5):
        got = gl.to_u64(gl.mul(gl.from_u64(a), gl.as_i64(c)))
        assert np.array_equal(got, gl64.mul(a, np.uint64(c)))


def test_sum_mod_matches_numpy():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2**64, size=(5, 13, 3), dtype=np.uint64) \
        % np.uint64(P)
    for dim in range(3):
        assert np.array_equal(gl.to_u64(gl.sum_mod(gl.from_u64(v), dim)),
                              gl64.sum_mod(v, axis=dim))


def test_u64_crossing_is_zero_copy_on_cpu():
    a = np.array([0, 2**63, 2**64 - 1, P - 1], dtype=np.uint64)
    t = gl.from_u64(a)
    assert t.dtype == torch.int64
    assert t.data_ptr() == a.__array_interface__["data"][0]
    assert np.array_equal(gl.to_u64(t), a)
    assert gl.as_i64(P) == gl.P and gl.as_i64(5) == 5


# ---- the plain twins of the device primitives of csrc/gl.cuh, against
# Python integers on every ordered pair of the edge values (operands at and
# above p included: the device primitives take any u64) and random pairs

def _twin(op, a, b, k=0):
    ta, tb = gl.from_u64(a), gl.from_u64(b)
    if op == "sqr":
        return gl.to_u64(gl.sqr(ta))
    if op == "mul":
        return gl.to_u64(gl.mul(ta, tb))
    if op == "mul_pow2":
        return gl.to_u64(gl.mul_pow2(ta, k))
    if op == "add_nc":
        return gl.to_u64(gl.add(ta, tb))
    if op == "pow7_add":
        lo, hi = gl.mul_wide(gl.sqr(gl.mul(gl.sqr(ta), ta)), ta)
        lo2 = lo + tb
        return gl.to_u64(gl.reduce128(lo2, hi + gl.ult(lo2, tb).long()))
    assert op == "dot"
    return gl.to_u64(gl.dot(ta.view(-1, gl_check.DOT_WIDTH),
                            tb.view(-1, gl_check.DOT_WIDTH), 1))


@pytest.mark.parametrize("op", ["mul", "sqr", "dot", "add_nc", "pow7_add"])
def test_plain_twins_of_device_primitives_on_edge_pairs(op):
    a, b = gl_check.operands(op, 600, seed=3)
    assert np.array_equal(_twin(op, a, b), gl_check.expected(op, a, b))


@pytest.mark.parametrize("ks", [range(0, 64), range(64, 128),
                                range(128, 192)])
def test_mul_pow2_twin_for_every_shift(ks):
    a, b = gl_check.operands("mul_pow2", 200, seed=4)
    for k in ks:
        assert np.array_equal(_twin("mul_pow2", a, b, k),
                              gl_check.expected("mul_pow2", a, b, k)), k
    with pytest.raises(ValueError):
        gl.mul_pow2(gl.from_u64(a), 192)


def test_reduce160_twin_on_edge_words():
    """Three-word values (top, hi, lo) with every word at its edges; top
    stays below 2^32 - 1, as the accumulator keeps it."""
    words = np.array([0, 1, 2**32 - 1, 2**32, 2**63, P - 1, P, 2**64 - 1],
                     dtype=np.uint64)
    tops = np.array([0, 1, 12, 2**31, 2**32 - 2], dtype=np.uint64)
    lo, hi, top = [x.reshape(-1) for x in np.meshgrid(words, words, tops)]
    got = gl.to_u64(gl.reduce160(gl.from_u64(lo), gl.from_u64(hi),
                                 gl.from_u64(top)))
    want = [((int(t) << 128) + (int(h) << 64) + int(l)) % P
            for l, h, t in zip(lo, hi, top)]
    assert [int(g) for g in got] == want


def test_gl_check_expected_agrees_with_the_numpy_engine():
    """The Python-integer yardstick of the device check is itself held to
    fields/gl64.py on canonical operands."""
    a, b = _operands(seed=12)
    for op in ("mul", "add", "sub"):
        assert np.array_equal(gl_check.expected(op, a, b),
                              getattr(gl64, op)(a, b))
    with pytest.raises(ValueError):
        gl_check.run("mul", a, b, torch.device("cpu"))
