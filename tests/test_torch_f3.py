"""GF(p^3) of the port (eigen_zkvm_tpu_torch/ops/f3.py) against
fields/f3g.py and the JAX device products (ops/vm_jax.py `_f3_mul`,
`_f3_inv`; ops/fri_jax.py `_f3_mul`).  Bit-exact: tolerance 0."""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.fields import f3g
from eigen_zkvm_tpu.ops import fri_jax, vm_jax
from eigen_zkvm_tpu.ops.vm_jax import _join64, _split64
from eigen_zkvm_tpu_torch.ops import f3, gl

P = 0xFFFFFFFF00000001
EDGE = np.array([0, 1, P - 1, 2**32, 2**32 - 1, 2**63], dtype=np.uint64)


def _elems(seed, n=257):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**64, size=(n, 3), dtype=np.uint64) % np.uint64(P)
    edges = np.stack(np.meshgrid(EDGE, EDGE, EDGE), -1).reshape(-1, 3)
    return np.concatenate([a, edges[:: 7]])


def _t(a):
    return gl.from_u64(a)


def test_mul_matches_f3g_and_jax():
    a, b = _elems(1), _elems(2)
    got = gl.to_u64(f3.mul(_t(a), _t(b)))
    assert np.array_equal(got, f3g.mul(a, b))
    pa, pb = _split64(a), _split64(b)
    assert np.array_equal(got, _join64(*vm_jax._f3_mul(pa, pb)))
    assert np.array_equal(got, _join64(*fri_jax._f3_mul(pa, pb)))


def test_inv_matches_f3g_and_jax():
    a = _elems(3)
    a = a[np.any(a != 0, axis=1)]
    got = gl.to_u64(f3.inv(_t(a)))
    assert np.array_equal(got, f3g.inv(a))
    assert np.array_equal(got, _join64(*vm_jax._f3_inv(_split64(a))))
    one = gl.to_u64(f3.mul(_t(a), f3.inv(_t(a))))
    assert np.all(one == np.array([1, 0, 0], dtype=np.uint64))


def test_add_sub_neg_mul_base():
    a, b = _elems(4), _elems(5)
    s = _elems(6)[:, 0]
    assert np.array_equal(gl.to_u64(f3.add(_t(a), _t(b))), f3g.add(a, b))
    assert np.array_equal(gl.to_u64(f3.sub(_t(a), _t(b))), f3g.sub(a, b))
    assert np.array_equal(gl.to_u64(f3.neg(_t(a))), f3g.neg(a))
    assert np.array_equal(gl.to_u64(f3.mul_base(_t(a), _t(s))),
                          f3g.mul_base(a, s))
    k = int(s[3])
    assert np.array_equal(gl.to_u64(f3.mul_base(_t(a), gl.as_i64(k))),
                          f3g.mul_base(a, np.uint64(k)))


@pytest.mark.parametrize("n", [1, 2, 37, 256])
def test_prefix_product_matches_f3g(n):
    a = _elems(7, n)[:n]
    assert np.array_equal(gl.to_u64(f3.prefix_product(_t(a))),
                          f3g.prefix_product(a))


def test_int_forms_match_f3g():
    a, b = _elems(8, 40), _elems(9, 40)
    for x, y in zip(a, b):
        tx, ty = tuple(int(v) for v in x), tuple(int(v) for v in y)
        assert f3.mul_int(tx, ty) == tuple(int(v) for v in f3g.mul(x, y))
        assert f3.add_int(tx, ty) == tuple(int(v) for v in f3g.add(x, y))
        assert f3.sub_int(tx, ty) == tuple(int(v) for v in f3g.sub(x, y))
        assert f3.mul_base_int(tx, int(y[0])) == tuple(
            int(v) for v in f3g.mul_base(x, y[0]))
        assert f3.exp_int(tx, 1000003) == tuple(
            int(v) for v in f3g.exp(x, 1000003))
        if any(tx):
            assert f3.inv_int(tx) == tuple(int(v) for v in f3g.inv(x))


def test_broadcast_against_one_point():
    """The VM multiplies [n, 3] columns by one challenge, expanded."""
    a = _elems(10)
    c = _elems(11, 1)[:1]
    got = f3.mul(_t(a), _t(c).expand(a.shape[0], 3))
    assert np.array_equal(gl.to_u64(got),
                          f3g.mul(a, np.broadcast_to(c, a.shape)))
