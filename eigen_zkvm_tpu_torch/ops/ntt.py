"""Goldilocks NTT, inverse NTT and coset LDE along axis 0 of [N, P] tensors.

Port of eigen_zkvm_tpu/ops/ntt_jax.py + ops/ntt_pallas.py.  Values are
int64 tensors of u64 bit patterns (ops/gl.py), natural order in and out,
bit-exact with eigen_zkvm_tpu/poly/ntt.py.

A transform of up to 2^KMAX rows is one leaf: the CUDA kernel csrc/ntt.cu
for a CUDA tensor, `leaf_plain` for a CPU tensor.  Longer transforms are a
four-step, as ntt_pallas.ntt: leaf NTTs over the first factor, the twiddle
multiply w^(k1*i2) and the transpose (both fused into the leaf's store),
then the second factor, recursively; up to 2^(2*KMAX) rows that is two
passes over device memory.  The inverse transform runs the forward ladder
with the inverse root and folds 1/n into the last leaf's store;
`interpolate` folds the coset scale n^-1 * SHIFT^j there too, and hands the
extended transform only the rows that hold coefficients: a leaf takes the
rows it is not given as zero, so no zero-padded copy is written or read.

Twiddle tables are built on the host (CPU tensors, ops/gl.py) and copied
to the device once per (size, root, device).
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from . import gl

# Largest leaf: a [2^11, 8]-column tile is 128 KB of the 227 KB of shared
# memory a block may use (csrc/ntt.cu), so transforms of up to 2^22 rows are
# two leaf passes.
KMAX = 11


def _root(nbits: int) -> int:
    return gl.root_of_unity(nbits)


def _root_inv(nbits: int) -> int:
    return gl.inv_int(_root(nbits))


def _device_table(build):
    """Cache the host table build(*args) (a CPU tensor) per (args, device)."""
    @functools.lru_cache(maxsize=64)
    def get(*args, device: torch.device) -> torch.Tensor:
        return build(*args).to(device)
    return get


@_device_table
def _roots(log_n: int, root: int) -> torch.Tensor:
    """root^j for j < n: the leaf's table twiddles."""
    return gl.powers(root, 1 << log_n)


@_device_table
def _four_step(nbits: int, a: int, root: int) -> torch.Tensor:
    """root^(k1*i2) for k1 < 2^a, i2 < 2^(nbits-a), flattened."""
    n1, n2 = 1 << a, 1 << (nbits - a)
    base = gl.powers(root, n2)
    out = torch.empty((n1, n2), dtype=torch.int64)
    out[0] = 1
    for k1 in range(1, n1):
        out[k1] = gl.mul(out[k1 - 1], base)
    return out.reshape(-1)


@_device_table
def _coset_scale(nbits: int) -> torch.Tensor:
    """n^-1 * SHIFT^j: the LDE's coefficient scale."""
    return gl.mul(gl.shift_powers(nbits),
                  gl.as_i64(gl.inv_int(1 << nbits)))


@_device_table
def _n_inv(nbits: int) -> torch.Tensor:
    """n^-1 per row: the inverse transform's scale."""
    return gl.full((1 << nbits,), gl.inv_int(1 << nbits), None)


def _zero_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [rows, M] with zero rows appended up to n."""
    if x.shape[0] == n:
        return x
    pad = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    pad[: x.shape[0]] = x
    return pad


def leaf_plain(x: torch.Tensor, log_n: int, root: int,
               post: torch.Tensor | None = None, P: int | None = None,
               transpose: bool = False) -> torch.Tensor:
    """Plain version of the leaf kernel (same arguments as `_leaf`): the
    radix-2 ladder of poly/ntt.py over axis 0 of x [rows <= n, M], rows
    above the given ones zero, for any n."""
    n = 1 << log_n
    x = _zero_rows(x, n)
    M = x.shape[1]
    P = M if P is None else P
    G = M // P
    buf = x[gl.bit_reverse(log_n).to(x.device)]
    pows = _roots(log_n, root, device=x.device)
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        tw = pows[:: n // m][:half].view(1, half, 1)
        b = buf.view(n // m, m, M)
        t = gl.mul(b[:, half:], tw)
        buf = torch.cat([gl.add(b[:, :half], t), gl.sub(b[:, :half], t)],
                        dim=1).view(n, M)
    if post is not None:
        buf = gl.mul(buf.view(n, G, P), post.view(n, G, 1)).view(n, M)
    if transpose:
        buf = buf.view(n, G, P).transpose(0, 1).reshape(G, n * P)
    return buf


def _is_inverse(log_n: int, root: int) -> bool:
    """Whether `root` is the inverse of the canonical root of order
    2^log_n (the kernel's inner twiddles are fixed powers of two, so it
    takes these two roots only)."""
    if root == _root(log_n):
        return False
    if root == _root_inv(log_n):
        return True
    raise ValueError(f"the NTT kernel takes the canonical root of order "
                     f"2^{log_n} or its inverse, not {root}")


def _leaf(x: torch.Tensor, log_n: int, root: int,
          post: torch.Tensor | None = None, P: int | None = None,
          transpose: bool = False, out: torch.Tensor | None = None):
    """Length-2^log_n NTT along axis 0 of x [rows <= n, M] with `root`, the
    rows above the given ones taken as zero; see csrc/ntt.cu for `post`,
    `P` and `transpose`.  `out` receives the (untransposed) result when
    given."""
    rows, M = x.shape
    n = 1 << log_n
    P = M if P is None else P
    if x.device.type == "cpu":
        res = leaf_plain(x, log_n, root, post, P, transpose)
        if out is None:
            return res
        return out.copy_(res)
    if not x.is_cuda:
        raise ValueError(f"no NTT for device {x.device}")
    if x.dtype != torch.int64 or not x.is_contiguous() or rows > n:
        raise ValueError("the NTT kernel takes a contiguous int64 "
                         "[rows <= 2^a, M]")
    inverse = _is_inverse(log_n, root)
    if M == 0:  # no columns: nothing to launch or count
        return _zero_rows(x, n).clone() if out is None else out
    if log_n > KMAX or M % P:
        raise ValueError(f"leaf of 2^{log_n} rows, M={M}, P={P}")
    if out is None:
        out = torch.empty((M // P, n * P) if transpose else (n, M),
                          dtype=torch.int64, device=x.device)
    elif transpose or not out.is_contiguous() or out.shape != (n, M):
        raise ValueError("`out` takes an untransposed contiguous result")
    roots = _roots(log_n, root, device=x.device)
    kernels.NTT.launch(x.device.index, x.data_ptr(), out.data_ptr(),
                       roots.data_ptr(), kernels.pointer(post), log_n, rows,
                       M, P, int(transpose), int(inverse),
                       stream=torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _split(nbits: int) -> int:
    """The first factor's bits of a four-step of 2^nbits rows."""
    return min((nbits + 1) // 2, KMAX)


def _ntt(x: torch.Tensor, nbits: int, root: int,
         post: torch.Tensor | None = None, post_P: int | None = None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """Four-step NTT of 2^nbits rows with `root`, of x [rows, P] whose
    missing rows (a multiple of the second factor is given) are zero; the
    natural-order output row k is multiplied by post[k] when given (post_P =
    the original P)."""
    rows, P = x.shape
    n = 1 << nbits
    post_P = P if post_P is None else post_P
    if nbits <= KMAX:
        return _leaf(x, nbits, root, post, post_P, out=out)
    a = _split(nbits)
    b = nbits - a
    n1, n2 = 1 << a, 1 << b
    if rows % n2:
        raise ValueError(f"{rows} rows given to a four-step of {n1} x {n2}")
    y = _leaf(x.reshape(rows // n2, n2 * P), a, gl.exp_int(root, n2),
              post=_four_step(nbits, a, root, device=x.device), P=P,
              transpose=True)                                   # [n2, n1*P]
    z = _ntt(y, b, gl.exp_int(root, n1), post, post_P,
             None if out is None else out.view(n2, n1 * P))
    return z.view(n, P)


def _check(x: torch.Tensor, nbits: int):
    if x.dim() != 2 or x.shape[0] != 1 << nbits or x.dtype != torch.int64:
        raise ValueError(f"expected int64 [2^{nbits}, P], got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def ntt(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Forward NTT along axis 0 of [2^nbits, P]."""
    x = _check(x, nbits)
    return _ntt(x, nbits, _root(nbits))


def intt(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse NTT (with the 1/n scale) along axis 0 of [2^nbits, P]."""
    x = _check(x, nbits)
    return _ntt(x, nbits, _root_inv(nbits),
                post=_n_inv(nbits, device=x.device))


def interpolate(x: torch.Tensor, nbits: int, nbits_ext: int) -> torch.Tensor:
    """Coset LDE [2^nbits, P] -> [2^nbits_ext, P]: iNTT, scale coefficient j
    by n^-1 * SHIFT^j, NTT on the extended domain with the coefficients
    above 2^nbits zero (not stored: the first leaf pass takes the missing
    rows as zero)."""
    x = _check(x, nbits)
    coeffs = _ntt(x, nbits, _root_inv(nbits),
                  post=_coset_scale(nbits, device=x.device))
    if nbits_ext > KMAX and nbits < nbits_ext - _split(nbits_ext):
        # fewer coefficients than one row of the four-step's first factor
        coeffs = _zero_rows(coeffs, 1 << (nbits_ext - _split(nbits_ext)))
    return _ntt(coeffs, nbits_ext, _root(nbits_ext))


# ---- plain versions of the whole transforms: one radix-2 ladder over the
# full length, no four-step; the reference that the kernel path is held to

def ntt_plain(x: torch.Tensor, nbits: int) -> torch.Tensor:
    return leaf_plain(_check(x, nbits), nbits, _root(nbits))


def intt_plain(x: torch.Tensor, nbits: int) -> torch.Tensor:
    return leaf_plain(_check(x, nbits), nbits, _root_inv(nbits),
                      post=_n_inv(nbits, device=x.device))


def interpolate_plain(x: torch.Tensor, nbits: int,
                      nbits_ext: int) -> torch.Tensor:
    x = _check(x, nbits)
    n, P = x.shape
    coeffs = leaf_plain(x, nbits, _root_inv(nbits),
                        post=_coset_scale(nbits, device=x.device))
    padded = torch.zeros((1 << nbits_ext, P), dtype=torch.int64,
                         device=x.device)
    padded[:n] = coeffs
    return leaf_plain(padded, nbits_ext, _root(nbits_ext))
