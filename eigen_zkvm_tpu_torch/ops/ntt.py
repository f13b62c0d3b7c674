"""Goldilocks NTT, inverse NTT and coset LDE along axis 0 of [N, P] tensors.

Port of eigen_zkvm_tpu/ops/ntt_jax.py + ops/ntt_pallas.py.  Values are
int64 tensors of u64 bit patterns (ops/gl.py), natural order in and out,
bit-exact with eigen_zkvm_tpu/poly/ntt.py.

A transform of up to 2^KMAX rows is one leaf: the CUDA kernel csrc/ntt.cu
for a CUDA tensor, `leaf_plain` for a CPU tensor.  Longer transforms are a
four-step, as ntt_pallas.ntt: leaf NTTs over the first factor, the twiddle
multiply w^(k1*i2) and the transpose (both fused into the leaf's store),
then the second factor, recursively.  The inverse transform runs the
forward ladder with the inverse root and folds 1/n into the last leaf's
store; `interpolate` folds the coset scale n^-1 * SHIFT^j there too and
writes straight into the zero-padded extended buffer.

Twiddle tables are built on the host (CPU tensors, ops/gl.py) and copied
to the device once per (size, root, device).
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from . import gl

# Largest leaf: a [2^8, 32]-column tile is 64 KB of shared memory, so three
# blocks fit one SM; 2^20- and 2^21-row transforms are three leaf passes
# either way with a cap of 8 or 9.
KMAX = 8


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
    """root^j for j < max(n/2, 1): the leaf's stage twiddles."""
    return gl.powers(root, max((1 << log_n) // 2, 1))


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


def leaf_plain(x: torch.Tensor, log_n: int, root: int,
               post: torch.Tensor | None = None, P: int | None = None,
               transpose: bool = False) -> torch.Tensor:
    """Plain version of the leaf kernel (same arguments as `_leaf`): the
    radix-2 ladder of poly/ntt.py over axis 0 of x [n, M], for any n."""
    n, M = x.shape
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


def _leaf(x: torch.Tensor, log_n: int, root: int,
          post: torch.Tensor | None = None, P: int | None = None,
          transpose: bool = False, out: torch.Tensor | None = None):
    """Length-2^log_n NTT along axis 0 of x [n, M] with `root`; see
    csrc/ntt.cu for `post`, `P` and `transpose`.  `out` receives the
    (untransposed) result when given."""
    n, M = x.shape
    P = M if P is None else P
    if x.device.type == "cpu":
        res = leaf_plain(x, log_n, root, post, P, transpose)
        if out is None:
            return res
        return out.copy_(res)
    if not x.is_cuda:
        raise ValueError(f"no NTT for device {x.device}")
    if x.dtype != torch.int64 or not x.is_contiguous() or n != 1 << log_n:
        raise ValueError("the NTT kernel takes a contiguous int64 [2^a, M]")
    if M == 0:  # no columns: nothing to launch or count
        return x.clone() if out is None else out
    if log_n > KMAX or M % P:
        raise ValueError(f"leaf of 2^{log_n} rows, M={M}, P={P}")
    if out is None:
        out = torch.empty((M // P, n * P) if transpose else (n, M),
                          dtype=torch.int64, device=x.device)
    elif transpose or not out.is_contiguous() or out.shape != x.shape:
        raise ValueError("`out` takes an untransposed contiguous result")
    roots = _roots(log_n, root, device=x.device)
    kernels.NTT.launch(x.device.index, x.data_ptr(), out.data_ptr(),
                       roots.data_ptr(), kernels.pointer(post), log_n, M, P,
                       int(transpose),
                       stream=torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _ntt(x: torch.Tensor, nbits: int, root: int,
         post: torch.Tensor | None = None, post_P: int | None = None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """Four-step NTT of x [2^nbits, P] with `root`; the natural-order output
    row k is multiplied by post[k] when given (post_P = the original P)."""
    n, P = x.shape
    post_P = P if post_P is None else post_P
    if nbits <= KMAX:
        return _leaf(x, nbits, root, post, post_P, out=out)
    a = min((nbits + 1) // 2, KMAX)
    b = nbits - a
    n1, n2 = 1 << a, 1 << b
    y = _leaf(x.reshape(n1, n2 * P), a, gl.exp_int(root, n2),
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
    by n^-1 * SHIFT^j, zero-pad, NTT on the extended domain."""
    x = _check(x, nbits)
    n, P = x.shape
    padded = torch.empty((1 << nbits_ext, P), dtype=torch.int64,
                         device=x.device)
    padded[n:].zero_()
    _ntt(x, nbits, _root_inv(nbits),
         post=_coset_scale(nbits, device=x.device), out=padded[:n])
    return _ntt(padded, nbits_ext, _root(nbits_ext))


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
