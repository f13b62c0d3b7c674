"""Batched Poseidon-GL permutation, sponge hash and Merkle leaf hash.

Port of eigen_zkvm_tpu/ops/poseidon_jax.py (`permute`, `hash_n`,
`hash_leaves`) with the Pallas kernels ops/poseidon_pallas.py and
ops/poseidon_mxu.py folded into one CUDA kernel, csrc/poseidon_gl.cu.
States are int64 tensors of u64 bit patterns (ops/gl.py); digests are
bit-exact with hash/poseidon.py and eigen_zkvm_tpu/hash/linearhash_gl.py.

`permute` and `hash_n` launch the kernel for CUDA tensors and run the plain
version (`permute_plain`, `hash_n_plain`) for CPU tensors.  A Merkle level
is `hash_n` over the level viewed as [n/2, 8] with zero capacity
(`fold_root_pow2` folds a power-of-two batch of digests so).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..hash import poseidon as pnp
from . import gl

T = 12
_HALF_F = 4
_N_P = 22
# on the CPU the plain version permutes this many states at a time: its
# dozens of temporaries a round then stay in a core's cache (2^16 states
# at once take about twice as long a state)
PLAIN_ROWS = 1 << 12


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> dict:
    return {k: gl.from_u64(v, device)
            for k, v in (("C", pnp.C), ("M", pnp.M), ("P", pnp.PMAT),
                         ("S", pnp.S))}


def _mix(st, mat):
    """out[:, i] = sum_j st[:, j] * mat[j, i]."""
    return gl.sum_mod(gl.mul(st[:, :, None], mat[None, :, :]), dim=1)


def _mix_mds(st, m):
    """_mix for the MDS matrix, whose entries are below 2^6: each 32-bit limb
    of the state times the matrix sums to under 2^42 without wrapping, so one
    128-bit reduction per output replaces twelve multiplies and the sum."""
    lo = ((st & 0xFFFFFFFF)[:, :, None] * m).sum(dim=1)
    hi = (((st >> 32) & 0xFFFFFFFF)[:, :, None] * m).sum(dim=1)
    # lo + hi * 2^32 as a 128-bit (low, high) pair
    low = lo + ((hi & 0xFFFFFFFF) << 32)
    high = ((hi >> 32) & 0xFFFFFFFF) + gl.ult(low, lo).long()
    return gl.reduce128(low, high)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: [B, 12] -> [B, 12], the opt schedule of
    hash/poseidon_gl.py::permute, on the CPU PLAIN_ROWS states at a time."""
    if state.shape[0] <= PLAIN_ROWS or state.device.type != "cpu":
        return _permute_rows(state)
    return torch.cat([_permute_rows(s) for s in state.split(PLAIN_ROWS)])


def _permute_rows(state: torch.Tensor) -> torch.Tensor:
    k = _consts(state.device)
    C, M, S = k["C"], k["M"], k["S"]
    st = gl.add(state, C[None, 0:T])
    for r in range(_HALF_F - 1):
        st = _mix_mds(gl.add(gl.pow7(st), C[None, (r + 1) * T : (r + 2) * T]),
                      M)
    st = _mix(gl.add(gl.pow7(st), C[None, _HALF_F * T : (_HALF_F + 1) * T]),
              k["P"])
    for r in range(_N_P):
        base = (2 * T - 1) * r
        s0 = gl.add(gl.pow7(st[:, 0:1]), C[(_HALF_F + 1) * T + r])
        new0 = gl.sum_mod(gl.mul(torch.cat([s0, st[:, 1:]], dim=1),
                                 S[None, base : base + T]), dim=1)
        tail = gl.add(st[:, 1:], gl.mul(s0, S[None, base + T : base + 2 * T - 1]))
        st = torch.cat([new0[:, None], tail], dim=1)
    base = (_HALF_F + 1) * T + _N_P
    for r in range(_HALF_F - 1):
        st = _mix_mds(gl.add(gl.pow7(st),
                             C[None, base + r * T : base + (r + 1) * T]), M)
    return _mix_mds(gl.pow7(st), M)


def hash_n_plain(inp: torch.Tensor, cap: torch.Tensor | None = None):
    """Plain version of the kernel's sponge call: [B, 8] x [B, 4] -> [B, 4]."""
    if cap is None:
        cap = torch.zeros((inp.shape[0], 4), dtype=torch.int64,
                          device=inp.device)
    return permute_plain(torch.cat([inp, cap], dim=1))[:, :4].contiguous()


_constants_on: set = set()


def _launch(inp, in_width: int, cap, out, out_width: int):
    if inp.shape[0] == 0:  # no states: nothing to launch or count
        return
    dev = inp.device
    if dev.index not in _constants_on:
        keep = [np.ascontiguousarray(a, dtype=np.uint64)
                for a in (pnp.C, pnp.M, pnp.PMAT, pnp.S)]
        kernels.check("poseidon_gl_set_constants",
                      kernels.library().poseidon_gl_set_constants(
                          dev.index, *[a.ctypes.data for a in keep]))
        _constants_on.add(dev.index)
    kernels.POSEIDON.launch(dev.index, inp.data_ptr(), inp.stride(0),
                            in_width, kernels.pointer(cap), out.data_ptr(),
                            out.stride(0), out_width, inp.shape[0],
                            stream=torch.cuda.current_stream(dev).cuda_stream)


def _rows(t: torch.Tensor, width: int, name: str) -> torch.Tensor:
    if t.dim() != 2 or t.shape[1] != width or t.dtype != torch.int64:
        raise ValueError(f"{name}: expected int64 [B, {width}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t if t.stride(1) == 1 else t.contiguous()


def permute(state: torch.Tensor) -> torch.Tensor:
    """[B, 12] -> [B, 12] permutation."""
    state = _rows(state, T, "permute")
    if state.device.type == "cpu":
        return permute_plain(state)
    if not state.is_cuda:
        raise ValueError(f"no Poseidon for device {state.device}")
    out = torch.empty_like(state, memory_format=torch.contiguous_format)
    _launch(state, T, None, out, T)
    return out


def hash_n(inp: torch.Tensor, cap: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Sponge call: inp [B, 8] (any row stride), capacity cap [B, 4] (None
    = zero) -> digests [B, 4], written into `out` when given."""
    inp = _rows(inp, 8, "hash_n")
    B = inp.shape[0]
    if cap is not None:
        cap = _rows(cap, 4, "hash_n cap").contiguous()
    if inp.device.type == "cpu":
        res = hash_n_plain(inp, cap)
        return res if out is None else out.copy_(res)
    if not inp.is_cuda:
        raise ValueError(f"no Poseidon for device {inp.device}")
    if out is None:
        out = torch.empty((B, 4), dtype=torch.int64, device=inp.device)
    elif out.shape != (B, 4) or not out.is_contiguous():
        raise ValueError("hash_n: `out` must be a contiguous [B, 4]")
    _launch(inp, 8, cap, out, 4)
    return out


def fold_root_pow2(digs: torch.Tensor) -> torch.Tensor:
    """Fold [..., n, 4] digests (n a power of two) to their Merkle root
    [..., 4] (poseidon_jax.fold_root_pow2): each level is one batched
    `hash_n` over every batch element's row pairs."""
    n = digs.shape[-2]
    if n & (n - 1):
        raise ValueError(f"fold_root_pow2 takes a power-of-two count, "
                         f"got {n}")
    batch = digs.shape[:-2]
    while n > 1:
        n //= 2
        digs = hash_n(digs.reshape(-1, 8)).reshape(*batch, n, 4)
    return digs[..., 0, :]


def _pad_cols(rows: torch.Tensor, width: int) -> torch.Tensor:
    out = torch.zeros((rows.shape[0], width), dtype=torch.int64,
                      device=rows.device)
    out[:, : rows.shape[1]] = rows
    return out


def _hash_fold(rows: torch.Tensor, sponge) -> torch.Tensor:
    """Sponge-fold [B, w] -> [B, 4] (linearhash_gl._hash_rows)."""
    B, w = rows.shape
    if w <= 4:
        return _pad_cols(rows, 4)
    st = None
    n_full = w // 8
    for i in range(n_full):
        st = sponge(rows[:, i * 8 : (i + 1) * 8], st)
    if w > n_full * 8:
        st = sponge(_pad_cols(rows[:, n_full * 8 :], 8), st)
    return st


def _leaves(rows: torch.Tensor, width: int, sponge) -> torch.Tensor:
    if width <= 4:
        return _pad_cols(rows[:, :width], 4)
    bs = max(8, -(-width // 4))
    hsz = -(-width // bs)
    digs = [_hash_fold(rows[:, c * bs : min((c + 1) * bs, width)], sponge)
            for c in range(hsz)]
    if hsz == 1:
        return digs[0]
    return _hash_fold(torch.cat(digs, dim=1), sponge)


def hash_leaves(rows: torch.Tensor, width: int) -> torch.Tensor:
    """Leaf hash of [B, width] -> [B, 4] (linearhash.rs semantics: chunks of
    max(8, ceil(w/4)) folded independently, then their digests folded)."""
    return _leaves(rows, width, hash_n)


def hash_leaves_plain(rows: torch.Tensor, width: int) -> torch.Tensor:
    """hash_leaves with every sponge call on hash_n_plain, on any device."""
    return _leaves(rows, width, hash_n_plain)
