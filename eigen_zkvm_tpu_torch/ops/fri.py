"""FRI folds and fold-tree commits on the engine's device.

Port of eigen_zkvm_tpu/ops/fri_jax.py (`fold`, `fold_tree`).  A fold is one
batched group iNTT (size 2^(pol_bits - step_nbits), over every group and
extension coordinate at once, on the NTT kernel) and a Horner ladder at the
per-group point y_g = special_x * shift_inv * w^-g; no [n_x, G] power
matrix is built.  The fold tree hashes on the hash backend's Poseidon
kernel (ops/commit.py, ops/commit_big.py); its nodes stay on the device,
so a step sends up special_x and brings back the root.
"""
from __future__ import annotations

import functools

import torch

from . import commit, f3, gl, ntt


@functools.lru_cache(maxsize=32)
def _sinv(pol_bits: int, step_nbits: int, shift_inv: int,
          device: torch.device) -> torch.Tensor:
    """[2^step_nbits] shift_inv * w(pol_bits)^-g."""
    wi = gl.inv_int(gl.root_of_unity(pol_bits))
    return gl.mul(gl.powers(wi, 1 << step_nbits, device),
                  gl.as_i64(shift_inv))


def fold(pol: torch.Tensor, special_x, pol_bits: int, step_nbits: int,
         shift_inv: int) -> torch.Tensor:
    """pol [2^pol_bits, 3] -> the folded [2^step_nbits, 3]; special_x is
    an F3 point (three ints), shift_inv the coset's inverse shift."""
    n_x_bits = pol_bits - step_nbits
    n_x, pol2_n = 1 << n_x_bits, 1 << step_nbits
    coeffs = ntt.intt(pol.reshape(n_x, pol2_n * 3), n_x_bits).view(
        n_x, pol2_n, 3)
    sx = f3.from_ints(special_x, pol.device)
    y = f3.mul_base(sx[None, :], _sinv(pol_bits, step_nbits, int(shift_inv),
                                       pol.device))            # [pol2_n, 3]
    res = coeffs[n_x - 1]
    for j in range(n_x - 2, -1, -1):
        res = f3.add(f3.mul(res, y), coeffs[j])
    return res


def fold_tree(pol: torch.Tensor, step_nbits: int, next_nbits: int,
              tree=commit):
    """Commit a folded pol for the next step: leaf i is
    [pol[j * n_groups + i] for j] flattened (fri.rs layout); `tree` is the
    hash backend's tree builder (stark/backends.py)."""
    n_groups = 1 << next_nbits
    group_size = (1 << step_nbits) // n_groups
    leaves = pol.reshape(group_size, n_groups, 3).transpose(0, 1).reshape(
        n_groups, group_size * 3)
    return tree.merkelize(leaves.contiguous())
