"""FRI folds and fold-tree commits on the engine's device.

Port of eigen_zkvm_tpu/ops/fri_jax.py (`fold`, `fold_tree`), and of
stark/fri.py's host fold for its GF(p^5) chain.  A fold is one batched
group iNTT (size 2^(pol_bits - step_nbits), over every group and extension
coordinate at once, on the NTT kernel) and a Horner ladder at the
per-group point y_g = special_x * shift_inv * w^-g in the extension field
`ext` (ops/f3.py, or ops/f5.py); no [n_x, G] power matrix is built.  The
fold tree hashes on the hash backend's Poseidon kernel (ops/commit.py,
ops/commit_big.py); its nodes stay on the device, so a step sends up
special_x and brings back the root.

Under a mesh (fri_jax.py's layout) a pol too long for the axis' rows is a
row block, and both functions work on group blocks: row j * n_g + g holds
group g, so every row block holds a piece of every group, and one
all_to_all hands each rank the whole of its groups (`_groups`).  A fold's
result is then a row block of the folded pol, and a fold tree is
ops/commit.py's sharded tree.  A step with fewer groups than the axis has
ranks stays replicated.
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


def _groups(pol: torch.Tensor, n_x: int, n_g: int, mesh):
    """(the groups this rank works on of pol viewed as [n_x, n_g, dim]
    (row j * n_g + g), the first group's index).  Without a mesh, or with
    fewer groups than ranks: all of them (a row-sharded pol is gathered).
    Else this rank's block of n_g / model groups: from a row-sharded pol
    whose row blocks hold whole j slices, by one all_to_all; otherwise
    sliced out of the whole pol."""
    dim = pol.shape[-1]
    sharded = mesh is not None and pol.shape[0] < n_x * n_g
    if mesh is None or not mesh.sharded(n_g):
        full = mesh.replicated(pol) if sharded else pol
        return full.reshape(n_x, n_g, dim), 0
    m = mesh.model
    g_l = n_g // m
    g0 = mesh.coords[1] * g_l
    if sharded and n_x % m == 0:
        chunks = pol.reshape(n_x // m, m, g_l, dim).transpose(0, 1)
        return mesh.all_to_all(chunks).reshape(n_x, g_l, dim), g0
    full = mesh.replicated(pol) if sharded else pol
    return full.reshape(n_x, n_g, dim)[:, g0 : g0 + g_l], g0


def fold(pol: torch.Tensor, special_x, pol_bits: int, step_nbits: int,
         shift_inv: int, mesh=None, ext=f3) -> torch.Tensor:
    """pol [2^pol_bits, dim] -> the folded [2^step_nbits, dim]; `ext` is
    the extension field's module (ops/f3.py, or ops/f5.py for dim 5),
    special_x a point of it (dim ints), shift_inv the coset's inverse
    shift.  Under a mesh, pol and the result are row blocks where the axis
    splits them (see `_groups`)."""
    dim = ext.DIM
    n_x_bits = pol_bits - step_nbits
    n_x, pol2_n = 1 << n_x_bits, 1 << step_nbits
    grp, g0 = _groups(pol, n_x, pol2_n, mesh)
    g_l = grp.shape[1]
    coeffs = ntt.intt(grp.reshape(n_x, g_l * dim),
                      n_x_bits).view(n_x, g_l, dim)
    sx = ext.from_ints(special_x, pol.device)
    sinv = _sinv(pol_bits, step_nbits, int(shift_inv), pol.device)
    y = ext.mul_base(sx[None, :], sinv[g0 : g0 + g_l])      # [g_l, dim]
    res = coeffs[n_x - 1]
    for j in range(n_x - 2, -1, -1):
        res = ext.add(ext.mul(res, y), coeffs[j])
    return res


def fold_tree(pol: torch.Tensor, step_nbits: int, next_nbits: int,
              tree=commit, mesh=None):
    """Commit a folded pol for the next step: leaf i is
    [pol[j * n_groups + i] for j] flattened (fri.rs layout); `tree` is the
    hash backend's tree module (stark/backends.py).  Under a mesh, a tree
    whose leaves split over the axis is sharded by leaf blocks."""
    n_groups = 1 << next_nbits
    group_size = (1 << step_nbits) // n_groups
    grp, _ = _groups(pol, group_size, n_groups, mesh)
    leaves = grp.transpose(0, 1).reshape(grp.shape[1],
                                         group_size * pol.shape[-1])
    if grp.shape[1] < n_groups:
        return commit.ShardedCommit(mesh).merkelize(leaves.contiguous())
    return tree.merkelize(leaves.contiguous())
