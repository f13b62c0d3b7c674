"""Sharded commit of a batch of traces over a (data, model) grid: LDE ->
all_to_all -> Merkle.

Port of eigen_zkvm_tpu/parallel/sharded.py::make_sharded_commit.  Axis
"data" runs independent traces (one proof a data row); axis "model" splits
one trace: the LDE runs pol-sharded, so each rank transforms whole columns
(ops/ntt.py), one all_to_all hands every rank a block of rows with all
their pols, each rank hashes its rows' leaves (ops/poseidon.py) and folds
them to its block's subtree root, and an all_gather of the model axis'
sub-roots feeds the replicated top of the tree (`fold_root_pow2`).
"""
from __future__ import annotations

import torch

from ..ops import ntt, poseidon


def make_sharded_commit(mesh, nbits: int, nbits_ext: int, n_pols: int):
    """A sharded commit on `mesh` (parallel/meshctx.Mesh): a function of
    this rank's traces [B / data, 2^nbits, n_pols / model] (int64, its
    data row's traces and its model rank's block of pols) that returns
    their roots [B / data, 4], the same on every rank of the data row."""
    m = mesh.model
    n_ext = 1 << nbits_ext
    if n_pols % m or n_ext % m:
        raise ValueError(f"n_pols={n_pols} and 2^{nbits_ext} must divide by "
                         f"model={m}")
    p_l, r_l = n_pols // m, n_ext // m

    def commit(traces: torch.Tensor) -> torch.Tensor:
        b_l = traces.shape[0]
        if traces.shape[1:] != (1 << nbits, p_l):
            raise ValueError(f"expected [B, 2^{nbits}, {p_l}] traces, got "
                             f"{tuple(traces.shape)}")
        # every trace's pol block as columns of one transform: [N, B_l*P_l]
        cols = traces.to(mesh.device).permute(1, 0, 2).reshape(
            1 << nbits, b_l * p_l)
        lde = ntt.interpolate(cols, nbits, nbits_ext)
        # phase switch: rows split, pols gathered -- one all_to_all
        got = mesh.all_to_all(lde.reshape(m, r_l, b_l * p_l))
        rows = got.reshape(m, r_l, b_l, p_l).permute(2, 1, 0, 3).reshape(
            b_l * r_l, n_pols)                    # [B_l * R_l, n_pols]
        digs = poseidon.hash_leaves(rows, n_pols).reshape(b_l, r_l, 4)
        sub = poseidon.fold_root_pow2(digs)       # [B_l, 4]
        tops = mesh.all_gather(sub).transpose(0, 1)   # [B_l, m, 4]
        return poseidon.fold_root_pow2(tops.contiguous())

    return commit
