"""The Goldilocks Merkle tree: roots of whole columns on a device, and the
check of one opened row against a root on the host.

A leaf is the linear hash of one row of w elements: up to 4 elements are
the digest itself, zero-padded; wider rows are cut into chunks of
max(8, ceil(w / 4)) elements, each chunk of more than 4 absorbed 8 at a
time (zero-padded) into a 4-element capacity starting at zero (a chunk of
4 or fewer is its own zero-padded digest), and the chunk digests, where
there are several, absorbed the same way.  A node is Poseidon of the two
child digests under a zero capacity.  A path lists the siblings from the
leaf up.
"""
from __future__ import annotations

import torch

from . import poseidon


def _sponge(vals: list) -> list:
    if len(vals) <= 4:
        return vals + [0] * (4 - len(vals))
    st = [0, 0, 0, 0]
    for i in range(0, len(vals), 8):
        block = vals[i : i + 8]
        st = poseidon.hash8(block + [0] * (8 - len(block)), st)
    return st


def leaf(row) -> list:
    vals = [int(v) for v in row]
    w = len(vals)
    if w <= 4:
        return _sponge(vals)
    size = max(8, -(-w // 4))
    digests = [_sponge(vals[c : c + size]) for c in range(0, w, size)]
    if len(digests) == 1:
        return digests[0]
    return _sponge([x for d in digests for x in d])


def node(left, right) -> list:
    return poseidon.hash8(list(left) + list(right))


def root_of_path(row, idx: int, siblings) -> list:
    value = leaf(row)
    for sib in siblings:
        sib = [int(v) for v in sib]
        value = node(sib, value) if idx & 1 else node(value, sib)
        idx >>= 1
    return value


# ---- roots of whole columns -------------------------------------------------

def _sponge_cols(cols: list) -> list:
    zero = torch.zeros_like(cols[0])
    if len(cols) <= 4:
        return cols + [zero] * (4 - len(cols))
    st = [zero] * 4
    for i in range(0, len(cols), 8):
        block = cols[i : i + 8]
        block = block + [zero] * (8 - len(block))
        st = poseidon.permute_cols(block + st)[:4]
    return st


def leaves(rows: torch.Tensor) -> list:
    """rows [n, w] int64 -> the n leaf digests as 4 tensors [n]."""
    w = rows.shape[1]
    cols = [rows[:, j].contiguous() for j in range(w)]
    if w <= 4:
        return _sponge_cols(cols)
    size = max(8, -(-w // 4))
    digests = [_sponge_cols(cols[c : c + size]) for c in range(0, w, size)]
    if len(digests) == 1:
        return digests[0]
    return _sponge_cols([x for d in digests for x in d])


def root(rows: torch.Tensor, host_below: int = 1 << 10) -> list:
    """The root of the tree over rows [n, w] (n a power of two): the
    levels on the rows' device down to `host_below` nodes, the rest on the
    host."""
    level = leaves(rows)
    while level[0].shape[0] > host_below:
        zero = torch.zeros_like(level[0][0::2])
        level = poseidon.permute_cols([d[0::2].contiguous() for d in level]
                                      + [d[1::2].contiguous() for d in level]
                                      + [zero] * 4)[:4]
    digests = [[int(v) % poseidon.P for v in col]
               for col in (c.cpu().numpy().astype("uint64").tolist()
                           for c in level)]
    nodes = [list(t) for t in zip(*digests)]
    while len(nodes) > 1:
        nodes = [node(nodes[i], nodes[i + 1]) for i in range(0, len(nodes), 2)]
    return nodes[0]
