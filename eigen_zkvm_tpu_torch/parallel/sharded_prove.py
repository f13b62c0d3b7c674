"""Full sharded eSTARK prove over a parallel/meshctx.Mesh.

Port of eigen_zkvm_tpu/parallel/sharded_prove.py::sharded_prove.  Every
rank of the mesh's model axis calls this with the same arguments (SPMD);
stark/stark_gen.py then runs on the rank's row blocks through
`Engine(mesh=mesh)`: pol-sharded LDEs between all_to_alls, row-sharded
Merkle trees and constraint VM with next-row halos, a distributed grand
product, group-sharded FRI folds, and the Fiat-Shamir transcript
replicated on every rank's host.  Every rank returns the proof of the
single-device prove, byte for byte.
"""
from __future__ import annotations

import numpy as np

from ..ops import commit, gl
from ..stark.engine import Engine
from ..stark.stark_gen import StarkProof, stark_gen


def sharded_prove(cm_pols, const_pols, setup, stark_struct, mesh,
                  prover_addr: str = "", prof=None) -> StarkProof:
    """Prove with every device stage sharded over `mesh`'s model axis.
    `setup` is a stark/stark_setup.StarkSetup of these const pols: its
    const tree is committed again over the mesh's row blocks, and its root
    must equal `setup.const_root`.  `prof` (utils/profiler.Prof) gets
    stark_gen's stage ticks."""
    engine = Engine(mesh=mesh)
    r0, rows = mesh.block(1 << stark_struct.nBits)
    const_tree = commit.ShardedCommit(mesh).extend_and_merkelize(
        gl.from_u64(const_pols.buffer[r0 : r0 + rows], mesh.device),
        stark_struct.nBits, stark_struct.nBitsExt)
    if not np.array_equal(const_tree.root(), setup.const_root):
        raise ValueError("the sharded const tree's root is not the setup's")
    return stark_gen(cm_pols, const_pols, const_tree, setup.starkinfo,
                     setup.program, stark_struct, engine=engine,
                     prover_addr=prover_addr, prof=prof)
