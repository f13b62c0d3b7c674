"""eSTARK prover, device-resident on the port's engine.

Port of eigen_zkvm_tpu/stark/stark_gen.py::stark_gen in its resident
configuration (commit, VM and FRI on the device), with the same stage order
and Fiat-Shamir schedule:

  stage1  commit trace            -> LDE + Merkle (ops/commit.py, or
                                     ops/commit_big.py under BN128 /
                                     BLS12381)
  stage2  plookup H1/H2           -> device segment + stable sorts
  stage3  grand-product Z         -> log-depth F3 prefix product
  stage4  Q = C / Z_H on coset    -> device segment + Q split (iNTT/NTT)
  evals   openings at xi, w*xi    -> Lagrange iNTT + limb sums (ops/vm.py)
  FRI     deep quotient + folds   -> group iNTT + Horner, fold trees

Every section lives on `engine.device` from the start; the host sees the
roots, the openings and the query rows (and, on the CPU, the plain h1/h2's
columns).  The hash backend (stark/backends.py: GL, BN128 or BLS12381)
chooses the Merkle trees and the transcript; nothing else changes with it.

With `engine.mesh` (parallel/meshctx.py; GL only) every rank runs this
function on its row blocks (SPMD) and the transcript runs replicated on
every rank's host: the commits are ops/commit.py's sharded twins, h1/h2
gather their two columns, the grand products are a distributed scan, and
FRI folds over group blocks.  The proof is the single-device one, on every
rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import commit, f3, gl, vm
from ..utils import structlog
from ..utils.profiler import Prof
from .backends import get_backend
from .engine import Engine
from .fri import FRI, FRIProof


class StarkProof:
    def __init__(self):
        self.root1 = self.root2 = self.root3 = self.root4 = None
        self.rootC = None
        self.fri_proof: FRIProof | None = None
        self.evals = None      # [n_ev, 3]
        self.publics = None    # [n_pub, 3]
        self.public_dims = []  # per-public value dim (1 or 3) for transcript
        self.prover_addr = ""


def _pol_ref(ctx, pol_id: int):
    p = ctx.starkinfo.var_pol_map[pol_id]
    return ctx.sections[p.section], p.section_pos, p.dim


def get_pol(ctx, pol_id: int) -> torch.Tensor:
    """A polynomial as extension values [deg, 3] on the device."""
    buf, off, dim = _pol_ref(ctx, pol_id)
    out = torch.zeros((buf.shape[0], 3), dtype=torch.int64, device=buf.device)
    out[:, :dim] = buf[:, off : off + dim]
    return out


def set_pol(ctx, pol_id: int, pol: torch.Tensor):
    buf, off, dim = _pol_ref(ctx, pol_id)
    buf[:, off : off + dim] = pol[:, :dim]


def calculate_h1h2(f: np.ndarray, t: np.ndarray):
    """Plookup halves (starky stark_gen.rs calculate_H1H2) on the host:
    each f row takes the index of its row in t (the last one, where t
    repeats a row), t and f merge by that key with a stable sort, and the
    merged rows split even/odd."""
    idx_t = {}
    for i, row in enumerate(t):
        idx_t[tuple(int(x) for x in row)] = i
    n_t, n_f = t.shape[0], f.shape[0]
    keys = np.empty(n_t + n_f, dtype=np.int64)
    keys[:n_t] = np.arange(n_t)
    for i, row in enumerate(f):
        k = tuple(int(x) for x in row)
        if k not in idx_t:
            raise ValueError(f"Number not included: {k}")
        keys[n_t + i] = idx_t[k]
    order = np.argsort(keys, kind="stable")
    s = np.concatenate([t, f], axis=0)[order]
    return s[0::2], s[1::2]


def _lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts the rows of an [n, k] tensor by their columns
    (last column most significant), equal rows in index order."""
    perm = torch.arange(rows.shape[0], device=rows.device)
    for c in range(rows.shape[1]):
        order = torch.sort(rows[perm, c], stable=True).indices
        perm = perm[order]
    return perm


def calculate_h1h2_tensor(f: torch.Tensor, t: torch.Tensor):
    """calculate_h1h2 as tensor code on the rows' device, with the same
    bits: t and f ([n, k] int64) sorted together so that equal rows form
    runs, each run's last t index (the largest) is the key of its f rows,
    and a stable sort of the keys merges t then f.  Raises ValueError when
    an f row is missing from t."""
    n_t = t.shape[0]
    rows = torch.cat([t, f])
    perm = _lexsort_rows(rows)
    srt = rows[perm]
    new_run = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    new_run[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    run = torch.cumsum(new_run, 0) - 1
    in_t = perm < n_t
    last_t = torch.full((rows.shape[0],), -1, dtype=torch.int64,
                        device=rows.device)
    last_t.scatter_reduce_(0, run[in_t], perm[in_t], "amax")
    key_f = torch.empty(f.shape[0], dtype=torch.int64, device=rows.device)
    key_f[perm[~in_t] - n_t] = last_t[run[~in_t]]
    missing = key_f < 0
    if bool(missing.any()):
        row = f[int(torch.nonzero(missing)[0, 0])]
        raise ValueError("Number not included: "
                         f"{tuple(int(x) for x in gl.to_u64(row))}")
    keys = torch.cat([torch.arange(n_t, device=rows.device), key_f])
    merged = rows[torch.sort(keys, stable=True).indices]
    return merged[0::2], merged[1::2]


def h1h2(f: torch.Tensor, t: torch.Tensor):
    """Plookup halves of f and t ([n, 3] on the engine's device): the
    plain calculate_h1h2 for CPU tensors, the tensor version on a card."""
    if f.device.type == "cpu":
        return [gl.from_u64(h) for h in calculate_h1h2(gl.to_u64(f),
                                                         gl.to_u64(t))]
    return calculate_h1h2_tensor(f, t)


def calculate_z(num: torch.Tensor, den: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Z[0] = 1, Z[i] = prod_{k<i} num[k] / den[k] ([N, 3] on the device);
    the full product must be 1.  Under a mesh, num and den are row blocks
    and so is Z: the scan runs over the whole column
    (f3.prefix_product_sharded)."""
    ratio = f3.mul(num, f3.inv(den))
    if mesh is None:
        acc = f3.prefix_product(ratio)
        total, first = acc[-1], f3.from_ints(f3.ONE_INT, num.device)
    else:
        acc, first, total = f3.prefix_product_sharded(ratio, mesh)
    if gl.to_u64(total).tolist() != [1, 0, 0]:
        raise ValueError("calculate_z: the grand product is not 1")
    return torch.cat([first[None, :], acc[:-1]])


def _extend_and_merkelize(ctx, section: str, tree_builder):
    """LDE a *_n section into its *_2ns twin and Merkle-commit it with the
    hash backend's tree builder; the twin is the tree's device tensor."""
    tree = tree_builder.extend_and_merkelize(ctx.sections[section],
                                             ctx.nbits, ctx.nbits_ext)
    ctx.sections[section.replace("_n", "_2ns")] = _committed(ctx, tree)
    return tree


def _committed(ctx, tree) -> torch.Tensor:
    """The [Next, width] values a tree commits to (this rank's rows of
    them), on the engine's device."""
    if tree.width == 0:
        return torch.zeros((ctx.rows_ext, 0), dtype=torch.int64,
                           device=ctx.device)
    return tree.device_elements.to(ctx.device)


def stark_gen(cm_pols, const_pols, const_tree, starkinfo, program,
              stark_struct, engine: Engine | None = None,
              prover_addr: str = "", prof: Prof | None = None) -> StarkProof:
    backend = get_backend(stark_struct.verificationHashType)
    engine = engine or Engine()
    dev, mesh = engine.device, engine.mesh
    prof = prof or Prof("stark_gen", dev)
    ctx = vm.ProverContext(starkinfo, stark_struct, dev, mesh)
    ctx.engine = engine
    if mesh is None:
        commits, q_split = backend.tree, commit.q_split
    elif stark_struct.verificationHashType != "GL":
        raise ValueError("a sharded prove commits GL trees only")
    else:
        commits = commit.ShardedCommit(mesh)
        q_split = commits.q_split
    structlog.log_event("stark_gen.start", nbits=stark_struct.nBits,
                        nbits_ext=stark_struct.nBitsExt,
                        hash=stark_struct.verificationHashType,
                        engine=repr(engine))
    nbits = ctx.nbits
    n_cm = starkinfo.n_cm1

    # trace + preprocessed columns
    cm_host = cm_pols.write_buff()
    rows = slice(ctx.row0_n, ctx.row0_n + ctx.rows_n)
    ctx.sections["cm1_n"].copy_(gl.from_u64(cm_host[rows]))
    ctx.sections["const_n"].copy_(gl.from_u64(
        const_pols.write_buff()[rows]))
    ctx.sections["const_2ns"] = _committed(ctx, const_tree)
    vm.seed_domains(ctx)

    # publics
    n_pub = len(starkinfo.publics)
    ctx.publics = np.zeros((n_pub, 3), dtype=np.uint64)
    public_dims = []
    for i, pe in enumerate(starkinfo.publics):
        if pe.polType == "cmP":
            ctx.publics[i, 0] = cm_host[pe.idx, pe.polId]
            public_dims.append(1)
        elif pe.polType == "imP":
            val, dim = vm.exp_at_point(ctx, program.publics_code[i], pe.idx)
            ctx.publics[i, :dim] = val[:dim]
            public_dims.append(dim)
        else:
            raise ValueError(f"Invalid public type {pe.polType}")

    transcript = backend.transcript()
    for i in range(n_pub):
        transcript.put_elements([int(x) for x in ctx.publics[i, : public_dims[i]]])

    # ---- stage 1
    tree1 = _extend_and_merkelize(ctx, "cm1_n", commits)
    transcript.put_root(tree1.root())
    ctx.challenges[0] = transcript.get_field()  # u
    ctx.challenges[1] = transcript.get_field()  # defVal

    vm.execute_segment(ctx, program.step2prev, "n")
    for pu in starkinfo.pu_ctx:
        f_pol = get_pol(ctx, starkinfo.exp2pol[pu.f_exp_id])
        t_pol = get_pol(ctx, starkinfo.exp2pol[pu.t_exp_id])
        if mesh is not None:   # a sort needs the whole columns
            f_pol, t_pol = mesh.replicated(f_pol), mesh.replicated(t_pol)
        for h in h1h2(f_pol, t_pol):
            set_pol(ctx, starkinfo.cm_n[n_cm],
                    h if mesh is None else mesh.rows(h))
            n_cm += 1
    prof.tick("stage1 trace commit")

    # ---- stage 2
    tree2 = _extend_and_merkelize(ctx, "cm2_n", commits)
    transcript.put_root(tree2.root())
    ctx.challenges[2] = transcript.get_field()  # gamma
    ctx.challenges[3] = transcript.get_field()  # beta

    vm.execute_segment(ctx, program.step3prev, "n")
    for o in list(starkinfo.pu_ctx) + list(starkinfo.pe_ctx) + list(starkinfo.ci_ctx):
        p_num = get_pol(ctx, starkinfo.exp2pol[o.num_id])
        p_den = get_pol(ctx, starkinfo.exp2pol[o.den_id])
        set_pol(ctx, starkinfo.cm_n[n_cm], calculate_z(p_num, p_den, mesh))
        n_cm += 1
    vm.execute_segment(ctx, program.step3, "n")
    prof.tick("stage2 h1/h2 commit")

    # ---- stage 3
    tree3 = _extend_and_merkelize(ctx, "cm3_n", commits)
    transcript.put_root(tree3.root())
    ctx.challenges[4] = transcript.get_field()  # vc
    prof.tick("stage3a cm3 commit")

    vm.execute_segment(ctx, program.step42ns, "2ns")
    prof.tick("stage3b step42ns")

    # Q split: monomial blocks of size N, coset-unscaled, on the ext domain
    q_dim, q_deg = starkinfo.q_dim, starkinfo.q_deg
    if q_deg > 0:
        ctx.sections["cm4_2ns"] = q_split(
            ctx.sections["q_2ns"], q_dim, q_deg, nbits, ctx.nbits_ext)
    else:
        ctx.sections["cm4_2ns"] = torch.zeros(
            (ctx.rows_ext, starkinfo.map_sectionsN.cm4_n), dtype=torch.int64,
            device=dev)
    prof.tick("stage3 z commit")

    # ---- stage 4
    tree4 = commits.merkelize(ctx.sections["cm4_2ns"])
    transcript.put_root(tree4.root())
    ctx.challenges[7] = transcript.get_field()  # xi

    # openings at xi and w*xi via the Lagrange iNTT
    xi = tuple(int(x) for x in ctx.challenges[7])
    w_n = gl.root_of_unity(nbits)
    shift_inv = gl.inv_int(gl.SHIFT)
    xis = f3.mul_base_int(xi, shift_inv)
    wxi = f3.mul_base_int(xi, w_n)
    wxis = f3.mul_base_int(wxi, shift_inv)
    if len(starkinfo.ev_map):
        evals = vm.compute_evals(ctx, *vm.compute_levs(ctx, xis, wxis))
    else:
        evals = np.zeros((0, 3), dtype=np.uint64)
    ctx.evals = evals
    for i in range(evals.shape[0]):
        transcript.put_elements([int(x) for x in evals[i]])
    ctx.challenges[5] = transcript.get_field()  # v1
    ctx.challenges[6] = transcript.get_field()  # v2

    ctx.x_div_x_sub_xi, ctx.x_div_x_sub_wxi = vm.compute_xdiv(ctx, xi, wxi)
    vm.execute_segment(ctx, program.step52ns, "2ns")
    prof.tick("stage4 quotient + openings")

    trees = [tree1, tree2, tree3, tree4, const_tree]

    def query_pol(idx: int):
        return [t.get_group_proof(idx) for t in trees]

    def prefetch(idxs):
        """One gather per device tree for all queries."""
        for t in trees:
            if hasattr(t, "prefetch"):
                t.prefetch(idxs)

    fri_proof = FRI(stark_struct, backend, mesh).prove(
        transcript, ctx.sections["f_2ns"], query_pol, prefetch=prefetch)
    prof.tick("fri")
    prof.done()

    proof = StarkProof()
    proof.rootC = const_tree.root()
    proof.root1 = tree1.root()
    proof.root2 = tree2.root()
    proof.root3 = tree3.root()
    proof.root4 = tree4.root()
    proof.fri_proof = fri_proof
    proof.evals = evals
    proof.publics = ctx.publics
    proof.public_dims = public_dims
    proof.prover_addr = prover_addr
    return proof
