"""Device executor of the compiled constraint Segments, and the prover's
device-resident buffers.

Port of eigen_zkvm_tpu/ops/vm_jax.py (the whole-column executor of the
section stream) with the ProverContext of eigen_zkvm_tpu/stark/vm.py.  Every
section is a [rows, width] int64 tensor on the engine's device; every
3-address Section runs as one whole-column GL or GF(p^3) operation in
section order (stark/vm.py's row-order argument), eagerly, and a next-row
read is a `torch.roll`.  Section writes go in place; a value read from a
section is copied before it can outlive a later write (`copy`), and every
other op makes a new tensor, so no read aliases a write.

Also here: the domain vectors (`seed_domains`), the Lagrange vectors and
openings at xi / w*xi (`compute_levs`, `compute_evals`) and
xDivXSubXi / xDivXSubWXi (`compute_xdiv`), each built on the device.

Under a mesh (parallel/meshctx.py; vm_jax.py's row-sharded layout) every
section is this rank's row block: the column ops stay local, a next-row
read or a next-row write takes a halo of the neighbouring block
(`Mesh.roll`), the domain vectors start at the block's first row, and the
openings' limb sums are all-reduced.
"""
from __future__ import annotations

import numpy as np
import torch

from ..stark.types import parse_pil_number
from . import f3, gl, ntt


class ProverContext:
    """All prover buffers of one prove, on `device`.

    The n-domain sections, q_2ns and f_2ns start as zeros; the committed
    extended sections (cm1_2ns .. cm4_2ns, const_2ns) are the commits' own
    device tensors, set by the prover.  challenges / publics / evals are
    host arrays (the transcript's side).

    With a `mesh`, the sections hold this rank's row block: rows
    [row0_n, row0_n + rows_n) of the n domain and [row0_ext, row0_ext +
    rows_ext) of the extended one (N and Next stay the whole domains)."""

    def __init__(self, starkinfo, stark_struct, device: torch.device,
                 mesh=None):
        self.starkinfo = starkinfo
        self.device = device
        self.mesh = mesh
        self.nbits = stark_struct.nBits
        self.nbits_ext = stark_struct.nBitsExt
        self.N = 1 << self.nbits
        self.Next = 1 << self.nbits_ext
        if mesh is not None and not mesh.sharded(self.N) and mesh.model > 1:
            raise ValueError(f"2^{self.nbits} rows do not split over "
                             f"{mesh.model} ranks")
        self.row0_n, self.rows_n = (0, self.N) if mesh is None \
            else mesh.block(self.N)
        self.row0_ext, self.rows_ext = (0, self.Next) if mesh is None \
            else mesh.block(self.Next)
        N, Next = self.rows_n, self.rows_ext
        sN = starkinfo.map_sectionsN

        def zeros(deg, width):
            return torch.zeros((deg, width), dtype=torch.int64, device=device)

        self.sections = {
            "cm1_n": zeros(N, sN.cm1_n),
            "cm2_n": zeros(N, sN.cm2_n),
            "cm3_n": zeros(N, sN.cm3_n),
            "cm4_n": zeros(N, sN.cm4_n),
            "tmpexp_n": zeros(N, sN.tmpexp_n),
            "q_2ns": zeros(Next, starkinfo.q_dim),
            "f_2ns": zeros(Next, 3),
            "const_n": zeros(N, starkinfo.n_constants),
        }
        self.x_n = None        # [N]
        self.x_2ns = None      # [Next]
        self.zhinv_2ns = None  # [Next] (periodic Z_H^-1, tiled)
        self.challenges = np.zeros((8, 3), dtype=np.uint64)
        self.publics = np.zeros((0, 3), dtype=np.uint64)
        self.evals = np.zeros((0, 3), dtype=np.uint64)
        self.x_div_x_sub_xi = None   # [Next, 3]
        self.x_div_x_sub_wxi = None  # [Next, 3]
        self.engine = None


def _roll(ctx, a, k: int):
    """Row i takes row (i + k) mod n of the whole domain (k < 0: row
    i - |k|); under a mesh the neighbouring block's rows come in as a
    halo."""
    if ctx.mesh is not None:
        return ctx.mesh.roll(a, k)
    return a if k == 0 else torch.roll(a, -k, dims=0)


def _set_c0(a, v):
    """a [n, 3] with component 0 replaced by v [n, 1]."""
    return torch.cat([v, a[:, 1:]], dim=-1)


def _binop(op: str, a, da: int, b, db: int):
    """F3 semantics on ([n, da], da) x ([n, db], db) (vm_jax._binop)."""
    if op == "mul":
        if da == db == 1:
            return gl.mul(a, b), 1
        if da == 3 and db == 3:
            return f3.mul(a, b), 3
        if da == 3:
            return gl.mul(a, b), 3            # [n,3] * [n,1] broadcast
        return gl.mul(b, a), 3
    if op == "add":
        if da == db:
            return gl.add(a, b), da
        if da == 3:
            return _set_c0(a, gl.add(a[:, :1], b)), 3
        return _set_c0(b, gl.add(b[:, :1], a)), 3
    if op == "sub":
        if da == db:
            return gl.sub(a, b), da
        if da == 3:
            return _set_c0(a, gl.sub(a[:, :1], b)), 3
        return _set_c0(gl.neg(b), gl.sub(a, b[:, :1])), 3
    raise ValueError(op)


def _host_rows(arr, device) -> torch.Tensor:
    """A small host [k, 3] u64 array on the device."""
    return gl.from_u64(np.asarray(arr, dtype=np.uint64).reshape(-1, 3), device)


def _run_ops(ctx, ops, dom: str) -> dict:
    """Execute `ops` over the whole `dom` domain; writes go into
    ctx.sections in place.  Returns the tmps: id -> ([n, d], d)."""
    si = ctx.starkinfo
    dev = ctx.device
    n = ctx.rows_n if dom == "n" else ctx.rows_ext
    next_ = 1 if dom == "n" else 1 << (ctx.nbits_ext - ctx.nbits)
    small: dict = {}   # uploaded once per segment run, on first read

    def host(name):
        if name not in small:
            small[name] = _host_rows(getattr(ctx, name), dev)
        return small[name]

    tmps: dict = {}
    # a tmp is dropped after its last read, so a segment holds only its live
    # [n, d] values (the compiled streams keep hundreds of tmps)
    last_read = {s.id: k for k, sec in enumerate(ops)
                 for s in sec.src if s.type_ == "tmp"}

    def read(node):
        t = node.type_
        if t == "tmp":
            return tmps[node.id]
        if t == "const":
            buf = ctx.sections["const_n" if dom == "n" else "const_2ns"]
            col = buf[:, node.id : node.id + 1]
            if node.prime:
                col = _roll(ctx, col, 1 if dom == "n" else next_)
            return col, 1
        if t in ("cm", "tmpExp"):
            if t == "cm":
                pol_id = si.cm_n[node.id] if dom == "n" else si.cm_2ns[node.id]
            else:
                pol_id = si.tmpexp_n[node.id]
            p = si.var_pol_map[pol_id]
            col = ctx.sections[p.section][:, p.section_pos
                                          : p.section_pos + p.dim]
            if node.prime:
                col = _roll(ctx, col, next_)
            return col, p.dim
        if t == "number":
            return gl.full((1, 1), parse_pil_number(node.value),
                           dev).expand(n, 1), 1
        if t == "public":
            return host("publics")[node.id : node.id + 1, 0:1].expand(n, 1), 1
        if t == "challenge":
            return host("challenges")[node.id][None, :].expand(n, 3), 3
        if t == "eval":
            return host("evals")[node.id][None, :].expand(n, 3), 3
        if t == "x":
            return (ctx.x_n if dom == "n" else ctx.x_2ns)[:, None], 1
        if t == "Zi":
            return ctx.zhinv_2ns[:, None], 1
        if t == "xDivXSubXi":
            return ctx.x_div_x_sub_xi, 3
        if t == "xDivXSubWXi":
            return ctx.x_div_x_sub_wxi, 3
        raise ValueError(f"Invalid reference type get {t}")

    for k, sec in enumerate(ops):
        if sec.op in ("add", "sub", "mul"):
            a, da = read(sec.src[0])
            b, db = read(sec.src[1])
            val, dv = _binop(sec.op, a, da, b, db)
        elif sec.op == "muladd":
            a, da = read(sec.src[0])
            b, db = read(sec.src[1])
            c, dc = read(sec.src[2])
            val, dv = _binop("mul", a, da, b, db)
            val, dv = _binop("add", val, dv, c, dc)
        elif sec.op == "copy":
            val, dv = read(sec.src[0])
            val = val.clone()   # a snapshot: later sections may write its source
        else:
            raise ValueError(f"Invalid op {sec.op}")
        for s in sec.src:
            if s.type_ == "tmp" and last_read[s.id] == k:
                tmps.pop(s.id, None)

        dest = sec.dest
        if dest.type_ == "tmp":
            tmps[dest.id] = (val, dv)
            continue
        if dest.type_ in ("cm", "tmpExp"):
            pol_id = (si.cm_n[dest.id] if dom == "n" else si.cm_2ns[dest.id]) \
                if dest.type_ == "cm" else si.tmpexp_n[dest.id]
            p = si.var_pol_map[pol_id]
            name, off, width = p.section, p.section_pos, p.dim
        elif dest.type_ == "q":
            name, off, width = "q_2ns", dest.id, si.q_dim
        elif dest.type_ == "f":
            name, off, width = "f_2ns", dest.id, 3
        else:
            raise ValueError(f"Invalid reference type set {dest.type_}")
        if dv > width:
            raise ValueError("dim overflow on write")
        if dest.prime:
            val = _roll(ctx, val, -next_)
        buf = ctx.sections[name]
        buf[:, off : off + dv] = val
        if dv < width:   # a dim-1 value in a dim-3 slot: zero the rest
            buf[:, off + dv : off + width] = 0
    return tmps


def execute_segment(ctx, segment, dom: str):
    """Run segment.first over the whole domain (vm_jax.execute_segment);
    the written sections stay on the device."""
    _run_ops(ctx, segment.first, dom)


def exp_at_point(ctx, segment, idx: int):
    """The publics segment's last value at row `idx` of the n domain:
    (u64 [3], dim) on the host (stark_gen._calculate_exp_at_point); under
    a mesh the rank that owns the row answers every rank."""
    tmps = _run_ops(ctx, segment.first, "n")
    val, dv = tmps[segment.first[-1].dest.id]
    if ctx.mesh is None:
        row = val[idx]
    else:
        owner, local = divmod(idx, ctx.rows_n)
        row = ctx.mesh.from_owner(val[local], owner)
    out = np.zeros(3, dtype=np.uint64)
    out[:dv] = gl.to_u64(row)
    return out, dv


def seed_domains(ctx):
    """x_n, x_2ns and zhinv_2ns built on the device (vm_jax.seed_domains):
    w^i by log-doubling, the coset scale, and the 2^eb distinct values of
    1 / (SHIFT^N * w_eb^i - 1) tiled over the extended domain."""
    dev = ctx.device
    w_n, w_ext = gl.root_of_unity(ctx.nbits), gl.root_of_unity(ctx.nbits_ext)
    ctx.x_n = gl.powers(w_n, ctx.rows_n, dev)
    if ctx.row0_n:   # the block's first row
        ctx.x_n = gl.mul(ctx.x_n, gl.as_i64(gl.exp_int(w_n, ctx.row0_n)))
    ctx.x_2ns = gl.mul(gl.powers(w_ext, ctx.rows_ext, dev), gl.as_i64(
        gl.mul_int(gl.SHIFT, gl.exp_int(w_ext, ctx.row0_ext))))
    eb = ctx.nbits_ext - ctx.nbits
    sn = gl.exp_int(gl.SHIFT, ctx.N)
    w_eb = gl.root_of_unity(eb)
    zhinv = [gl.inv_int((gl.mul_int(sn, gl.exp_int(w_eb, i)) - 1) % gl.P_INT)
             for i in range(1 << eb)]
    ctx.zhinv_2ns = gl.from_u64(np.array(zhinv, dtype=np.uint64),
                                dev).repeat(ctx.rows_ext >> eb)


def _geometric(r, nbits: int, device) -> torch.Tensor:
    """[1, r, r^2, ..., r^(2^nbits - 1)] for an F3 point r -> [2^nbits, 3],
    by doubling; the squares r^(2^k) are taken on the host."""
    pows = f3.from_ints(f3.ONE_INT, device)[None, :]
    cur = tuple(int(x) for x in r)
    for _ in range(nbits):
        pows = torch.cat([pows, f3.mul(pows, f3.from_ints(cur, device))])
        cur = f3.mul_int(cur, cur)
    return pows


def compute_levs(ctx, xis, wxis):
    """(LEv, LpEv): the Lagrange vectors at xi / w*xi (each [N, 3]), the
    iNTT of the geometric powers, built on the device; under a mesh each
    rank builds them whole and keeps its block's rows."""
    r0, n = ctx.row0_n, ctx.rows_n
    return tuple(ntt.intt(_geometric(r, ctx.nbits, ctx.device),
                          ctx.nbits)[r0 : r0 + n] for r in (xis, wxis))


def ev_entries(starkinfo):
    """(section, offset, dim, prime) of every ev_map entry."""
    entries = []
    for ev in starkinfo.ev_map:
        if ev.type_ == "const":
            entries.append(("const_2ns", int(ev.id), 1, bool(ev.prime)))
        elif ev.type_ == "cm":
            p = starkinfo.var_pol_map[starkinfo.cm_2ns[ev.id]]
            entries.append((p.section, int(p.section_pos), int(p.dim),
                            bool(ev.prime)))
        else:
            raise ValueError(f"Invalid ev type: {ev.type_}")
    return entries


def compute_evals(ctx, LEv, LpEv) -> np.ndarray:
    """The openings: for each ev_map entry, the sum over the n domain of its
    extended column (stride 2^eb) times the Lagrange vector.  Each product's
    32-bit limbs sum exactly in int64 (N < 2^31), and the one download of
    all the limb sums is reduced mod p on the host (under a mesh, after
    one all_reduce of every rank's sums).  Returns u64 [n_ev, 3]."""
    stride = 1 << (ctx.nbits_ext - ctx.nbits)
    sums = []
    for name, off, dim, prime in ev_entries(ctx.starkinfo):
        v = ctx.sections[name][::stride, off : off + dim]
        lv = LpEv if prime else LEv
        prod = gl.mul(lv, v) if dim == 1 else f3.mul(v, lv)
        sums.append(torch.stack([(prod & 0xFFFFFFFF).sum(0),
                                 ((prod >> 32) & 0xFFFFFFFF).sum(0)]))
    out = np.zeros((len(sums), 3), dtype=np.uint64)
    if sums:
        limbs = torch.stack(sums)                    # [n_ev, 2, 3]
        if ctx.mesh is not None:
            limbs = ctx.mesh.row_sum(limbs)
        limbs = limbs.cpu().tolist()
        for i, (lo, hi) in enumerate(limbs):
            out[i] = [(l + (h << 32)) % gl.P_INT for l, h in zip(lo, hi)]
    return out


def compute_xdiv(ctx, xi, wxi):
    """x / (x - xi) and x / (x - w*xi) over the extended coset, each
    [Next, 3] on the device (xi, wxi: F3 points as int 3-tuples)."""
    x = ctx.x_2ns
    outs = []
    for pt in (xi, wxi):
        den = torch.stack([gl.sub(x, gl.as_i64(pt[0])),
                           gl.full(x.shape, (-int(pt[1])) % gl.P_INT, x.device),
                           gl.full(x.shape, (-int(pt[2])) % gl.P_INT, x.device)],
                          dim=-1)
        outs.append(f3.mul_base(f3.inv(den), x))
    return tuple(outs)
