"""Batched BN254 G1 and G2 on tensors: the plain point arithmetic, the
multi-scalar multiplication (kernel 1, csrc/msm.cu) and the fixed-base
batch (kernel 2, csrc/ec_batch.cu).

Port of eigen_zkvm_tpu/ops/ec_jax.py, for G1 over Fq and G2 over Fq2.
Points cross the module as words in Montgomery form (ops/bigint.py):
affine G1 [n, 2, 4] (x, y), affine G2 [n, 2, 2, 4]; Jacobian points, which
pass between the MSM's stages, [n, 3, 4] and [n, 3, 2, 4] (X, Y, Z).  The
point at infinity is (0, 0) in affine form, which lies on neither curve, and
Z = 0 in Jacobian form.  The plain arithmetic works on limb tensors
(bigint.limbs) with ec_jax's complete formulas: dbl-2009-l doubling and the
add-2007-bl addition, patched where a point is infinity, where P + P needs
the doubling and where P + (-P) is infinity; the independent Fq products of
a formula are taken in one batched product.

The MSM is Pippenger's bucket method, the same stages on both routes:
  1. glue (torch): each scalar's c-bit digits, one entry per nonzero digit of
     a finite point, sorted by bucket (window, digit);
  2. bucket sums: each run of one bucket cut into segments of at most
     SEGMENT entries, one sum per segment, repeated on the partial sums until
     each bucket has one (`sums`: csrc/msm.cu msm_sum, or `sums_plain`);
     a hot bucket (the digit 1 of a circuit's many boolean wires) is split
     like any other;
  3. the buckets' weights without running sums: sum_d d * B_d =
     sum_j 2^j * (sum of the B_d whose digit has bit j), so the same
     segment sums over (window, bit) keys;
  4. combine (`combine`: msm_combine, or `combine_plain`): per window
     V_w = sum_j 2^j T_(w,j), then sum_w 2^(c*w) V_w by doubling, and the
     result to affine.
A CUDA tensor goes to the kernels (a failure raises kernels.KernelError);
a CPU tensor to the plain versions.  The kernels are held against two plain
versions: `msm_plain`, ec_jax's double-and-add, which shares none of these
stages, and, at the prove's sizes, `msm_stages_plain`, the same glue with
the plain versions of stages 2 and 4.  Windows above the highest nonzero
digit are left out of stage 4.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from ..curves import bn254
from . import bigint as bi
from .bigint import FQ

NBITS = 254          # Fr scalars fit 254 bits
SEGMENT = 32         # entries a segment sum adds at the most
TABLE_BITS = 8       # window of the plain fixed-base tables


class Group:
    """G1 (coordinates in Fq, deg 1) or G2 (coordinates in Fq2, deg 2)."""

    def __init__(self, name: str, deg: int, code: int):
        self.name = name
        self.deg = deg
        self.code = code          # the kernels' curve argument

    def __repr__(self) -> str:
        return self.name

    def mul(self, a, b):
        return bi.mul(FQ, a, b) if self.deg == 1 else bi.f2_mul(a, b)

    def add(self, a, b):
        return bi.add(FQ, a, b)

    def sub(self, a, b):
        return bi.sub(FQ, a, b)

    def is_zero(self, a):
        return bi.is_zero(a, self.deg)

    def one(self, device):
        o = bi.const(FQ.one, device)
        return o if self.deg == 1 else torch.stack([o, torch.zeros_like(o)])

    def inv(self, a):
        """Batch inverse over the leading dimension (no zeros)."""
        if self.deg == 1:
            return bi.batch_inv(FQ, a)
        sq = bi.mul(FQ, a, a)
        t = bi.batch_inv(FQ, bi.add(FQ, sq[..., 0, :], sq[..., 1, :]))
        c = torch.stack([a[..., 0, :], bi.neg(FQ, a[..., 1, :])], -2)
        return bi.mul(FQ, c, t.unsqueeze(-2).expand_as(c))

    @property
    def coord_shape(self) -> tuple:
        """Word shape of one coordinate."""
        return (4,) if self.deg == 1 else (2, 4)


G1 = Group("G1", 1, 1)
G2 = Group("G2", 2, 2)


def _muls(g: Group, *pairs):
    """The products of independent pairs (same shapes) in one batch."""
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    return g.mul(a, b).unbind(0)


# ---- plain point arithmetic on limb tensors (Jacobian, a = 0) ----

def dbl(g: Group, p):
    """dbl-2009-l; infinity (Z = 0) stays infinity."""
    X, Y, Z = p
    A, B, YZ = _muls(g, (X, X), (Y, Y), (Y, Z))
    XB = g.add(X, B)
    E = g.add(g.add(A, A), A)
    C, XB2, F_ = _muls(g, (B, B), (XB, XB), (E, E))
    D = g.sub(g.sub(XB2, A), C)
    D = g.add(D, D)
    X3 = g.sub(F_, g.add(D, D))
    C2 = g.add(C, C)
    C4 = g.add(C2, C2)
    (t,) = _muls(g, (E, g.sub(D, X3)))
    Y3 = g.sub(t, g.add(C4, C4))
    return X3, Y3, g.add(YZ, YZ)


def add(g: Group, p, q):
    """Complete Jacobian addition (add-2007-bl with the exceptional cases
    patched as ec_jax._add does)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, t1, t2 = _muls(g, (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1))
    U1, U2, S1, S2 = _muls(g, (X1, Z2Z2), (X2, Z1Z1), (t1, Z2Z2),
                           (t2, Z1Z1))
    H = g.sub(U2, U1)
    r = g.sub(S2, S1)
    h_zero, r_zero = g.is_zero(H), g.is_zero(r)
    r = g.add(r, r)
    H2 = g.add(H, H)
    ZZ = g.add(Z1, Z2)
    I, rr, ZZ2 = _muls(g, (H2, H2), (r, r), (ZZ, ZZ))
    J, V, Z3 = _muls(g, (H, I), (U1, I),
                     (g.sub(g.sub(ZZ2, Z1Z1), Z2Z2), H))
    X3 = g.sub(g.sub(rr, J), g.add(V, V))
    a, b = _muls(g, (r, g.sub(V, X3)), (S1, J))
    Y3 = g.sub(a, g.add(b, b))
    # H = 0, r != 0 (P + (-P)): Z3 = 0 already, infinity
    i1, i2 = g.is_zero(Z1), g.is_zero(Z2)
    same = h_zero & r_zero & ~i1 & ~i2
    if bool(same.any()):
        d = dbl(g, p)
        X3, Y3, Z3 = (bi.select(same, dv, v) for dv, v in zip(d, (X3, Y3, Z3)))
    return tuple(bi.select(i1, b2, bi.select(i2, b1, v))
                 for b1, b2, v in zip(p, q, (X3, Y3, Z3)))


def add_affine(g: Group, p, q):
    """p + an affine limb point q = (x, y, inf): madd-2007-bl (7M + 4S),
    complete as `add` is; the plain twin of bn254.cuh's add_affine."""
    X1, Y1, Z1 = p
    x2, y2, i2 = q
    (Z1Z1,) = _muls(g, (Z1, Z1))
    U2, t = _muls(g, (x2, Z1Z1), (y2, Z1))
    (S2,) = _muls(g, (t, Z1Z1))
    H = g.sub(U2, X1)
    r = g.sub(S2, Y1)
    h_zero, r_zero = g.is_zero(H), g.is_zero(r)
    ZH = g.add(Z1, H)
    HH, ZH2 = _muls(g, (H, H), (ZH, ZH))
    I = g.add(HH, HH)
    I = g.add(I, I)
    r = g.add(r, r)
    J, V, rr = _muls(g, (H, I), (X1, I), (r, r))
    X3 = g.sub(g.sub(rr, J), g.add(V, V))
    a, b = _muls(g, (r, g.sub(V, X3)), (Y1, J))
    Y3 = g.sub(a, g.add(b, b))
    Z3 = g.sub(g.sub(ZH2, Z1Z1), HH)
    i1 = g.is_zero(Z1)
    same = h_zero & r_zero & ~i1 & ~i2
    if bool(same.any()):
        d = dbl(g, p)
        X3, Y3, Z3 = (bi.select(same, dv, v) for dv, v in zip(d, (X3, Y3, Z3)))
    one = g.one(x2.device).expand_as(x2)
    return tuple(bi.select(i2, b1, bi.select(i1, b2, v))
                 for b1, b2, v in zip(p, (x2, y2, one), (X3, Y3, Z3)))


# ---- word tensors <-> limb points ----

def from_affine(g: Group, pts: torch.Tensor):
    """Affine words [n, 2, ...] -> Jacobian limb point, (0, 0) -> Z = 0."""
    x, y = bi.limbs(pts[:, 0]), bi.limbs(pts[:, 1])
    inf = g.is_zero(x) & g.is_zero(y)
    z = bi.select(inf, torch.zeros_like(x), g.one(pts.device).expand_as(x))
    return x, y, z


def affine_limbs(g: Group, pts: torch.Tensor):
    """Affine words [n, 2, ...] -> (x, y, inf) limb tensors."""
    x, y = bi.limbs(pts[:, 0]), bi.limbs(pts[:, 1])
    return x, y, g.is_zero(x) & g.is_zero(y)


def from_jacobian(pts: torch.Tensor):
    """Jacobian words [n, 3, ...] -> limb point."""
    return tuple(bi.limbs(pts[:, i]) for i in range(3))


def jacobian_words(p) -> torch.Tensor:
    return torch.stack([bi.words(v) for v in p], 1)


def to_affine(g: Group, p) -> torch.Tensor:
    """Jacobian limb point [n] -> affine words [n, 2, ...] (one batch
    inversion)."""
    X, Y, Z = p
    inf = g.is_zero(Z)
    zi = g.inv(bi.select(inf, g.one(Z.device).expand_as(Z), Z))
    (zi2,) = _muls(g, (zi, zi))
    (zi3,) = _muls(g, (zi2, zi))
    x, y = _muls(g, (X, zi2), (Y, zi3))
    zero = torch.zeros_like(x)
    return torch.stack([bi.words(bi.select(inf, zero, x)),
                        bi.words(bi.select(inf, zero, y))], 1)


# ---- Python affine points <-> word tensors ----

def affine_tensor(g: Group, points, device=None) -> torch.Tensor:
    """Affine points as Python ints (None = infinity) -> Montgomery words."""
    vals = []
    for p in points:
        if p is None:
            vals.extend([0] * (2 * g.deg))
        elif g.deg == 1:
            vals.extend(FQ.to_mont_int(v) for v in p)
        else:
            vals.extend(FQ.to_mont_int(v) for c in p for v in c)
    return bi.to_tensor(vals, device).view(len(points), 2, *g.coord_shape)


def affine_ints(g: Group, t: torch.Tensor) -> list:
    """Montgomery affine words [n, 2, ...] -> Python points (None for
    (0, 0))."""
    v = bi.to_ints(t)
    k = 2 * g.deg
    out = []
    for i in range(0, len(v), k):
        c = v[i : i + k]
        if not any(c):
            out.append(None)
            continue
        c = [FQ.from_mont_int(x) for x in c]
        out.append((c[0], c[1]) if g.deg == 1
                   else ((c[0], c[1]), (c[2], c[3])))
    return out


# ---- Pippenger ----

def window_bits(n: int) -> int:
    """The digit width c of an MSM of n points."""
    return max(4, min(14, n.bit_length() - 7))


def digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """[n, 4] standard words -> [n, W] c-bit digits, W = ceil(254 / c)."""
    cols = []
    for w in range(-(-NBITS // c)):
        wi, sh = divmod(c * w, 64)
        d = scalars[:, wi] if sh == 0 else \
            (scalars[:, wi] >> sh) & ((1 << (64 - sh)) - 1)
        if sh + c > 64 and wi + 1 < 4:
            d = d | (scalars[:, wi + 1] << (64 - sh))
        cols.append(d & ((1 << c) - 1))
    return torch.stack(cols, 1)


def segments(keys: torch.Tensor, size: int = SEGMENT):
    """Sorted keys -> (start [S + 1] of each segment: a run of one key cut
    every `size` entries, key [S] of each segment)."""
    n = keys.numel()
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = keys[1:] != keys[:-1]
    run_start = torch.nonzero(new).squeeze(1)
    pos = torch.arange(n, device=keys.device)
    rank = pos - run_start[torch.cumsum(new, 0) - 1]
    start = torch.nonzero(new | (rank % size == 0)).squeeze(1)
    return (torch.cat([start, torch.tensor([n], device=keys.device)]),
            keys[start])


PLAIN_CHUNK = 1 << 20   # entries (or lanes) a plain batch holds at the most


def sums_plain(g: Group, pts: torch.Tensor, affine: bool,
               idx: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Plain version of msm_sum: out[s] = sum of pts[idx[j]] for j in
    [start[s], start[s+1]), by pairwise rounds inside each segment, at most
    PLAIN_CHUNK entries a batch.  Jacobian words [S, 3, ...]."""
    bounds = torch.searchsorted(
        start, torch.arange(0, int(start[-1]), PLAIN_CHUNK,
                            device=start.device)).tolist()
    bounds = sorted(set(bounds) | {start.numel() - 1})
    if len(bounds) < 2:
        return torch.zeros((0, 3, *g.coord_shape), dtype=torch.int64,
                           device=pts.device)
    return torch.cat([
        _sums_batch(g, pts, affine, idx[int(start[a]) : int(start[b])],
                    start[a : b + 1] - start[a])
        for a, b in zip(bounds[:-1], bounds[1:])])


def _sums_batch(g, pts, affine, idx, start):
    sel = pts[idx]
    p = from_affine(g, sel) if affine else from_jacobian(sel)
    lens = start.diff()
    seg = torch.repeat_interleave(
        torch.arange(lens.numel(), device=idx.device), lens)
    rank = torch.arange(idx.numel(), device=idx.device) - start[:-1][seg]
    length = lens[seg]
    step = 1
    while step < int(lens.max()):
        act = torch.nonzero((rank % (2 * step) == 0)
                            & (rank + step < length)).squeeze(1)
        r = add(g, tuple(v[act] for v in p), tuple(v[act + step] for v in p))
        for v, rv in zip(p, r):
            v[act] = rv
        step *= 2
    return jacobian_words(tuple(v[start[:-1]] for v in p))


def sums(g: Group, pts: torch.Tensor, affine: bool, idx: torch.Tensor,
         start: torch.Tensor) -> torch.Tensor:
    """Segment sums (stage 2): kernel 1's msm_sum for CUDA tensors."""
    if pts.device.type == "cpu":
        return sums_plain(g, pts, affine, idx, start)
    return _sums_cuda(g, pts, affine, idx, start)


def _sums_cuda(g, pts, affine, idx, start):
    n_seg = start.numel() - 1
    out = torch.empty((n_seg, 3, *g.coord_shape), dtype=torch.int64,
                      device=pts.device)
    if n_seg:
        kernels.MSM.launch(pts.device.index, g.code, int(affine),
                           pts.data_ptr(), idx.data_ptr(), start.data_ptr(),
                           n_seg, out.data_ptr(),
                           stream=_stream(pts.device), entry="msm_sum")
    return out


def combine_plain(g: Group, planes: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of msm_combine: planes [W * c, 3, ...] Jacobian words,
    plane w*c + j the sum of the buckets of window w whose digit has bit
    j -> the affine result [1, 2, ...]."""
    W = planes.shape[0] // c
    p = tuple(v.view(W, c, *v.shape[1:]) for v in from_jacobian(planes))
    acc = tuple(v[:, c - 1] for v in p)
    for j in range(c - 2, -1, -1):
        acc = add(g, dbl(g, acc), tuple(v[:, j] for v in p))
    res = tuple(v[W - 1 : W] for v in acc)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            res = dbl(g, res)
        res = add(g, res, tuple(v[w : w + 1] for v in acc))
    return to_affine(g, res)


def combine(g: Group, planes: torch.Tensor, c: int) -> torch.Tensor:
    """Stage 4: kernel 1's msm_combine for CUDA tensors."""
    if planes.device.type == "cpu":
        return combine_plain(g, planes, c)
    return _combine_cuda(g, planes, c)


def _combine_cuda(g, planes, c):
    out = torch.empty((1, 2, *g.coord_shape), dtype=torch.int64,
                      device=planes.device)
    kernels.MSM.launch(planes.device.index, g.code, planes.data_ptr(), c,
                       planes.shape[0] // c, out.data_ptr(),
                       stream=_stream(planes.device), entry="msm_combine")
    return out


def _reduce_runs(g, sum_fn, pts, affine, idx, keys):
    """Sum the entries of each key (sorted keys): segment sums, then sums of
    the partial sums until every key has one.  (unique keys, Jacobian
    words)."""
    if keys.numel() == 0:
        return keys, torch.zeros((0, 3, *g.coord_shape), dtype=torch.int64,
                                 device=keys.device)
    while True:
        start, seg_keys = segments(keys)
        pts = sum_fn(g, pts, affine, idx, start)
        if bool((seg_keys[1:] != seg_keys[:-1]).all()):
            return seg_keys, pts
        affine, keys = False, seg_keys
        idx = torch.arange(keys.numel(), device=keys.device)


def _pippenger(g: Group, points: torch.Tensor, scalars: torch.Tensor,
               sum_fn, combine_fn) -> torch.Tensor:
    n = points.shape[0]
    dev = points.device
    c = window_bits(n)
    d = digits(scalars, c)
    inf = (points.flatten(1) == 0).all(1)
    ent = torch.nonzero((d != 0) & ~inf.unsqueeze(1))
    if ent.shape[0] == 0:   # every scalar zero or every point infinity
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=dev)
    keys = ent[:, 1] * (1 << c) + d[ent[:, 0], ent[:, 1]]
    keys, order = torch.sort(keys)
    bkeys, buckets = _reduce_runs(g, sum_fn, points, True, ent[order, 0], keys)
    # (window, bit) entries of each bucket
    bits = (bkeys.unsqueeze(1) >> torch.arange(c, device=dev)) & 1
    be = torch.nonzero(bits)
    pkeys = (bkeys[be[:, 0]] >> c) * c + be[:, 1]
    pkeys, order = torch.sort(pkeys)
    pk, psums = _reduce_runs(g, sum_fn, buckets, False, be[order, 0], pkeys)
    # windows above the highest nonzero digit are left out of the combine
    planes = torch.zeros((int(pk[-1]) // c * c + c, 3, *g.coord_shape),
                         dtype=torch.int64, device=dev)
    planes[pk] = psums
    return combine_fn(g, planes, c)


def _check_msm(g: Group, points: torch.Tensor, scalars: torch.Tensor):
    if points.dtype != torch.int64 or scalars.dtype != torch.int64 or \
            points.shape[1:] != (2, *g.coord_shape) or \
            scalars.shape != (points.shape[0], 4) or \
            points.device != scalars.device:
        raise ValueError(f"msm over {g}: points int64 [n, 2, "
                         f"{g.coord_shape}] and scalars int64 [n, 4] on one "
                         f"device, got {tuple(points.shape)} "
                         f"{tuple(scalars.shape)}")
    return points.contiguous(), scalars.contiguous()


def msm(g: Group, points: torch.Tensor, scalars: torch.Tensor
        ) -> torch.Tensor:
    """sum_i scalars[i] * points[i]: points affine Montgomery words, scalars
    standard words below r.  Returns affine words [1, 2, ...]."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    return _pippenger(g, points, scalars, sums, combine)


def msm_stages_plain(g: Group, points: torch.Tensor, scalars: torch.Tensor
                     ) -> torch.Tensor:
    """The MSM through the same glue with kernel 1's plain versions
    (sums_plain, combine_plain) on any device: what a CUDA tensor's
    kernels are held against at sizes where msm_plain's double-and-add
    takes too long.  Affine words [1, 2, ...]."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    return _pippenger(g, points, scalars, sums_plain, combine_plain)


def msm_plain(g: Group, points: torch.Tensor, scalars: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of the MSM on any device, independent of Pippenger's
    glue: ec_jax._msm_core's bit-plan double-and-add (each lane adds its
    base where its scalar's bit is set, then doubles the base), then the
    lanes summed pairwise (_tree_reduce).  Affine words [1, 2, ...]."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    bits = digits(scalars, 1)
    top = torch.nonzero(bits.any(0))
    base = from_affine(g, points)
    acc = tuple(torch.zeros_like(v) for v in base)     # Z = 0: infinity
    for k in range(int(top.max()) + 1 if top.numel() else 0):
        z = bi.select(bits[:, k] == 1, base[2], torch.zeros_like(base[2]))
        acc = add(g, acc, (base[0], base[1], z))
        base = dbl(g, base)
    while acc[0].shape[0] > 1:
        if acc[0].shape[0] % 2:
            acc = tuple(torch.cat([v, torch.zeros_like(v[:1])]) for v in acc)
        acc = add(g, tuple(v[0::2] for v in acc),
                  tuple(v[1::2] for v in acc))
    return to_affine(g, acc)


# ---- fixed-base batch ----

def generator(g: Group):
    return bn254.G1_GEN if g.deg == 1 else bn254.G2_GEN


@functools.lru_cache(maxsize=8)
def _table(g: Group, base, device: torch.device) -> torch.Tensor:
    """Affine words [ceil(254/8), 256, 2, ...]: entry (w, d) is
    d * 2^(8w) * base (d = 0: infinity), built on the host."""
    if g.deg == 1:
        from_a, add_, to_a, zero = (bn254.g1_from_affine, bn254.g1_add,
                                    bn254.g1_to_affine_all, bn254.G1_ZERO)
    else:
        from_a, add_, to_a, zero = (bn254.g2_from_affine, bn254.g2_add,
                                    bn254.g2_to_affine_all, bn254.G2_ZERO)
    rows = []
    b = from_a(base)
    for _ in range(-(-NBITS // TABLE_BITS)):
        row = [zero]
        for _d in range(1, 1 << TABLE_BITS):
            row.append(add_(row[-1], b))
        rows.extend(row)
        b = add_(row[-1], b)
    W = -(-NBITS // TABLE_BITS)
    return affine_tensor(g, to_a(rows), device).view(
        W, 1 << TABLE_BITS, 2, *g.coord_shape)


def scalar_mul_batch_plain(g: Group, base, scalars: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of kernel 2: s_i * base for each standard scalar,
    affine words [n, 2, ...].  A windowed fixed-base multiply over host
    tables (one complete mixed addition a window), then one batch
    inversion, PLAIN_CHUNK lanes a batch."""
    tab = _table(g, base, scalars.device)
    out = []
    for part in scalars.split(PLAIN_CHUNK):
        d = digits(part, TABLE_BITS)
        acc = from_affine(g, tab[0, d[:, 0]])
        for w in range(1, tab.shape[0]):
            acc = add_affine(g, acc, affine_limbs(g, tab[w, d[:, w]]))
        out.append(to_affine(g, acc))
    return torch.cat(out) if out else \
        torch.zeros((0, 2, *g.coord_shape), dtype=torch.int64,
                    device=scalars.device)


def scalar_mul_batch(g: Group, base, scalars: torch.Tensor) -> torch.Tensor:
    """s_i * base (base: affine Python ints), affine Montgomery words
    [n, 2, ...]: kernel 2 (csrc/ec_batch.cu) for a CUDA tensor."""
    if scalars.dtype != torch.int64 or scalars.dim() != 2 or \
            scalars.shape[1] != 4:
        raise ValueError(f"scalars: int64 [n, 4], got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")
    scalars = scalars.contiguous()
    if scalars.device.type == "cpu":
        return scalar_mul_batch_plain(g, base, scalars)
    return _scalar_mul_batch_cuda(g, base, scalars)


def _scalar_mul_batch_cuda(g, base, scalars):
    n = scalars.shape[0]
    out = torch.empty((n, 2, *g.coord_shape), dtype=torch.int64,
                      device=scalars.device)
    if n:
        b = affine_tensor(g, [base], scalars.device)
        kernels.EC_BATCH.launch(scalars.device.index, g.code, b.data_ptr(),
                                scalars.data_ptr(), n, out.data_ptr(),
                                stream=_stream(scalars.device))
    return out


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
