"""Batched G1 and G2 of BN254 and of BLS12-381 on tensors: the plain point
arithmetic, the multi-scalar multiplication (kernel 1, csrc/msm.cuh in
csrc/msm{,_g2,_g2_sums,_bls}.cu) and the fixed-base batch (kernel 2,
csrc/ec_batch.cu and csrc/ec_batch_bls.cu).

Port of eigen_zkvm_tpu/ops/ec_jax.py, for G1 over Fq and G2 over Fq2, and
of the host group arithmetic the JAX package runs for BLS12-381.  A
`Curve` holds what differs between the two (base and scalar field, scalar
bits, host arithmetic on ints, the kernels); a `Group` (G1, G2, G1_BLS,
G2_BLS) is one of its groups.  Points cross the module as words in
Montgomery form (ops/bigint.py), W words a base-field element (4 for
BN254, 6 for BLS12-381): affine G1 [n, 2, W] (x, y), affine G2 [n, 2, 2,
W]; Jacobian points, which pass between the MSM's stages, [n, 3, W] and
[n, 3, 2, W] (X, Y, Z).  The
point at infinity is (0, 0) in affine form, which lies on neither curve, and
Z = 0 in Jacobian form.  The plain arithmetic works on limb tensors
(bigint.limbs) with ec_jax's complete formulas: dbl-2009-l doubling and the
add-2007-bl addition, patched where a point is infinity, where P + P needs
the doubling and where P + (-P) is infinity; the independent Fq products of
a formula are taken in one batched product.

The MSM is Pippenger's bucket method with signed digits, the same stages on
both routes:
  1. entries (`entries`: csrc/msm.cu msm_digits, or `entries_plain`): each
     scalar's signed c-bit digits (signed_digits), one entry per nonzero
     digit of a finite point, keyed by bucket (window, |digit|) with the
     point's index and the digit's sign; then sorted by key (torch.sort);
  2. bucket sums (`level`: csrc/msm.cu msm_level, or `level_plain`): the
     sorted entries cut into chunks (`first_chunk`), each chunk's runs
     summed, a run that crosses a chunk boundary carried to a next level
     of LEVEL_CHUNK partials (`sum_by_key`), so a hot bucket (the digit 1 of
     a circuit's many boolean wires) is split like any other;
  3. the buckets' weights by running sums (`window_chunks`:
     msm_window_chunks, or `window_chunks_plain`): each window's buckets
     cut into chunks, a chunk's running sum and weighted sum, the chunks of
     a window summed by `sum_by_key`;
  4. combine (`combine`: msm_combine, or `combine_plain`):
     sum_w 2^(c w) V_w by Horner's rule, the result to affine.
A CUDA tensor goes to the kernels (a failure raises kernels.KernelError);
a CPU tensor to the plain versions.  The kernels are held against two plain
versions: `msm_plain`, ec_jax's double-and-add, which shares none of these
stages, and, at the prove's sizes, `msm_stages_plain`, the same glue with
the plain versions of stages 1-4.  One host sync an MSM: the count of
entries.  `msm(..., trace=[])` records CUDA events at the stage
boundaries.
"""
from __future__ import annotations

import ctypes
import functools
import time

import torch

from .. import kernels
from ..curves import bls12_381, bn254
from . import bigint as bi

NBITS = 254          # BN254's Fr scalars fit 254 bits
TABLE_BITS = 8       # window of the plain fixed-base tables


class Curve:
    """What the group code needs of a pairing curve: its name (the JSON's
    and the key file's), the host arithmetic on Python ints (a module with
    curves/bn254.py's interface), its base field `fq` and scalar field
    `fr` (ops/bigint.Field), the bits of its scalars, and its MSM and
    fixed-base kernels (their launch counts)."""

    def __init__(self, name: str, ints, fq: bi.Field, fr: bi.Field,
                 nbits: int, msm: kernels.Kernel, batch: kernels.Kernel):
        self.name = name
        self.ints = ints
        self.fq = fq
        self.fr = fr
        self.nbits = nbits
        self.msm = msm
        self.batch = batch

    def __repr__(self) -> str:
        return self.name


BN254 = Curve("bn128", bn254, bi.FQ, bi.FR, NBITS, kernels.MSM,
              kernels.EC_BATCH)
# BLS12-381's r is 255 bits (about 0.45 * 2^256): its signed digits cover
# 256 bits, its fixed-base tables the same 32 windows of 8 bits
BLS12_381 = Curve("bls12381", bls12_381, bi.FQ381, bi.FR_BLS, 255,
                  kernels.MSM_BLS, kernels.EC_BATCH_BLS)


class Group:
    """G1 (coordinates in the curve's Fq, deg 1) or G2 (in its Fq2, deg 2)
    of `curve`; `code` is the kernels' curve argument, `prefix` the prefix
    of its MSM stages' C entries (csrc/msm.cuh)."""

    def __init__(self, name: str, curve: Curve, deg: int, code: int,
                 prefix: str):
        self.name = name
        self.curve = curve
        self.field = curve.fq
        self.deg = deg
        self.code = code
        self.prefix = prefix

    def __repr__(self) -> str:
        return self.name

    def mul(self, a, b):
        return bi.mul(self.field, a, b) if self.deg == 1 else \
            bi.f2_mul(a, b, self.field)

    def add(self, a, b):
        return bi.add(self.field, a, b)

    def sub(self, a, b):
        return bi.sub(self.field, a, b)

    def neg(self, a):
        return bi.neg(self.field, a)

    def is_zero(self, a):
        return bi.is_zero(a, self.deg)

    def one(self, device):
        o = bi.one(self.field, device)
        return o if self.deg == 1 else torch.stack([o, torch.zeros_like(o)])

    def inv(self, a):
        """Batch inverse over the leading dimension (no zeros)."""
        f = self.field
        if self.deg == 1:
            return bi.batch_inv(f, a)
        sq = bi.mul(f, a, a)
        t = bi.batch_inv(f, bi.add(f, sq[..., 0, :], sq[..., 1, :]))
        c = torch.stack([a[..., 0, :], bi.neg(f, a[..., 1, :])], -2)
        return bi.mul(f, c, t.unsqueeze(-2).expand_as(c))

    @property
    def coord_shape(self) -> tuple:
        """Word shape of one coordinate."""
        w = self.field.words
        return (w,) if self.deg == 1 else (2, w)

    @property
    def nbits(self) -> int:
        return self.curve.nbits


G1 = Group("G1", BN254, 1, 1, "msm")
G2 = Group("G2", BN254, 2, 2, "msm_g2")
G1_BLS = Group("BLS12-381 G1", BLS12_381, 1, 3, "msm_bls")
G2_BLS = Group("BLS12-381 G2", BLS12_381, 2, 4, "msm_bls_g2")
GROUPS = {BN254.name: (G1, G2), BLS12_381.name: (G1_BLS, G2_BLS)}
CURVES = {BN254.name: BN254, BLS12_381.name: BLS12_381}


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


def add(g: Group, p, q, check: bool = True):
    """Complete Jacobian addition (add-2007-bl with the exceptional cases
    patched as ec_jax._add does).  `check` reads on the host whether any
    lane adds a point to itself and skips the doubling when none does;
    without it the doubling is always computed (no host read, as a
    captured CUDA graph needs; the same result)."""
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
    if not check or bool(same.any()):
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
    f = g.field
    vals = []
    for p in points:
        if p is None:
            vals.extend([0] * (2 * g.deg))
        elif g.deg == 1:
            vals.extend(f.to_mont_int(v) for v in p)
        else:
            vals.extend(f.to_mont_int(v) for c in p for v in c)
    return bi.to_tensor(vals, device, f.words).view(len(points), 2,
                                                     *g.coord_shape)


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
        c = [g.field.from_mont_int(x) for x in c]
        out.append((c[0], c[1]) if g.deg == 1
                   else ((c[0], c[1]), (c[2], c[3])))
    return out


# ---- stage trace ----

def _mark(trace: list | None, label: str, device: torch.device, **info):
    """Append a CUDA event (and the host clock) to `trace` at a stage
    boundary, when the caller passed a list and the MSM runs on the card."""
    if trace is not None and device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        trace.append((label, ev, time.perf_counter(), info))


def stage_times(trace: list) -> list:
    """[{stage, device_ms, host_ms, ...}] of an MSM's `trace`: the time
    from the previous mark to this one on the card's stream and on the
    host (synchronizes)."""
    if not trace:
        return []
    torch.cuda.synchronize()
    return [dict(stage=lab, device_ms=a[1].elapsed_time(ev),
                 host_ms=(t - a[2]) * 1e3, **info)
            for a, (lab, ev, t, info) in zip(trace, trace[1:])]


# ---- Pippenger ----

BUCKET_CHUNK = 64    # entries a thread of the first bucket level walks, at
                     # the least
LEVEL_CHUNK = 8      # partial sums a thread of a later level adds
WINDOW_PARTS = 1024  # chunks of a window's buckets for the running sums


def window_bits(n: int) -> int:
    """The digit width c of an MSM of n points."""
    return max(4, min(14, n.bit_length() - 7))


def n_windows(c: int, nbits: int = NBITS) -> int:
    """Windows of signed c-bit digits of scalars below 2^nbits: c W >=
    nbits + 1 leaves the top window room for the carry out of the one below
    (BN254: scalars < r < 2^254, c W >= 255; BLS12-381: r < 2^255, c W >=
    256, so c (W - 1) may be 255, the highest bit a window starts at)."""
    return -(-(nbits + 1) // c)


def digits(scalars: torch.Tensor, c: int, windows: int | None = None
           ) -> torch.Tensor:
    """[n, 4] standard words -> [n, W] unsigned c-bit digits, W = windows
    or ceil(254 / c)."""
    cols = []
    for w in range(windows or -(-NBITS // c)):
        wi, sh = divmod(c * w, 64)
        d = scalars[:, wi] if sh == 0 else \
            (scalars[:, wi] >> sh) & ((1 << (64 - sh)) - 1)
        if sh + c > 64 and wi + 1 < 4:
            d = d | (scalars[:, wi + 1] << (64 - sh))
        cols.append(d & ((1 << c) - 1))
    return torch.stack(cols, 1)


def signed_digits(scalars: torch.Tensor, c: int, nbits: int = NBITS
                  ) -> torch.Tensor:
    """[n, 4] standard words below 2^nbits -> [n, n_windows(c, nbits)]
    digits in (-2^(c-1), 2^(c-1)] with sum_w d_w 2^(c w) = s: a digit
    above 2^(c-1) becomes d - 2^c and carries one into the next window
    (never out of the top one: n_windows)."""
    raw = digits(scalars, c, n_windows(c, nbits))
    half = 1 << (c - 1)
    carry = torch.zeros_like(raw[:, 0])
    cols = []
    for w in range(raw.shape[1]):
        d = raw[:, w] + carry
        carry = (d > half).to(d.dtype)
        cols.append(d - (carry << c))
    return torch.stack(cols, 1)


PLAIN_CHUNK = 1 << 20   # entries (or lanes) a plain batch holds at the most


def _entry_points(g: Group, pts, refs, a: int, b: int):
    """Entries a..b-1 of a level as Jacobian limb points: affine points
    through refs (index << 1 | negative: (x, q - y)), else partials."""
    if refs is None:
        return from_jacobian(pts[a:b])
    r = refs[a:b].long()
    x, y, z = from_affine(g, pts[r >> 1])
    return x, bi.select((r & 1).bool(), g.neg(y), y), z


def _segment_sums(g: Group, pts, refs, start: torch.Tensor, end: int
                  ) -> torch.Tensor:
    """Jacobian words [S]: segment s sums entries [start[s], start[s+1])
    (start[S] = end) by pairwise rounds, at most PLAIN_CHUNK entries a
    batch."""
    bounds = torch.searchsorted(
        start, torch.arange(0, end, PLAIN_CHUNK, device=start.device))
    bounds = sorted(set(bounds.tolist()) | {start.numel()})
    start = torch.cat([start, start.new_tensor([end])])
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        a, b = int(start[lo]), int(start[hi])
        p = _entry_points(g, pts, refs, a, b)
        rel = start[lo : hi + 1] - a
        lens = rel.diff()
        seg = torch.repeat_interleave(
            torch.arange(lens.numel(), device=rel.device), lens)
        rank = torch.arange(b - a, device=rel.device) - rel[:-1][seg]
        length = lens[seg]
        step = 1
        while step < int(lens.max()):
            act = torch.nonzero((rank % (2 * step) == 0)
                                & (rank + step < length)).squeeze(1)
            r = add(g, tuple(v[act] for v in p),
                    tuple(v[act + step] for v in p))
            for v, rv in zip(p, r):
                v[act] = rv
            step *= 2
        out.append(jacobian_words(tuple(v[rel[:-1]] for v in p)))
    return torch.cat(out)


def level_plain(g: Group, pts: torch.Tensor, refs, keys: torch.Tensor,
                L: int, sums: torch.Tensor):
    """Plain version of msm_level: the entries of sorted keys cut into
    chunks of L; each run of one key inside a chunk is summed; a run that
    is the whole of its key's run goes to sums[key] (unless infinity), the
    run a chunk opens with, begun in the chunk before, to the chunk's head
    slot, the run it closes with, going on into the next, to its tail slot.
    Returns the carries (keys int32 [2C], Jacobian words [2C]) for C
    chunks; an unused slot is infinity under the chunk's first or last
    key."""
    M = keys.numel()
    dev = keys.device
    C = -(-M // L)
    pos = torch.arange(M, device=dev)
    cut = pos % L == 0
    cut[1:] |= keys[1:] != keys[:-1]
    start = torch.nonzero(cut).squeeze(1)
    last = torch.cat([start[1:], start.new_tensor([M])]) - 1
    k = keys[start]
    before = (start > 0) & (keys[(start - 1).clamp(min=0)] == k)
    on = (last + 1 < M) & (keys[(last + 1).clamp(max=M - 1)] == k)
    seg = _segment_sums(g, pts, refs, start, M)
    chunk = start // L
    first_of = torch.arange(C, device=dev) * L
    ck = torch.stack([keys[first_of],
                      keys[(first_of + L).clamp(max=M) - 1]], 1).view(-1)
    cp = torch.zeros((2 * C, 3, *g.coord_shape), dtype=torch.int64,
                     device=dev)
    tail = ~before & on
    cp[2 * chunk[before]] = seg[before]
    cp[2 * chunk[tail] + 1] = seg[tail]
    done = ~before & ~on & ~g.is_zero(seg[:, 2])
    sums[k[done].long()] = seg[done]
    return ck, cp


def level(g: Group, pts: torch.Tensor, refs, keys: torch.Tensor, L: int,
          sums: torch.Tensor):
    """One level of the bucket sums (stage 2): kernel 1's msm_level for
    CUDA tensors."""
    if keys.device.type == "cpu":
        return level_plain(g, pts, refs, keys, L, sums)
    dev = keys.device
    C = -(-keys.numel() // L)
    ck = torch.empty(2 * C, dtype=torch.int32, device=dev)
    cp = torch.empty((2 * C, 3, *g.coord_shape), dtype=torch.int64,
                     device=dev)
    g.curve.msm.launch(dev.index, g.code, int(refs is not None),
                       pts.data_ptr(), kernels.pointer(refs), keys.data_ptr(),
                       keys.numel(), L, sums.data_ptr(), ck.data_ptr(),
                       cp.data_ptr(), stream=_stream(dev),
                       entry=f"{g.prefix}_level")
    return ck, cp


@functools.lru_cache(maxsize=None)
def _level_capacity(device_index: int, g: Group) -> int:
    threads = ctypes.c_int()
    kernels.check(g.curve.msm.name, getattr(
        kernels.library(), f"{g.prefix}_level_capacity")(
            device_index, g.code, ctypes.byref(threads)))
    return threads.value


def first_chunk(g: Group, keys: torch.Tensor) -> int:
    """Affine entries a thread of the first level walks: BUCKET_CHUNK on
    the CPU; on the card at least that, and as many as spread the entries
    over the threads of msm_level it holds at once (one wave of equal
    chunks; the plain version on a CUDA tensor cuts the same chunks)."""
    if keys.device.type == "cpu":
        return BUCKET_CHUNK
    cap = _level_capacity(keys.device.index, g)
    return max(BUCKET_CHUNK, -(-keys.numel() // cap))


def sum_by_key(g: Group, level_fn, pts: torch.Tensor, refs,
               keys: torch.Tensor, n_out: int, trace=None) -> torch.Tensor:
    """Jacobian words [n_out]: slot k the sum of the entries of key k
    (sorted int32 keys; infinity for a key with none), level by level:
    first_chunk affine entries or LEVEL_CHUNK partials a thread, then the
    carries, until one chunk holds them all."""
    if LEVEL_CHUNK < 4:     # two carries a chunk: fewer entries a level
        raise ValueError(f"LEVEL_CHUNK {LEVEL_CHUNK} < 4")
    sums = torch.zeros((n_out, 3, *g.coord_shape), dtype=torch.int64,
                       device=keys.device)
    L = first_chunk(g, keys) if refs is not None else LEVEL_CHUNK
    while True:
        ck, cp = level_fn(g, pts, refs, keys, L, sums)
        _mark(trace, "msm_level", keys.device, entries=keys.numel(),
              threads=ck.numel() // 2, affine=refs is not None)
        if keys.numel() <= L:
            return sums
        pts, refs, keys, L = cp, None, ck, LEVEL_CHUNK


def window_chunks_plain(g: Group, buckets: torch.Tensor, m: int, s: int,
                        n_win: int) -> torch.Tensor:
    """Plain version of msm_window_chunks, batched over every (window,
    chunk): buckets [n_win * m] Jacobian words, bucket b of a window the
    sum of its digit b + 1 -> [n_win * (m / s)]: chunk p's
    sum_(b in [p s, p s + s)) (b + 1) B_b, by the kernel's running sums
    S += B_b, T += S from the top and T + (p s) S."""
    P = m // s
    B = tuple(v.view(n_win * P, s, *v.shape[1:])
              for v in from_jacobian(buckets))
    S = tuple(torch.zeros_like(v[:, 0]) for v in B)
    T = S
    for b in range(s - 1, -1, -1):
        S = add(g, S, tuple(v[:, b] for v in B))
        T = add(g, T, S)
    k = torch.arange(n_win * P, device=buckets.device) % P * s
    R = tuple(torch.zeros_like(v) for v in S)
    for bit in range(int(k.max()).bit_length() - 1, -1, -1):
        R = dbl(g, R)
        z = bi.select((k >> bit) & 1 == 1, S[2], torch.zeros_like(S[2]))
        R = add(g, R, (S[0], S[1], z))
    return jacobian_words(add(g, T, R))


def window_chunks(g: Group, buckets: torch.Tensor, m: int, s: int,
                  n_win: int) -> torch.Tensor:
    """Stage 3's running sums: kernel 1's msm_window_chunks for CUDA
    tensors."""
    if buckets.device.type == "cpu":
        return window_chunks_plain(g, buckets, m, s, n_win)
    out = torch.empty((n_win * (m // s), 3, *g.coord_shape),
                      dtype=torch.int64, device=buckets.device)
    g.curve.msm.launch(buckets.device.index, g.code, buckets.data_ptr(), m,
                       s, n_win, out.data_ptr(),
                       stream=_stream(buckets.device),
                       entry=f"{g.prefix}_window_chunks")
    return out


def _jacobian_ints(g: Group, pts: torch.Tensor) -> list:
    """Jacobian Montgomery words [n, 3, ...] -> Python Jacobian points in
    standard form (the same projective points, the curve module's form)."""
    v = [g.field.from_mont_int(x) for x in bi.to_ints(pts)]
    if g.deg == 1:
        return [tuple(v[i : i + 3]) for i in range(0, len(v), 3)]
    return [tuple((v[j], v[j + 1]) for j in range(i, i + 6, 2))
            for i in range(0, len(v), 6)]


def combine_plain(g: Group, windows: torch.Tensor, c: int) -> torch.Tensor:
    """Plain version of msm_combine: sum_w 2^(c w) V_w over the window
    sums [W] (Jacobian words) by Horner's rule, on Python ints (the curve's
    module, curves/bn254.py or curves/bls12_381.py).  The fold is a chain of
    c (W - 1) doublings of one point, as in the kernel's one thread; as
    tensor code each doubling would be a round of a few hundred operations
    on one element.  The affine result [1, 2, ...]."""
    c_ = g.curve.ints
    if g.deg == 1:
        dbl_, add_, to_, res = (c_.g1_double, c_.g1_add, c_.g1_to_affine,
                                c_.G1_ZERO)
    else:
        dbl_, add_, to_, res = (c_.g2_double, c_.g2_add, c_.g2_to_affine,
                                c_.G2_ZERO)
    for p in reversed(_jacobian_ints(g, windows)):
        for _ in range(c):
            res = dbl_(res)
        res = add_(res, p)
    return affine_tensor(g, [to_(res)], windows.device)


def combine(g: Group, windows: torch.Tensor, c: int) -> torch.Tensor:
    """Stage 4: kernel 1's msm_combine for CUDA tensors."""
    if windows.device.type == "cpu":
        return combine_plain(g, windows, c)
    out = torch.empty((1, 2, *g.coord_shape), dtype=torch.int64,
                      device=windows.device)
    g.curve.msm.launch(windows.device.index, g.code, windows.data_ptr(), c,
                       windows.shape[0], out.data_ptr(),
                       stream=_stream(windows.device),
                       entry=f"{g.prefix}_combine")
    return out


def entries_plain(points: torch.Tensor, scalars: torch.Tensor, c: int,
                  curve: Curve = BN254):
    """Plain version of msm_digits: one entry per nonzero signed digit of a
    finite point, (keys, refs) int32 [M]: key w 2^(c-1) + |d| - 1 (window
    w's bucket of |d|), ref the point's index << 1 | (d < 0)."""
    d = signed_digits(scalars, c, curve.nbits)
    W = d.shape[1]
    live = ~(points.flatten(1) == 0).all(1)
    ent = torch.nonzero(((d != 0) & live.unsqueeze(1)).view(-1)).squeeze(1)
    dv = d.view(-1)[ent]
    keys = (ent % W * (1 << (c - 1)) + dv.abs() - 1).to(torch.int32)
    refs = (ent // W * 2 + (dv < 0).long()).to(torch.int32)
    return keys, refs


def entries(points: torch.Tensor, scalars: torch.Tensor, c: int,
            curve: Curve = BN254):
    """Stage 1: kernel 1's msm_digits for CUDA tensors (entries in the
    order its warps reserve them); the count is read back, the MSM's one
    host sync."""
    if points.device.type == "cpu":
        return entries_plain(points, scalars, c, curve)
    dev = points.device
    n, W = points.shape[0], n_windows(c, curve.nbits)
    keys = torch.empty(n * W, dtype=torch.int32, device=dev)
    refs = torch.empty(n * W, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    curve.msm.launch(dev.index, points.data_ptr(), points[0].numel(),
                     scalars.data_ptr(), n, c, W, keys.data_ptr(),
                     refs.data_ptr(), count.data_ptr(), stream=_stream(dev),
                     entry="msm_digits")
    M = int(count)
    return keys[:M], refs[:M]


KERNEL_STAGES = (entries, level, window_chunks, combine)
PLAIN_STAGES = (entries_plain, level_plain, window_chunks_plain,
                combine_plain)


def _pippenger(g: Group, points: torch.Tensor, scalars: torch.Tensor,
               stages, trace=None) -> torch.Tensor:
    entries_fn, level_fn, chunks_fn, combine_fn = stages
    n = points.shape[0]
    dev = points.device
    if n >= 1 << 30:
        raise ValueError(f"msm of {n} points: refs are int32")
    c = window_bits(n)
    m = 1 << (c - 1)        # buckets a window: |digit| in 1..2^(c-1)
    W = n_windows(c, g.nbits)
    _mark(trace, "start", dev)
    keys, refs = entries_fn(points, scalars, c, g.curve)
    _mark(trace, "entries (sync)", dev, entries=keys.numel())
    if keys.numel() == 0:   # every scalar zero or every point infinity
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=dev)
    keys, order = torch.sort(keys)
    refs = refs[order]
    del order
    _mark(trace, "sort", dev)
    buckets = sum_by_key(g, level_fn, points, refs, keys, W * m, trace)
    del keys, refs
    s = max(1, m // WINDOW_PARTS)   # buckets a thread of the running sums
    parts = chunks_fn(g, buckets, m, s, W)
    _mark(trace, "msm_window_chunks", dev, threads=parts.shape[0])
    wkeys = torch.arange(W, dtype=torch.int32, device=dev).repeat_interleave(
        m // s)
    windows = sum_by_key(g, level_fn, parts, None, wkeys, W, trace)
    out = combine_fn(g, windows, c)
    _mark(trace, "msm_combine", dev, windows=W)
    return out


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


def msm(g: Group, points: torch.Tensor, scalars: torch.Tensor,
        trace: list | None = None) -> torch.Tensor:
    """sum_i scalars[i] * points[i]: points affine Montgomery words, scalars
    standard words below r.  Returns affine words [1, 2, ...].  With a
    `trace` list, CUDA events at the stage boundaries go into it
    (`stage_times` reads them)."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    return _pippenger(g, points, scalars, KERNEL_STAGES, trace)


def msm_stages_plain(g: Group, points: torch.Tensor, scalars: torch.Tensor
                     ) -> torch.Tensor:
    """The MSM through the same glue with kernel 1's plain versions
    (PLAIN_STAGES) on any device: what
    a CUDA tensor's kernels are held against at sizes where msm_plain's
    double-and-add takes too long.  Affine words [1, 2, ...]."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    return _pippenger(g, points, scalars, PLAIN_STAGES)


def msm_plain(g: Group, points: torch.Tensor, scalars: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of the MSM on any device, independent of Pippenger's
    glue: ec_jax._msm_core's bit-plan double-and-add (each lane adds its
    base where its scalar's bit is set, then doubles the base), then the
    lanes summed pairwise (_tree_reduce).  Affine words [1, 2, ...].  On a
    CUDA device with at most GRAPH_LANES lanes the rounds replay one
    captured round (`_rounds_on_a_graph`)."""
    points, scalars = _check_msm(g, points, scalars)
    if points.shape[0] == 0:
        return torch.zeros((1, 2, *g.coord_shape), dtype=torch.int64,
                           device=points.device)
    bits = digits(scalars, 1, g.nbits) == 1
    top = torch.nonzero(bits.any(0))
    rounds = int(top.max()) + 1 if top.numel() else 0
    base = from_affine(g, points)
    acc = tuple(torch.zeros_like(v) for v in base)     # Z = 0: infinity
    if points.is_cuda and rounds and points.shape[0] <= GRAPH_LANES:
        acc = _rounds_on_a_graph(g, acc, base, bits, rounds)
    else:
        for k in range(rounds):
            acc, base = _bit_round(g, acc, base, bits[:, k])
    while acc[0].shape[0] > 1:
        if acc[0].shape[0] % 2:
            acc = tuple(torch.cat([v, torch.zeros_like(v[:1])]) for v in acc)
        acc = add(g, tuple(v[0::2] for v in acc),
                  tuple(v[1::2] for v in acc))
    return to_affine(g, acc)


# Up to this many lanes a round of msm_plain on the card is bound by its
# launches, and a graph replay of it is faster (2^13 lanes: 2.3-2.6x on an
# H100); at 2^16 its device time binds, and the replay's unconditional
# doubling makes it no faster (0.9-1.1x).
GRAPH_LANES = 1 << 14


def _bit_round(g: Group, acc, base, bit, check: bool = True):
    """One round of msm_plain: each lane adds its base where its bit is
    set, and the bases double."""
    z = bi.select(bit, base[2], torch.zeros_like(base[2]))
    return add(g, acc, (base[0], base[1], z), check), dbl(g, base)


def _rounds_on_a_graph(g: Group, acc, base, bits, rounds: int):
    """msm_plain's rounds on a CUDA device: one round captured as a CUDA
    graph (`add` without its host check) and replayed `rounds` times, bit
    column k copied into the graph's input first: the eager loop's
    operations without their launch cost, thousands a round."""
    state = [v.clone() for v in acc + base]
    bit = bits[:, 0].clone()

    def one_round():
        a, b = _bit_round(g, tuple(state[:3]), tuple(state[3:]), bit,
                          check=False)
        return a + b

    side = torch.cuda.Stream(bit.device)
    side.wait_stream(torch.cuda.current_stream(bit.device))
    with torch.cuda.stream(side):
        one_round()   # warm-up: the cached constants exist before capture
    torch.cuda.current_stream(bit.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s, v in zip(state, one_round()):
            s.copy_(v)
    for k in range(rounds):
        bit.copy_(bits[:, k])
        graph.replay()
    return tuple(state[:3])


# ---- fixed-base batch ----

def generator(g: Group):
    c_ = g.curve.ints
    return c_.G1_GEN if g.deg == 1 else c_.G2_GEN


@functools.lru_cache(maxsize=8)
def _table(g: Group, base, device: torch.device) -> torch.Tensor:
    """Affine words [ceil(nbits/8), 256, 2, ...] (32 windows on both
    curves): entry (w, d) is d * 2^(8w) * base (d = 0: infinity), built on
    the host."""
    c_ = g.curve.ints
    if g.deg == 1:
        from_a, add_, to_a, zero = (c_.g1_from_affine, c_.g1_add,
                                    c_.g1_to_affine_all, c_.G1_ZERO)
    else:
        from_a, add_, to_a, zero = (c_.g2_from_affine, c_.g2_add,
                                    c_.g2_to_affine_all, c_.G2_ZERO)
    W = -(-g.nbits // TABLE_BITS)
    rows = []
    b = from_a(base)
    for _ in range(W):
        row = [zero]
        for _d in range(1, 1 << TABLE_BITS):
            row.append(add_(row[-1], b))
        rows.extend(row)
        b = add_(row[-1], b)
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
        d = digits(part, TABLE_BITS, tab.shape[0])
        acc = from_affine(g, tab[0, d[:, 0]])
        for w in range(1, tab.shape[0]):
            acc = add_affine(g, acc, affine_limbs(g, tab[w, d[:, w]]))
        out.append(to_affine(g, acc))
    return torch.cat(out) if out else \
        torch.zeros((0, 2, *g.coord_shape), dtype=torch.int64,
                    device=scalars.device)


def scalar_mul_batch(g: Group, base, scalars: torch.Tensor) -> torch.Tensor:
    """s_i * base (base: affine Python ints), affine Montgomery words
    [n, 2, ...]: kernel 2 (csrc/ec_batch.cu, csrc/ec_batch_bls.cu) for a
    CUDA tensor."""
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
        tab = _table(g, base, scalars.device)
        scratch = torch.empty_like(out)   # Z and the prefix products
        batch = g.curve.batch
        batch.launch(scalars.device.index, g.code, tab.data_ptr(),
                     scalars.data_ptr(), n, out.data_ptr(),
                     scratch.data_ptr(), stream=_stream(scalars.device))
    return out


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
