"""secp256k1 ECDSA public-key recovery (ecrecover) as a C guest on the
RV32 zkVM machine.

The reference proves transaction signatures by compiling the k256 crate
into its RISC-V guest (the reference's zkvm/program/evm/src/lib.rs:2-27 —
revm + k256 in-guest).  This module is that capability for the native
machine: full public-key recovery — hint-verified square root, in-guest
binary-ext-GCD modular inversions, Shamir double-scalar multiplication in
Jacobian coordinates, and keccak256 address derivation (reusing
guest_keccak.py) — written in the cc.py C subset and compiled to RV32IM
machine code.

Soundness model for the one hint: the y-coordinate of the decompressed
point R is passed in as input and VERIFIED in-guest (ry^2 == rx^3 + 7
mod p, parity(ry) == v).  A wrong hint makes the guest return the
failure code; it can never make it recover a different address.  This is
the standard zkVM accelerator pattern (the reference's k256 build does
the sqrt in-guest; hinting it saves ~500 field exponentiation steps of
trace).

Numbers are 256-bit little-endian u32[8] limb arrays.  Field layout:
  - mod p (2^256 - 2^32 - 977): products fold with the sparse constant
    0x1000003D1 = 2^32 + 977 (hot path, used by every point operation)
  - mod n (group order): cold path (two multiplies), binary shift-add
    modmul — simple and branch-verifiable
Inversions (1/r mod n, two 1/Z mod p) use the binary extended GCD
(HAC 14.61), add/sub/shift only.

Copy of eigen_zkvm_tpu/zkvm/guest_secp256k1.py for the PyTorch port."""
from __future__ import annotations

from .guest_keccak import keccak256_ref, keccak_c_source

# ---------------------------------------------------------------------------
# curve constants
# ---------------------------------------------------------------------------
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B7 = 7


# ---------------------------------------------------------------------------
# host-side reference implementation (differential oracle + vectors)
# ---------------------------------------------------------------------------
def _inv(x: int, m: int) -> int:
    return pow(x, -1, m)


def _point_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _point_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _point_add(acc, pt)
        pt = _point_add(pt, pt)
        k >>= 1
    return acc


def pubkey_of(priv: int):
    return _point_mul(priv, (GX, GY))


def address_of(pub) -> bytes:
    x, y = pub
    return keccak256_ref(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def sign(e: int, priv: int, k: int):
    """Deterministic-k ECDSA sign (test-vector construction only).
    Returns (v, r, s) with v the y-parity recid in {0, 1}."""
    R = _point_mul(k, (GX, GY))
    r = R[0] % N
    assert r != 0
    s = _inv(k, N) * ((e % N) + r * priv) % N
    assert s != 0
    return (R[1] & 1, r, s)


def ecrecover_ref(e: int, v: int, r: int, s: int) -> bytes | None:
    """Host-side oracle with Ethereum-precompile semantics: x = r only
    (the r + n second candidate is unreachable through the precompile),
    v in {0, 1} is the parity of R.y.  Returns the 20-byte address."""
    if not (0 < r < N and 0 < s < N and v in (0, 1)):
        return None
    # lift x = r to a curve point
    y2 = (pow(r, 3, P) + B7) % P
    ry = pow(y2, (P + 1) // 4, P)
    if ry * ry % P != y2:
        return None  # not a residue: r is not an x-coordinate
    if (ry & 1) != v:
        ry = P - ry
    rinv = _inv(r, N)
    u1 = (-(e % N)) * rinv % N
    u2 = s * rinv % N
    Q = _point_add(_point_mul(u1, (GX, GY)), _point_mul(u2, (r, ry)))
    if Q is None:
        return None
    return address_of(Q)


def sqrt_hint(r: int, v: int) -> int | None:
    """The y-coordinate hint the guest verifies (parity matched to v)."""
    y2 = (pow(r, 3, P) + B7) % P
    ry = pow(y2, (P + 1) // 4, P)
    if ry * ry % P != y2:
        return None
    return ry if (ry & 1) == v else P - ry


# ---------------------------------------------------------------------------
# C guest source
# ---------------------------------------------------------------------------
def _limbs(x: int) -> str:
    return ", ".join(f"{(x >> (32 * i)) & 0xFFFFFFFF}u" for i in range(8))


def _bignum_c() -> str:
    """The 256-bit primitive layer with bodies UNROLLED over constant
    limb indices: at the cc.py -O0 codegen a counted loop pays index
    arithmetic + branch per limb, and these helpers sit under every
    field operation (same trick as guest_keccak's unrolled rounds —
    153K -> 25K cycles/permutation there)."""
    cp = "\n    ".join(f"d[{i}] = s[{i}];" for i in range(8))
    zr = "\n    ".join(f"d[{i}] = 0u;" for i in range(8))
    isz = " | ".join(f"a[{i}]" for i in range(8))
    add = "\n    ".join(
        f"t = a[{i}] + c; c1 = t < c; s = t + b[{i}]; "
        f"c = c1 | (s < t); d[{i}] = s;" for i in range(8))
    sub = "\n    ".join(
        f"t = a[{i}] - b[{i}]; b1 = a[{i}] < b[{i}]; s = t - brw; "
        f"brw = b1 | (t < brw); d[{i}] = s;" for i in range(8))
    cmp_ = "\n    ".join(
        f"if (a[{i}] < b[{i}]) return -1;\n    if (a[{i}] > b[{i}]) return 1;"
        for i in range(7, -1, -1))
    shr = "\n    ".join(
        f"a[{i}] = (a[{i}] >> 1) | (a[{i+1}] << 31);" for i in range(7))
    return f"""
/* ---- 256-bit little-endian u32[8] primitives (unrolled) ---- */
void b_copy(unsigned *d, unsigned *s) {{
    {cp}
}}

void b_zero(unsigned *d) {{
    {zr}
}}

int b_iszero(unsigned *a) {{
    return ({isz}) == 0u ? 1 : 0;
}}

int b_isone(unsigned *a) {{
    if (a[0] != 1u) return 0;
    return (a[1] | a[2] | a[3] | a[4] | a[5] | a[6] | a[7]) == 0u ? 1 : 0;
}}

/* -1 / 0 / 1 as a < / == / > b */
int b_cmp(unsigned *a, unsigned *b) {{
    {cmp_}
    return 0;
}}

/* d = a + b, returns carry-out */
unsigned b_add(unsigned *d, unsigned *a, unsigned *b) {{
    unsigned c = 0u;
    unsigned t;
    unsigned c1;
    unsigned s;
    {add}
    return c;
}}

/* d = a - b, returns borrow-out */
unsigned b_sub(unsigned *d, unsigned *a, unsigned *b) {{
    unsigned brw = 0u;
    unsigned t;
    unsigned b1;
    unsigned s;
    {sub}
    return brw;
}}

/* in-place >>1 with carry-in at bit 255 */
void b_shr1c(unsigned *a, unsigned cin) {{
    {shr}
    a[7] = (a[7] >> 1) | (cin << 31);
}}

unsigned b_bit(unsigned *a, int i) {{
    return (a[i >> 5] >> (i & 31)) & 1u;
}}
"""


_MODHELP_C = r"""

/* ---- modular add/sub for operands already < m ---- */
void m_add(unsigned *d, unsigned *a, unsigned *b, unsigned *m) {
    unsigned c = b_add(d, a, b);
    if (c != 0u || b_cmp(d, m) >= 0) b_sub(d, d, m);
}

void m_sub(unsigned *d, unsigned *a, unsigned *b, unsigned *m) {
    if (b_sub(d, a, b) != 0u) b_add(d, d, m);
}

/* ---- binary extended GCD inverse: d = a^-1 mod m (m odd, a != 0) ----
   HAC algorithm 14.61; all arithmetic is add/sub/shift. */
unsigned gu[8];
unsigned gv[8];
unsigned gx1[8];
unsigned gx2[8];

void m_inv(unsigned *d, unsigned *a, unsigned *m) {
    b_copy(gu, a);
    b_copy(gv, m);
    b_zero(gx1);
    gx1[0] = 1u;
    b_zero(gx2);
    while (b_isone(gu) == 0 && b_isone(gv) == 0) {
        while ((gu[0] & 1u) == 0u) {
            b_shr1c(gu, 0u);
            if ((gx1[0] & 1u) == 0u) b_shr1c(gx1, 0u);
            else b_shr1c(gx1, b_add(gx1, gx1, m));
        }
        while ((gv[0] & 1u) == 0u) {
            b_shr1c(gv, 0u);
            if ((gx2[0] & 1u) == 0u) b_shr1c(gx2, 0u);
            else b_shr1c(gx2, b_add(gx2, gx2, m));
        }
        if (b_cmp(gu, gv) >= 0) {
            b_sub(gu, gu, gv);
            m_sub(gx1, gx1, gx2, m);
        } else {
            b_sub(gv, gv, gu);
            m_sub(gx2, gx2, gx1, m);
        }
    }
    if (b_isone(gu)) b_copy(d, gx1);
    else b_copy(d, gx2);
}

"""


def _mulp_c() -> str:
    """The hot kernel: d = a*b mod p as ONE fully-unrolled function over
    fixed global arrays (MA, MB -> MD).  Constant limb indices on
    low-data globals compile to single absolute-addressed lw/sw in
    cc.py's codegen; the pointer-API mul_p is a thin copy wrapper, so
    every call costs ~75 copy cycles against a ~7x cheaper body than
    the looped pointer version (measured 7.8K -> ~1.1K cycles).

    Reduction: 2^256 = 0x1000003D1 (mod p) folds the high half as
    (hi << 32) + hi*977, twice, then one sparse carry fold + cond-sub."""
    L = []
    # ---- product rows: PRD[16] = MA * MB (row 0 initializes) ----
    L.append("ai = MA[0]; carry = 0u;")
    for j in range(8):
        L.append(f"lo = ai * MB[{j}]; hi = __mulhu(ai, MB[{j}]);")
        L.append(f"t = lo + carry; c1 = t < carry; PRD[{j}] = t; "
                 "carry = hi + c1;")
    L.append("PRD[8] = carry;")
    for i in range(1, 8):
        L.append(f"ai = MA[{i}]; carry = 0u;")
        for j in range(8):
            L.append(f"lo = ai * MB[{j}]; hi = __mulhu(ai, MB[{j}]);")
            L.append(f"t = PRD[{i + j}] + lo; c1 = t < lo;")
            L.append(f"s = t + carry; carry = hi + c1 + (s < t); "
                     f"PRD[{i + j}] = s;")
        L.append(f"PRD[{i + 8}] = carry;")
    # ---- fold 1: FLD[0..8] (+ h1) = PRD[0..7] + hi*977 + (hi << 32) ----
    L.append("carry = 0u;")
    for j in range(8):
        L.append(f"lo = PRD[{8 + j}] * 977u; hi = __mulhu(PRD[{8 + j}], 977u);")
        L.append(f"t = PRD[{j}] + lo; c1 = t < lo;")
        L.append(f"s = t + carry; carry = hi + c1 + (s < t); FLD[{j}] = s;")
    L.append("FLD[8] = carry;")
    L.append("cc = 0u;")
    for j in range(8):
        L.append(f"t = FLD[{j + 1}] + PRD[{8 + j}]; c1 = t < PRD[{8 + j}];")
        L.append(f"s = t + cc; cc = c1 | (s < t); FLD[{j + 1}] = s;")
    # ---- fold 2 (h1 = cc <= 1, h0 = FLD[8] <= ~2^33 worth of carries) ----
    L.append("h0 = FLD[8]; h1 = cc;")
    L.append("lo = h0 * 977u; hi = __mulhu(h0, 977u);")
    L.append("t = FLD[0] + lo; c1 = t < lo; MD[0] = t;")
    L.append("lo = h1 * 977u;")
    L.append("t = FLD[1] + hi; cc = t < hi;")
    L.append("s = t + c1; cc = cc + (s < t);")
    L.append("t = s + lo; cc = cc + (t < s);")
    L.append("s = t + h0; cc = cc + (s < t);")
    L.append("MD[1] = s;")
    L.append("t = FLD[2] + h1; c1 = t < h1;")
    L.append("s = t + cc; c1 = c1 + (s < t); MD[2] = s;")
    for j in range(3, 8):
        L.append(f"t = FLD[{j}] + c1; c1 = t < c1; MD[{j}] = t;")
    body = "\n    ".join(L)
    return f"""
/* ---- mod-p multiply: unrolled schoolbook 8x8 + sparse fold ---- */
unsigned MA[8];
unsigned MB[8];
unsigned MD[8];
unsigned PRD[16];
unsigned FLD[9];

void mulp_g() {{
    unsigned ai;
    unsigned lo;
    unsigned hi;
    unsigned t;
    unsigned s;
    unsigned c1;
    unsigned carry;
    unsigned cc;
    unsigned h0;
    unsigned h1;
    {body}
    /* value < 2^256 + 2^67 so the carry-out is one sparse fold; the
       wrapped low part is then < 2^67, no second wrap possible */
    if (c1 != 0u) {{
        t = MD[0] + 977u;
        cc = t < 977u;
        MD[0] = t;
        MD[1] = MD[1] + 1u + cc;
    }}
    if (b_cmp(MD, Pmod) >= 0) b_sub(MD, MD, Pmod);
}}

void mul_p(unsigned *d, unsigned *a, unsigned *b) {{
    b_copy(MA, a);
    b_copy(MB, b);
    mulp_g();
    b_copy(d, MD);
}}

void sqr_p(unsigned *d, unsigned *a) {{
    b_copy(MA, a);
    b_copy(MB, a);
    mulp_g();
    b_copy(d, MD);
}}
"""


_MULN_C = r"""
/* ---- mod-n multiply: binary shift-add (cold path, 2 uses) ---- */
unsigned MACC[8];

void mul_n(unsigned *d, unsigned *a, unsigned *b) {
    int i;
    b_zero(MACC);
    for (i = 255; i >= 0; i--) {
        unsigned c = b_add(MACC, MACC, MACC);
        if (c != 0u || b_cmp(MACC, Nmod) >= 0) b_sub(MACC, MACC, Nmod);
        if (b_bit(b, i) != 0u) {
            c = b_add(MACC, MACC, a);
            if (c != 0u || b_cmp(MACC, Nmod) >= 0) b_sub(MACC, MACC, Nmod);
        }
    }
    b_copy(d, MACC);
}
"""

_POINT_C = r"""
/* ---- Jacobian point ops mod p on the accumulator (QX, QY, QZ) ---- */
unsigned QX[8];
unsigned QY[8];
unsigned QZ[8];
unsigned tA[8];
unsigned tB[8];
unsigned tC[8];
unsigned tD[8];
unsigned tE[8];
unsigned tF[8];
unsigned tG[8];
unsigned tH[8];

/* Q = 2Q (a = 0 doubling; Q may be infinity: Z = 0 fixes itself since
   Z3 = 2*Y*Z stays 0) */
void pdbl() {
    /* A = X^2, B = Y^2, C = B^2 */
    sqr_p(tA, QX);
    sqr_p(tB, QY);
    sqr_p(tC, tB);
    /* D = 2*((X+B)^2 - A - C) */
    m_add(tD, QX, tB, Pmod);
    sqr_p(tD, tD);
    m_sub(tD, tD, tA, Pmod);
    m_sub(tD, tD, tC, Pmod);
    m_add(tD, tD, tD, Pmod);
    /* E = 3A, F = E^2 */
    m_add(tE, tA, tA, Pmod);
    m_add(tE, tE, tA, Pmod);
    sqr_p(tF, tE);
    /* X3 = F - 2D */
    m_sub(tF, tF, tD, Pmod);
    m_sub(tF, tF, tD, Pmod);
    /* Y3 = E*(D - X3) - 8C */
    m_sub(tD, tD, tF, Pmod);
    mul_p(tD, tE, tD);
    m_add(tC, tC, tC, Pmod);
    m_add(tC, tC, tC, Pmod);
    m_add(tC, tC, tC, Pmod);
    m_sub(QY, tD, tC, Pmod);
    /* Z3 = 2*Y*Z (uses the OLD Y, saved in tB? no: Y^2 is tB; need old Y) */
    b_copy(QX, tF);
}

/* full doubling wrapper that preserves old Y for Z3 */
void pdouble() {
    b_copy(tH, QY);        /* old Y */
    pdbl();
    mul_p(QZ, tH, QZ);
    m_add(QZ, QZ, QZ, Pmod);
}

/* Q += (ax, ay) with (ax, ay) affine.  Handles Q = infinity, the
   doubling coincidence (H = 0, R = 0), and the inverse pair (-> Z = 0).
   Standard madd: U2 = ax*Z^2, S2 = ay*Z^3, H = U2-X, R = S2-Y. */
void padd_aff(unsigned *ax, unsigned *ay) {
    if (b_iszero(QZ)) {
        b_copy(QX, ax);
        b_copy(QY, ay);
        b_zero(QZ);
        QZ[0] = 1u;
        return;
    }
    sqr_p(tA, QZ);            /* Z^2 */
    mul_p(tB, tA, QZ);        /* Z^3 */
    mul_p(tA, tA, ax);        /* U2 */
    mul_p(tB, tB, ay);        /* S2 */
    m_sub(tC, tA, QX, Pmod);  /* H */
    m_sub(tD, tB, QY, Pmod);  /* R */
    if (b_iszero(tC)) {
        if (b_iszero(tD)) {
            pdouble();
            return;
        }
        b_zero(QZ);           /* inverse pair: infinity */
        return;
    }
    sqr_p(tE, tC);            /* H^2 */
    mul_p(tF, tE, tC);        /* H^3 */
    mul_p(tE, tE, QX);        /* X*H^2 */
    sqr_p(tG, tD);            /* R^2 */
    m_sub(tG, tG, tF, Pmod);
    m_sub(tG, tG, tE, Pmod);
    m_sub(tG, tG, tE, Pmod);  /* X3 = R^2 - H^3 - 2*X*H^2 */
    m_sub(tE, tE, tG, Pmod);  /* X*H^2 - X3 */
    mul_p(tE, tD, tE);        /* R*(X*H^2 - X3) */
    mul_p(tF, tF, QY);        /* Y*H^3 */
    m_sub(QY, tE, tF, Pmod);  /* Y3 */
    mul_p(QZ, QZ, tC);        /* Z3 = Z*H */
    b_copy(QX, tG);
}
"""


def build_guest_source(e: int, v: int, r: int, s: int,
                       ry_hint: int | None = None) -> str:
    """Emit the full ecrecover guest with the signature embedded as
    initialized globals (the cc.py guest-input convention, see
    guest_evm_c.build_guest_source).  Returns C source whose main()
    leaves status in a0 (1 = recovered, 0 = invalid signature) and the
    20-byte address in the `out_addr` global (bound into the RAM-image
    continuation digest)."""
    if ry_hint is None:
        ry_hint = sqrt_hint(r, v)
    hint = 0 if ry_hint is None else ry_hint
    src = keccak_c_source()
    src += f"""
unsigned Pmod[8] = {{{_limbs(P)}}};
unsigned Nmod[8] = {{{_limbs(N)}}};
unsigned Gx[8] = {{{_limbs(GX)}}};
unsigned Gy[8] = {{{_limbs(GY)}}};
unsigned sig_r[8] = {{{_limbs(r)}}};
unsigned sig_s[8] = {{{_limbs(s)}}};
unsigned msg_e[8] = {{{_limbs(e)}}};
unsigned sig_v = {v}u;
unsigned hint_ry[8] = {{{_limbs(hint)}}};
"""
    src += _bignum_c() + _MODHELP_C + _mulp_c() + _MULN_C
    src += _POINT_C
    src += r"""
unsigned u1[8];
unsigned u2[8];
unsigned cgx[8];   /* G + R affine */
unsigned cgy[8];
unsigned rx[8];
unsigned zi[8];
unsigned afx[8];
unsigned afy[8];
unsigned char pkbuf[64];
unsigned char dig[32];
unsigned char out_addr[20];

void be_store(unsigned char *buf, unsigned *x) {
    int i;
    for (i = 0; i < 8; i++) {
        unsigned limb = x[7 - i];
        buf[4 * i] = (unsigned char)(limb >> 24);
        buf[4 * i + 1] = (unsigned char)(limb >> 16);
        buf[4 * i + 2] = (unsigned char)(limb >> 8);
        buf[4 * i + 3] = (unsigned char)limb;
    }
}

int main() {
    int i;
    /* 1. range checks: 0 < r < n, 0 < s < n, v in {0,1} */
    if (b_iszero(sig_r) || b_cmp(sig_r, Nmod) >= 0) return 0;
    if (b_iszero(sig_s) || b_cmp(sig_s, Nmod) >= 0) return 0;
    if (sig_v > 1u) return 0;
    /* 2. verify the sqrt hint: ry^2 == rx^3 + 7 (mod p), parity == v */
    b_copy(rx, sig_r);
    sqr_p(tA, hint_ry);
    sqr_p(tB, rx);
    mul_p(tB, tB, rx);
    b_zero(tC);
    tC[0] = 7u;
    m_add(tB, tB, tC, Pmod);
    if (b_cmp(tA, tB) != 0) return 0;
    if ((hint_ry[0] & 1u) != sig_v) return 0;
    if (b_cmp(hint_ry, Pmod) >= 0) return 0;
    /* 3. u1 = -e * r^-1 mod n, u2 = s * r^-1 mod n */
    m_inv(tD, sig_r, Nmod);           /* r^-1 mod n */
    b_copy(tE, msg_e);
    if (b_cmp(tE, Nmod) >= 0) b_sub(tE, tE, Nmod);
    if (b_iszero(tE)) b_zero(tF);
    else b_sub(tF, Nmod, tE);         /* -e mod n */
    mul_n(u1, tF, tD);
    mul_n(u2, sig_s, tD);
    /* 4. precompute G + R affine (via one Jacobian add + affinize) */
    b_zero(QZ);
    padd_aff(Gx, Gy);
    padd_aff(rx, hint_ry);
    if (b_iszero(QZ)) {
        /* G == -R: G+R is infinity; the joint table entry is never a
           valid add target then — flag with cgx = cgy = 0 */
        b_zero(cgx);
        b_zero(cgy);
    } else {
        m_inv(zi, QZ, Pmod);
        sqr_p(tA, zi);
        mul_p(cgx, QX, tA);
        mul_p(tA, tA, zi);
        mul_p(cgy, QY, tA);
    }
    /* 5. Shamir ladder over (u1, u2) */
    b_zero(QZ);
    b_zero(QX);
    b_zero(QY);
    for (i = 255; i >= 0; i--) {
        unsigned k;
        pdouble();
        k = b_bit(u1, i) | (b_bit(u2, i) << 1);
        if (k == 1u) padd_aff(Gx, Gy);
        if (k == 2u) padd_aff(rx, hint_ry);
        if (k == 3u) {
            if (b_iszero(cgx) && b_iszero(cgy)) {
                padd_aff(Gx, Gy);
                padd_aff(rx, hint_ry);
            } else padd_aff(cgx, cgy);
        }
    }
    if (b_iszero(QZ)) return 0;       /* recovered point at infinity */
    /* 6. affinize */
    m_inv(zi, QZ, Pmod);
    sqr_p(tA, zi);
    mul_p(afx, QX, tA);
    mul_p(tA, tA, zi);
    mul_p(afy, QY, tA);
    /* 7. address = keccak256(X || Y)[12..32] */
    be_store(pkbuf, afx);
    be_store(pkbuf + 32, afy);
    keccak256(pkbuf, 64u, dig);
    for (i = 0; i < 20; i++) out_addr[i] = dig[12 + i];
    return 1;
}
"""
    return src


def build_unit_source(op: str, a: int, b: int) -> str:
    """Tiny single-operation guests for differential unit tests of the
    field primitives (op in mul_p / mul_n / inv_p / inv_n).  main()
    computes d = op(a, b) and returns 1 iff d matches the host-computed
    expectation baked in as `expect`."""
    if op == "mul_p":
        expect = a * b % P
    elif op == "mul_n":
        expect = a * b % N
    elif op == "inv_p":
        expect = pow(a, -1, P)
    elif op == "inv_n":
        expect = pow(a, -1, N)
    else:
        raise ValueError(op)
    src = f"""
unsigned Pmod[8] = {{{_limbs(P)}}};
unsigned Nmod[8] = {{{_limbs(N)}}};
unsigned ua[8] = {{{_limbs(a)}}};
unsigned ub[8] = {{{_limbs(b)}}};
unsigned expect[8] = {{{_limbs(expect)}}};
unsigned res[8];
"""
    src += _bignum_c() + _MODHELP_C + _mulp_c() + _MULN_C
    body = {
        "mul_p": "mul_p(res, ua, ub);",
        "mul_n": "mul_n(res, ua, ub);",
        "inv_p": "m_inv(res, ua, Pmod);",
        "inv_n": "m_inv(res, ua, Nmod);",
    }[op]
    src += f"""
int main() {{
    {body}
    return b_cmp(res, expect) == 0 ? 1 : 0;
}}
"""
    return src
