"""keccak256 as a C guest for the RV32 zkVM (compiled by zkvm/cc.py).

The reference EVM guest hashes with keccak in-guest (zkvm/program/evm:
revm pulls in the keccak256 crate); this is that capability for the
native machine: Keccak-f[1600] over 64-bit lanes represented as u32
(lo, hi) pairs — RV32 has no 64-bit registers — with the theta/rho/pi/
chi/iota schedule written in plain C and compiled to RV32IM machine
code.  `keccak256_c_source()` is reused by the EVM interpreter guest
(zkvm/guest_evm_c.py).

Copy of eigen_zkvm_tpu/zkvm/guest_keccak.py for the PyTorch port."""
from __future__ import annotations

# Rho rotation offsets and pi lane permutation (standard Keccak tables),
# and the 24 round constants split into u32 halves.
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45,
        15, 21, 8, 18, 2, 61, 56, 14]  # rot[x + 5y]
_PI_SRC = [(0, 0)] + [None] * 24
# pi: out[y][2x+3y] = in[x][y] — precompute dest index for src lane i
_PI = [0] * 25
for x in range(5):
    for y in range(5):
        _PI[x + 5 * y] = y + 5 * ((2 * x + 3 * y) % 5)


def _round_body() -> str:
    """The Keccak-f round fully unrolled with CONSTANT state indices —
    with the state arrays in the low-2KB data region, every access
    compiles to a single absolute-addressed lw/sw (the generic loop
    version pays li+add per access: 153K cycles/permutation vs ~25K)."""
    L = []
    # theta: column parities into locals (register-promoted)
    for x in range(5):
        L.append(f"c{x}l = kst_lo[{x}] ^ kst_lo[{x+5}] ^ kst_lo[{x+10}]"
                 f" ^ kst_lo[{x+15}] ^ kst_lo[{x+20}];")
        L.append(f"c{x}h = kst_hi[{x}] ^ kst_hi[{x+5}] ^ kst_hi[{x+10}]"
                 f" ^ kst_hi[{x+15}] ^ kst_hi[{x+20}];")
    for x in range(5):
        p1, p4 = (x + 1) % 5, (x + 4) % 5
        L.append(f"dl = ((c{p1}l << 1) | (c{p1}h >> 31)) ^ c{p4}l;")
        L.append(f"dh = ((c{p1}h << 1) | (c{p1}l >> 31)) ^ c{p4}h;")
        for i in range(x, 25, 5):
            L.append(f"kst_lo[{i}] = kst_lo[{i}] ^ dl;")
            L.append(f"kst_hi[{i}] = kst_hi[{i}] ^ dh;")
    # rho + pi into tmp, constant rotations
    for i in range(25):
        n, d = _ROT[i], _PI[i]
        if n == 0:
            L.append(f"ktmp_lo[{d}] = kst_lo[{i}];")
            L.append(f"ktmp_hi[{d}] = kst_hi[{i}];")
        elif n < 32:
            L.append(f"ktmp_lo[{d}] = (kst_lo[{i}] << {n})"
                     f" | (kst_hi[{i}] >> {32 - n});")
            L.append(f"ktmp_hi[{d}] = (kst_hi[{i}] << {n})"
                     f" | (kst_lo[{i}] >> {32 - n});")
        elif n == 32:
            L.append(f"ktmp_lo[{d}] = kst_hi[{i}];")
            L.append(f"ktmp_hi[{d}] = kst_lo[{i}];")
        else:
            m = n - 32
            L.append(f"ktmp_lo[{d}] = (kst_hi[{i}] << {m})"
                     f" | (kst_lo[{i}] >> {32 - m});")
            L.append(f"ktmp_hi[{d}] = (kst_lo[{i}] << {m})"
                     f" | (kst_hi[{i}] >> {32 - m});")
    # chi, constant indices
    for x in range(0, 25, 5):
        for i in range(5):
            a, b, c = x + i, x + (i + 1) % 5, x + (i + 2) % 5
            L.append(f"kst_lo[{a}] = ktmp_lo[{a}]"
                     f" ^ (~ktmp_lo[{b}] & ktmp_lo[{c}]);")
            L.append(f"kst_hi[{a}] = ktmp_hi[{a}]"
                     f" ^ (~ktmp_hi[{b}] & ktmp_hi[{c}]);")
    return "\n        ".join(L)


def keccak_c_source() -> str:
    rc_lo = ", ".join(str(rc & 0xFFFFFFFF) for rc in _RC)
    rc_hi = ", ".join(str(rc >> 32) for rc in _RC)
    return r"""
unsigned kst_lo[25];
unsigned kst_hi[25];
unsigned ktmp_lo[25];
unsigned ktmp_hi[25];
unsigned krc_lo[24] = {""" + rc_lo + r"""};
unsigned krc_hi[24] = {""" + rc_hi + r"""};

void keccakf(void) {
    int round;
    unsigned c0l; unsigned c1l; unsigned c2l; unsigned c3l; unsigned c4l;
    unsigned c0h; unsigned c1h; unsigned c2h; unsigned c3h; unsigned c4h;
    unsigned dl;
    unsigned dh;
    for (round = 0; round < 24; round++) {
        """ + _round_body() + r"""
        kst_lo[0] = kst_lo[0] ^ krc_lo[round];
        kst_hi[0] = kst_hi[0] ^ krc_hi[round];
    }
}

/* keccak256 (Ethereum padding 0x01), rate 136 bytes; out = 32 bytes */
void keccak256(unsigned char *data, unsigned len, unsigned char *out) {
    int i;
    unsigned pos = 0;
    for (i = 0; i < 25; i++) { kst_lo[i] = 0u; kst_hi[i] = 0u; }
    while (1) {
        unsigned chunk = len - pos;
        if (chunk > 136u) chunk = 136u;
        for (i = 0; (unsigned)i < chunk; i++) {
            unsigned lane = (unsigned)i >> 3;
            unsigned byte = (unsigned)i & 7u;
            unsigned v = (unsigned)data[pos + (unsigned)i];
            if (byte < 4u) kst_lo[lane] = kst_lo[lane] ^ (v << (byte * 8u));
            else kst_hi[lane] = kst_hi[lane] ^ (v << ((byte - 4u) * 8u));
        }
        if (chunk < 136u) {
            unsigned lane = chunk >> 3;
            unsigned byte = chunk & 7u;
            if (byte < 4u) kst_lo[lane] = kst_lo[lane] ^ (1u << (byte * 8u));
            else kst_hi[lane] = kst_hi[lane] ^ (1u << ((byte - 4u) * 8u));
            kst_hi[16] = kst_hi[16] ^ 0x80000000u;   /* byte 135 high bit */
            keccakf();
            break;
        }
        keccakf();
        pos += 136u;
        if (pos > len) break;
    }
    for (i = 0; i < 32; i++) {
        unsigned lane = (unsigned)i >> 3;
        unsigned byte = (unsigned)i & 7u;
        unsigned w;
        if (byte < 4u) w = kst_lo[lane]; else w = kst_hi[lane];
        out[i] = (unsigned char)((w >> (((unsigned)i & 3u) * 8u)) & 0xffu);
    }
}
"""


def keccak256_ref(data: bytes) -> bytes:
    """Host-side Keccak-256 (Ethereum padding) for differential tests."""
    rot = _ROT
    pi = _PI
    st = [0] * 25

    def f():
        for _ in range(1):
            pass
        for rnd in range(24):
            c = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20]
                 for x in range(5)]
            for x in range(5):
                d = ((c[(x + 1) % 5] << 1 | c[(x + 1) % 5] >> 63)
                     & 0xFFFFFFFFFFFFFFFF) ^ c[(x + 4) % 5]
                for i in range(x, 25, 5):
                    st[i] ^= d
            tmp = [0] * 25
            for i in range(25):
                n = rot[i]
                v = st[i]
                tmp[pi[i]] = ((v << n) | (v >> (64 - n))) \
                    & 0xFFFFFFFFFFFFFFFF if n else v
            for x in range(0, 25, 5):
                for i in range(5):
                    st[x + i] = tmp[x + i] ^ (
                        (~tmp[x + (i + 1) % 5]) & tmp[x + (i + 2) % 5]
                        & 0xFFFFFFFFFFFFFFFF)
            st[0] ^= _RC[rnd]

    pos = 0
    while True:
        chunk = data[pos : pos + 136]
        for i, b in enumerate(chunk):
            st[i >> 3] ^= b << (8 * (i & 7))
        if len(chunk) < 136:
            st[len(chunk) >> 3] ^= 0x01 << (8 * (len(chunk) & 7))
            st[16] ^= 0x80 << 56
            f()
            break
        f()
        pos += 136
        if pos > len(data):
            break
    out = b""
    for i in range(4):
        out += st[i].to_bytes(8, "little")
    return out
