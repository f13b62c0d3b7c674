"""EVM bytecode interpreter as a C guest on the RV32 machine.

The reference proves general EVM execution by compiling revm into the
RISC-V guest (zkvm/program/evm/src/lib.rs — revm + keccak in-guest).
This is that capability natively: a 256-bit-word EVM interpreter written
in C, compiled by the in-repo C compiler (zkvm/cc.py) to RV32IM machine
code, with keccak256 in-guest (guest_keccak.py) for SHA3 and executed
under RAM-image continuations.

Opcodes: STOP ADD MUL SUB DIV SDIV MOD SMOD ADDMOD MULMOD EXP SIGNEXTEND
LT GT SLT SGT EQ ISZERO AND OR XOR NOT BYTE SHL SHR SAR SHA3 CALLVALUE
CALLDATALOAD CALLDATASIZE CALLDATACOPY CODESIZE CODECOPY POP MLOAD
MSTORE SLOAD SSTORE JUMP JUMPI PC MSIZE GAS JUMPDEST PUSH1..32 DUP1..16
SWAP1..16 LOG0..LOG4 RETURN.  Emitted logs (topics + data records) are
serialized into the post-state digest.  256-bit words are u32[8]
little-endian limbs; memory/calldata follow EVM big-endian convention.
DIV/MOD run binary long division (shift-subtract with the 2^256 carry
tracked); MULMOD reduces the full 512-bit schoolbook product; EXP is
bitwise square-and-multiply.

Gas accounting (EIP-150/160-shaped; documented simplifications): base
costs per opcode, EXP 10 + 50/exponent-byte, SHA3 30 + 6/word, memory
expansion 3w + w^2/512 over the high-water word count, SLOAD flat 100
(all slots treated warm), SSTORE 20000 zero->nonzero else 5000 with NO
refund counter, and the meter is u32 (transactions past 4.29 gigagas are
out of scope).  Out-of-gas returns rc=3 with the state rolled up like an
error.  JUMPDEST validation is relaxed (any target executes) — noted
divergence.

The guest returns keccak256(final storage || return data || gas_left) in
a0/a1 (boundary publics x10/x11), binding the full post-state AND the
metered cost to the proof; `evm_mirror` is the host-side differential
oracle.

Copy of eigen_zkvm_tpu/zkvm/guest_evm_c.py for the PyTorch port, with
one committed guest: the token contract below (tests/test_cc_evm.py's
mapping-and-storage vector), built by the port's C compiler,
`cc.c_to_elf(token_source())`, and stored gzip-compressed at TOKEN_ELF;
run to its end it returns TOKEN_A0, word 0 of `evm_mirror`'s post-state
digest.  Reading it needs no pycparser: `load_token_elf()`."""
from __future__ import annotations

import gzip
import os

from .guest_keccak import keccak256_ref, keccak_c_source

MAXS = 16          # storage slots
MAXSTACK = 48      # 256-bit stack entries (guest RAM budget; EVM's 1024
                   # does not fit the 8 KB image — documented cap)
MAXMEM = 512       # bytes of EVM memory
MAXRET = 64
MAXLOGBUF = 256    # serialized LOG0..LOG4 records

_EVM_C = r"""
unsigned stk[MAXSTACK * 8];
int sp256;
unsigned char emem[MAXMEM];
unsigned char retbuf[MAXRET];
unsigned retlen;
unsigned skey[MAXS * 8];
unsigned sval[MAXS * 8];
int ns;
/* LOG0..LOG4 records: [n_topics u8][topics 32B each][dlen u8][data] */
unsigned char logbuf[MAXLOGBUF];
unsigned loglen;

void w_copy(unsigned *d, unsigned *s) {
    int i;
    for (i = 0; i < 8; i++) d[i] = s[i];
}

void w_zero(unsigned *d) {
    int i;
    for (i = 0; i < 8; i++) d[i] = 0u;
}

int w_eq(unsigned *a, unsigned *b) {
    int i;
    for (i = 0; i < 8; i++) if (a[i] != b[i]) return 0;
    return 1;
}

int w_iszero(unsigned *a) {
    int i;
    for (i = 0; i < 8; i++) if (a[i] != 0u) return 0;
    return 1;
}

void w_add(unsigned *d, unsigned *a, unsigned *b) {
    unsigned c = 0u;
    int i;
    for (i = 0; i < 8; i++) {
        unsigned t = a[i] + c;
        unsigned c1 = t < c ? 1u : 0u;
        unsigned s = t + b[i];
        unsigned c2 = s < t ? 1u : 0u;
        d[i] = s;
        c = c1 | c2;
    }
}

void w_sub(unsigned *d, unsigned *a, unsigned *b) {
    unsigned brw = 0u;
    int i;
    for (i = 0; i < 8; i++) {
        unsigned t = a[i] - b[i];
        unsigned b1 = a[i] < b[i] ? 1u : 0u;
        unsigned s = t - brw;
        unsigned b2 = t < brw ? 1u : 0u;
        d[i] = s;
        brw = b1 | b2;
    }
}

void w_mul(unsigned *d, unsigned *a, unsigned *b) {
    unsigned acc[8];
    int i;
    int j;
    w_zero(acc);
    for (i = 0; i < 8; i++) {
        unsigned carry = 0u;
        for (j = 0; i + j < 8; j++) {
            unsigned lo = a[i] * b[j];
            unsigned hi = __mulhu(a[i], b[j]);
            unsigned t = acc[i + j] + lo;
            unsigned c1 = t < lo ? 1u : 0u;
            unsigned t2 = t + carry;
            unsigned c2 = t2 < carry ? 1u : 0u;
            acc[i + j] = t2;
            carry = hi + c1 + c2;
        }
    }
    w_copy(d, acc);
}

int w_lt(unsigned *a, unsigned *b) {
    int i;
    for (i = 7; i >= 0; i--) {
        if (a[i] < b[i]) return 1;
        if (a[i] > b[i]) return 0;
    }
    return 0;
}

int w_slt(unsigned *a, unsigned *b) {
    /* signed compare = unsigned compare with sign bits flipped */
    unsigned ah = a[7] ^ 0x80000000u;
    unsigned bh = b[7] ^ 0x80000000u;
    int i;
    if (ah < bh) return 1;
    if (ah > bh) return 0;
    for (i = 6; i >= 0; i--) {
        if (a[i] < b[i]) return 1;
        if (a[i] > b[i]) return 0;
    }
    return 0;
}

int w_isneg(unsigned *a) { return (int)(a[7] >> 31); }

void w_neg(unsigned *d, unsigned *a) {
    unsigned c = 1u;
    int i;
    for (i = 0; i < 8; i++) {
        unsigned t = ~a[i] + c;
        c = (c != 0u && t == 0u) ? 1u : 0u;
        d[i] = t;
    }
}

void w_shl1(unsigned *a) {
    int i;
    for (i = 7; i > 0; i--) a[i] = (a[i] << 1) | (a[i - 1] >> 31);
    a[0] = a[0] << 1;
}

/* q = num / b, r = num mod b over nbits bits of `num` (little-endian
   u32 limbs, nbits <= 512); q may be 0 to skip the quotient.  Binary
   shift-subtract; the 2^256 carry out of the remainder shift forces a
   subtraction (r_true = 2r+bit < 2b, so one subtract restores r < b). */
void w_divmod_bits(unsigned *q, unsigned *r, unsigned *num, int nbits,
                   unsigned *b) {
    int i;
    w_zero(r);
    for (i = nbits - 1; i >= 0; i--) {
        unsigned c = r[7] >> 31;
        w_shl1(r);
        r[0] |= (num[i >> 5] >> ((unsigned)i & 31u)) & 1u;
        if (c != 0u || !w_lt(r, b)) {
            w_sub(r, r, b);
            if (q) q[i >> 5] |= 1u << ((unsigned)i & 31u);
        }
    }
}

/* d = a / b, m = a mod b (unsigned); EVM: by-zero -> 0 */
void w_divmod(unsigned *d, unsigned *m, unsigned *a, unsigned *b) {
    unsigned q[8]; unsigned r[8];
    if (w_iszero(b)) { w_zero(d); w_zero(m); return; }
    w_zero(q);
    w_divmod_bits(q, r, a, 256, b);
    w_copy(d, q);
    w_copy(m, r);
}

/* full 512-bit product (16 limbs) */
void w_mul_full(unsigned *d16, unsigned *a, unsigned *b) {
    int i;
    int j;
    for (i = 0; i < 16; i++) d16[i] = 0u;
    for (i = 0; i < 8; i++) {
        unsigned carry = 0u;
        for (j = 0; j < 8; j++) {
            unsigned lo = a[i] * b[j];
            unsigned hi = __mulhu(a[i], b[j]);
            unsigned t = d16[i + j] + lo;
            unsigned c1 = t < lo ? 1u : 0u;
            unsigned t2 = t + carry;
            unsigned c2 = t2 < carry ? 1u : 0u;
            d16[i + j] = t2;
            carry = hi + c1 + c2;
        }
        {
            int k = i + 8;
            unsigned c = carry;
            while (c != 0u && k < 16) {
                unsigned t = d16[k] + c;
                c = t < c ? 1u : 0u;
                d16[k] = t;
                k = k + 1;
            }
        }
    }
}

/* d = a^e mod 2^256, square-and-multiply from the top set bit down */
void w_exp(unsigned *d, unsigned *a, unsigned *e) {
    unsigned acc[8]; unsigned base[8];
    int top = -1;
    int i;
    for (i = 255; i >= 0; i--)
        if ((e[i >> 5] >> ((unsigned)i & 31u)) & 1u) { top = i; break; }
    w_zero(acc); acc[0] = 1u;
    if (top < 0) { w_copy(d, acc); return; }
    w_copy(base, a);
    for (i = 0; i <= top; i++) {
        if ((e[i >> 5] >> ((unsigned)i & 31u)) & 1u) w_mul(acc, acc, base);
        if (i < top) w_mul(base, base, base);
    }
    w_copy(d, acc);
}

/* logical shift by s (s >= 256 -> 0); dir 0 = left, 1 = right */
void w_shift(unsigned *d, unsigned *a, unsigned s, int dir) {
    unsigned tmp[8];
    int ws = (int)(s >> 5);
    unsigned bs = s & 31u;
    int i;
    if (s >= 256u) { w_zero(d); return; }
    if (dir == 0) {
        for (i = 7; i >= 0; i--) {
            unsigned v = 0u;
            if (i - ws >= 0) v = a[i - ws] << bs;
            if (bs != 0u && i - ws - 1 >= 0)
                v |= a[i - ws - 1] >> (32u - bs);
            tmp[i] = v;
        }
    } else {
        for (i = 0; i < 8; i++) {
            unsigned v = 0u;
            if (i + ws < 8) v = a[i + ws] >> bs;
            if (bs != 0u && i + ws + 1 < 8)
                v |= a[i + ws + 1] << (32u - bs);
            tmp[i] = v;
        }
    }
    w_copy(d, tmp);
}

/* EVM big-endian byte j (0 = most significant) of a word */
unsigned w_byte(unsigned *a, int j) {
    int lb = 31 - j;
    return (a[lb >> 2] >> (((unsigned)lb & 3u) * 8u)) & 0xffu;
}

void w_setbyte(unsigned *a, int j, unsigned v) {
    int lb = 31 - j;
    unsigned sh = ((unsigned)lb & 3u) * 8u;
    a[lb >> 2] = (a[lb >> 2] & ~(0xffu << sh)) | ((v & 0xffu) << sh);
}

unsigned *spush(void) {
    unsigned *p = stk + sp256 * 8;
    sp256 = sp256 + 1;
    return p;
}

unsigned *spop(void) {
    sp256 = sp256 - 1;
    return stk + sp256 * 8;
}

unsigned *speek(int d) {
    return stk + (sp256 - 1 - d) * 8;
}

/* ---- gas meter (see module docstring for the documented model) ---- */
unsigned gas;
unsigned memwords;

int use_gas(unsigned c) {
    if (gas < c) return 0;
    gas = gas - c;
    return 1;
}

unsigned memcost(unsigned w) { return 3u * w + (w * w) / 512u; }

int mem_expand(unsigned end_bytes) {
    unsigned w = (end_bytes + 31u) >> 5;
    if (w > memwords) {
        if (!use_gas(memcost(w) - memcost(memwords))) return 0;
        memwords = w;
    }
    return 1;
}

unsigned base_cost(unsigned op) {
    if (op >= 0x60u && op <= 0x9fu) return 3u;     /* PUSH/DUP/SWAP */
    if (op == 0x01u || op == 0x03u || (op >= 0x10u && op <= 0x1du)
        || op == 0x35u || op == 0x51u || op == 0x52u)
        return 3u;                                 /* verylow */
    if (op == 0x02u || (op >= 0x04u && op <= 0x07u) || op == 0x0bu)
        return 5u;                                 /* low */
    if (op == 0x08u || op == 0x09u) return 8u;     /* ADDMOD/MULMOD */
    if (op == 0x0au) return 10u;                   /* EXP base */
    if (op == 0x20u) return 30u;                   /* SHA3 base */
    if (op == 0x34u || op == 0x50u || op == 0x36u || op == 0x38u
        || op == 0x58u || op == 0x59u || op == 0x5au)
        return 2u;     /* CALLVALUE/POP/CDSIZE/CODESIZE/PC/MSIZE/GAS */
    if (op == 0x37u || op == 0x39u) return 3u;     /* *COPY base */
    if (op == 0x54u) return 100u;                  /* SLOAD (warm) */
    if (op == 0x56u) return 8u;                    /* JUMP */
    if (op == 0x57u) return 10u;                   /* JUMPI */
    if (op == 0x5bu) return 1u;                    /* JUMPDEST */
    return 0u;                      /* STOP/SSTORE/RETURN: dynamic/free */
}

/* run code; returns 0 = STOP, 1 = RETURN, 2 = error, 3 = out of gas */
int evm_run(unsigned char *code, unsigned codelen,
            unsigned char *calldata, unsigned cdlen,
            unsigned *callvalue) {
    unsigned pc = 0;
    sp256 = 0;
    retlen = 0;
    memwords = 0;
    loglen = 0;
    while (pc < codelen) {
        unsigned op = (unsigned)code[pc];
        pc = pc + 1;
        if (!use_gas(base_cost(op))) return 3;
        if (op == 0x00u) return 0;                 /* STOP */
        else if (op == 0x01u) {                    /* ADD */
            unsigned *b = spop(); unsigned *a = speek(0);
            w_add(a, a, b);
        } else if (op == 0x02u) {                  /* MUL */
            unsigned *b = spop(); unsigned *a = speek(0);
            w_mul(a, a, b);
        } else if (op == 0x03u) {                  /* SUB: top - next */
            unsigned *b = spop(); unsigned *a = speek(0);
            w_sub(a, b, a);
        } else if (op == 0x04u) {                  /* DIV: top / next */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned m[8];
            w_divmod(a, m, b, a);
        } else if (op == 0x05u) {                  /* SDIV (trunc) */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned na[8]; unsigned nb[8]; unsigned m[8];
            int sa = w_isneg(b);
            int sb = w_isneg(a);
            if (sa) w_neg(na, b); else w_copy(na, b);
            if (sb) w_neg(nb, a); else w_copy(nb, a);
            w_divmod(a, m, na, nb);
            if (sa != sb && !w_iszero(a)) w_neg(a, a);
            else if (sa != sb) w_zero(a);
        } else if (op == 0x06u) {                  /* MOD */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned q[8];
            w_divmod(q, a, b, a);
        } else if (op == 0x07u) {                  /* SMOD: sign of top */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned na[8]; unsigned nb[8]; unsigned q[8];
            int sa = w_isneg(b);
            if (sa) w_neg(na, b); else w_copy(na, b);
            if (w_isneg(a)) w_neg(nb, a); else w_copy(nb, a);
            w_divmod(q, a, na, nb);
            if (sa && !w_iszero(a)) w_neg(a, a);
        } else if (op == 0x08u || op == 0x09u) {   /* ADDMOD / MULMOD */
            unsigned *b = spop(); unsigned *c = spop();
            unsigned *n = speek(0);
            unsigned wide[16];
            int i;
            if (w_iszero(n)) { w_zero(n); }
            else {
                if (op == 0x08u) {
                    unsigned s[8];
                    unsigned cr = 0u;
                    for (i = 0; i < 8; i++) {
                        unsigned t = b[i] + cr;
                        unsigned c1 = t < cr ? 1u : 0u;
                        unsigned u = t + c[i];
                        unsigned c2 = u < t ? 1u : 0u;
                        s[i] = u;
                        cr = c1 | c2;
                    }
                    for (i = 0; i < 8; i++) wide[i] = s[i];
                    wide[8] = cr;
                    for (i = 9; i < 16; i++) wide[i] = 0u;
                } else {
                    w_mul_full(wide, b, c);
                }
                {
                    unsigned r[8];
                    w_divmod_bits((unsigned *)0, r, wide, 512, n);
                    w_copy(n, r);
                }
            }
        } else if (op == 0x0au) {                  /* EXP: base^exp */
            unsigned *b = spop(); unsigned *e = speek(0);
            unsigned nbytes = 0u;
            int i;
            for (i = 31; i >= 0; i--)
                if (w_byte(e, i) != 0u) { nbytes = (unsigned)(32 - i); break; }
            if (!use_gas(50u * nbytes)) return 3;
            {
                unsigned r[8];
                w_exp(r, b, e);
                w_copy(e, r);
            }
        } else if (op == 0x0bu) {                  /* SIGNEXTEND */
            unsigned *k = spop(); unsigned *x = speek(0);
            int knz = 0;
            int i;
            for (i = 1; i < 8; i++) if (k[i] != 0u) knz = 1;
            if (!knz && k[0] < 31u) {
                unsigned bit = 8u * k[0] + 7u;
                unsigned set = (x[bit >> 5] >> (bit & 31u)) & 1u;
                for (i = (int)bit + 1; i < 256; i++) {
                    unsigned sh = (unsigned)i & 31u;
                    if (set) x[i >> 5] |= 1u << sh;
                    else x[i >> 5] &= ~(1u << sh);
                }
            }
        } else if (op == 0x10u) {                  /* LT: top < next */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned r = (unsigned)w_lt(b, a);
            w_zero(a); a[0] = r;
        } else if (op == 0x11u) {                  /* GT: top > next */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned r = (unsigned)w_lt(a, b);
            w_zero(a); a[0] = r;
        } else if (op == 0x12u) {                  /* SLT: top <s next */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned r = (unsigned)w_slt(b, a);
            w_zero(a); a[0] = r;
        } else if (op == 0x13u) {                  /* SGT: top >s next */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned r = (unsigned)w_slt(a, b);
            w_zero(a); a[0] = r;
        } else if (op == 0x14u) {                  /* EQ */
            unsigned *b = spop(); unsigned *a = speek(0);
            unsigned r = (unsigned)w_eq(a, b);
            w_zero(a); a[0] = r;
        } else if (op == 0x15u) {                  /* ISZERO */
            unsigned *a = speek(0);
            unsigned r = (unsigned)w_iszero(a);
            w_zero(a); a[0] = r;
        } else if (op == 0x16u) {                  /* AND */
            unsigned *b = spop(); unsigned *a = speek(0);
            int i; for (i = 0; i < 8; i++) a[i] = a[i] & b[i];
        } else if (op == 0x17u) {                  /* OR */
            unsigned *b = spop(); unsigned *a = speek(0);
            int i; for (i = 0; i < 8; i++) a[i] = a[i] | b[i];
        } else if (op == 0x18u) {                  /* XOR */
            unsigned *b = spop(); unsigned *a = speek(0);
            int i; for (i = 0; i < 8; i++) a[i] = a[i] ^ b[i];
        } else if (op == 0x19u) {                  /* NOT */
            unsigned *a = speek(0);
            int i; for (i = 0; i < 8; i++) a[i] = ~a[i];
        } else if (op == 0x1au) {                  /* BYTE: top=index */
            unsigned *i256 = spop(); unsigned *x = speek(0);
            int knz = 0;
            int j;
            unsigned v = 0u;
            for (j = 1; j < 8; j++) if (i256[j] != 0u) knz = 1;
            if (!knz && i256[0] < 32u) v = w_byte(x, (int)i256[0]);
            w_zero(x); x[0] = v;
        } else if (op == 0x1bu || op == 0x1cu) {   /* SHL / SHR */
            unsigned *s = spop(); unsigned *x = speek(0);
            int knz = 0;
            int j;
            for (j = 1; j < 8; j++) if (s[j] != 0u) knz = 1;
            if (knz) w_zero(x);
            else w_shift(x, x, s[0], op == 0x1bu ? 0 : 1);
        } else if (op == 0x1du) {                  /* SAR */
            unsigned *s = spop(); unsigned *x = speek(0);
            int neg = w_isneg(x);
            int knz = 0;
            int j;
            for (j = 1; j < 8; j++) if (s[j] != 0u) knz = 1;
            if (knz || s[0] >= 256u) {
                if (neg) { for (j = 0; j < 8; j++) x[j] = 0xffffffffu; }
                else w_zero(x);
            } else {
                unsigned sh = s[0];
                w_shift(x, x, sh, 1);
                if (neg && sh != 0u) {
                    /* fill the vacated top sh bits with ones */
                    for (j = 255; j >= 256 - (int)sh; j--)
                        x[j >> 5] |= 1u << ((unsigned)j & 31u);
                }
            }
        } else if (op == 0x20u) {                  /* SHA3 */
            unsigned *o = spop(); unsigned *l = speek(0);
            unsigned off = o[0]; unsigned len = l[0];
            unsigned char dig[32];
            if (off > (unsigned)MAXMEM || len > (unsigned)MAXMEM
                || off + len > (unsigned)MAXMEM) return 2;
            if (!use_gas(6u * ((len + 31u) >> 5))) return 3;
            if (!mem_expand(off + len)) return 3;
            keccak256(emem + off, len, dig);
            w_zero(l);
            { int j; for (j = 0; j < 32; j++)
                  w_setbyte(l, j, (unsigned)dig[j]); }
        } else if (op == 0x34u) {                  /* CALLVALUE */
            w_copy(spush(), callvalue);
        } else if (op == 0x35u) {                  /* CALLDATALOAD */
            unsigned *a = speek(0);
            unsigned off = a[0];
            int j;
            w_zero(a);
            for (j = 0; j < 32; j++) {
                unsigned v = 0u;
                if (off + (unsigned)j < cdlen)
                    v = (unsigned)calldata[off + (unsigned)j];
                w_setbyte(a, j, v);
            }
        } else if (op == 0x36u) {                  /* CALLDATASIZE */
            unsigned *a = spush();
            w_zero(a); a[0] = cdlen;
        } else if (op == 0x37u || op == 0x39u) {   /* CALLDATACOPY/CODECOPY */
            unsigned *d = spop(); unsigned *o = spop(); unsigned *l = spop();
            unsigned dst = d[0]; unsigned off = o[0]; unsigned len = l[0];
            unsigned char *src = op == 0x37u ? calldata : code;
            unsigned srclen = op == 0x37u ? cdlen : codelen;
            unsigned j;
            if (dst > (unsigned)MAXMEM || len > (unsigned)MAXMEM
                || dst + len > (unsigned)MAXMEM) return 2;
            if (!use_gas(3u * ((len + 31u) >> 5))) return 3;
            if (!mem_expand(dst + len)) return 3;
            for (j = 0; j < len; j++)
                emem[dst + j] = off + j < srclen ? src[off + j]
                                                 : (unsigned char)0;
        } else if (op == 0x38u) {                  /* CODESIZE */
            unsigned *a = spush();
            w_zero(a); a[0] = codelen;
        } else if (op == 0x50u) {                  /* POP */
            spop();
        } else if (op == 0x51u) {                  /* MLOAD */
            unsigned *a = speek(0);
            unsigned off = a[0];
            int j;
            if (off > (unsigned)MAXMEM - 32u) return 2;
            if (!mem_expand(off + 32u)) return 3;
            w_zero(a);
            for (j = 0; j < 32; j++)
                w_setbyte(a, j, (unsigned)emem[off + (unsigned)j]);
        } else if (op == 0x52u) {                  /* MSTORE */
            unsigned *o = spop(); unsigned *v = spop();
            unsigned off = o[0];
            int j;
            if (off > (unsigned)MAXMEM - 32u) return 2;
            if (!mem_expand(off + 32u)) return 3;
            for (j = 0; j < 32; j++)
                emem[off + (unsigned)j] = (unsigned char)w_byte(v, j);
        } else if (op == 0x54u) {                  /* SLOAD */
            unsigned *a = speek(0);
            int i;
            int hit = 0;
            for (i = 0; i < ns; i++) {
                if (w_eq(skey + i * 8, a)) {
                    w_copy(a, sval + i * 8);
                    hit = 1;
                    break;
                }
            }
            if (!hit) w_zero(a);
        } else if (op == 0x55u) {                  /* SSTORE */
            unsigned *k = spop(); unsigned *v = spop();
            int i;
            int hit = -1;
            int curzero = 1;
            for (i = 0; i < ns; i++) {
                if (w_eq(skey + i * 8, k)) {
                    hit = i;
                    curzero = w_iszero(sval + i * 8);
                    break;
                }
            }
            if (!use_gas((curzero && !w_iszero(v)) ? 20000u : 5000u))
                return 3;
            if (hit >= 0) {
                w_copy(sval + hit * 8, v);
            } else {
                if (ns >= MAXS) return 2;
                w_copy(skey + ns * 8, k);
                w_copy(sval + ns * 8, v);
                ns = ns + 1;
            }
        } else if (op == 0x56u) {                  /* JUMP */
            unsigned *a = spop();
            pc = a[0];
        } else if (op == 0x57u) {                  /* JUMPI */
            unsigned *t = spop(); unsigned *c = spop();
            if (!w_iszero(c)) pc = t[0];
        } else if (op == 0x58u) {                  /* PC (of this op) */
            unsigned *a = spush();
            w_zero(a); a[0] = pc - 1u;
        } else if (op == 0x59u) {                  /* MSIZE */
            unsigned *a = spush();
            w_zero(a); a[0] = memwords * 32u;
        } else if (op == 0x5au) {                  /* GAS (post-charge) */
            unsigned *a = spush();
            w_zero(a); a[0] = gas;
        } else if (op == 0x5bu) {                  /* JUMPDEST */
        } else if (op >= 0x60u && op <= 0x7fu) {   /* PUSH1..32 */
            unsigned n = op - 0x5fu;
            unsigned *a = spush();
            unsigned j;
            w_zero(a);
            for (j = 0; j < n; j++)
                w_setbyte(a, (int)(32u - n + j), (unsigned)code[pc + j]);
            pc = pc + n;
        } else if (op >= 0x80u && op <= 0x8fu) {   /* DUP1..16 */
            unsigned d = op - 0x80u;
            unsigned *src = speek((int)d);
            w_copy(spush(), src);
        } else if (op >= 0x90u && op <= 0x9fu) {   /* SWAP1..16 */
            unsigned d = op - 0x8fu;
            unsigned *a = speek(0);
            unsigned *b = speek((int)d);
            unsigned t;
            int i;
            for (i = 0; i < 8; i++) { t = a[i]; a[i] = b[i]; b[i] = t; }
        } else if (op >= 0xa0u && op <= 0xa4u) {   /* LOG0..LOG4 */
            unsigned nt = op - 0xa0u;
            unsigned *o = spop(); unsigned *l = spop();
            unsigned off = o[0]; unsigned len = l[0];
            unsigned j;
            unsigned t;
            if (off > (unsigned)MAXMEM || len > (unsigned)MAXMEM
                || off + len > (unsigned)MAXMEM || len > 255u) return 2;
            if (!use_gas(375u + 375u * nt + 8u * len)) return 3;
            if (!mem_expand(off + len)) return 3;
            if (loglen + 2u + nt * 32u + len > (unsigned)MAXLOGBUF)
                return 2;
            logbuf[loglen] = (unsigned char)nt; loglen = loglen + 1u;
            for (t = 0; t < nt; t++) {
                unsigned *tp = spop();
                for (j = 0; j < 32; j++) {
                    logbuf[loglen] = (unsigned char)w_byte(tp, (int)j);
                    loglen = loglen + 1u;
                }
            }
            logbuf[loglen] = (unsigned char)len; loglen = loglen + 1u;
            for (j = 0; j < len; j++) {
                logbuf[loglen] = emem[off + j]; loglen = loglen + 1u;
            }
        } else if (op == 0xf3u) {                  /* RETURN */
            unsigned *o = spop(); unsigned *l = spop();
            unsigned off = o[0]; unsigned len = l[0];
            unsigned j;
            if (off > (unsigned)MAXMEM || len > (unsigned)MAXMEM
                || off + len > (unsigned)MAXMEM) return 2;
            if (!mem_expand(off + len)) return 3;
            if (len > (unsigned)MAXRET) len = (unsigned)MAXRET;
            retlen = len;
            for (j = 0; j < len; j++) retbuf[j] = emem[off + j];
            return 1;
        } else {
            return 2;                              /* unsupported */
        }
    }
    return 0;
}

/* serialize (ns, key/val pairs, return data) and hash it: the post-state
   commitment the proof's boundary publics carry */
unsigned char acc_buf[MAXS * 64 + MAXRET + MAXLOGBUF + 14];
unsigned char out_dig[32];

unsigned post_state_digest(void) {
    unsigned pos = 0;
    int i;
    int j;
    acc_buf[pos] = (unsigned char)ns; pos = pos + 1;
    for (i = 0; i < ns; i++) {
        for (j = 0; j < 32; j++) {
            acc_buf[pos] = (unsigned char)w_byte(skey + i * 8, j);
            pos = pos + 1;
        }
        for (j = 0; j < 32; j++) {
            acc_buf[pos] = (unsigned char)w_byte(sval + i * 8, j);
            pos = pos + 1;
        }
    }
    acc_buf[pos] = (unsigned char)retlen; pos = pos + 1;
    for (j = 0; (unsigned)j < retlen; j++) {
        acc_buf[pos] = retbuf[j]; pos = pos + 1;
    }
    /* emitted logs (2-byte LE length + records) */
    acc_buf[pos] = (unsigned char)(loglen & 0xffu); pos = pos + 1;
    acc_buf[pos] = (unsigned char)(loglen >> 8); pos = pos + 1;
    for (j = 0; (unsigned)j < loglen; j++) {
        acc_buf[pos] = logbuf[j]; pos = pos + 1;
    }
    for (j = 0; j < 4; j++) {      /* remaining gas, little-endian */
        acc_buf[pos] = (unsigned char)((gas >> (8u * (unsigned)j)) & 0xffu);
        pos = pos + 1;
    }
    keccak256(acc_buf, pos, out_dig);
    return ((unsigned)out_dig[0] | ((unsigned)out_dig[1] << 8)
          | ((unsigned)out_dig[2] << 16) | ((unsigned)out_dig[3] << 24));
}
"""


def build_guest_source(code: bytes, calldata: bytes, callvalue: int,
                       storage: dict[int, int] | None = None,
                       gas_limit: int = 30_000_000) -> str:
    """Emit the full C guest: interpreter + this transaction's inputs as
    initialized globals + main() that runs and returns the post-state
    digest words in a0/a1."""
    storage = storage or {}

    def arr(name, data: bytes, ctype="unsigned char"):
        if not data:
            return f"{ctype} {name}[1] = {{0}};\n"
        vals = ", ".join(str(b) for b in data)
        return f"{ctype} {name}[{len(data)}] = {{{vals}}};\n"

    cv_limbs = [(callvalue >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    init_kv = b""
    src = _EVM_C.replace("MAXSTACK", str(MAXSTACK)) \
                .replace("MAXLOGBUF", str(MAXLOGBUF)) \
                .replace("MAXMEM", str(MAXMEM)) \
                .replace("MAXRET", str(MAXRET)) \
                .replace("MAXS", str(MAXS))
    pre = (f"#define NSINIT {len(storage)}\n"
           + arr("g_code", code)
           + arr("g_calldata", calldata))
    pre += ("unsigned g_callvalue[8] = {"
            + ", ".join(f"{v}u" for v in cv_limbs) + "};\n")
    kinit, vinit = [], []
    for k, v in storage.items():
        kinit += [(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        vinit += [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    if storage:
        pre += ("unsigned g_skey[" + str(len(kinit)) + "] = {"
                + ", ".join(f"{v}u" for v in kinit) + "};\n")
        pre += ("unsigned g_sval[" + str(len(vinit)) + "] = {"
                + ", ".join(f"{v}u" for v in vinit) + "};\n")
    else:
        pre += "unsigned g_skey[8] = {0};\nunsigned g_sval[8] = {0};\n"
    main = f"""
int main() {{
    int i;
    ns = NSINIT;
    gas = {gas_limit}u;
    for (i = 0; i < NSINIT * 8; i++) {{
        skey[i] = g_skey[i];
        sval[i] = g_sval[i];
    }}
    int rc = evm_run(g_code, {len(code)}u, g_calldata,
                     {len(calldata)}u, g_callvalue);
    if (rc == 2 || rc == 3) return 0;
    return (int)post_state_digest();
}}
"""
    return pre + keccak_c_source() + src + main


def _base_cost(op: int) -> int:
    if 0x60 <= op <= 0x9F:
        return 3
    if op in (0x01, 0x03, 0x35, 0x37, 0x39, 0x51, 0x52) \
            or 0x10 <= op <= 0x1D:
        return 3
    if op in (0x02, 0x04, 0x05, 0x06, 0x07, 0x0B):
        return 5
    if op in (0x08, 0x09):
        return 8
    return {0x0A: 10, 0x20: 30, 0x34: 2, 0x36: 2, 0x38: 2, 0x50: 2,
            0x54: 100, 0x56: 8, 0x57: 10, 0x58: 2, 0x59: 2, 0x5A: 2,
            0x5B: 1}.get(op, 0)


def evm_mirror(code: bytes, calldata: bytes, callvalue: int,
               storage: dict[int, int] | None = None,
               gas_limit: int = 30_000_000):
    """Host-side differential oracle: same opcode semantics AND the same
    gas model as the C guest, pure Python.  Returns
    (rc, storage_pairs ordered, retdata, digest bytes, gas_left)."""
    M = (1 << 256) - 1
    SIGN = 1 << 255

    def s2c(v):  # unsigned word -> signed
        return v - (1 << 256) if v & SIGN else v

    stk: list[int] = []
    mem = bytearray(MAXMEM)
    skey: list[int] = []
    sval: list[int] = []
    for k, v in (storage or {}).items():
        skey.append(k)
        sval.append(v)
    ret = b""
    logblob = b""
    pc = 0
    rc = 0
    gas = gas_limit
    memwords = 0

    def memcost(w):
        return 3 * w + w * w // 512

    def use(c):
        nonlocal gas
        if gas < c:
            return False
        gas -= c
        return True

    def expand(end):
        nonlocal memwords
        w = (end + 31) >> 5
        if w > memwords:
            if not use(memcost(w) - memcost(memwords)):
                return False
            memwords = w
        return True

    while pc < len(code):
        op = code[pc]
        pc += 1
        if not use(_base_cost(op)):
            rc = 3
            break
        if op == 0x00:
            rc = 0
            break
        elif op == 0x01:
            b, a = stk.pop(), stk.pop()
            stk.append((a + b) & M)
        elif op == 0x02:
            b, a = stk.pop(), stk.pop()
            stk.append((a * b) & M)
        elif op == 0x03:   # SUB: top - next
            b, a = stk.pop(), stk.pop()
            stk.append((b - a) & M)
        elif op == 0x04:   # DIV: top / next
            b, a = stk.pop(), stk.pop()
            stk.append(b // a if a else 0)
        elif op == 0x05:   # SDIV (truncated)
            b, a = stk.pop(), stk.pop()
            sa, sb = s2c(b), s2c(a)
            if sb == 0:
                stk.append(0)
            else:
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                stk.append(q & M)
        elif op == 0x06:   # MOD
            b, a = stk.pop(), stk.pop()
            stk.append(b % a if a else 0)
        elif op == 0x07:   # SMOD (sign of dividend)
            b, a = stk.pop(), stk.pop()
            sa, sb = s2c(b), s2c(a)
            if sb == 0:
                stk.append(0)
            else:
                r = abs(sa) % abs(sb)
                if sa < 0:
                    r = -r
                stk.append(r & M)
        elif op == 0x08:   # ADDMOD
            b, c, n = stk.pop(), stk.pop(), stk.pop()
            stk.append((b + c) % n if n else 0)
        elif op == 0x09:   # MULMOD
            b, c, n = stk.pop(), stk.pop(), stk.pop()
            stk.append((b * c) % n if n else 0)
        elif op == 0x0A:   # EXP
            b, e = stk.pop(), stk.pop()
            nbytes = (e.bit_length() + 7) // 8
            if not use(50 * nbytes):
                rc = 3
                break
            stk.append(pow(b, e, 1 << 256))
        elif op == 0x0B:   # SIGNEXTEND
            k, x = stk.pop(), stk.pop()
            if k < 31:
                bit = 8 * k + 7
                if (x >> bit) & 1:
                    x |= M ^ ((1 << (bit + 1)) - 1)
                else:
                    x &= (1 << (bit + 1)) - 1
            stk.append(x)
        elif op == 0x10:   # LT: top < next
            b, a = stk.pop(), stk.pop()
            stk.append(1 if b < a else 0)
        elif op == 0x11:   # GT: top > next
            b, a = stk.pop(), stk.pop()
            stk.append(1 if b > a else 0)
        elif op == 0x12:   # SLT
            b, a = stk.pop(), stk.pop()
            stk.append(1 if s2c(b) < s2c(a) else 0)
        elif op == 0x13:   # SGT
            b, a = stk.pop(), stk.pop()
            stk.append(1 if s2c(b) > s2c(a) else 0)
        elif op == 0x14:
            b, a = stk.pop(), stk.pop()
            stk.append(1 if a == b else 0)
        elif op == 0x15:
            stk.append(1 if stk.pop() == 0 else 0)
        elif op == 0x16:
            b, a = stk.pop(), stk.pop()
            stk.append(a & b)
        elif op == 0x17:
            b, a = stk.pop(), stk.pop()
            stk.append(a | b)
        elif op == 0x18:
            b, a = stk.pop(), stk.pop()
            stk.append(a ^ b)
        elif op == 0x19:
            stk.append(stk.pop() ^ M)
        elif op == 0x1A:   # BYTE (top = index, 0 = MSB)
            i, x = stk.pop(), stk.pop()
            stk.append((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
        elif op == 0x1B:   # SHL
            s, x = stk.pop(), stk.pop()
            stk.append((x << s) & M if s < 256 else 0)
        elif op == 0x1C:   # SHR
            s, x = stk.pop(), stk.pop()
            stk.append(x >> s if s < 256 else 0)
        elif op == 0x1D:   # SAR
            s, x = stk.pop(), stk.pop()
            stk.append((s2c(x) >> min(s, 255)) & M if s < 256
                       else (M if x & SIGN else 0))
        elif op == 0x20:
            off, ln = stk.pop(), stk.pop()
            if off + ln > MAXMEM:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not use(6 * ((ln + 31) >> 5)) or not expand(off + ln):
                rc = 3
                break
            stk.append(int.from_bytes(
                keccak256_ref(bytes(mem[off : off + ln])), "big"))
        elif op == 0x34:
            stk.append(callvalue)
        elif op == 0x35:
            off = stk.pop()
            blob = calldata[off : off + 32].ljust(32, b"\x00")
            stk.append(int.from_bytes(blob, "big"))
        elif op == 0x36:
            stk.append(len(calldata))
        elif op in (0x37, 0x39):   # CALLDATACOPY / CODECOPY
            dst, off, ln = stk.pop(), stk.pop(), stk.pop()
            src = calldata if op == 0x37 else code
            if dst + ln > MAXMEM:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not use(3 * ((ln + 31) >> 5)) or not expand(dst + ln):
                rc = 3
                break
            blob = src[off : off + ln].ljust(ln, b"\x00")
            mem[dst : dst + ln] = blob
        elif op == 0x38:
            stk.append(len(code))
        elif op == 0x50:
            stk.pop()
        elif op == 0x51:
            off = stk.pop()
            if off > MAXMEM - 32:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not expand(off + 32):
                rc = 3
                break
            stk.append(int.from_bytes(mem[off : off + 32], "big"))
        elif op == 0x52:
            off, v = stk.pop(), stk.pop()
            if off > MAXMEM - 32:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not expand(off + 32):
                rc = 3
                break
            mem[off : off + 32] = v.to_bytes(32, "big")
        elif op == 0x54:
            k = stk.pop()
            stk.append(sval[skey.index(k)] if k in skey else 0)
        elif op == 0x55:
            k, v = stk.pop(), stk.pop()
            cur = sval[skey.index(k)] if k in skey else 0
            if not use(20000 if (cur == 0 and v != 0) else 5000):
                rc = 3
                break
            if k in skey:
                sval[skey.index(k)] = v
            else:
                skey.append(k)
                sval.append(v)
        elif op == 0x56:
            pc = stk.pop()
        elif op == 0x57:
            t, c = stk.pop(), stk.pop()
            if c:
                pc = t
        elif op == 0x58:
            stk.append(pc - 1)
        elif op == 0x59:
            stk.append(memwords * 32)
        elif op == 0x5A:
            stk.append(gas)
        elif op == 0x5B:
            pass
        elif 0x60 <= op <= 0x7F:
            n = op - 0x5F
            stk.append(int.from_bytes(code[pc : pc + n], "big"))
            pc += n
        elif 0x80 <= op <= 0x8F:
            stk.append(stk[-(op - 0x80 + 1)])
        elif 0x90 <= op <= 0x9F:
            d = op - 0x8F
            stk[-1], stk[-1 - d] = stk[-1 - d], stk[-1]
        elif 0xA0 <= op <= 0xA4:   # LOG0..LOG4
            nt = op - 0xA0
            off, ln = stk.pop(), stk.pop()
            if off + ln > MAXMEM or ln > 255:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not use(375 + 375 * nt + 8 * ln):
                rc = 3
                break
            if not expand(off + ln):
                rc = 3
                break
            rec = bytes([nt])
            for _ in range(nt):
                rec += stk.pop().to_bytes(32, "big")
            rec += bytes([ln]) + bytes(mem[off : off + ln])
            if len(logblob) + len(rec) > MAXLOGBUF:
                return 2, list(zip(skey, sval)), b"", b"", gas
            logblob += rec
        elif op == 0xF3:
            off, ln = stk.pop(), stk.pop()
            if off + ln > MAXMEM:
                return 2, list(zip(skey, sval)), b"", b"", gas
            if not expand(off + ln):
                rc = 3
                break
            ln = min(ln, MAXRET)
            ret = bytes(mem[off : off + ln])
            rc = 1
            break
        else:
            return 2, list(zip(skey, sval)), b"", b"", gas
    if rc in (2, 3):
        return rc, list(zip(skey, sval)), b"", b"", gas
    blob = bytes([len(skey)])
    for k, v in zip(skey, sval):
        blob += k.to_bytes(32, "big") + v.to_bytes(32, "big")
    blob += bytes([len(ret)]) + ret
    blob += len(logblob).to_bytes(2, "little") + logblob
    blob += gas.to_bytes(4, "little")
    return rc, list(zip(skey, sval)), ret, keccak256_ref(blob), gas


# The committed guest: slot = keccak256(K || 0); balances[slot] += A;
# counter at slot 1 += 1; slot 7 = A / 3, slot 8 = A >> 5, slot 9 =
# sar(NOT A, 3); RETURN mem[0:32] (PUSH/DUP/SWAP/MSTORE/SHA3/SLOAD/SSTORE/
# ADD/DIV/SHR/SAR/NOT/RETURN), with K = 0xDEADBEEF, A = 12345 as calldata,
# no call value and slot 1 = 41 before the call.
TOKEN_CODE = bytes.fromhex(
    "600035" "600052" "6000602052" "6040600020"
    "8054" "602035" "01" "90" "55"
    "600154" "600101" "600155"
    "6003" "602035" "04" "600755"
    "602035" "6005" "1c" "600855"
    "602035" "19" "6003" "1d" "600955"
    "60206000f3")
TOKEN_CALLDATA = (0xDEADBEEF).to_bytes(32, "big") + (12345).to_bytes(32, "big")
TOKEN_CALLVALUE = 0
TOKEN_STORAGE = {1: 41}
TOKEN_ELF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "guests", "evm_token.elf.gz")
# int.from_bytes(evm_mirror(TOKEN_CODE, ...)[3][:4], "little")
TOKEN_A0 = 468375785


def token_source() -> str:
    """The committed token guest's C source."""
    return build_guest_source(TOKEN_CODE, TOKEN_CALLDATA, TOKEN_CALLVALUE,
                              TOKEN_STORAGE)


def load_token_elf() -> bytes:
    """The committed token guest's ELF bytes."""
    with open(TOKEN_ELF, "rb") as f:
        return gzip.decompress(f.read())
