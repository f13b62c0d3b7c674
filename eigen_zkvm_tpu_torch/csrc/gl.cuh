// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on native uint64_t for
// the port's CUDA kernels.
//
// The kernels are bound by the number of integer instructions they issue, so
// the primitives here are written for instruction count:
//   - a 64x64 -> 128-bit product is four IMAD.WIDE.U32 with the partial sums
//     riding in the multiply-add's 64-bit addend (mul_wide), a square three
//     (sqr_wide);
//   - the reduction folds a value of up to 160 bits with 2^64 = 2^32 - 1 and
//     2^96 = -1 (mod p) in two carry-flag chains (reduce160), and returns a
//     value that is only below 2^64, not below p ("non-canonical"), or, for
//     three instructions more, the canonical one;
//   - a dot product accumulates its 128-bit products in three words and is
//     reduced once (Acc);
//   - a product by 2^k is a shift and one reduction (mul_pow2): 2 has order
//     192, so the inner twiddles of a radix-8 or -16 butterfly are such
//     powers.
// Every primitive says which operands may be non-canonical.  `canon` brings a
// value below p; results that leave a kernel are canonical, so every
// implementation (ops/gl.py, the plain PyTorch twin of each primitive here,
// and the JAX package) agrees bit for bit.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

struct U128 {
  uint64_t lo, hi;
};

__device__ __forceinline__ uint32_t lo32(uint64_t a) { return (uint32_t)a; }
__device__ __forceinline__ uint32_t hi32(uint64_t a) {
  return (uint32_t)(a >> 32);
}
__device__ __forceinline__ uint64_t pack(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// any u64 -> its canonical value
__device__ __forceinline__ uint64_t canon(uint64_t a) {
  return a >= P ? a - P : a;
}

// a - b mod p; a any u64, b canonical; canonical when a is.  The borrow
// adds 2^64 = EPS (mod p), taken off again through the carry flag.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 m;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 m, 0, 0;\n\t"          // 0xFFFFFFFF on a borrow, else 0
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return pack(r0, r1);
}

// a + b mod p for canonical a and b, canonical: a - (p - b), and p - 0 = p
// is taken off like any other value.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 m, n0, n1;\n\t"
      "sub.cc.u32 n0, 1, %4;\n\t"              // p - b
      "subc.u32 n1, 0xFFFFFFFF, %5;\n\t"
      "sub.cc.u32 %0, %2, n0;\n\t"
      "subc.cc.u32 %1, %3, n1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return pack(r0, r1);
}

// p - a for canonical a, canonical
__device__ __forceinline__ uint64_t neg(uint64_t a) {
  return a == 0 ? 0 : P - a;
}

// a + b mod p; a any u64, b canonical; the result is any u64
__device__ __forceinline__ uint64_t add_nc(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 m;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"              // 0xFFFFFFFF on a carry, else 0
      "add.cc.u32 %0, %0, m;\n\t"      // + EPS (never carries again)
      "addc.u32 %1, %1, 0;\n\t}"
      : "=&r"(r0), "=&r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return pack(r0, r1);
}

// The tail of a reduction: r = (r0:r1) + (t0:t1) mod p for any u64 r and
// t < p.  A carry adds 2^64 = EPS (mod p); with CANON the sum is also brought
// below p, which is the same correction (r - p = r + EPS - 2^64) and can
// coincide with the carry's in no case, so one add of EPS serves both.
#define GL_FOLD_NC                                                       \
  "add.cc.u32 %0, %0, t0;\n\t"                                           \
  "addc.cc.u32 %1, %1, t1;\n\t"                                          \
  "addc.u32 m, 0, 0;\n\t"                                                \
  "neg.s32 m, m;\n\t"               /* 0xFFFFFFFF on a carry, else 0 */  \
  "add.cc.u32 %0, %0, m;\n\t"       /* + EPS (never carries again) */    \
  "addc.u32 %1, %1, 0;\n\t"
#define GL_FOLD_CANON                                                    \
  "add.cc.u32 %0, %0, t0;\n\t"                                           \
  "addc.cc.u32 %1, %1, t1;\n\t"                                          \
  "addc.u32 m, 0, 0;\n\t"                                                \
  "add.cc.u32 t0, %0, 0xFFFFFFFF;\n\t"  /* carries iff the sum >= p */   \
  "addc.cc.u32 t1, %1, 0;\n\t"                                           \
  "addc.u32 m, m, 0;\n\t"           /* 1 on either carry, never 2 */     \
  "neg.s32 m, m;\n\t"                                                    \
  "add.cc.u32 %0, %0, m;\n\t"                                            \
  "addc.u32 %1, %1, 0;\n\t"

// (top * 2^128 + hi * 2^64 + lo) mod p; top < 2^32 - 1.  With
// hi = h1 * 2^32 + h0 the value is lo - (top * 2^32 + h1) + h0 * (2^32 - 1).
// The result is any u64, or canonical with CANON.
template <bool CANON = false>
__device__ __forceinline__ uint64_t reduce160(uint64_t lo, uint64_t hi,
                                              uint32_t top) {
  uint32_t r0, r1;
#define GL_REDUCE160_HEAD                                                \
  "{\n\t.reg .u32 m, t0, t1;\n\t"                                        \
  "sub.cc.u32 %0, %2, %5;\n\t"     /* lo - (top:h1) */                   \
  "subc.cc.u32 %1, %3, %6;\n\t"                                          \
  "subc.u32 m, 0, 0;\n\t"                                                \
  "sub.cc.u32 %0, %0, m;\n\t"      /* borrow: - EPS (never again) */     \
  "subc.u32 %1, %1, 0;\n\t"                                              \
  "sub.cc.u32 t0, 0, %4;\n\t"      /* t = h0 * 2^32 - h0 < p */          \
  "subc.u32 t1, %4, 0;\n\t"
  if (CANON)
    asm(GL_REDUCE160_HEAD GL_FOLD_CANON "}"
        : "=&r"(r0), "=&r"(r1)
        : "r"(lo32(lo)), "r"(hi32(lo)), "r"(lo32(hi)), "r"(hi32(hi)),
          "r"(top));
  else
    asm(GL_REDUCE160_HEAD GL_FOLD_NC "}"
        : "=&r"(r0), "=&r"(r1)
        : "r"(lo32(lo)), "r"(hi32(lo)), "r"(lo32(hi)), "r"(hi32(hi)),
          "r"(top));
#undef GL_REDUCE160_HEAD
  return pack(r0, r1);
}

// (h0 * 2^64 + lo) mod p: lo + h0 * (2^32 - 1); any u64, or canonical
template <bool CANON = false>
__device__ __forceinline__ uint64_t reduce96(uint64_t lo, uint32_t h0) {
  uint32_t r0 = lo32(lo), r1 = hi32(lo);
#define GL_REDUCE96_HEAD                                                 \
  "{\n\t.reg .u32 m, t0, t1;\n\t"                                        \
  "sub.cc.u32 t0, 0, %2;\n\t"      /* t = h0 * 2^32 - h0 < p */          \
  "subc.u32 t1, %2, 0;\n\t"
  if (CANON)
    asm(GL_REDUCE96_HEAD GL_FOLD_CANON "}" : "+r"(r0), "+r"(r1) : "r"(h0));
  else
    asm(GL_REDUCE96_HEAD GL_FOLD_NC "}" : "+r"(r0), "+r"(r1) : "r"(h0));
#undef GL_REDUCE96_HEAD
  return pack(r0, r1);
}
#undef GL_FOLD_NC
#undef GL_FOLD_CANON

template <bool CANON = false>
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  return reduce160<CANON>(lo, hi, 0);
}

// the 128-bit product of any two u64: four IMAD.WIDE.U32, each partial sum
// small enough to ride in the next product's 64-bit addend
__device__ __forceinline__ U128 mul_wide(uint64_t a, uint64_t b) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  const uint64_t t = (uint64_t)a0 * b0;
  const uint64_t u = (uint64_t)a0 * b1 + (t >> 32);
  const uint64_t v = (uint64_t)a1 * b0 + (u & EPS);
  const uint64_t w = (uint64_t)a1 * b1 + (u >> 32) + (v >> 32);
  return {pack(lo32(t), lo32(v)), w};
}

// the 128-bit square of any u64: the cross product is taken once
__device__ __forceinline__ U128 sqr_wide(uint64_t a) {
  const uint32_t a0 = lo32(a), a1 = hi32(a);
  const uint64_t t = (uint64_t)a0 * a0;
  const uint64_t c = (uint64_t)a0 * a1;
  const uint64_t u = c + (t >> 32);      // < 2^64: c <= (2^32 - 1)^2
  const uint64_t v = c + (u & EPS);
  const uint64_t w = (uint64_t)a1 * a1 + (u >> 32) + (v >> 32);
  return {pack(lo32(t), lo32(v)), w};
}

// p += c; the caller knows the sum stays below 2^128
__device__ __forceinline__ void add128(U128& p, uint64_t c) {
  asm("add.cc.u64 %0, %0, %2;\n\t"
      "addc.u64 %1, %1, 0;"
      : "+l"(p.lo), "+l"(p.hi)
      : "l"(c));
}

// products of any u64 operands; `_nc` results are any u64
__device__ __forceinline__ uint64_t mul_nc(uint64_t a, uint64_t b) {
  const U128 p = mul_wide(a, b);
  return reduce128(p.lo, p.hi);
}
__device__ __forceinline__ uint64_t sqr_nc(uint64_t a) {
  const U128 p = sqr_wide(a);
  return reduce128(p.lo, p.hi);
}
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const U128 p = mul_wide(a, b);
  return reduce128<true>(p.lo, p.hi);
}
__device__ __forceinline__ uint64_t sqr(uint64_t a) {
  const U128 p = sqr_wide(a);
  return reduce128<true>(p.lo, p.hi);
}

// a^7 + c as any u64, for any u64 a and c: two squares and two products,
// the addend folded into the last product before its reduction
__device__ __forceinline__ uint64_t pow7_add_nc(uint64_t a, uint64_t c) {
  const uint64_t a2 = sqr_nc(a);
  const uint64_t a3 = mul_nc(a2, a);
  const uint64_t a6 = sqr_nc(a3);
  U128 p = mul_wide(a6, a);             // <= (2^64 - 1)^2: room for c
  add128(p, c);
  return reduce128(p.lo, p.hi);
}

// A sum of up to 2^31 128-bit values in three words, reduced once.
struct Acc {
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;

  __device__ __forceinline__ void add(U128 p) {
    asm("add.cc.u64 %0, %0, %3;\n\t"
        "addc.cc.u64 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(lo), "+l"(hi), "+r"(top)
        : "l"(p.lo), "l"(p.hi));
  }
  __device__ __forceinline__ void mul_add(uint64_t a, uint64_t b) {
    add(mul_wide(a, b));
  }
  __device__ __forceinline__ uint64_t reduce() const {
    return reduce160(lo, hi, top);
  }
};

// a * 2^k mod p for any u64 a and 0 < k < 96 (any u64, or canonical with
// CANON): the shifted value has at most 160 bits, at most 96 for k <= 32
template <bool CANON = false>
__device__ __forceinline__ uint64_t mul_pow2_small(uint64_t a, int k) {
  if (k <= 32) return reduce96<CANON>(a << k, (uint32_t)(a >> (64 - k)));
  if (k < 64) return reduce160<CANON>(a << k, a >> (64 - k), 0);
  if (k == 64) return reduce160<CANON>(0, a, 0);
  return reduce160<CANON>(0, a << (k - 64), (uint32_t)(a >> (128 - k)));
}

// a * 2^k mod p, canonical, for any u64 a and 0 <= k < 192 (2^96 = -1)
__device__ __forceinline__ uint64_t mul_pow2(uint64_t a, int k) {
  const int s = k < 96 ? k : k - 96;
  const uint64_t r = s == 0 ? canon(a) : mul_pow2_small<true>(a, s);
  return k < 96 ? r : neg(r);
}

}  // namespace gl
