// BN254 field and curve arithmetic for the port's Groth16 kernels (sm_90a):
// Fq (the base field), Fr (the scalar field), Fq2 = Fq[u]/(u^2 + 1), and G1
// / G2 points in Jacobian coordinates on y^2 = x^3 + b (a = 0).
//
// The device counterpart of ops/bigint.py and ops/ec.py, and of the JAX
// package's ops/bigint_jax.py and ops/ec_jax.py.  An element is eight 32-bit
// limbs, little-endian: the same bytes as the [..., 4] int64 words the
// tensors hold, so a kernel reads and writes them in place.  Field elements
// are in Montgomery form (R = 2^256) and canonical (below the modulus) in
// and out of every primitive.
//
// Multiplication is CIOS (coarsely integrated operand scanning) over the
// eight limbs: each of the 8 rounds adds a[j] * b[i] and m * q[j] into a
// running 9-limb value through 64-bit multiply-adds, which the compiler
// issues as IMAD.WIDE.U32 and 64-bit adds: 580 instructions a product
// (kernel_probe; PTX mad.lo/mad.hi carry chains compile to 828 here); one
// conditional subtraction at the end.  Both moduli are below 2^254, so no
// sum ever leaves 256 bits plus one limb.
//
// The point formulas are complete, as ec_jax._add is at :111-124: the point
// at infinity (Z = 0; affine (0, 0), which lies on neither curve), P + P
// (the doubling) and P + (-P) (infinity) are branches.  Doubling is
// dbl-2009-l (2M + 5S), addition add-2007-bl (11M + 5S), mixed addition
// with an affine point madd-2007-bl (7M + 4S).
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int N = 8;  // limbs of an element

// [0]: Fq, [1]: Fr
static __constant__ uint32_t kMod[2][N] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u}};
// R mod q: 1 in Montgomery form
static __constant__ uint32_t kOne[2][N] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
// q - 2: Fermat's inverse exponent
static __constant__ uint32_t kInvExp[2][N] = {
    {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u}};

// -q^-1 mod 2^32
__device__ __forceinline__ uint32_t inv32(int f) {
  return f == 0 ? 0xe4866389u : 0xefffffffu;
}

template <int F>
struct Fp {
  uint32_t v[N];
};
using Fq = Fp<0>;
using Fr = Fp<1>;

template <int F>
__device__ __forceinline__ Fp<F> zero() {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = 0;
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> one() {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = kOne[F][i];
  return r;
}

template <int F>
__device__ __forceinline__ bool is_zero(const Fp<F>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) o |= a.v[i];
  return o == 0;
}

template <int F>
__device__ __forceinline__ bool eq(const Fp<F>& a, const Fp<F>& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) o |= a.v[i] ^ b.v[i];
  return o == 0;
}

// a -> a - q where a >= q (a < 2q)
template <int F>
__device__ __forceinline__ void reduce_once(Fp<F>& a) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - kMod[F][i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (!borrow) {
#pragma unroll
    for (int i = 0; i < N; ++i) a.v[i] = d[i];
  }
}

template <int F>
__device__ __forceinline__ Fp<F> add(const Fp<F>& a, const Fp<F>& b) {
  Fp<F> r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once(r);  // q < 2^254: the sum fits 256 bits
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> sub(const Fp<F>& a, const Fp<F>& b) {
  Fp<F> r;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      c += (uint64_t)r.v[i] + kMod[F][i];
      r.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> neg(const Fp<F>& a) {
  return sub(zero<F>(), a);
}

template <int F>
__device__ __forceinline__ Fp<F> dbl(const Fp<F>& a) {
  return add(a, a);
}

// CIOS Montgomery product a * b / R mod q
template <int F>
__device__ __forceinline__ Fp<F> mul(const Fp<F>& a, const Fp<F>& b) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c = (uint64_t)a.v[j] * b.v[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * inv32(F);
    c = (uint64_t)m * kMod[F][0] + t[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c = (uint64_t)m * kMod[F][j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[N] + (c >> 32);
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = t[i];
  reduce_once(r);  // t < 2q, and t[N] = 0 since 2q < 2^256
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> sqr(const Fp<F>& a) {
  return mul(a, a);
}

// a^(q-2) = a^-1 (0 -> 0), square-and-multiply from the top bit; the
// loops stay rolled (an unrolled inversion is 500 inlined products)
template <int F>
__device__ __forceinline__ Fp<F> inv(const Fp<F>& a) {
  Fp<F> r = one<F>();
#pragma unroll 1
  for (int i = N - 1; i >= 0; --i) {
    const uint32_t e = kInvExp[F][i];
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      r = sqr(r);
      if ((e >> b) & 1) r = mul(r, a);
    }
  }
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> load(const int64_t* p) {
  Fp<F> r;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = q[i];
  return r;
}

template <int F>
__device__ __forceinline__ void store(int64_t* p, const Fp<F>& a) {
  uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = a.v[i];
}

// ---- Fq2 = Fq[u]/(u^2 + 1) ----

struct Fq2 {
  Fq c0, c1;
};

__device__ __forceinline__ Fq2 add(const Fq2& a, const Fq2& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 sub(const Fq2& a, const Fq2& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 dbl(const Fq2& a) { return add(a, a); }
__device__ __forceinline__ Fq2 neg(const Fq2& a) {
  return {neg(a.c0), neg(a.c1)};
}
__device__ __forceinline__ bool is_zero(const Fq2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}
__device__ __forceinline__ bool eq(const Fq2& a, const Fq2& b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

// Karatsuba: three Fq products
__device__ __forceinline__ Fq2 mul(const Fq2& a, const Fq2& b) {
  const Fq t0 = mul(a.c0, b.c0);
  const Fq t1 = mul(a.c1, b.c1);
  const Fq t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u: two Fq products
__device__ __forceinline__ Fq2 sqr(const Fq2& a) {
  const Fq t = mul(a.c0, a.c1);
  return {mul(add(a.c0, a.c1), sub(a.c0, a.c1)), add(t, t)};
}

// (a0 - a1 u) / (a0^2 + a1^2)
__device__ __forceinline__ Fq2 inv(const Fq2& a) {
  const Fq t = inv(add(sqr(a.c0), sqr(a.c1)));
  return {mul(a.c0, t), mul(neg(a.c1), t)};
}

// ---- coordinate fields of G1 (Fq) and G2 (Fq2), as the point code sees them

template <class E>
struct Coord;

template <>
struct Coord<Fq> {
  static constexpr int kWords = 4;  // int64 words of one coordinate
  static __device__ __forceinline__ Fq zero() { return bn254::zero<0>(); }
  static __device__ __forceinline__ Fq one() { return bn254::one<0>(); }
  static __device__ __forceinline__ Fq load(const int64_t* p) {
    return bn254::load<0>(p);
  }
  static __device__ __forceinline__ void store(int64_t* p, const Fq& a) {
    bn254::store<0>(p, a);
  }
};

template <>
struct Coord<Fq2> {
  static constexpr int kWords = 8;
  static __device__ __forceinline__ Fq2 zero() {
    return {bn254::zero<0>(), bn254::zero<0>()};
  }
  static __device__ __forceinline__ Fq2 one() {
    return {bn254::one<0>(), bn254::zero<0>()};
  }
  static __device__ __forceinline__ Fq2 load(const int64_t* p) {
    return {bn254::load<0>(p), bn254::load<0>(p + 4)};
  }
  static __device__ __forceinline__ void store(int64_t* p, const Fq2& a) {
    bn254::store<0>(p, a.c0);
    bn254::store<0>(p + 4, a.c1);
  }
};

// ---- points ----

template <class E>
struct Jac {
  E X, Y, Z;  // Z = 0: infinity
};

template <class E>
struct Aff {
  E x, y;
  bool inf;  // stored as (0, 0)
};

template <class E>
__device__ __forceinline__ Jac<E> infinity() {
  return {Coord<E>::one(), Coord<E>::one(), Coord<E>::zero()};
}

template <class E>
__device__ __forceinline__ Aff<E> load_affine(const int64_t* p) {
  constexpr int W = Coord<E>::kWords;
  Aff<E> a;
  a.x = Coord<E>::load(p);
  a.y = Coord<E>::load(p + W);
  a.inf = is_zero(a.x) && is_zero(a.y);
  return a;
}

template <class E>
__device__ __forceinline__ Jac<E> load_jacobian(const int64_t* p) {
  constexpr int W = Coord<E>::kWords;
  return {Coord<E>::load(p), Coord<E>::load(p + W),
          Coord<E>::load(p + 2 * W)};
}

template <class E>
__device__ __forceinline__ void store_jacobian(int64_t* p, const Jac<E>& a) {
  constexpr int W = Coord<E>::kWords;
  Coord<E>::store(p, a.X);
  Coord<E>::store(p + W, a.Y);
  Coord<E>::store(p + 2 * W, a.Z);
}

// infinity as the zero words (Z = 0), the form the plain versions write
template <class E>
__device__ __forceinline__ void store_jacobian_zero(int64_t* p) {
  constexpr int W = Coord<E>::kWords;
#pragma unroll
  for (int i = 0; i < 3 * W; ++i) p[i] = 0;
}

// dbl-2009-l
template <class E>
__device__ __forceinline__ Jac<E> dbl(const Jac<E>& p) {
  if (is_zero(p.Z)) return p;
  const E A = sqr(p.X);
  const E B = sqr(p.Y);
  const E C = sqr(B);
  E D = sub(sub(sqr(add(p.X, B)), A), C);
  D = dbl(D);
  const E Ee = add(dbl(A), A);
  const E Ff = sqr(Ee);
  Jac<E> r;
  r.X = sub(Ff, dbl(D));
  r.Y = sub(mul(Ee, sub(D, r.X)), dbl(dbl(dbl(C))));
  r.Z = dbl(mul(p.Y, p.Z));
  return r;
}

// add-2007-bl, complete
template <class E>
__device__ __forceinline__ Jac<E> add(const Jac<E>& p, const Jac<E>& q) {
  if (is_zero(p.Z)) return q;
  if (is_zero(q.Z)) return p;
  const E Z1Z1 = sqr(p.Z);
  const E Z2Z2 = sqr(q.Z);
  const E U1 = mul(p.X, Z2Z2);
  const E U2 = mul(q.X, Z1Z1);
  const E S1 = mul(mul(p.Y, q.Z), Z2Z2);
  const E S2 = mul(mul(q.Y, p.Z), Z1Z1);
  const E H = sub(U2, U1);
  E r = sub(S2, S1);
  if (is_zero(H)) {
    if (is_zero(r)) return dbl(p);
    return infinity<E>();
  }
  const E I = sqr(dbl(H));
  const E J = mul(H, I);
  r = dbl(r);
  const E V = mul(U1, I);
  Jac<E> o;
  o.X = sub(sub(sqr(r), J), dbl(V));
  o.Y = sub(mul(r, sub(V, o.X)), dbl(mul(S1, J)));
  o.Z = mul(sub(sub(sqr(add(p.Z, q.Z)), Z1Z1), Z2Z2), H);
  return o;
}

// madd-2007-bl: p + an affine point, complete
template <class E>
__device__ __forceinline__ Jac<E> add_affine(const Jac<E>& p,
                                             const Aff<E>& q) {
  if (q.inf) return p;
  if (is_zero(p.Z)) return {q.x, q.y, Coord<E>::one()};
  const E Z1Z1 = sqr(p.Z);
  const E U2 = mul(q.x, Z1Z1);
  const E S2 = mul(mul(q.y, p.Z), Z1Z1);
  const E H = sub(U2, p.X);
  E r = sub(S2, p.Y);
  if (is_zero(H)) {
    if (is_zero(r)) return dbl(p);
    return infinity<E>();
  }
  const E HH = sqr(H);
  const E I = dbl(dbl(HH));
  const E J = mul(H, I);
  r = dbl(r);
  const E V = mul(p.X, I);
  Jac<E> o;
  o.X = sub(sub(sqr(r), J), dbl(V));
  o.Y = sub(mul(r, sub(V, o.X)), dbl(mul(p.Y, J)));
  o.Z = sub(sub(sqr(add(p.Z, H)), Z1Z1), HH);
  return o;
}

// Jacobian -> affine words (x, y); infinity -> (0, 0)
template <class E>
__device__ __forceinline__ void store_affine(int64_t* out, const Jac<E>& p) {
  constexpr int W = Coord<E>::kWords;
  if (is_zero(p.Z)) {
    Coord<E>::store(out, Coord<E>::zero());
    Coord<E>::store(out + W, Coord<E>::zero());
    return;
  }
  const E zi = inv(p.Z);
  const E zi2 = sqr(zi);
  Coord<E>::store(out, mul(p.X, zi2));
  Coord<E>::store(out + W, mul(p.Y, mul(zi2, zi)));
}

}  // namespace bn254
