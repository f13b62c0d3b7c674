// Field and curve arithmetic for the port's Groth16 kernels (sm_90a), over
// BN254 and BLS12-381: the base fields Fq, the scalar fields Fr, Fq2 =
// Fq[u]/(u^2 + 1) over either base field (u^2 = -1 on both curves), and G1 /
// G2 points in Jacobian coordinates on y^2 = x^3 + b (a = 0).  A field is a
// row of the constant tables: [0] BN254's Fq, [1] BN254's Fr, [2]
// BLS12-381's Fr (also the big-field Poseidon's, poseidon_fr.cu), [3]
// BLS12-381's Fq.
//
// The device counterpart of ops/bigint.py and ops/ec.py, and of the JAX
// package's ops/bigint_jax.py and ops/ec_jax.py.  An element is kLimbs<F>
// 32-bit limbs, little-endian: 8 for the three fields below 2^256, 12 for
// BLS12-381's Fq (below 2^381): the same bytes as the [..., 4] or [..., 6]
// int64 words the tensors hold, so a kernel reads and writes them in place.
// Field elements are in Montgomery form (R = 2^(32 kLimbs): 2^256 or
// 2^384) and canonical (below the modulus) in and out of every primitive.
//
// Multiplication is CIOS (coarsely integrated operand scanning) over the
// limbs: each of the n rounds adds a[j] * b[i] and m * q[j] into a running
// (n + 1)-limb value through 64-bit multiply-adds, which the compiler
// issues as IMAD.WIDE.U32 and 64-bit adds: 580 instructions a BN254 product
// (kernel_probe; PTX mad.lo/mad.hi carry chains compile to 828 here); one
// conditional subtraction at the end.  Every modulus is below a quarter of
// its R except BLS12-381's r (about 0.45 * 2^256), and all are below R / 2,
// so twice the modulus fits the limbs: the sum of two canonical values
// does, CIOS keeps t < 2q, and one conditional subtraction reduces either.
// A sum of three unreduced values may not fit: reduce after every add.
//
// BLS12-381's Fq product (144 + 144 limb products) is a call, not inlined:
// a G2 point operation over its Fq2 holds some fifty of them, and inlined
// they made kernels of hundreds of thousands of instructions that ptxas
// takes minutes to allocate and the instruction cache cannot hold.  The
// 8-limb products stay inlined, as before.
//
// The point formulas are complete, as ec_jax._add is at :111-124: the point
// at infinity (Z = 0; affine (0, 0), which lies on neither curve), P + P
// (the doubling) and P + (-P) (infinity) are branches.  Doubling is
// dbl-2009-l (2M + 5S), addition add-2007-bl (11M + 5S), mixed addition
// with an affine point madd-2007-bl (7M + 4S).
#pragma once

#include <cstdint>

namespace bn254 {

constexpr int N = 8;       // limbs of an element of a field below 2^256
constexpr int kMaxN = 12;  // limbs of BLS12-381's Fq

// limbs of field F's elements
template <int F>
constexpr int kLimbs = F == 3 ? 12 : 8;

// [0]: BN254's Fq, [1]: BN254's Fr, [2]: BLS12-381's Fr, [3]: BLS12-381's
// Fq; an 8-limb row is zero above its limbs
static __constant__ uint32_t kMod[4][kMaxN] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,
     0x3339d808u, 0x299d7d48u, 0x73eda753u},
    {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
     0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
     0x397fe69au, 0x1a0111eau}};
// R mod q: 1 in Montgomery form
static __constant__ uint32_t kOne[4][kMaxN] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu,
     0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau, 0xecbc4ff5u,
     0x998c4fefu, 0xacc5056fu, 0x1824b159u},
    {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
     0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
     0xfa80e493u, 0x15f65ec3u}};
// q - 2: Fermat's inverse exponent
static __constant__ uint32_t kInvExp[4][kMaxN] = {
    {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,
     0x3339d808u, 0x299d7d48u, 0x73eda753u},
    {0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
     0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
     0x397fe69au, 0x1a0111eau}};

// -q^-1 mod 2^32
__device__ __forceinline__ uint32_t inv32(int f) {
  return f == 0   ? 0xe4866389u
         : f == 1 ? 0xefffffffu
         : f == 2 ? 0xffffffffu
                  : 0xfffcfffdu;
}

template <int F>
struct Fp {
  uint32_t v[kLimbs<F>];
};
using Fq = Fp<0>;
using Fr = Fp<1>;
using FrBls = Fp<2>;
using FqBls = Fp<3>;

template <int F>
__device__ __forceinline__ Fp<F> zero() {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) r.v[i] = 0;
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> one() {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) r.v[i] = kOne[F][i];
  return r;
}

template <int F>
__device__ __forceinline__ bool is_zero(const Fp<F>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) o |= a.v[i];
  return o == 0;
}

template <int F>
__device__ __forceinline__ bool eq(const Fp<F>& a, const Fp<F>& b) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) o |= a.v[i] ^ b.v[i];
  return o == 0;
}

// a -> a - q where a >= q (a < 2q)
template <int F>
__device__ __forceinline__ void reduce_once(Fp<F>& a) {
  constexpr int n = kLimbs<F>;
  uint32_t d[n];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - kMod[F][i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (!borrow) {
#pragma unroll
    for (int i = 0; i < n; ++i) a.v[i] = d[i];
  }
}

template <int F>
__device__ __forceinline__ Fp<F> add(const Fp<F>& a, const Fp<F>& b) {
  Fp<F> r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once(r);  // 2q < R: the sum fits the limbs
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> sub(const Fp<F>& a, const Fp<F>& b) {
  constexpr int n = kLimbs<F>;
  Fp<F> r;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
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
__device__ __forceinline__ Fp<F> mul_cios(const Fp<F>& a, const Fp<F>& b) {
  constexpr int n = kLimbs<F>;
  uint32_t t[n + 2];
#pragma unroll
  for (int i = 0; i < n + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      c = (uint64_t)a.v[j] * b.v[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[n] + (c >> 32);
    t[n] = (uint32_t)c;
    t[n + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * inv32(F);
    c = (uint64_t)m * kMod[F][0] + t[0];
#pragma unroll
    for (int j = 1; j < n; ++j) {
      c = (uint64_t)m * kMod[F][j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[n] + (c >> 32);
    t[n - 1] = (uint32_t)c;
    t[n] = t[n + 1] + (uint32_t)(c >> 32);
  }
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < n; ++i) r.v[i] = t[i];
  reduce_once(r);  // t < 2q, and t[n] = 0 since 2q < R
  return r;
}

// the product as a call (BLS12-381's Fq; see the top of the file)
template <int F>
__device__ __noinline__ Fp<F> mul_call(Fp<F> a, Fp<F> b) {
  return mul_cios(a, b);
}

template <int F>
__device__ __forceinline__ Fp<F> mul(const Fp<F>& a, const Fp<F>& b) {
  if constexpr (F == 3)
    return mul_call<F>(a, b);
  else
    return mul_cios(a, b);
}

template <int F>
__device__ __forceinline__ Fp<F> sqr(const Fp<F>& a) {
  return mul(a, a);
}

// a^2 / R mod q by separated operand scanning: the 28 cross products once,
// doubled by a shift, the 8 squares added, then the Montgomery reduction's
// 64 products: 100 limb products against mul's 128.  For a caller that
// squares often (the big-field Poseidon's S-box); mul and sqr above are
// what the Groth16 kernels use.
template <int F>
__device__ __forceinline__ Fp<F> sqr_sos(const Fp<F>& a) {
  constexpr int n = kLimbs<F>;
  uint32_t t[2 * n];
#pragma unroll
  for (int i = 0; i < 2 * n; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < n - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < n; ++j) {
      c = (uint64_t)a.v[i] * a.v[j] + t[i + j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    t[i + n] = (uint32_t)(c >> 32);
  }
  // twice the cross sum: below a^2 < q^2 < R^2 / 4, so no bit leaves t
#pragma unroll
  for (int i = 2 * n - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const uint64_t p = (uint64_t)a.v[i] * a.v[i];
    c += (uint64_t)t[2 * i] + (uint32_t)p;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + t[2 * i + 1] + (p >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  // Montgomery reduction; `hi` carries into t[i + n] from the row before
  uint32_t hi = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const uint32_t m = t[i] * inv32(F);
    c = 0;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      c = (uint64_t)m * kMod[F][j] + t[i + j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    const uint64_t s = (uint64_t)t[i + n] + (c >> 32) + hi;
    t[i + n] = (uint32_t)s;
    hi = (uint32_t)(s >> 32);
  }
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < n; ++i) r.v[i] = t[n + i];
  reduce_once(r);  // (a^2 + m q) / R < 2q < R: hi ends 0
  return r;
}

// a^(q-2) = a^-1 (0 -> 0), square-and-multiply from the top bit; the
// loops stay rolled (an unrolled inversion is hundreds of inlined products)
template <int F>
__device__ __forceinline__ Fp<F> inv(const Fp<F>& a) {
  Fp<F> r = one<F>();
#pragma unroll 1
  for (int i = kLimbs<F> - 1; i >= 0; --i) {
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
  for (int i = 0; i < kLimbs<F>; ++i) r.v[i] = q[i];
  return r;
}

template <int F>
__device__ __forceinline__ void store(int64_t* p, const Fp<F>& a) {
  uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < kLimbs<F>; ++i) q[i] = a.v[i];
}

// ---- Fq2 = Fq[u]/(u^2 + 1) over base field row F (0 or 3) ----

template <int F>
struct Fp2 {
  Fp<F> c0, c1;
};
using Fq2 = Fp2<0>;
using Fq2Bls = Fp2<3>;

template <int F>
__device__ __forceinline__ Fp2<F> add(const Fp2<F>& a, const Fp2<F>& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
template <int F>
__device__ __forceinline__ Fp2<F> sub(const Fp2<F>& a, const Fp2<F>& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
template <int F>
__device__ __forceinline__ Fp2<F> dbl(const Fp2<F>& a) {
  return add(a, a);
}
template <int F>
__device__ __forceinline__ Fp2<F> neg(const Fp2<F>& a) {
  return {neg(a.c0), neg(a.c1)};
}
template <int F>
__device__ __forceinline__ bool is_zero(const Fp2<F>& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}
template <int F>
__device__ __forceinline__ bool eq(const Fp2<F>& a, const Fp2<F>& b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

// Karatsuba: three base-field products
template <int F>
__device__ __forceinline__ Fp2<F> mul(const Fp2<F>& a, const Fp2<F>& b) {
  const Fp<F> t0 = mul(a.c0, b.c0);
  const Fp<F> t1 = mul(a.c1, b.c1);
  const Fp<F> t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u: two base-field products
template <int F>
__device__ __forceinline__ Fp2<F> sqr(const Fp2<F>& a) {
  const Fp<F> t = mul(a.c0, a.c1);
  return {mul(add(a.c0, a.c1), sub(a.c0, a.c1)), add(t, t)};
}

// (a0 - a1 u) / (a0^2 + a1^2)
template <int F>
__device__ __forceinline__ Fp2<F> inv(const Fp2<F>& a) {
  const Fp<F> t = inv(add(sqr(a.c0), sqr(a.c1)));
  return {mul(a.c0, t), mul(neg(a.c1), t)};
}

// ---- coordinate fields of G1 (Fq) and G2 (Fq2), as the point code sees them

template <class E>
struct Coord;

template <int F>
struct Coord<Fp<F>> {
  static constexpr int kWords = kLimbs<F> / 2;  // int64 words a coordinate
  static __device__ __forceinline__ Fp<F> zero() { return bn254::zero<F>(); }
  static __device__ __forceinline__ Fp<F> one() { return bn254::one<F>(); }
  static __device__ __forceinline__ Fp<F> load(const int64_t* p) {
    return bn254::load<F>(p);
  }
  static __device__ __forceinline__ void store(int64_t* p, const Fp<F>& a) {
    bn254::store<F>(p, a);
  }
};

template <int F>
struct Coord<Fp2<F>> {
  static constexpr int kWords = kLimbs<F>;
  static __device__ __forceinline__ Fp2<F> zero() {
    return {bn254::zero<F>(), bn254::zero<F>()};
  }
  static __device__ __forceinline__ Fp2<F> one() {
    return {bn254::one<F>(), bn254::zero<F>()};
  }
  static __device__ __forceinline__ Fp2<F> load(const int64_t* p) {
    return {bn254::load<F>(p), bn254::load<F>(p + kLimbs<F> / 2)};
  }
  static __device__ __forceinline__ void store(int64_t* p, const Fp2<F>& a) {
    bn254::store<F>(p, a.c0);
    bn254::store<F>(p + kLimbs<F> / 2, a.c1);
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
