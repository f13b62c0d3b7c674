// SASS probes for bn254.cuh: each kernel's only loop runs one primitive a
// trip, so kernel_probe.py reads the instructions of one Fq product, one Fq
// square, one Fq2 product, one mixed addition (G1, G2) and one doubling (G1)
// from the loop body the compiler makes of it.  Never launched; not on the
// prover's path.  The mixed addition's body holds its exceptional branches
// too (the doubling of P + P is inlined), so kernel_probe reports it beside
// the doubling's.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

using bn254::Aff;
using bn254::Coord;
using bn254::Fq;
using bn254::Fq2;
using bn254::Jac;

// extern "C" and never launched: external linkage keeps them in the library
extern "C" __global__ void probe_fq_mul(const int64_t* in, int iters,
                                        int64_t* out) {
  Fq a = bn254::load<0>(in), b = bn254::load<0>(in + 4);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) a = bn254::mul(a, b);
  bn254::store(out, a);
}

extern "C" __global__ void probe_fq_sqr(const int64_t* in, int iters,
                                        int64_t* out) {
  Fq a = bn254::load<0>(in);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) a = bn254::sqr(a);
  bn254::store(out, a);
}

extern "C" __global__ void probe_fq2_mul(const int64_t* in, int iters,
                                         int64_t* out) {
  Fq2 a = Coord<Fq2>::load(in), b = Coord<Fq2>::load(in + 8);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) a = bn254::mul(a, b);
  Coord<Fq2>::store(out, a);
}

template <class E>
static __device__ __forceinline__ void madd_loop(const int64_t* in,
                                                 int iters, int64_t* out) {
  constexpr int W = Coord<E>::kWords;
  Jac<E> acc = bn254::load_jacobian<E>(in);
  const Aff<E> q = bn254::load_affine<E>(in + 3 * W);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) acc = bn254::add_affine(acc, q);
  bn254::store_jacobian(out, acc);
}

extern "C" __global__ void probe_g1_madd(const int64_t* in, int iters,
                                         int64_t* out) {
  madd_loop<Fq>(in, iters, out);
}

extern "C" __global__ void probe_g2_madd(const int64_t* in, int iters,
                                         int64_t* out) {
  madd_loop<Fq2>(in, iters, out);
}

extern "C" __global__ void probe_g1_dbl(const int64_t* in, int iters,
                                        int64_t* out) {
  Jac<Fq> acc = bn254::load_jacobian<Fq>(in);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) acc = bn254::dbl(acc);
  bn254::store_jacobian(out, acc);
}
