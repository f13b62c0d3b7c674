// Fixed-base batch s_i * G -> affine over BN254 G1 and G2 for Hopper
// (sm_90a): the query points of a Groth16 setup.
//
// Replaces eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all (:221), which
// runs native/ec_curves.cpp's g1_fixed_batch / g2_fixed_batch on the host;
// on the JAX package's device path the same work is ops/ec_jax.py
// ::_msm_core's per-lane double-and-add (:154) without its reduction.
//
// One thread a lane: left-to-right double-and-add over the scalar's 254
// bits with the affine base (a doubling a bit, a mixed addition a set bit),
// then the lane's own inversion (Fermat) to affine.  What bounds it: field
// products, about 3,500 a G1 lane (254 doublings of 7, 127 additions of 11,
// the inversion's 380 or so) and three Fq products each in G2; the lane
// reads 32 bytes and writes 64 or 128.  A windowed table of the base would
// need fewer products; this first design has none.
//
// base: affine [2, W] Montgomery words (W = 4 for G1, 8 for G2); scalars
// [n, 4] standard words below r; out [n, 2, W].
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Aff;
using bn254::Coord;
using bn254::Fq;
using bn254::Fq2;
using bn254::Jac;

constexpr int kThreads = 128;

template <class E>
__global__ void __launch_bounds__(kThreads)
    fixed_base_kernel(const int64_t* __restrict__ base,
                      const int64_t* __restrict__ scalars, long long n,
                      int64_t* __restrict__ out) {
  constexpr int W = Coord<E>::kWords;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Aff<E> g = bn254::load_affine<E>(base);
  const uint64_t* s = reinterpret_cast<const uint64_t*>(scalars + i * 4);
  Jac<E> acc = bn254::infinity<E>();
#pragma unroll 1
  for (int w = 3; w >= 0; --w) {
    const uint64_t word = s[w];
#pragma unroll 1
    for (int b = 63; b >= 0; --b) {
      acc = bn254::dbl(acc);
      if ((word >> b) & 1) acc = bn254::add_affine(acc, g);
    }
  }
  bn254::store_affine(out + i * 2 * W, acc);
}

}  // namespace

// curve: 1 = G1, 2 = G2
extern "C" int ec_fixed_base(int device, int curve, const void* base,
                             const void* scalars, long long n, void* out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (curve == 1) {
    fixed_base_kernel<Fq><<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int64_t*)base, (const int64_t*)scalars, n, (int64_t*)out);
  } else if (curve == 2) {
    fixed_base_kernel<Fq2><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const int64_t*)base, (const int64_t*)scalars, n, (int64_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
