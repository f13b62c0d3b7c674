// Fixed-base batch s_i * G -> affine over BN254 G1 and G2 for Hopper
// (sm_90a): the query points of a Groth16 setup.
//
// Replaces eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all (:221), which
// runs native/ec_curves.cpp's windowed g1_fixed_batch / g2_fixed_batch
// (:387) on the host; on the JAX package's device path the same work is
// ops/ec_jax.py::_msm_core's per-lane double-and-add (:154) without its
// reduction.
//
// Table-driven, as the host's batch is: `table` holds d * 2^(8w) * G for
// the 32 windows w of 8 bits and every digit d (ops/ec._table, built once
// on the host from Python ints), so a lane does one mixed addition (7M + 4S)
// for each nonzero byte of its scalar and no doubling, about 31 additions
// for a random scalar where a double-and-add needs 254 doublings and 127
// additions.  The lanes then go to affine by Montgomery's batch inversion:
// a thread holds `per` lanes (lane t, t + T, t + 2T, ... for T threads, so a
// warp's loads and stores stay coalesced), keeps each lane's Jacobian X, Y
// in `out` and its Z with the product of the Z before it in `scratch`, takes
// one Fermat inversion of the product, and walks back: 3 products a lane for
// the inverse, 4 for x = X / Z^2 and y = Y / Z^3.  A lane at infinity (a
// zero scalar: setup's a_t and b_t hold one for every wire missing from A or
// B) is left out of the product chain and written (0, 0), so it cannot make
// its neighbours' inverses wrong.
//
// What bounds it: field products, about 350 a random G1 lane (three Fq
// products an Fq2 product in G2); the table (512 KB in G1, 1 MB in G2) is
// read through L2, 64 or 128 bytes an addition.  The grid is sized to the
// blocks that fit on the card at once, so every thread stays resident and
// the one inversion a thread is spread over as many lanes as possible.
//
// table: affine [32, 256, 2, W] Montgomery words (W = 4 for G1, 8 for G2);
// scalars [n, 4] standard words below r; out [n, 2, W]; scratch [n, 2, W].
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
constexpr int kWindows = 32;  // 8-bit windows of a 256-bit scalar
constexpr int kDigits = 256;

template <class E>
__global__ void __launch_bounds__(kThreads)
    fixed_base_kernel(const int64_t* __restrict__ table,
                      const int64_t* __restrict__ scalars, long long n,
                      int64_t* __restrict__ out,
                      int64_t* __restrict__ scratch) {
  constexpr int W = Coord<E>::kWords;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  E prod = Coord<E>::one();  // product of the finite lanes' Z so far
  long long last = -1;
#pragma unroll 1
  for (long long i = first; i < n; i += stride) {
    const uint64_t* s = reinterpret_cast<const uint64_t*>(scalars + i * 4);
    Jac<E> acc = bn254::infinity<E>();
#pragma unroll 1
    for (int w = 0; w < kWindows; ++w) {
      const uint32_t d = (uint32_t)(s[w >> 3] >> (8 * (w & 7))) & 0xffu;
      if (d)
        acc = bn254::add_affine(
            acc, bn254::load_affine<E>(table + ((long long)w * kDigits + d) *
                                                   2 * W));
    }
    Coord<E>::store(out + i * 2 * W, acc.X);
    Coord<E>::store(out + i * 2 * W + W, acc.Y);
    Coord<E>::store(scratch + i * 2 * W, acc.Z);
    Coord<E>::store(scratch + i * 2 * W + W, prod);
    if (!bn254::is_zero(acc.Z)) prod = bn254::mul(prod, acc.Z);
    last = i;
  }
  if (last < 0) return;
  E inv = bn254::inv(prod);  // 1 / (product of every finite Z)
#pragma unroll 1
  for (long long i = last; i >= first; i -= stride) {
    int64_t* o = out + i * 2 * W;
    const E z = Coord<E>::load(scratch + i * 2 * W);
    if (bn254::is_zero(z)) {
      Coord<E>::store(o, Coord<E>::zero());
      Coord<E>::store(o + W, Coord<E>::zero());
      continue;
    }
    const E zi = bn254::mul(inv, Coord<E>::load(scratch + i * 2 * W + W));
    inv = bn254::mul(inv, z);
    const E zi2 = bn254::sqr(zi);
    Coord<E>::store(o, bn254::mul(Coord<E>::load(o), zi2));
    Coord<E>::store(o + W,
                    bn254::mul(Coord<E>::load(o + W), bn254::mul(zi2, zi)));
  }
}

template <class E>
int launch(int device, const void* table, const void* scalars, long long n,
           void* out, void* scratch, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fixed_base_kernel<E>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + kThreads - 1) / kThreads;
  if (blocks > need) blocks = need;
  fixed_base_kernel<E><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int64_t*)table, (const int64_t*)scalars, n, (int64_t*)out,
      (int64_t*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 1 = G1, 2 = G2
extern "C" int ec_fixed_base(int device, int curve, const void* table,
                             const void* scalars, long long n, void* out,
                             void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (curve == 1)
    return launch<Fq>(device, table, scalars, n, out, scratch,
                      (cudaStream_t)stream);
  if (curve == 2)
    return launch<Fq2>(device, table, scalars, n, out, scratch,
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
