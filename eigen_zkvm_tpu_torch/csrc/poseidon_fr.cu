// Poseidon over a big field on the card (sm_90a): BN254's scalar field or
// BLS12-381's, circomlib's "opt" schedule, any state width t = 2..17.
//
// Replaces the JAX package's host permutation of the big-field Merkle trees
// (native/poseidon_fr.cpp: posfr_hash_batch :432 over permute_scalar :143 /
// permute_v8 :254; hash/poseidon_big.py:132-169 in Python), which has no
// Pallas kernel.  The plain version is ops/poseidon_fr.py::permute_plain.
//
// inp [B, t-1, 4] and init [B, 4] are int64 words in value form (canonical,
// the u64 limbs of the JAX package's limb arrays); out [B, n_out, 4] gets
// the first n_out lanes of each permuted state.  State lane 0 is the
// capacity (init), lanes 1..t-1 the inputs.  The tables (C, M and P
// [t * t] with M[j][i] at j * t + i, the sparse S) are in Montgomery form
// in device memory, one set a width (hash/poseidon_big.py::device_tables).
// The inputs enter Montgomery form by one product with R^2 mod r, the
// outputs leave it by one product with 1.
//
// Schedule (PoseidonBig.hash_ex): add C; half - 1 full rounds (x^5 on
// every lane, add C, mix with M); one full round mixing with P; n_p partial
// rounds (x^5 on lane 0 plus its constant; new lane 0 = sum_j S_j * s_j;
// lanes k >= 1 += S * s0); half - 1 full rounds; a last full round with no
// constant add.
//
// Design: one thread a permutation, t a run-time argument and the loops
// over lanes rolled, so one kernel serves every width of a field (two
// instances in all) and the build stays short.  The state and the mixed
// state are arrays of up to 17 elements indexed at run time: they live in
// the thread's local memory (1,088 bytes, L1/L2-cached), and ptxas reports
// them as its stack frame.  The tables are read through the read-only
// cache; a warp reads the same entry on every lane.
//
// What bounds it: the field products.  A permutation needs 8 (3t + t^2)
// in its full rounds and n_p (3 + t + (t - 1)) in its partial rounds,
// plus t + n_out conversions: 5,168 + 34 at t = 17 over BN254 (n_p = 68),
// each 128 IMAD.WIDE.U32 at the least, so a level of 2^13 t = 17 nodes is
// bound at about 0.32 ms.  A CIOS product here is about 580 instructions
// (bn254.cuh), so the kernel runs at a fraction of that bound at best.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fp;

constexpr int kMaxT = 17;
constexpr int kHalf = 4;  // half of the 8 full rounds
constexpr int kThreads = 128;

// R^2 mod r, plain 32-bit limbs: [0] BN254's Fr, [1] BLS12-381's Fr
__constant__ uint32_t kR2[2][bn254::N] = {
    {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u,
     0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u},
    {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu, 0x7254398fu,
     0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}};

template <int F>
__device__ __forceinline__ Fp<F> ld(const int64_t* p) {
  Fp<F> r;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r.v[i] = __ldg(q + i);
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> pow5(const Fp<F>& x) {
  const Fp<F> x2 = bn254::mul(x, x);
  return bn254::mul(bn254::mul(x2, x2), x);
}

// st <- mat^T (x^5 of st, plus c when given): out_i = sum_j mat[j][i] s_j
template <int F>
__device__ __forceinline__ void full_round(Fp<F>* st, Fp<F>* nx, int t,
                                           const int64_t* c,
                                           const int64_t* mat) {
#pragma unroll 1
  for (int i = 0; i < t; ++i) {
    Fp<F> x = pow5(st[i]);
    if (c != nullptr) x = bn254::add(x, ld<F>(c + 4 * i));
    nx[i] = x;
  }
#pragma unroll 1
  for (int i = 0; i < t; ++i) {
    Fp<F> acc = bn254::mul(ld<F>(mat + 4 * i), nx[0]);
#pragma unroll 1
    for (int j = 1; j < t; ++j)
      acc = bn254::add(acc, bn254::mul(ld<F>(mat + 4 * (j * t + i)), nx[j]));
    st[i] = acc;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    poseidon_fr_kernel(int t, int n_p, const int64_t* C, const int64_t* M,
                       const int64_t* P, const int64_t* S, const int64_t* inp,
                       const int64_t* init, int64_t* out, int n_out,
                       long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fp<F> r2;
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r2.v[i] = kR2[F - 1][i];
  Fp<F> st[kMaxT], nx[kMaxT];
  st[0] = bn254::add(bn254::mul(ld<F>(init + 4 * b), r2), ld<F>(C));
  const int64_t* in = inp + 4 * (t - 1) * b;
#pragma unroll 1
  for (int i = 1; i < t; ++i)
    st[i] = bn254::add(bn254::mul(ld<F>(in + 4 * (i - 1)), r2),
                       ld<F>(C + 4 * i));

#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r)
    full_round<F>(st, nx, t, C + 4 * (r + 1) * t, M);
  full_round<F>(st, nx, t, C + 4 * kHalf * t, P);

  const int64_t* cp = C + 4 * (kHalf + 1) * t;
#pragma unroll 1
  for (int r = 0; r < n_p; ++r) {
    const int64_t* s = S + 4 * (2 * t - 1) * r;
    const Fp<F> s0 = bn254::add(pow5(st[0]), ld<F>(cp + 4 * r));
    Fp<F> acc = bn254::mul(ld<F>(s), s0);
#pragma unroll 1
    for (int j = 1; j < t; ++j)
      acc = bn254::add(acc, bn254::mul(ld<F>(s + 4 * j), st[j]));
#pragma unroll 1
    for (int k = 1; k < t; ++k)
      st[k] = bn254::add(st[k], bn254::mul(ld<F>(s + 4 * (t + k - 1)), s0));
    st[0] = acc;
  }

  const int64_t* cf = cp + 4 * n_p;
#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r)
    full_round<F>(st, nx, t, cf + 4 * r * t, M);
  full_round<F>(st, nx, t, nullptr, M);

  Fp<F> one = bn254::zero<F>();
  one.v[0] = 1;
  int64_t* o = out + 4 * (long long)n_out * b;
#pragma unroll 1
  for (int i = 0; i < n_out; ++i) bn254::store(o + 4 * i, bn254::mul(st[i], one));
}

}  // namespace

// field: 0 BN254's Fr, 1 BLS12-381's Fr.  Every pointer is to int64 words
// on `device`; returns cudaGetLastError() after the launch.
extern "C" int poseidon_fr(int device, int field, int t, int n_p,
                           const void* C, const void* M, const void* P,
                           const void* S, const void* inp, const void* init,
                           void* out, int n_out, long long B, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (field < 0 || field > 1 || t < 2 || t > kMaxT || n_p < 0 || n_out < 1
      || n_out > t || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c = (const int64_t*)C;
  const auto* m = (const int64_t*)M;
  const auto* p = (const int64_t*)P;
  const auto* sp = (const int64_t*)S;
  const auto* in = (const int64_t*)inp;
  const auto* ini = (const int64_t*)init;
  auto* o = (int64_t*)out;
  if (field == 0)
    poseidon_fr_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, n_p, c, m, p, sp, in, ini, o, n_out, B);
  else
    poseidon_fr_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, n_p, c, m, p, sp, in, ini, o, n_out, B);
  return (int)cudaGetLastError();
}
