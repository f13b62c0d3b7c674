// NTT stages and pointwise products over BN254's Fr for Hopper (sm_90a):
// the quotient H = (A*B - C) / Z of a Groth16 prove.
//
// Replaces the transforms of eigen_zkvm_tpu/groth16/groth16.py::_witness_h
// (:315; its Python `_ntt` / `_intt` at :34-72, native/ec_curves.cpp's
// fr_witness_h on the host engine).  ops/fr_ntt.py runs a transform as a
// bit-reversal gather (torch) and one launch of fr_ntt_stage a radix-2 stage;
// fr_mul applies the inverse transform's 1/n with the coset shift's powers
// (and moves values in and out of Montgomery form), fr_quotient forms
// (a*b - c) * Z(shift)^-1 on the coset.
//
// What bounds it: a stage reads and writes every value (64 bytes a
// butterfly plus its twiddle) and takes one Fr product a butterfly, about
// 400 integer instructions; at 2^21 values a stage moves 128 MB, about 40 us
// of memory time against about 30 us of products.  One launch a stage is the
// first design; stages fused in shared memory, as csrc/ntt.cu does for
// Goldilocks, are later work.
//
// Values are [n, 4] int64 words in Montgomery form; tw[j] = w^j, j < n/2.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fr;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    stage_kernel(int64_t* __restrict__ x, const int64_t* __restrict__ tw,
                 int log_n, int s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1ll << (log_n - 1))) return;
  const long long h = 1ll << s;
  const long long j = i & (h - 1);
  const long long pos = ((i >> s) << (s + 1)) | j;
  const Fr u = bn254::load<1>(x + pos * 4);
  const Fr w = bn254::load<1>(tw + (j << (log_n - 1 - s)) * 4);
  const Fr v = bn254::mul(bn254::load<1>(x + (pos + h) * 4), w);
  bn254::store(x + pos * 4, bn254::add(u, v));
  bn254::store(x + (pos + h) * 4, bn254::sub(u, v));
}

__global__ void __launch_bounds__(kThreads)
    mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
               int b_step, int64_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn254::store(out + i * 4, bn254::mul(bn254::load<1>(a + i * 4),
                                       bn254::load<1>(b + i * b_step * 4)));
}

__global__ void __launch_bounds__(kThreads)
    quotient_kernel(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ b,
                    const int64_t* __restrict__ c,
                    const int64_t* __restrict__ k, int64_t* __restrict__ out,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fr ab = bn254::mul(bn254::load<1>(a + i * 4),
                           bn254::load<1>(b + i * 4));
  bn254::store(out + i * 4, bn254::mul(bn254::sub(ab, bn254::load<1>(c + i * 4)),
                                       bn254::load<1>(k)));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// One radix-2 stage (half = 2^s) in place on a bit-reversed buffer of 2^log_n
extern "C" int fr_ntt_stage(int device, void* x, const void* tw, int log_n,
                            int s, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (log_n < 1 || log_n > 28 || s < 0 || s >= log_n)
    return (int)cudaErrorInvalidValue;
  stage_kernel<<<blocks_for(1ll << (log_n - 1)), kThreads, 0,
                 (cudaStream_t)stream>>>((int64_t*)x, (const int64_t*)tw,
                                         log_n, s);
  return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i * b_step] (b_step 0: one value for all)
extern "C" int fr_mul(int device, const void* a, const void* b, int b_step,
                      void* out, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, b_step, (int64_t*)out, n);
  return (int)cudaGetLastError();
}

// out[i] = (a[i] * b[i] - c[i]) * k[0]
extern "C" int fr_quotient(int device, const void* a, const void* b,
                           const void* c, const void* k, void* out,
                           long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  quotient_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (const int64_t*)c,
      (const int64_t*)k, (int64_t*)out, n);
  return (int)cudaGetLastError();
}
