// Test entry for the field primitives of bn254.cuh: applies one primitive to
// arrays of operands so that a test can hold the device arithmetic against
// Python integers on chosen edge values (0, 1, q - 1, q - 2, R mod q) and
// random pairs.  Not on the prover's path.
//
// field: 0 Fq, 1 Fr.  op: 0 mul, 1 sqr, 2 add, 3 sub, 4 inv, 5 neg (on
// elements [n, 4]), 6 Fq2 mul, 7 Fq2 sqr, 8 Fq2 inv (on [n, 2, 4], Fq
// only).  Operands are canonical words; mul, sqr and inv take and give
// Montgomery form (mul returns a * b / R).
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

template <int F>
__global__ void check_kernel(int op, const int64_t* a, const int64_t* b,
                             int64_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bn254::Fp<F> x = bn254::load<F>(a + i * 4);
  const bn254::Fp<F> y = bn254::load<F>(b + i * 4);
  bn254::Fp<F> r;
  switch (op) {
    case 0: r = bn254::mul(x, y); break;
    case 1: r = bn254::sqr(x); break;
    case 2: r = bn254::add(x, y); break;
    case 3: r = bn254::sub(x, y); break;
    case 4: r = bn254::inv(x); break;
    default: r = bn254::neg(x); break;
  }
  bn254::store(out + i * 4, r);
}

__global__ void check_f2_kernel(int op, const int64_t* a, const int64_t* b,
                                int64_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  using C = bn254::Coord<bn254::Fq2>;
  const bn254::Fq2 x = C::load(a + i * 8);
  const bn254::Fq2 y = C::load(b + i * 8);
  bn254::Fq2 r;
  switch (op) {
    case 6: r = bn254::mul(x, y); break;
    case 7: r = bn254::sqr(x); break;
    default: r = bn254::inv(x); break;
  }
  C::store(out + i * 8, r);
}

}  // namespace

extern "C" int bn254_check(int device, int op, int field, const void* a,
                           const void* b, void* out, long long n,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < 0 || op > 8 || field < 0 || field > 1 || (op >= 6 && field != 0))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (op >= 6) {
    check_f2_kernel<<<blocks, 128, 0, s>>>(op, (const int64_t*)a,
                                          (const int64_t*)b, (int64_t*)out, n);
  } else if (field == 0) {
    check_kernel<0><<<blocks, 128, 0, s>>>(op, (const int64_t*)a,
                                           (const int64_t*)b, (int64_t*)out,
                                           n);
  } else {
    check_kernel<1><<<blocks, 128, 0, s>>>(op, (const int64_t*)a,
                                           (const int64_t*)b, (int64_t*)out,
                                           n);
  }
  return (int)cudaGetLastError();
}
