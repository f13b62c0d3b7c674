// Test entry for the field primitives of bn254.cuh: applies one primitive to
// arrays of operands so that a test can hold the device arithmetic against
// Python integers on chosen edge values (0, 1, q - 1, q - 2, R mod q) and
// random pairs.  Not on the prover's path.
//
// field: a row of bn254.cuh (0 BN254's Fq, 1 its Fr, 2 BLS12-381's Fr, 3
// its Fq).  op: 0 mul, 1 sqr, 2 add, 3 sub, 4 inv, 5 neg (on elements
// [n, W], W = 4 or 6 words), 6 Fq2 mul, 7 Fq2 sqr, 8 Fq2 inv (on [n, 2, W],
// base fields 0 and 3 only).  Operands are canonical words; mul, sqr and
// inv take and give Montgomery form (mul returns a * b / R).
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

template <int F>
__global__ void check_kernel(int op, const int64_t* a, const int64_t* b,
                             int64_t* out, long long n) {
  constexpr int W = bn254::kLimbs<F> / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bn254::Fp<F> x = bn254::load<F>(a + i * W);
  const bn254::Fp<F> y = bn254::load<F>(b + i * W);
  bn254::Fp<F> r;
  switch (op) {
    case 0: r = bn254::mul(x, y); break;
    case 1: r = bn254::sqr(x); break;
    case 2: r = bn254::add(x, y); break;
    case 3: r = bn254::sub(x, y); break;
    case 4: r = bn254::inv(x); break;
    default: r = bn254::neg(x); break;
  }
  bn254::store(out + i * W, r);
}

template <int F>
__global__ void check_f2_kernel(int op, const int64_t* a, const int64_t* b,
                                int64_t* out, long long n) {
  using C = bn254::Coord<bn254::Fp2<F>>;
  constexpr int W = C::kWords;  // both coefficients
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bn254::Fp2<F> x = C::load(a + i * W);
  const bn254::Fp2<F> y = C::load(b + i * W);
  bn254::Fp2<F> r;
  switch (op) {
    case 6: r = bn254::mul(x, y); break;
    case 7: r = bn254::sqr(x); break;
    default: r = bn254::inv(x); break;
  }
  C::store(out + i * W, r);
}

template <int F>
void launch(int op, const void* a, const void* b, void* out, long long n,
            cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + 127) / 128);
  if (op >= 6) {
    if constexpr (F == 0 || F == 3)
      check_f2_kernel<F><<<blocks, 128, 0, s>>>(
          op, (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n);
  } else {
    check_kernel<F><<<blocks, 128, 0, s>>>(op, (const int64_t*)a,
                                           (const int64_t*)b, (int64_t*)out,
                                           n);
  }
}

}  // namespace

extern "C" int bn254_check(int device, int op, int field, const void* a,
                           const void* b, void* out, long long n,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < 0 || op > 8 || field < 0 || field > 3 ||
      (op >= 6 && field != 0 && field != 3))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: launch<0>(op, a, b, out, n, s); break;
    case 1: launch<1>(op, a, b, out, n, s); break;
    case 2: launch<2>(op, a, b, out, n, s); break;
    default: launch<3>(op, a, b, out, n, s); break;
  }
  return (int)cudaGetLastError();
}
