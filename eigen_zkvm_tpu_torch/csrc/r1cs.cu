// R1CS evaluation over a Groth16 scalar field for Hopper (sm_90a), BN254's
// Fr or BLS12-381's (bn254.cuh rows 1 and 2, the `field` argument): the
// three matrices A, B, C of a circuit times the witness, in one launch,
// written straight into the [3, m, 4] buffer the quotient transforms read.
//
// Replaces the sparse evaluation of eigen_zkvm_tpu/groth16/groth16.py
// ::_witness_h (:315, over the CSR of `_r1cs_csr` :283), which runs
// native/ec_curves.cpp's r1cs_eval on the host, pads each matrix's rows to
// the domain and copies the publics into A's tail (:341).
//
// The three matrices are one CSR of 3 nc rows with int32 row offsets and
// wires and a coefficient index of 2 or 4 bytes into a table of the
// distinct coefficients, 1 and -1 first.  What bounds it: the bytes (a row
// offset, a wire, an index a nonzero, a gathered 32-byte witness value,
// the 32-byte output) and the products of the nonzeros whose coefficient
// is not +-1.  The design:
//   - one launch writes every output slot once: slot (s, j) with j < nc is
//     row s nc + j; A's slots nc..nc+n_pub-1 are the publics (witness
//     0..n_pub-1) and every other slot is zero, so the caller allocates the
//     buffer with torch.empty and copies nothing;
//   - coefficient index 0 (1) adds the witness value, index 1 (-1)
//     subtracts it, any other index multiplies (a circuit's booleanity rows
//     and new wires are half its nonzeros);
//   - the rows are stored sorted (ops/r1cs.build, once a circuit): short
//     rows first, by their count of products and then by length, each
//     row's products before its +-1 terms, and `dest` names each stored
//     row's slot.  A warp's 32 rows then take the product path on the same
//     iterations: the 580-instruction product is not issued for lanes that
//     only add, as it is when booleanity rows and gates share a warp;
//   - a value moves as two 16-byte loads or stores;
//   - a row of at most SHORT_MAX (ops/r1cs.py) nonzeros is one thread's;
//     a longer one (a weighted sum of 254 bits, a packed word) is one
//     warp's: its lanes stride over the nonzeros and a shuffle tree sums
//     the partial sums mod r.  The first blocks take the short rows, the
//     next the padding slots, the rest the long rows, one warp each.
//
// indptr [3 nc + 1], wires [nnz], dest [3 nc] int32 (stored order); cidx
// [nnz] int16 or int32 (cidx_bytes); coefs [distinct, 4] and wit [n_vars,
// 4] Montgomery words; out [3, m, 4] Montgomery words.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fp;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kPlusOne = 0;   // coefficient indices of 1 and -1
constexpr int kMinusOne = 1;

template <int F>
__device__ __forceinline__ Fp<F> load2(const uint4* __restrict__ p) {
  static_assert(bn254::kLimbs<F> == bn254::N, "an Fr value is 8 limbs");
  const uint4 a = __ldg(p);
  const uint4 b = __ldg(p + 1);
  Fp<F> r;
  r.v[0] = a.x, r.v[1] = a.y, r.v[2] = a.z, r.v[3] = a.w;
  r.v[4] = b.x, r.v[5] = b.y, r.v[6] = b.z, r.v[7] = b.w;
  return r;
}

template <int F>
__device__ __forceinline__ void store2(uint4* __restrict__ p,
                                       const Fp<F>& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// acc += coefficient * witness for nonzero e
template <int F, typename CI>
__device__ __forceinline__ void accumulate(Fp<F>& acc, int e,
                                           const int* __restrict__ wires,
                                           const CI* __restrict__ cidx,
                                           const uint4* __restrict__ coefs,
                                           const uint4* __restrict__ wit) {
  const Fp<F> w = load2<F>(wit + 2 * (long long)__ldg(wires + e));
  const int c = __ldg(cidx + e);
  if (c == kPlusOne) {
    acc = bn254::add(acc, w);
  } else if (c == kMinusOne) {
    acc = bn254::sub(acc, w);
  } else {
    acc = bn254::add(acc, bn254::mul(load2<F>(coefs + 2 * c), w));
  }
}

// the output slot of row g = s nc + j: (s, j) of [3, m]
__device__ __forceinline__ long long slot(long long g, long long nc,
                                          long long m) {
  const long long s = g / nc;
  return s * m + (g - s * nc);
}

template <int F, typename CI>
__global__ void __launch_bounds__(kThreads)
    r1cs_kernel(const int* __restrict__ indptr, const int* __restrict__ wires,
                const CI* __restrict__ cidx, const uint4* __restrict__ coefs,
                const uint4* __restrict__ wit, const int* __restrict__ dest,
                long long n_short, long long nc, long long m, long long n_pub,
                long long row_blocks, long long pad_blocks,
                uint4* __restrict__ out) {
  const long long b = blockIdx.x;
  if (b < row_blocks) {  // a short row a thread
    const long long r = b * kThreads + threadIdx.x;
    if (r >= n_short) return;
    const int lo = __ldg(indptr + r), hi = __ldg(indptr + r + 1);
    Fp<F> acc = bn254::zero<F>();
    for (int e = lo; e < hi; ++e)
      accumulate(acc, e, wires, cidx, coefs, wit);
    store2(out + 2 * slot(__ldg(dest + r), nc, m), acc);
    return;
  }
  if (b < row_blocks + pad_blocks) {  // a padding slot a thread
    const long long pad = m - nc;
    const long long t = (b - row_blocks) * kThreads + threadIdx.x;
    if (t >= 3 * pad) return;
    const long long s = t / pad, j = nc + (t - s * pad);
    const Fp<F> v = s == 0 && j - nc < n_pub ? load2<F>(wit + 2 * (j - nc))
                                             : bn254::zero<F>();
    store2(out + 2 * (s * m + j), v);
    return;
  }
  // a long row a warp; a whole warp returns together, so the shuffles
  // below see all 32 lanes
  const long long r = n_short +
                      (b - row_blocks - pad_blocks) * kWarpsPerBlock +
                      threadIdx.x / 32;
  if (r >= 3 * nc) return;
  const int lane = threadIdx.x & 31;
  const int lo = __ldg(indptr + r), hi = __ldg(indptr + r + 1);
  Fp<F> acc = bn254::zero<F>();
  for (int e = lo + lane; e < hi; e += 32)
    accumulate(acc, e, wires, cidx, coefs, wit);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Fp<F> other;
#pragma unroll
    for (int i = 0; i < bn254::N; ++i)
      other.v[i] = __shfl_down_sync(0xffffffffu, acc.v[i], off);
    acc = bn254::add(acc, other);
  }
  if (lane == 0) store2(out + 2 * slot(__ldg(dest + r), nc, m), acc);
}

template <int F, typename CI>
int launch(const void* indptr, const void* wires, const void* cidx,
           const void* coefs, const void* wit, const void* dest,
           long long n_short, long long nc, long long m, long long n_pub,
           void* out, cudaStream_t stream) {
  const long long row_blocks = (n_short + kThreads - 1) / kThreads;
  const long long pad_blocks = (3 * (m - nc) + kThreads - 1) / kThreads;
  const long long long_blocks =
      (3 * nc - n_short + kWarpsPerBlock - 1) / kWarpsPerBlock;
  r1cs_kernel<F, CI><<<(unsigned)(row_blocks + pad_blocks + long_blocks),
                       kThreads, 0, stream>>>(
      (const int*)indptr, (const int*)wires, (const CI*)cidx,
      (const uint4*)coefs, (const uint4*)wit, (const int*)dest, n_short, nc,
      m, n_pub, row_blocks, pad_blocks, (uint4*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// field: 1 BN254's Fr, 2 BLS12-381's (bn254.cuh rows)
extern "C" int r1cs_eval(int device, int field, const void* indptr,
                         const void* wires, const void* cidx, int cidx_bytes,
                         const void* coefs, const void* wit, const void* dest,
                         long long n_short, long long nc, long long m,
                         long long n_pub, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((cidx_bytes != 2 && cidx_bytes != 4) || m < nc || n_short > 3 * nc ||
      (field != 1 && field != 2))
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 1) {
    if (cidx_bytes == 2)
      return launch<1, int16_t>(indptr, wires, cidx, coefs, wit, dest,
                                n_short, nc, m, n_pub, out, s);
    return launch<1, int32_t>(indptr, wires, cidx, coefs, wit, dest, n_short,
                              nc, m, n_pub, out, s);
  }
  if (cidx_bytes == 2)
    return launch<2, int16_t>(indptr, wires, cidx, coefs, wit, dest, n_short,
                              nc, m, n_pub, out, s);
  return launch<2, int32_t>(indptr, wires, cidx, coefs, wit, dest, n_short,
                            nc, m, n_pub, out, s);
}
