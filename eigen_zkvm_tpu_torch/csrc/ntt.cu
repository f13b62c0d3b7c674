// Goldilocks NTT leaf kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel eigen_zkvm_tpu/ops/ntt_pallas.py::_kernel (with
// its _rec_ntt / _stockham_axis0 body): a length-2^a NTT along axis 0 of a
// [2^a, M] matrix, natural order in and out.  ops/ntt.py composes longer
// transforms from it as a four-step, as ntt_pallas.ntt does.
//
// What bounds it on the card: the number of integer instructions first (a
// butterfly is a field product, an add and a subtract, all on the SM's 64
// integer lanes), device-memory traffic second (16 bytes a value a pass).
//
// What the design does about both:
//   - a block holds a [2^a, cols] tile in shared memory for a up to 11
//     (128 KB at 8 columns), so a transform of up to 2^22 rows is two passes
//     over device memory; narrow tiles keep 64 contiguous bytes a row, and
//     short transforms take wider tiles (8192 values) to keep a block busy;
//   - the stages run three or four at a time in registers: a thread loads
//     the 8 or 16 values of a radix-8 / radix-16 butterfly, multiplies each
//     by one table twiddle, and runs the inner stages with twiddles that are
//     powers of two (2 has order 192 in the field and the repo's roots of
//     order 2, 4, 8, 16 are 2^96, 2^48, 2^120, 2^156): a shift and a short
//     reduction in place of a product and a table load.  Shared-memory
//     round trips and barriers fall from one a stage to one every three or
//     four stages;
//   - the table twiddles (w^j, j < n) are copied beside the tile, so a pass
//     reads them from shared memory;
//   - rows of the input at and above `rows_in` are taken as zero and never
//     read, so a low-degree extension needs no zero-padded copy;
//   - the tile is loaded and stored 16 bytes a thread where rows allow it
//     (even M, and even P for the store), several rows in flight a thread;
//   - the four-step twiddle multiply, the transpose that follows it, and the
//     coset scale of an LDE are fused into the store.
//
// Arguments: `in` [rows_in, M] row-major, rows_in <= n = 2^log_n; `roots[j]`
// = w^j for j < n, w the transform's root of order n, which is the field's
// canonical root of that order (`inverse` = 0) or its inverse (1); `post`
// (nullable) multiplies output element (r, c) by post[(r * M + c) / P]; with
// `transpose`, output element (r, c) with c = g * P + p goes to
// out[(g * n + r) * P + p], i.e. out is [M / P, n * P].  `in` and `out` must
// not overlap.
#include <cstdint>

#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int kMaxLogN = 11;
constexpr int kMaxRadixBits = 4;  // stages a pass runs in registers
constexpr int kTileBytes = 64 * 1024;  // wide tiles of short transforms
// Launch shapes, by measurement on the H100: the kernel issues integer
// instructions nearly back to back, and more resident warps hide what
// latency is left, so registers are capped for occupancy as far as ptxas
// needs no spills: 256 threads and at least 3 blocks an SM (80 registers,
// three 72 KB tiles) up to 2^10 rows, and one block of 896 threads (72
// registers) for the 128 KB tile of 2^11 rows.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;
constexpr int kThreadsBig = 896;

// 2^root_exp(t) is the canonical root of unity of order 2^t, t <= 4
__host__ __device__ constexpr int root_exp(int t) {
  return t == 1 ? 96 : t == 2 ? 48 : t == 3 ? 120 : 156;
}

// the low `bits` (<= 4) bits of k reversed; no loop, so it folds to a
// constant wherever k does
__host__ __device__ constexpr int bit_reverse(int k, int bits) {
  return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) | ((k & 8) >> 3)) >>
         (4 - bits);
}

// Radix-2^LOG decimation-in-time butterfly on registers: v holds the LOG-bit
// sub-transforms in bit-reversed order, and leaves their combination in
// natural order.  Every twiddle is a power of two.  Canonical in and out.
template <int LOG, bool INV>
__device__ __forceinline__ void butterfly(uint64_t (&v)[1 << LOG]) {
  constexpr int R = 1 << LOG;
#pragma unroll
  for (int t = 1; t <= LOG; ++t) {
    const int half = 1 << (t - 1);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int m = i & (half - 1);
      const int i0 = ((i >> (t - 1)) << t) + m;
      const int i1 = i0 + half;
      int k = (root_exp(t) * m) % 192;
      if (INV) k = (192 - k) % 192;
      const bool negate = k >= 96;   // 2^96 = -1
      if (negate) k -= 96;
      const uint64_t x = k == 0 ? v[i1] : gl::mul_pow2_small<true>(v[i1], k);
      const uint64_t u = v[i0];
      v[i0] = negate ? gl::sub(u, x) : gl::add(u, x);
      v[i1] = negate ? gl::add(u, x) : gl::sub(u, x);
    }
  }
}

// The block's shared memory: the tile [n][cols], then the table twiddles
// w^j, j < n.  Addressed by offset, so every access is a 32-bit
// shared-memory address.
extern __shared__ __align__(16) uint64_t smem[];

// Stages s0+1 .. s0+LOG of the in-place decimation-in-time ladder over the
// tile (rows in bit-reversed order before stage 1).  A thread owns the 2^LOG
// rows that differ in bits s0 .. s0+LOG-1, scales row k by the table twiddle
// w_(2^(s0+LOG))^(j0 * bitrev(k)), j0 the row's low s0 bits, and runs the
// butterfly.
template <int LOG, bool INV>
__device__ __forceinline__ void run_pass(int log_n, int s0, int log_cols) {
  constexpr int R = 1 << LOG;
  const int items = ((1 << log_n) >> LOG) << log_cols;
  const int tw_shift = log_n - s0 - LOG;
  const int stride = 1 << (s0 + log_cols);
  const int roots = 1 << (log_n + log_cols);  // where the twiddles start
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int c = w & ((1 << log_cols) - 1);
    const int g = w >> log_cols;
    const int j0 = g & ((1 << s0) - 1);
    const int at = ((((g >> s0) << (s0 + LOG)) | j0) << log_cols) + c;
    uint64_t v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = smem[at + k * stride];
    if (s0 != 0) {
      const int step = j0 << tw_shift;
#pragma unroll
      for (int k = 1; k < R; ++k)
        v[k] = gl::mul(v[k], smem[roots + step * bit_reverse(k, LOG)]);
    }
    butterfly<LOG, INV>(v);
#pragma unroll
    for (int k = 0; k < R; ++k) smem[at + k * stride] = v[k];
  }
}

template <bool INV>
__device__ __forceinline__ void run_passes(int log_n, int log_cols) {
  // ceil(log_n / 4) passes of as even a depth as possible, deepest first
  const int passes = (log_n + 3) / 4;
  const int depth = passes ? log_n / passes : 0;
  const int deeper = passes ? log_n % passes : 0;
  int s0 = 0;
  for (int p = 0; p < passes; ++p) {
    const int log_r = depth + (p < deeper);
    switch (log_r) {
      case 1: run_pass<1, INV>(log_n, s0, log_cols); break;
      case 2: run_pass<2, INV>(log_n, s0, log_cols); break;
      case 3: run_pass<3, INV>(log_n, s0, log_cols); break;
      default: run_pass<4, INV>(log_n, s0, log_cols); break;
    }
    s0 += log_r;
    __syncthreads();
  }
}

// VEC values (1 or 2, 8 or 16 bytes) a thread moves at a time, UNROLL
// accesses in flight a thread
template <int VEC, int UNROLL>
__device__ __forceinline__ void load_tile(const uint64_t* __restrict__ in,
                                          int log_n, int rows_in, long long M,
                                          long long col0, int log_cols) {
  const int log_w = log_cols - (VEC == 2);  // accesses a row
  const int total = 1 << (log_n + log_w);
#pragma unroll UNROLL
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int c = (w & ((1 << log_w) - 1)) * VEC;
    const int r = w >> log_w;
    const int rr = log_n ? (int)(__brev((unsigned)r) >> (32 - log_n)) : 0;
    const bool has = r < rows_in && col0 + c < M;
    uint64_t* dst = smem + ((rr << log_cols) + c);
    const uint64_t* src = in + ((long long)r * M + col0 + c);
    if (VEC == 2) {
      *reinterpret_cast<ulonglong2*>(dst) =
          has ? *reinterpret_cast<const ulonglong2*>(src)
              : make_ulonglong2(0, 0);
    } else {
      *dst = has ? *src : 0;
    }
  }
}

template <int VEC, int UNROLL>
__device__ __forceinline__ void store_tile(uint64_t* __restrict__ out,
                                           const uint64_t* __restrict__ post,
                                           int log_n, long long M, long long P,
                                           int transpose, long long col0,
                                           int log_cols) {
  const int log_w = log_cols - (VEC == 2);
  const int total = 1 << (log_n + log_w);
  const long long n = 1ll << log_n;
  const long long G = M / P;
#pragma unroll UNROLL
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int lc = (w & ((1 << log_w) - 1)) * VEC;
    const int r = w >> log_w;
    const long long c = col0 + lc;
    if (c >= M) continue;
    const long long g = c / P;
    const long long p = c - g * P;
    const uint64_t* src = smem + ((r << log_cols) + lc);
    uint64_t* dst = out + (transpose ? ((g * n + r) * P + p)
                                     : ((long long)r * M + c));
    const uint64_t scale = post != nullptr ? post[(long long)r * G + g] : 1;
    if (VEC == 2) {  // P is even: both values lie in group g, side by side
      ulonglong2 v = *reinterpret_cast<const ulonglong2*>(src);
      if (post != nullptr) {
        v.x = gl::mul(v.x, scale);
        v.y = gl::mul(v.y, scale);
      }
      *reinterpret_cast<ulonglong2*>(dst) = v;
    } else {
      *dst = post != nullptr ? gl::mul(*src, scale) : *src;
    }
  }
}

template <bool BIG>
__global__ void __launch_bounds__(BIG ? kThreadsBig : kThreads,
                                  BIG ? 1 : kMinBlocks)
ntt_leaf_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                const uint64_t* __restrict__ roots,
                const uint64_t* __restrict__ post, int log_n, int rows_in,
                long long M, long long P, int transpose, int inverse,
                int log_cols, int vec_in, int vec_out) {
  const long long col0 = (long long)blockIdx.x << log_cols;
  // as many tile accesses in flight as ptxas fits into the registers the
  // launch bounds leave without spilling
  constexpr int kUnroll = BIG ? 4 : 2;

  // the table twiddles beside the tile: a pass then reads them with short
  // shared-memory addresses and latencies, which keeps its registers few
  if (log_n > kMaxRadixBits)  // a single pass uses no table twiddle
    for (int j = threadIdx.x; j < 1 << log_n; j += blockDim.x)
      smem[(1 << (log_n + log_cols)) + j] = roots[j];

  // bit-reversed load: the in-place ladder then ends in natural order
  if (vec_in)
    load_tile<2, kUnroll>(in, log_n, rows_in, M, col0, log_cols);
  else
    load_tile<1, kUnroll>(in, log_n, rows_in, M, col0, log_cols);
  __syncthreads();

  if (inverse)
    run_passes<true>(log_n, log_cols);
  else
    run_passes<false>(log_n, log_cols);

  if (vec_out)
    store_tile<2, kUnroll>(out, post, log_n, M, P, transpose, col0, log_cols);
  else
    store_tile<1, kUnroll>(out, post, log_n, M, P, transpose, col0, log_cols);
}

}  // namespace

// The columns a block's tile holds for a transform of 2^log_n rows of M
// columns, as a power of two: 8 for long transforms (the tile is then up to
// 128 KB), else as many as fill kTileBytes, but no more than M needs.
extern "C" int ntt_leaf_log_cols(int log_n, long long M) {
  int log_cols = 3;
  while (log_cols < 8 && ((sizeof(uint64_t) << (log_n + log_cols + 1))
                          <= kTileBytes))
    ++log_cols;
  while (log_cols > 3 && (1ll << (log_cols - 1)) >= M) --log_cols;
  return log_cols;
}

extern "C" int ntt_leaf(int device, const void* in, void* out,
                        const void* roots, const void* post, int log_n,
                        int rows_in, long long M, long long P, int transpose,
                        int inverse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (log_n < 0 || log_n > kMaxLogN || rows_in < 0 || rows_in > (1 << log_n))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int log_cols = ntt_leaf_log_cols(log_n, M);
  const int smem = (int)sizeof(uint64_t) *
                   ((1 << (log_n + log_cols)) +
                    (log_n > kMaxRadixBits ? 1 << log_n : 0));
  // one block a SM at the largest tile: more threads to cover latencies
  const bool big = log_n == kMaxLogN;
  const int threads = big ? kThreadsBig : kThreads;
  auto kernel = big ? ntt_leaf_kernel<true> : ntt_leaf_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (M + (1ll << log_cols) - 1) >> log_cols;
  // 16-byte accesses: tiles start at even columns, so even M keeps every
  // pair inside a row and even P inside a group
  const int vec_in = M % 2 == 0 && (uintptr_t)in % 16 == 0;
  const int vec_out = M % 2 == 0 && P % 2 == 0 && (uintptr_t)out % 16 == 0;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)roots,
      (const uint64_t*)post, log_n, rows_in, M, P, transpose, inverse,
      log_cols, vec_in, vec_out);
  return (int)cudaGetLastError();
}
