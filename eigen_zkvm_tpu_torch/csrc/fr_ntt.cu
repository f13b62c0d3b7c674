// NTT passes and pointwise products over a Groth16 scalar field for Hopper
// (sm_90a), BN254's Fr or BLS12-381's (bn254.cuh rows 1 and 2, both eight
// limbs; the `field` argument of each entry): the quotient H = (A*B - C) /
// Z of a Groth16 prove.
//
// Replaces the transforms of eigen_zkvm_tpu/groth16/groth16.py::_witness_h
// (:315; its Python `_ntt` / `_intt` at :34-72, native/ec_curves.cpp's
// fr_witness_h on the host engine).  ops/fr_ntt.py runs a transform of 2^L
// values as a four-step of ceil(L / 11) passes of fr_ntt_pass, natural order
// in and out; fr_mul moves values in and out of Montgomery form, and
// fr_quotient forms (a*b - c) * Z(shift)^-1 on the coset.
//
// A pass of `bits` = b (<= 11) views its input as [2^b, 2^(L-b)] row-major
// and runs a length-2^b transform down every column.  A block holds a tile
// of 2^b rows by 2^lc adjacent columns (at most 2^11 values, 64 KB) in
// shared memory: it loads rows bit-reversed, runs b radix-2
// decimation-in-time stages in place, multiplies value (r, c) by the
// four-step factor w^((g r) 2^lo) with g = c >> lo (lo: the bits of the
// passes before; w the order-2^L root), and stores it to
// out[(g 2^b + r) 2^lo + (c mod 2^lo)].  The next pass's view is then the
// remaining transform of 2^(L - lo - b) rows, whose columns are (k, c mod
// 2^lo) with k this pass's output frequency: every value lands in natural
// order after the last pass (g = 0 there, so it has no factor), and no pass
// permutes its input in device memory.  The last pass of an inverse
// transform may multiply by a natural-order table (`post`: n^-1 and the
// coset shift's powers) on the way out.
//
// What bounds it: products.  A stage is one Montgomery product a
// butterfly, 580 SASS instructions (kernel_probe) against 64 bytes of
// shared-memory traffic; a pass moves each value through device memory
// once each way.  At 2^21 values the 21 stages and the factor need about
// 2^21 x 10.5 products, 0.8 ms of the card's integer issue, against 0.08
// ms for the two passes' 256 MB.  So the design keeps the integer pipe fed:
// three 64 KB tiles an SM at 85 registers at most, a 2^11-value tile of
// 1,024 butterflies over 256 threads between barriers, no product where the
// twiddle is 1 (a leaf's first stage, the factor's g = 0 or r = 0), and
// every access in a coalesced or conflict-free pattern:
//   - device memory: a thread moves 16 bytes, two adjacent threads a value;
//     short transforms take narrower tiles so that at least 512 tiles (or
//     one a column) keep 132 SMs busy;
//   - the tile: eight limb planes of 32-bit words, positions swizzled (the
//     low five bits XORed with the next ten), so a warp's bit-reversed scatter
//     and its butterflies' runs fall on distinct banks;
//   - twiddles: a stage's twiddles w_(2h)^j are contiguous in one table
//     ([h + j], read through the L1), the four-step factor comes from the
//     transform's own table w^j, j < n/2, with w^(j + n/2) = -w^j.
//
// Values are [n, 4] int64 words (32 bytes, little-endian limbs) in
// Montgomery form.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fp;

constexpr int kMaxBits = 11;    // a tile holds at most 2^11 values: 64 KB
constexpr int kMaxLogN = 28;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;   // three 64 KB tiles an SM
constexpr int kMinTiles = 512;  // tiles a pass should have, narrowing its tile
constexpr int kPointwiseThreads = 256;

// One value from device memory: two 16-byte loads
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

// The tile: eight limb planes of `plane` words (the tile's value count).
extern __shared__ uint32_t smem[];

// A tile position's word offset in its plane: the low five bits XORed with
// the next ten.  A bijection on any power-of-two tile; an aligned run of 32
// positions keeps 32 banks, and 32 bit-reversed rows spread over them.
__device__ __forceinline__ int swizzle(int p) {
  return p ^ ((p >> 5) & 31) ^ ((p >> 10) & 31);
}

template <int F>
__device__ __forceinline__ Fp<F> tile_load(int p, int plane) {
  const uint32_t* s = smem + swizzle(p);
  Fp<F> r;
#pragma unroll
  for (int l = 0; l < bn254::N; ++l) r.v[l] = s[l * plane];
  return r;
}

template <int F>
__device__ __forceinline__ void tile_store(int p, int plane,
                                           const Fp<F>& a) {
  uint32_t* s = smem + swizzle(p);
#pragma unroll
  for (int l = 0; l < bn254::N; ++l) s[l * plane] = a.v[l];
}

template <int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pass_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                const uint4* __restrict__ tw,
                const uint4* __restrict__ stage_tw,
                const uint4* __restrict__ post, int log_n, int lo, int bits,
                int log_cols) {
  const int cols = 1 << log_cols;
  const int plane = 1 << (bits + log_cols);
  const long long width = 1ll << (log_n - bits);
  const long long col0 = (long long)blockIdx.x << log_cols;

  // load: two threads a value, 16 bytes each; row r to tile row bitrev(r)
#pragma unroll 4
  for (int w = threadIdx.x; w < 2 * plane; w += blockDim.x) {
    const int half = w & 1;
    const int c = (w >> 1) & (cols - 1);
    const int r = w >> (1 + log_cols);
    const int rr = bits ? (int)(__brev((unsigned)r) >> (32 - bits)) : 0;
    const uint4 v = __ldg(in + ((r * width + col0 + c) * 2 + half));
    uint32_t* s = smem + 4 * half * plane + swizzle((rr << log_cols) | c);
    s[0] = v.x;
    s[plane] = v.y;
    s[2 * plane] = v.z;
    s[3 * plane] = v.w;
  }
  __syncthreads();

  // radix-2 decimation-in-time stages, in place; stage s (h = 2^s) takes
  // twiddle w_(2h)^j at stage_tw[h + j]
  for (int s = 0; s < bits; ++s) {
    const int h = 1 << s;
    for (int t = threadIdx.x; t < plane / 2; t += blockDim.x) {
      const int c = t & (cols - 1);
      const int i = t >> log_cols;
      const int j = i & (h - 1);
      const int p0 = ((((i >> s) << (s + 1)) | j) << log_cols) | c;
      const int p1 = p0 + (h << log_cols);
      const Fp<F> u = tile_load<F>(p0, plane);
      Fp<F> v = tile_load<F>(p1, plane);
      if (j != 0) v = bn254::mul(v, load2<F>(stage_tw + 2 * (h + j)));
      tile_store(p0, plane, bn254::add(u, v));
      tile_store(p1, plane, bn254::sub(u, v));
    }
    __syncthreads();
  }

  // the four-step factor (none where g = 0: every tile of the last pass),
  // and the last pass's scale
  const bool factor = ((col0 + cols - 1) >> lo) != 0;
  if (factor || post != nullptr) {
    const long long half_n = (1ll << log_n) >> 1;
    for (int t = threadIdx.x; t < plane; t += blockDim.x) {
      const int r = t >> log_cols;
      const long long c = col0 + (t & (cols - 1));
      const long long e = ((c >> lo) * r) << lo;
      if (e == 0 && post == nullptr) continue;
      Fp<F> v = tile_load<F>(t, plane);
      if (e != 0) {
        v = bn254::mul(v, load2<F>(tw + 2 * (e & (half_n - 1))));
        if (e >= half_n) v = bn254::neg(v);
      }
      if (post != nullptr)
        v = bn254::mul(v, load2<F>(post + 2 * (r * width + c)));
      tile_store(t, plane, v);
    }
    __syncthreads();
  }

  // store: two threads a value; (r, c) -> (g 2^b + r) 2^lo + (c mod 2^lo)
  const long long low = (1ll << lo) - 1;
#pragma unroll 4
  for (int w = threadIdx.x; w < 2 * plane; w += blockDim.x) {
    const int half = w & 1;
    const int c = (w >> 1) & (cols - 1);
    const int r = w >> (1 + log_cols);
    const long long cg = col0 + c;
    const long long o = ((((cg >> lo) << bits) + r) << lo) | (cg & low);
    const uint32_t* s =
        smem + 4 * half * plane + swizzle((r << log_cols) | c);
    out[o * 2 + half] = make_uint4(s[0], s[plane], s[2 * plane], s[3 * plane]);
  }
}

template <int F>
__global__ void __launch_bounds__(kPointwiseThreads)
    mul_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
               int b_step, uint4* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store2(out + 2 * i,
         bn254::mul(load2<F>(a + 2 * i), load2<F>(b + 2 * i * b_step)));
}

template <int F>
__global__ void __launch_bounds__(kPointwiseThreads)
    quotient_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const uint4* __restrict__ c, const uint4* __restrict__ k,
                    uint4* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<F> ab = bn254::mul(load2<F>(a + 2 * i), load2<F>(b + 2 * i));
  store2(out + 2 * i,
         bn254::mul(bn254::sub(ab, load2<F>(c + 2 * i)), load2<F>(k)));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kPointwiseThreads - 1) / kPointwiseThreads);
}


template <int F>
int launch_pass(const void* in, void* out, const void* tw,
                const void* stage_tw, const void* post, int log_n, int lo,
                int bits, cudaStream_t stream) {
  // the widest tile of at most 2^11 values that leaves kMinTiles tiles
  const long long width = 1ll << (log_n - bits);
  int log_cols = kMaxBits - bits;
  while (log_cols > 0 &&
         ((1ll << log_cols) > width || (width >> log_cols) < kMinTiles))
    --log_cols;
  const int values = 1 << (bits + log_cols);
  const int smem = (int)sizeof(Fp<F>) * values;
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Fp<F>) << kMaxBits);
  if (err != cudaSuccess) return (int)err;
  const int threads = values / 2 < 32 ? 32
                      : values / 2 > kThreads ? kThreads : values / 2;
  pass_kernel<F><<<(unsigned)(width >> log_cols), threads, smem, stream>>>(
      (const uint4*)in, (uint4*)out, (const uint4*)tw,
      (const uint4*)stage_tw, (const uint4*)post, log_n, lo, bits, log_cols);
  return (int)cudaGetLastError();
}

template <int F>
int launch_mul(const void* a, const void* b, int b_step, void* out,
               long long n, cudaStream_t stream) {
  mul_kernel<F><<<blocks_for(n), kPointwiseThreads, 0, stream>>>(
      (const uint4*)a, (const uint4*)b, b_step, (uint4*)out, n);
  return (int)cudaGetLastError();
}

template <int F>
int launch_quotient(const void* a, const void* b, const void* c,
                    const void* k, void* out, long long n,
                    cudaStream_t stream) {
  quotient_kernel<F><<<blocks_for(n), kPointwiseThreads, 0, stream>>>(
      (const uint4*)a, (const uint4*)b, (const uint4*)c, (const uint4*)k,
      (uint4*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// field: 1 BN254's Fr, 2 BLS12-381's (bn254.cuh rows).  One pass of a
// transform of 2^log_n values (see the top of the file): the length-2^bits
// transforms down the columns of `in` viewed as [2^bits, 2^(log_n -
// bits)], lo the bits of the passes before.  `tw[j]` = w^j for j < n/2,
// `stage_tw[h + j]` = w_(2h)^j for h = 2^s, s < min(log_n, 11), both from
// the transform's root (its inverse for an inverse transform); `post`
// (nullable, the last pass only) scales the output.  `in` and `out` must
// not overlap; every pointer 16-byte aligned.
extern "C" int fr_ntt_pass(int device, int field, const void* in, void* out,
                           const void* tw, const void* stage_tw,
                           const void* post, int log_n, int lo, int bits,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (log_n < 0 || log_n > kMaxLogN || bits < 0 || bits > kMaxBits ||
      lo < 0 || lo + bits > log_n ||
      (post != nullptr && lo + bits != log_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 1)
    return launch_pass<1>(in, out, tw, stage_tw, post, log_n, lo, bits, s);
  if (field == 2)
    return launch_pass<2>(in, out, tw, stage_tw, post, log_n, lo, bits, s);
  return (int)cudaErrorInvalidValue;
}

// out[i] = a[i] * b[i * b_step] (b_step 0: one value for all)
extern "C" int fr_mul(int device, int field, const void* a, const void* b,
                      int b_step, void* out, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (field != 1 && field != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return field == 1 ? launch_mul<1>(a, b, b_step, out, n, s)
                    : launch_mul<2>(a, b, b_step, out, n, s);
}

// out[i] = (a[i] * b[i] - c[i]) * k[0]
extern "C" int fr_quotient(int device, int field, const void* a,
                           const void* b, const void* c, const void* k,
                           void* out, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (field != 1 && field != 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return field == 1 ? launch_quotient<1>(a, b, c, k, out, n, s)
                    : launch_quotient<2>(a, b, c, k, out, n, s);
}
