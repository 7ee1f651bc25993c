// Per-example ghost gradient norms of a dense layer, hand-written for sm_90a.
//
// Replaces ghost_norm_pallas (src/repro/kernels/ghost_norm/kernel.py, body
// _ghost_norm_kernel).  For y = a @ W with activations a [B,S,d_in] and
// output cotangents g [B,S,d_out] (each float32 or bfloat16, independently),
// it writes out[b] = ||A_b^T G_b||_F^2 = sum_{s,t} (a_s . a_t)(g_s . g_t) in
// float32, without the [B,d_in,d_out] per-example gradients and without the
// [B,S,S] Gram matrices ever reaching device memory.
//
// What bounds it: the Grams are symmetric, so the function needs only their
// upper triangles, B*S*(S+1)*(d_in+d_out) operations, against one read of
// a and g.  At the training shapes (S = 256, d up to 49152) that is
// (S+1)/2 = 128.5 operations per byte in bf16, below the H100's ~295 (bf16
// tensor-core peak over HBM rate), so the least time is the bytes over
// 3.35 TB/s.  This first kernel is SIMT float32, so it runs against the
// 67 TFLOP/s float32 rate, and is compute-bound far above that least time.
//
// Design (simple first): the (s, t) plane is cut into 64 x 64 tiles; one
// block of 256 threads owns one tile of one example, and only tiles with
// t >= s run, the off-diagonal ones counted twice (the Grams are
// symmetric).  The block loops over the feature axis in chunks of 32
// columns: each chunk of the s rows and of the t rows is staged in shared
// memory as float32, transposed so each thread reads its four s values and
// four t values as 16-byte vectors, and each thread accumulates a 4 x 4
// micro-tile of the Gram in registers.  The next chunk's global loads are
// issued before the current chunk's products, so their latency hides
// behind the math.  The a-Gram and the g-Gram of a tile land in the same
// registers of the same thread, so their elementwise product is summed
// there, then across the block (warp shuffles, then eight warp sums in a
// fixed order), and written to a [B, n_pairs] float32 scratch.  A second
// kernel sums each example's row of that scratch in ascending order.  No
// atomics: the norms set the clip factors, so they must be the same from
// run to run.  Rows past S and columns past d load as zeros, so any S and
// any d work (the TPU wrapper pads S to the block instead).  Tensor cores
// (wgmma, TMA loads) are later work.
//
// Plain C interface for ctypes: ghost_norm_launch() launches both kernels
// on the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                 // rows of s (and of t) per block
constexpr int kChunk = 32;                // feature columns per staged chunk
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 each
constexpr int kLd = kTile + 4;            // shared row stride, 16-byte rows
constexpr int kRowsPerPass = kThreads / kChunk;           // 8
constexpr int kLoads = kTile * kChunk / kThreads;         // 8 per thread
static_assert(kTile == 4 * 16, "16 x 16 threads of 4 x 4 outputs");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows row0 .. row0+63, columns k0 .. k0+31 of x [S, d] into registers;
// zeros outside [0, S) x [0, d).  Neighbouring threads read neighbouring
// columns of one row.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, int S,
                                           int d, int row0, int k0,
                                           float (&r)[kLoads]) {
  const int col = k0 + (threadIdx.x % kChunk);
  const int rbase = row0 + threadIdx.x / kChunk;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int row = rbase + j * kRowsPerPass;
    r[j] = (row < S && col < d) ? to_float(x[(int64_t)row * d + col]) : 0.f;
  }
}

// The registers of load_chunk into shared memory, transposed: sm[col][row].
__device__ __forceinline__ void store_chunk(float* sm,
                                            const float (&r)[kLoads]) {
  const int c = threadIdx.x % kChunk;
  const int rbase = threadIdx.x / kChunk;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) sm[c * kLd + rbase + j * kRowsPerPass] = r[j];
}

// acc[i][j] = sum_k x[s0 + 4*ty + i, k] * x[t0 + 4*tx + j, k] over [0, d).
template <typename T>
__device__ void gram_tile(const T* __restrict__ x, int S, int d, int s0,
                          int t0, float* sm_s, float* sm_t,
                          float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float rs[kLoads], rt[kLoads];
  load_chunk(x, S, d, s0, 0, rs);
  load_chunk(x, S, d, t0, 0, rt);
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();  // every thread is done reading the previous chunk
    store_chunk(sm_s, rs);
    store_chunk(sm_t, rt);
    __syncthreads();
    if (k0 + kChunk < d) {  // the next chunk's loads fly under this math
      load_chunk(x, S, d, s0, k0 + kChunk, rs);
      load_chunk(x, S, d, t0, k0 + kChunk, rt);
    }
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(sm_s + k * kLd + 4 * ty);
      const float4 v = *reinterpret_cast<const float4*>(sm_t + k * kLd + 4 * tx);
      const float us[4] = {u.x, u.y, u.z, u.w};
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(us[i], vs[j], acc[i][j]);
    }
  }
}

// One block per (upper-triangle tile pair, example): the tile's share of
// out[b], written to partial[b, pair].
template <typename TA, typename TG>
__global__ void __launch_bounds__(kThreads)
    ghost_norm_tiles(const TA* __restrict__ a, const TG* __restrict__ g,
                     float* __restrict__ partial, int S, int d_in, int d_out,
                     int n_tiles, int n_pairs) {
  __shared__ __align__(16) float sm_s[kChunk * kLd];
  __shared__ __align__(16) float sm_t[kChunk * kLd];
  __shared__ float warp_sums[kThreads / 32];
  const int pair = blockIdx.x, b = blockIdx.y;
  int si = 0, rest = pair;  // pair -> (si, ti), ti >= si, row by row
  while (rest >= n_tiles - si) {
    rest -= n_tiles - si;
    ++si;
  }
  const int ti = si + rest;

  float aa[4][4] = {}, gg[4][4] = {};
  gram_tile(a + (int64_t)b * S * d_in, S, d_in, si * kTile, ti * kTile, sm_s,
            sm_t, aa);
  gram_tile(g + (int64_t)b * S * d_out, S, d_out, si * kTile, ti * kTile,
            sm_s, sm_t, gg);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum = fmaf(aa[i][j], gg[i][j], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[(int64_t)b * n_pairs + pair] = (si == ti ? 1.f : 2.f) * total;
  }
}

// out[b] = sum over pairs of partial[b, pair], in ascending pair order.
__global__ void ghost_norm_rows(const float* __restrict__ partial,
                                float* __restrict__ out, int B, int n_pairs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* row = partial + (int64_t)b * n_pairs;
  float total = 0.f;
  for (int p = 0; p < n_pairs; ++p) total += row[p];
  out[b] = total;
}

template <typename TA, typename TG>
void launch_tiles(const void* a, const void* g, float* partial, int B, int S,
                  int d_in, int d_out, int n_tiles, int n_pairs,
                  cudaStream_t s) {
  const dim3 grid(n_pairs, B);
  ghost_norm_tiles<TA, TG><<<grid, kThreads, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TG*>(g), partial, S, d_in,
      d_out, n_tiles, n_pairs);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  partial is float32 [B, n_pairs]
// with n_tiles = ceil(S / 64) and n_pairs = n_tiles * (n_tiles + 1) / 2.
extern "C" int ghost_norm_launch(const void* a, const void* g, void* partial,
                                 void* out, int B, int S, int d_in, int d_out,
                                 int a_dtype, int g_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  float* part = static_cast<float*>(partial);
  switch (a_dtype * 2 + g_dtype) {
    case 0:
      launch_tiles<float, float>(a, g, part, B, S, d_in, d_out, n_tiles,
                                 n_pairs, s);
      break;
    case 1:
      launch_tiles<float, __nv_bfloat16>(a, g, part, B, S, d_in, d_out,
                                         n_tiles, n_pairs, s);
      break;
    case 2:
      launch_tiles<__nv_bfloat16, float>(a, g, part, B, S, d_in, d_out,
                                         n_tiles, n_pairs, s);
      break;
    case 3:
      launch_tiles<__nv_bfloat16, __nv_bfloat16>(a, g, part, B, S, d_in,
                                                 d_out, n_tiles, n_pairs, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ghost_norm_rows<<<(B + 127) / 128, 128, 0, s>>>(part, static_cast<float*>(out),
                                                  B, n_pairs);
  return (int)cudaGetLastError();
}
