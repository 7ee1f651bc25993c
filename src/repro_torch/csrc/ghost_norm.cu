// Per-example ghost gradient norms of a dense layer, hand-written for sm_90a.
//
// Replaces ghost_norm_pallas (src/repro/kernels/ghost_norm/kernel.py:44, body
// _ghost_norm_kernel).  For y = a @ W with activations a [B,S,d_in] and
// output cotangents g [B,S,d_out] (each float32 or bfloat16, independently),
// it writes out[b] = ||A_b^T G_b||_F^2 = sum_{s,t} (a_s . a_t)(g_s . g_t) in
// float32, without the [B,d_in,d_out] per-example gradients and without the
// [B,S,S] Gram matrices ever reaching device memory.
//
// What bounds it.  The Grams are symmetric, so the function needs only their
// upper triangles, B*S*(S+1)*(d_in+d_out) operations, against one read of a
// and g.  bfloat16: (S+1)/2 = 128.5 operations per byte at the training
// shapes (S = 256), below the ~295 at which the H100's bf16 tensor cores
// (989 TFLOP/s) outrun its memory (3.35 TB/s), so bytes bound it.  float32,
// by 3xTF32 (below): three TF32 products per product, so 3 * operations
// over 495 TFLOP/s against 4-byte elements over 3.35 TB/s; at S = 256 the
// operations bound it, by about 30%.  What the design does about each:
// both Grams run on the tensor cores; every byte reaches shared memory by
// cp.async through a ring that keeps the next chunks in flight while one
// is multiplied; an example's tile pairs are neighbouring blocks, so each
// row tile, which 4 pairs read at S = 256, comes from L2 after its first
// read.  What is left on an H100: in bf16 the reads from L2 into the SMs
// (the 4 reads of every row), in float32 the rate of mma.sync's TF32
// products, well under wgmma's.
//
// Tiles.  The (s, t) plane is cut into 64 x 64 tiles, and only tiles with
// t >= s run, the off-diagonal ones counted twice.  A block of 4 warps owns
// one tile of one example (or a share of its feature axis, below); each
// warp owns a 32 x 32 quarter of both Grams (2 x 4 accumulator tiles of
// m16n8, 32 float32 registers a thread).  The block walks the feature axis
// in chunks of 128 bytes per row (64 bf16 or 32 float32 columns): first
// every chunk of a, then every chunk of g, through one ring, so the switch
// from the a-Gram to the g-Gram costs nothing; a's finished Gram waits in
// shared memory (16 KB a block) while g's is formed.  A chunk's 64 s rows
// and 64 t rows sit in shared memory as they are in device memory (nothing
// is widened or transposed), rows padded by 16 bytes so that the 8 row
// addresses of an ldmatrix hit 8 distinct 4-bank groups.  A diagonal tile
// (s = t) loads its rows once and feeds them as both operands, and its
// lower-left quarter (the upper-right one transposed) is skipped and the
// upper-right counted twice.  The ring holds 3 chunks where both operands
// are bf16 (the loads bound it) and 2 otherwise (Config: fewer registers
// and less shared memory, so 4 blocks per SM hide the TF32 products'
// latency).
//
// Products.  A Gram X X^T reads rows on both sides, and its K (the feature
// axis) is contiguous in memory, so the s rows are mma's row-major A and
// the t rows its column-major B, both by ldmatrix.x4 without transpose.
// One K-step is 32 bytes in either dtype, and the ldmatrix of a 16-byte
// row piece hands lane l the 4 bytes at row l / 4, byte 4 (l % 4): for
// bf16 that is the pair (2 tq, 2 tq + 1) of m16n8k16's fragments, for
// float32 the element tq of m16n8k8.tf32's (a0: rows gq, k tq; a1: rows
// gq + 8; a2, a3: k tq + 4; b0: k tq, b1: k tq + 4).  So one address
// pattern loads both, and only the instruction differs:
//   bfloat16: mma.sync m16n8k16 bf16 x bf16 -> float32 (exact products);
//   float32:  3xTF32 on mma.sync m16n8k8 (CUTLASS's OpMultiplyAddFastF32):
//             hi and lo = x - hi, each rounded to TF32 to nearest (ties
//             away), and the sum gets lo*hi + hi*lo + hi*hi in float32.
//             x - hi is exact; lo is rounded again, since the tensor core
//             would truncate its low 13 bits; the dropped lo*lo is ~2^-22
//             of a product.  One TF32 product (hi*hi) would keep ~2^-11 and
//             break the float32 limits (tests/test_torch_ghost_norm.py
//             shows it).
// The tensor cores add into their float32 accumulator without rounding to
// nearest: with every K-step of a Gram in one accumulator, the head's
// 3,072 bf16 K-steps (49,152 columns) came out 2.5e-4 below the plain
// version on an H100, biased, past its rtol 1e-4.  So each chunk's
// products (4 K-steps: 4 mma.sync per accumulator tile in bf16, 12 in
// float32) go into a fresh accumulator, which the CUDA cores then add to
// the running Gram, rounding to nearest: 32 FADDs a thread per chunk.  The
// kernel then comes within 4e-7 of a float64 reference there, closer than
// the plain version's float32 products.
// Both instructions leave the same m16n8 float32 accumulator layout, so the
// a-Gram (in a's dtype) and the g-Gram (in g's) of one (s, t) element sit
// in the same register of the same thread for every dtype pair, and
// sum aa * gg is formed there, then over the warp (shuffles), then over the
// block's 4 warps in a fixed order, and written to a [B, n_pairs] float32
// scratch.  A last kernel, a programmatic dependent launch, sums each
// example's row of it in ascending pair order.  No atomics: the norms set
// the clip factors, so they must be the same from run to run, bit for bit.
//
// Split feature axis.  B * n_pairs blocks (160 at B = 16, S = 256) load
// 132 SMs unevenly: 28 of them run two blocks.  So `split` blocks (the
// wrapper's split_plan, from the shapes and the SM count only: 2 or 4 at
// the training shapes but for the narrowest bf16 ones) may share a tile
// pair, each taking an equal share of its chunks (of a and g together) and
// writing its two partial Grams to a float32 scratch; a third kernel adds
// the ranks' Grams in rank order and forms sum aa * gg.  On an H100 that
// costs 5 to 20 us of scratch traffic and still gains at every shape where
// split_plan splits: most at the head, 2.1 -> 1.3 ms in float32.  (A
// thread-block cluster adding the ranks through distributed shared memory
// was slower: its blocks are scheduled a GPC at a time.)
//
// Ragged shapes.  Rows past S and bytes past a row's end are zero-filled
// in shared memory (cp.async's src-size), so any S and any d work.  Each
// copy is 16 bytes where a's (or g's) base address and row length in
// bytes are multiples of 16; otherwise the launcher picks 8, 4 or (bf16
// only) 2 bytes from them before the launch, and a 2-byte copy is a plain
// load and store.
//
// Plain C interface for ctypes: ghost_norm_launch() launches its two or
// three kernels on the given stream, does not synchronise, and returns the
// first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                  // rows of s (and of t) per block
constexpr int kWarps = 4;                  // each a 32 x 32 quarter
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkBytes = 128;           // feature bytes per row and chunk
constexpr int kRowBytes = kChunkBytes + 16;  // padded shared-memory row
constexpr int kOperandBytes = kTile * kRowBytes;
constexpr int kStageBytes = 2 * kOperandBytes;  // s rows, then t rows
constexpr int kParkBytes = 32 * kThreads * 4;  // one Gram, 32 floats a thread
constexpr int kKSteps = kChunkBytes / 32;  // 32-byte K-steps per chunk

// `bytes` from global to shared memory, asynchronously; the last
// `bytes - n` of them are zero-filled (src must still be a valid address)
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(Bytes), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one operand's rows row0 .. row0 + 63, feature bytes col .. col + 127, of
// x (S rows of row_bytes bytes) into a padded shared-memory tile.  Thread
// t owns the 16-byte slot t % 8 of rows t / 8 + 16 j (j < 4), and copies
// it as 16 / Bytes pieces of Bytes bytes, Bytes dividing row_bytes and x's
// address; a piece past the row's end or a row past S is zeros.
template <int Bytes>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const unsigned char* x, int S,
                                          int64_t row_bytes, int row0,
                                          int64_t col) {
  const int cb = (threadIdx.x & 7) * 16;
  const int64_t left = row_bytes - col - cb;  // the slot's bytes in the row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (threadIdx.x >> 3) + 16 * j;
    const bool row_ok = row0 + r < S;
    const unsigned char* src =
        row_ok ? x + (int64_t)(row0 + r) * row_bytes + col + cb : x;
    unsigned char* d = dst + r * kRowBytes + cb;
#pragma unroll
    for (int k = 0; k < 16; k += Bytes) {
      const bool ok = row_ok && left > k;
      if constexpr (Bytes >= 4) {
        cp_async<Bytes>(d + k, ok ? src + k : x, ok ? Bytes : 0);
      } else {  // rows of an odd number of bf16 columns: no cp.async
        *reinterpret_cast<unsigned short*>(d + k) =
            ok ? *reinterpret_cast<const unsigned short*>(src + k) : 0;
      }
    }
  }
}

__device__ __forceinline__ void load_chunk(unsigned char* stage,
                                           const unsigned char* x, int S,
                                           int64_t row_bytes, int vec, int s0,
                                           int t0, int64_t col) {
  const bool diag = s0 == t0;
  switch (vec) {
    case 16:
      load_rows<16>(stage, x, S, row_bytes, s0, col);
      if (!diag) load_rows<16>(stage + kOperandBytes, x, S, row_bytes, t0, col);
      break;
    case 8:
      load_rows<8>(stage, x, S, row_bytes, s0, col);
      if (!diag) load_rows<8>(stage + kOperandBytes, x, S, row_bytes, t0, col);
      break;
    case 4:
      load_rows<4>(stage, x, S, row_bytes, s0, col);
      if (!diag) load_rows<4>(stage + kOperandBytes, x, S, row_bytes, t0, col);
      break;
    default:
      load_rows<2>(stage, x, S, row_bytes, s0, col);
      if (!diag) load_rows<2>(stage + kOperandBytes, x, S, row_bytes, t0, col);
      break;
  }
}

// four 8 x 16-byte matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives the 4 bytes at row
// l / 4, byte 4 (l % 4) of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D (16x8, float32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16x8, float32) += A (16x8, tf32, row-major) * B (8x8, tf32, col-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the float32 in x's bits as hi + lo, each rounded to tf32 as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero): half a unit of
// tf32's last place is added to the magnitude bits, and the tensor core
// reads only the top 19 bits of an operand, so it sees the rounded value.
// hi's low 13 bits are cleared before x - hi (exact); lo is rounded the
// same way.  cvt.rna itself also checks for infinities and NaNs, which
// costs three more instructions an element; here a non-finite input comes
// out NaN (the plain version's inf or NaN).
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  hi = x + 0x1000u;
  lo = __float_as_uint(__uint_as_float(x) -
                       __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// acc[mt][nt] += this warp's quarter of (s rows) (t rows)^T over one chunk
// of 128 bytes per row, in T's arithmetic: the chunk's products go into a
// fresh float32 sum on the tensor cores, which is then added to acc on the
// CUDA cores (round to nearest).  A fragments: matrix i of an
// ldmatrix is rows 8 (i % 2) .. + 7 of an m16 tile at bytes 16 (i / 2) of
// the K-step; B fragments: rows 8 (i / 2) .. + 7 of a pair of n8 tiles at
// bytes 16 (i % 2).
template <typename T>
__device__ __forceinline__ void gram_chunk(const unsigned char* s_tile,
                                           const unsigned char* t_tile,
                                           int wm, int wn,
                                           float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const unsigned char* a_row =
      s_tile + (32 * wm + 8 * (mi & 1) + (lane & 7)) * kRowBytes +
      16 * (mi >> 1);
  const unsigned char* b_row =
      t_tile + (32 * wn + 8 * (mi >> 1) + (lane & 7)) * kRowBytes +
      16 * (mi & 1);
  float part[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[m][n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    unsigned af[2][4], bf[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ldmatrix_x4(af[m], a_row + 16 * m * kRowBytes + 32 * ks);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4(bf[np], b_row + 16 * np * kRowBytes + 32 * ks);
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(part[m][n], af[m], bf[n >> 1][2 * (n & 1)],
                   bf[n >> 1][2 * (n & 1) + 1]);
    } else {
      unsigned ah[2][4], al[2][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int m = 0; m < 2; ++m) split_tf32(af[m][i], ah[m][i], al[m][i]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          split_tf32(bf[np][i], bh[np][i], bl[np][i]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int np = n >> 1, j = 2 * (n & 1);
          mma_tf32(part[m][n], al[m], bh[np][j], bh[np][j + 1]);
          mma_tf32(part[m][n], ah[m], bl[np][j], bl[np][j + 1]);
          mma_tf32(part[m][n], ah[m], bh[np][j], bh[np][j + 1]);
        }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
}

// The ring's depth and the blocks that must stay resident per SM, per
// (a, g) dtype pair.  Both bf16: the loads bound the kernel, so three
// stages and three blocks per SM (145 registers).  Any float32 operand:
// the 3xTF32 products bound it, so two stages, which leave room for four
// blocks per SM (128 registers) to hide their latency.  Shared memory: the
// ring, then the a-Gram while g's is formed.
template <typename TA, typename TG>
struct Config {
  static constexpr bool kBf16 = sizeof(TA) == 2 && sizeof(TG) == 2;
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int kMinBlocks = kBf16 ? 3 : 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = kRingBytes + kParkBytes;  // 71,680; 53,248
};

// Sum a thread's share of sum aa * gg over the block and write it to
// *dst: warp shuffles, then the 4 warps in a fixed order.  Off-diagonal
// tiles count twice; on a diagonal tile the upper-right quarter (warp 1)
// counts twice and the lower-left one (warp 2, its transpose) not at all.
__device__ __forceinline__ void finish_tile(float sum, bool diag,
                                            float* warp_sums, float* dst) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0)
    warp_sums[warp] = (!diag || wm < wn) ? 2.f * sum : (wm > wn ? 0.f : sum);
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    *dst = total;
  }
}

// (si, ti), ti >= si, of an upper-triangle tile pair, numbered row by row
__device__ __forceinline__ void pair_tiles(int pair, int n_tiles, int& si,
                                           int& ti) {
  int rest = pair;
  si = 0;
  while (rest >= n_tiles - si) {
    rest -= n_tiles - si;
    ++si;
  }
  ti = si + rest;
}

// One block per (upper-triangle tile pair, share of the chunks, example):
// blockIdx.x = pair * split + rank.  With split = 1 the block writes the
// tile's share of out[b] to partial[b, pair]; otherwise it writes its
// partial Grams, 2 x 32 floats a thread, to
// scratch[b][pair][rank][Gram][32][kThreads] for ghost_norm_combine.
// vec_a, vec_g: bytes per copy.
template <typename TA, typename TG>
__global__ void __launch_bounds__(kThreads, (Config<TA, TG>::kMinBlocks))
    ghost_norm_tiles(const TA* __restrict__ a, const TG* __restrict__ g,
                     float* __restrict__ partial, float* __restrict__ scratch,
                     int S, int d_in, int d_out, int vec_a, int vec_g,
                     int n_tiles, int n_pairs, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStages = Config<TA, TG>::kStages;
  unsigned char* const ring = smem;  // [kStages][s rows, t rows][64][144 B]
  __shared__ float warp_sums[kWarps];
  // the next kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  const int pair = blockIdx.x / split, rank = blockIdx.x % split;
  const int b = blockIdx.y;
  int si, ti;
  pair_tiles(pair, n_tiles, si, ti);
  const int s0 = si * kTile, t0 = ti * kTile;
  const bool diag = si == ti;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  // a diagonal tile's lower-left quarter is the upper-right one transposed
  const bool idle = diag && wm > wn;

  const int64_t a_row = (int64_t)d_in * sizeof(TA);
  const int64_t g_row = (int64_t)d_out * sizeof(TG);
  const unsigned char* ab =
      reinterpret_cast<const unsigned char*>(a) + (int64_t)b * S * a_row;
  const unsigned char* gb =
      reinterpret_cast<const unsigned char*>(g) + (int64_t)b * S * g_row;
  // chunk c: a's chunk c for c < na, then g's chunk c - na; this block
  // takes chunks [c0, c1)
  const int na = (int)((a_row + kChunkBytes - 1) / kChunkBytes);
  const int n_chunks = na + (int)((g_row + kChunkBytes - 1) / kChunkBytes);
  const int c0 = (int)((int64_t)n_chunks * rank / split);
  const int c1 = (int)((int64_t)n_chunks * (rank + 1) / split);

  auto issue = [&](int c) {
    if (c < c1) {
      unsigned char* stage = ring + (c % kStages) * kStageBytes;
      if (c < na)
        load_chunk(stage, ab, S, a_row, vec_a, s0, t0,
                   (int64_t)c * kChunkBytes);
      else
        load_chunk(stage, gb, S, g_row, vec_g, s0, t0,
                   (int64_t)(c - na) * kChunkBytes);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // the Gram being formed (a's, then g's); a's finished one waits in
  // shared memory, 32 floats per thread, thread-major
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  float* const aa =
      reinterpret_cast<float*>(ring + Config<TA, TG>::kRingBytes) +
      threadIdx.x;
  auto park = [&]() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aa[(16 * m + 4 * n + i) * kThreads] = acc[m][n][i];
          acc[m][n][i] = 0.f;
        }
  };
  if (c0 > na) park();  // this block has no chunk of a

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c0 + c);
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's, and every warp is done with chunk c - 1
    issue(c + kStages - 1);  // into chunk c - 1's stage
    if (c == na) park();     // a's Gram is done: park it, start g's
    if (!idle) {
      const unsigned char* s_tile = ring + (c % kStages) * kStageBytes;
      const unsigned char* t_tile = diag ? s_tile : s_tile + kOperandBytes;
      if (c < na)
        gram_chunk<TA>(s_tile, t_tile, wm, wn, acc);
      else
        gram_chunk<TG>(s_tile, t_tile, wm, wn, acc);
    }
  }
  if (c1 <= na) park();  // this block has no chunk of g

  if (split > 1) {  // the partial Grams, for the combine kernel
    float* dst = scratch + (((int64_t)b * n_pairs + pair) * split + rank) *
                               (2 * 32 * kThreads) + threadIdx.x;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = (16 * m + 4 * n + i) * kThreads;
          dst[e] = aa[e];
          dst[32 * kThreads + e] = acc[m][n][i];
        }
    return;
  }
  // sum aa * gg over this thread's 32 elements (its own aa, no barrier)
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sum = fmaf(aa[(16 * m + 4 * n + i) * kThreads], acc[m][n][i], sum);
  finish_tile(sum, diag, warp_sums, partial + (int64_t)b * n_pairs + pair);
}

// One block per (tile pair, example) where the chunks were split: each
// Gram is the ranks' partial Grams added in rank order, then sum aa * gg
// as in the tile kernel, into partial[b, pair].  A programmatic dependent
// launch: it waits for the tile kernel's grid here.
__global__ void __launch_bounds__(kThreads)
    ghost_norm_combine(const float* __restrict__ scratch,
                       float* __restrict__ partial, int n_tiles, int n_pairs,
                       int split) {
  __shared__ float warp_sums[kWarps];
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int pair = blockIdx.x, b = blockIdx.y;
  int si, ti;
  pair_tiles(pair, n_tiles, si, ti);
  const float* src = scratch + ((int64_t)b * n_pairs + pair) * split *
                                   (2 * 32 * kThreads) + threadIdx.x;
  float x[32], y[32];  // 64 loads in flight per rank
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    x[e] = src[e * kThreads];
    y[e] = src[(32 + e) * kThreads];
  }
  for (int r = 1; r < split; ++r) {
    src += 2 * 32 * kThreads;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      x[e] += src[e * kThreads];
      y[e] += src[(32 + e) * kThreads];
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sum = fmaf(x[e], y[e], sum);
  finish_tile(sum, si == ti, warp_sums, partial + (int64_t)b * n_pairs + pair);
}

// out[b] = sum over pairs of partial[b, pair], in ascending pair order
__global__ void ghost_norm_rows(const float* __restrict__ partial,
                                float* __restrict__ out, int B, int n_pairs) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the previous grid
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* row = partial + (int64_t)b * n_pairs;
  float total = 0.f;
  for (int p = 0; p < n_pairs; ++p) total += row[p];
  out[b] = total;
}

// the widest copy, of 16, 8, 4 or 2 bytes, that divides x's address and
// its row length in bytes
int copy_bytes(const void* x, int64_t row_bytes) {
  const uint64_t both = reinterpret_cast<uintptr_t>(x) | (uint64_t)row_bytes;
  for (int v = 16; v > 2; v >>= 1)
    if (both % v == 0) return v;
  return 2;
}

template <typename TA, typename TG>
int blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      ghost_norm_tiles<TA, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Config<TA, TG>::kSmemBytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ghost_norm_tiles<TA, TG>, kThreads, Config<TA, TG>::kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// a launch of `kernel` on `grid` x `block` that may start while the
// previous kernel on the stream runs (it waits on the device instead)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename TA, typename TG>
cudaError_t launch(const void* a, const void* g, float* partial,
                   float* scratch, float* out, int B, int S, int d_in,
                   int d_out, int split, cudaStream_t stream) {
  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int64_t a_row = (int64_t)d_in * sizeof(TA);
  const int64_t g_row = (int64_t)d_out * sizeof(TG);
  constexpr int kSmem = Config<TA, TG>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ghost_norm_tiles<TA, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  ghost_norm_tiles<TA, TG><<<dim3(n_pairs * split, B), kThreads, kSmem,
                             stream>>>(
      static_cast<const TA*>(a), static_cast<const TG*>(g), partial, scratch,
      S, d_in, d_out, copy_bytes(a, a_row), copy_bytes(g, g_row), n_tiles,
      n_pairs, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split > 1) {
    err = launch_dependent(ghost_norm_combine, dim3(n_pairs, B),
                           dim3(kThreads), stream,
                           static_cast<const float*>(scratch), partial,
                           n_tiles, n_pairs, split);
    if (err != cudaSuccess) return err;
  }
  return launch_dependent(ghost_norm_rows, dim3((B + 127) / 128), dim3(128),
                          stream, static_cast<const float*>(partial), out, B,
                          n_pairs);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  partial is float32 [B, n_pairs]
// with n_tiles = ceil(S / 64) and n_pairs = n_tiles * (n_tiles + 1) / 2;
// split is how many blocks share a tile pair's chunks (the wrapper's
// split_plan), and with split > 1 scratch is float32
// [B, n_pairs, split, 2, 32, 128].
extern "C" int ghost_norm_launch(const void* a, const void* g, void* partial,
                                 void* scratch, void* out, int B, int S,
                                 int d_in, int d_out, int a_dtype,
                                 int g_dtype, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* scr = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  switch (a_dtype * 2 + g_dtype) {
    case 0:
      return (int)launch<float, float>(a, g, part, scr, o, B, S, d_in, d_out,
                                       split, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(a, g, part, scr, o, B, S, d_in,
                                               d_out, split, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(a, g, part, scr, o, B, S, d_in,
                                               d_out, split, s);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, g, part, scr, o, B,
                                                       S, d_in, d_out, split,
                                                       s);
  }
  return (int)cudaErrorInvalidValue;
}

// the tile kernel's dynamic shared memory, in bytes, for these dtypes
// (codes as above)
extern "C" int ghost_norm_smem_bytes(int a_dtype, int g_dtype) {
  switch (a_dtype * 2 + g_dtype) {
    case 0:
      return Config<float, float>::kSmemBytes;
    case 1:
      return Config<float, __nv_bfloat16>::kSmemBytes;
    case 2:
      return Config<__nv_bfloat16, float>::kSmemBytes;
    case 3:
      return Config<__nv_bfloat16, __nv_bfloat16>::kSmemBytes;
  }
  return -(int)cudaErrorInvalidValue;
}

// how many tile-kernel blocks stay resident on one SM for these dtypes, or
// minus a CUDA error
extern "C" int ghost_norm_blocks_per_sm(int a_dtype, int g_dtype) {
  switch (a_dtype * 2 + g_dtype) {
    case 0:
      return blocks_per_sm<float, float>();
    case 1:
      return blocks_per_sm<float, __nv_bfloat16>();
    case 2:
      return blocks_per_sm<__nv_bfloat16, float>();
    case 3:
      return blocks_per_sm<__nv_bfloat16, __nv_bfloat16>();
  }
  return -(int)cudaErrorInvalidValue;
}
