// Blocked causal / sliding-window GQA attention over full sequences,
// hand-written for sm_90a.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:76, body _flash_kernel): q [B,S,H,D] attends to k and v
// [B,L,KV,D]; query head h reads KV head h / (H / KV), so K and V are never
// expanded to H heads; scale 1/sqrt(D); query row i keeps key j when j <= i
// (causal) and j > i - window (a window is set), positions with no offset
// when L != S; float32 online softmax (running max, normaliser and
// accumulator), masked probabilities exactly 0, output acc / max(l, 1e-30)
// in q's dtype, so a row that sees no key comes out 0.  Unlike the TPU
// kernel it reads the [B,S,H,D] layout directly (the Pallas version's
// transposes to [B,H,S,D] existed for its BlockSpecs), and S and L need not
// be multiples of its own tiles: ragged query rows and keys are masked.
//
// What bounds it: operations.  At the evaluation shape (B=8, S=2048, H=15,
// KV=5, D=64) the causal lower triangle holds B*H*S*(S+1)/2 (query, key)
// pairs at 4*D flops each, 64.5 GFLOP, against 84 MB of q, k, v and o in
// bf16: about 770 flops per byte, above the ~295 at which the H100's bf16
// tensor cores would outrun its memory.  The least time is 0.065 ms at the
// 989 TFLOP/s bf16 tensor-core peak.
//
// Two kernels, picked by dtype in the launcher; both keep every reduction
// in a fixed order with nothing atomic, so a run repeats bit for bit, and
// both skip key tiles that lie wholly above the causal diagonal or wholly
// outside the window (in the reference such a tile leaves m, l and acc
// unchanged).
//
// bfloat16: tensor cores (flash_attention_mma_kernel), FlashAttention-2's
// shape.  One block of 4 warps per (query head, b, 64 query rows); each
// warp owns 16 query rows.  Q is staged in shared memory with the first
// key tile and each k-step loads its A fragment by ldmatrix, which keeps
// D / 4 registers a lane free for O.  Tiles of 64 keys of K and V pass through
// a ring of two shared-memory stages filled by cp.async, rows padded by 16
// bytes so the 8 row addresses of each ldmatrix hit 8 distinct 4-bank
// groups.
// S = Q K^T is mma.sync m16n8k16 (bf16 in, float32 accumulate) with K
// fragments from ldmatrix; the online softmax runs on the accumulators in
// registers (row max and sum over the 4 lanes of a quad by __shfl_xor_sync,
// exp2f with the scale pre-multiplied by log2 e); P goes from the
// accumulators straight into bf16 A fragments, and O += P V is the same
// mma.sync with V fragments from ldmatrix.trans.  P is carried in two bf16
// terms, P = hi + lo with hi = bf16(P) and lo = bf16(P - hi), and O gets
// hi V + lo V: one rounding of P to bf16 (FlashAttention-2's) moves a row
// that sees a few keys by up to 2^-9 of a weight times |v|, more than the
// 1e-3 + 1e-2 |o| the kernel is held to against its plain version
// (tests/test_torch_flash_attention.py shows it), while two terms keep P to
// about 2^-17.  It costs a third more tensor-core work.  Blocks walk a query
// head's K/V on their own, so a KV head's tiles are read by its G query
// heads' blocks, from L2 after the first (G = 3 at SmolLM-360M); the
// operations, not those bytes, bound the kernel.  Blocks take the latest
// query tiles (the most keys under a causal mask) first, across all heads.
// A warp skips a tile that is masked for all its rows and masks only the
// tiles that cross its diagonal, its window's edge or the end of the keys.
// wgmma and TMA are the next step.  At head dims 192 and 256
// (Nemotron-4-340B's and Gemma-7B's) O's accumulators (D / 2 registers)
// leave no room for a 64-key S tile under the 255-register cap, so the key
// tiles are 32 wide there (100 KB of shared memory at D = 256, 75 KB at
// 192).
//
// float32: CUDA cores (flash_attention_simt_kernel).  Tensor cores would
// mean TF32, about 3 decimal digits, which breaks the 3e-5 float32 limit.
// One thread block per (b, KV head, 64 query rows) serves the query heads
// of that KV head (up to 384 / (64 * D / 32) of them, 3 at D = 64; a
// larger group is split over grid.y), so each K/V tile is read once for
// all of them.  Each query row belongs to D/32 neighbouring lanes, each
// holding 32 of its dimensions (as 8 interleaved float4 chunks, so the
// lanes of a row read neighbouring shared-memory words) of q and of the
// accumulator in registers; a score is their partial dot products summed
// with warp shuffles.  Above D = 128 a row has 8 lanes of D/32 dimensions
// (6 or 8 chunks) and a block 32 rows of one head, and the double-buffered
// tiles take 96 KB (D = 192) or 128 KB (256) of shared memory.  Tiles of
// 32 keys are copied into shared memory by cp.async, double-buffered so
// the next tile's copy overlaps this tile's compute.  Its floor is the 67
// TFLOP/s float32 rate, 0.96 ms at the evaluation shape.
//
// The wrapper guarantees contiguous q, k, v and out with 16-byte aligned
// base pointers; with D a multiple of 8 every row slice is then 16-byte
// aligned too.
//
// Plain C interface for ctypes: flash_attention_launch() launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- float32: CUDA cores ------------------------------------------------------

constexpr int kBQ = 64;           // query positions per block, D <= 128
constexpr int kTK = 32;           // keys per shared-memory tile
constexpr int kMaxThreads = 384;  // threads per block, at most (no spills)
constexpr int kChunks = 8;        // float4 chunks of a row held per lane

// Lanes per query row and query rows per block.  Up to D = 128 a row has
// D / 32 lanes of 32 dimensions each and a block 64 rows per head.  Above
// it a row has 8 lanes of D / 32 dimensions each (6 or 8 float4 chunks):
// D / 32 lanes would be 6 at D = 192, which straddles two warps' shuffles,
// and 8 at 256 but then 64 rows need 512 threads.  A block then holds 32
// rows of one head, 256 threads.
template <int D>
__host__ __device__ constexpr int simt_tpr() {
  return D <= 128 ? D / 32 : 8;
}
template <int D>
__host__ __device__ constexpr int simt_bq() {
  return D <= 128 ? kBQ : 32;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
constexpr size_t simt_smem_bytes() {
  return 2 * 2 * kTK * D * sizeof(float);  // two buffers of K and V tiles
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
    flash_attention_simt_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ out, int S, int L, int H,
                                int KV, int heads_per_block, int causal,
                                int window, float scale) {
  constexpr int TPR = simt_tpr<D>();  // lanes per query row
  constexpr int CH = D / (4 * TPR);   // float4 chunks of a row per lane
  constexpr int BQ = simt_bq<D>();    // query rows per block and head
  static_assert(32 % TPR == 0 && 4 * TPR * CH == D && CH <= kChunks,
                "a row's lanes must lie in one warp and cover D");
  constexpr int kRowVecs = D / 4;     // 16-byte copies per key row
  constexpr int kTile = kTK * D;      // elements of one K (or V) tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);  // [2 buffers][K, V][kTK][D]

  const int G = H / KV;
  const int n_hchunks = (G + heads_per_block - 1) / heads_per_block;
  const int kvh = blockIdx.y / n_hchunks;
  const int g = (blockIdx.y % n_hchunks) * heads_per_block +
                threadIdx.x / (TPR * BQ);
  const int b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // latest tiles first
  const int t = threadIdx.x % TPR;                    // which chunks of D
  const int qpos = q0 + (threadIdx.x / TPR) % BQ;
  const bool active = g < G && qpos < S;
  const size_t qrow = (((size_t)b * S + qpos) * H + kvh * G + g) * D;

  float4 qr[CH], acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d0 = 4 * (t + TPR * c);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) x = load4(q + qrow + d0);
    qr[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // the keys any row of this block may attend: [k_begin, k_end)
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(L, q_last + 1) : L;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kTK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTK - 1) / kTK : 0;

  const size_t kv_row = (size_t)KV * D;  // stride between key positions
  const float* kb = k + (size_t)b * L * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * L * kv_row + (size_t)kvh * D;
  auto copy_tile = [&](int tile, int buf) {
    const int k0 = k_begin + tile * kTK;
    float* kd = raw + buf * 2 * kTile;
    float* vd = kd + kTile;
    for (int e = threadIdx.x; e < kTK * kRowVecs; e += blockDim.x) {
      const int j = e / kRowVecs, c = (e % kRowVecs) * 4;
      const bool valid = k0 + j < L;
      const size_t off = valid ? (size_t)(k0 + j) * kv_row + c : 0;
      cp_async16(kd + j * D + c, kb + off, valid);
      cp_async16(vd + j * D + c, vb + off, valid);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) copy_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      copy_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every thread
    const float* ks = raw + buf * 2 * kTile;
    const float* vs = ks + kTile;

    // scores of this row against the tile's keys: partial dots over this
    // lane's dimensions, then summed over the row's lanes
    float s[kTK];
#pragma unroll
    for (int j = 0; j < kTK; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d0 = 4 * (t + TPR * c);
      const float4 qc = qr[c];
#pragma unroll
      for (int j = 0; j < kTK; ++j) {
        const float4 kc = *reinterpret_cast<const float4*>(ks + j * D + d0);
        s[j] = fmaf(qc.x, kc.x, s[j]);
        s[j] = fmaf(qc.y, kc.y, s[j]);
        s[j] = fmaf(qc.z, kc.z, s[j]);
        s[j] = fmaf(qc.w, kc.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    }

    // online softmax over the tile
    const int k0 = k_begin + it * kTK;
    unsigned ok = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      const int kp = k0 + j;
      const bool keep = kp < L && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
      ok |= (unsigned)keep << j;
      s[j] = keep ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      s[j] = (ok >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vc =
            *reinterpret_cast<const float4*>(vs + j * D + 4 * (t + TPR * c));
        acc[c].x = fmaf(p, vc.x, acc[c].x);
        acc[c].y = fmaf(p, vc.y, acc[c].y);
        acc[c].z = fmaf(p, vc.z, acc[c].z);
        acc[c].w = fmaf(p, vc.w, acc[c].w);
      }
    }
    __syncthreads();  // every thread is done with this tile's buffers
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 a = acc[c];
      *reinterpret_cast<float4*>(out + qrow + 4 * (t + TPR * c)) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* out, int B,
                int S, int L, int H, int KV, int causal, int window,
                cudaStream_t stream) {
  constexpr int TPR = simt_tpr<D>();
  constexpr int BQ = simt_bq<D>();
  static_assert(BQ * TPR <= kMaxThreads, "one head's rows must fit a block");
  const int G = H / KV;
  const int max_heads = kMaxThreads / (BQ * TPR);
  const int heads = G < max_heads ? G : max_heads;
  const int n_hchunks = (G + heads - 1) / heads;
  constexpr size_t smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, KV * n_hchunks, B);
  flash_attention_simt_kernel<D><<<grid, heads * BQ * TPR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, L, H, KV,
      heads, causal, window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// -- bfloat16: tensor cores ---------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBM = 16 * kMmaWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;              // keys per shared-memory tile, D <= 128
constexpr int kStages = 2;           // cp.async ring

// A warp's Q fragments would take D / 4 registers a lane beside O's D / 2,
// so Q is staged in shared memory and its A fragments are loaded per k-step
// by ldmatrix: at D = 64 that lets ptxas keep 4 blocks an SM (127
// registers) without the 8-byte spill it made with Q in registers (128).
// Above D = 128 a 64-key S tile beside O (128 registers at D = 256) would
// crowd the 255 registers a thread may hold, so the key tiles are 32 wide
// there (254 registers at D = 256, 0 spilled).
template <int D>
__host__ __device__ constexpr int mma_bn() {
  return D <= 128 ? kBN : 32;
}

// a shared-memory row of K, V or Q holds D + 8 bf16: padded by 16 bytes
template <int D>
constexpr size_t mma_smem_bytes() {
  return ((size_t)kStages * 2 * mma_bn<D>() + kBM) * (D + 8) *
         sizeof(__nv_bfloat16);
}

// D (16x8, float32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives its share of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}
// two probabilities as the hi and lo bf16 terms of the P fragments
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of m16n8k16 (PTX ISA), with gq = lane / 4 and
// tq = lane % 4: a C fragment holds rows gq (c[0], c[1]) and gq + 8 (c[2],
// c[3]) at columns 2 tq and 2 tq + 1; an A fragment holds the same two rows
// at columns 2 tq, 2 tq + 1 (a[0]: row gq, a[1]: row gq + 8) and 8 more
// (a[2], a[3]); a B fragment holds column gq at rows 2 tq, 2 tq + 1 (b0)
// and 8 more (b1).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int S, int L,
                               int H, int KV, int causal, int window,
                               float scale_log2) {
  constexpr int RS = D + 8;     // padded shared-memory row
  constexpr int KS = D / 16;    // k-steps of S = Q K^T
  constexpr int ND = D / 8;     // n-tiles of O
  constexpr int BN = mma_bn<D>();  // keys per tile
  constexpr int NT = BN / 8;    // n-tiles of S
  constexpr int kTile = BN * RS;
  constexpr int kRowVecs = D / 8;  // 16-byte copies per key (or query) row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  // [kStages][K, V][BN][RS], then Q's [kBM][RS]
  __nv_bfloat16* qs = tiles + kStages * 2 * kTile;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // latest tiles first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int w0 = q0 + 16 * warp;          // this warp's first row
  const int w1 = min(w0 + 15, S - 1);     // and its last real one
  const int row[2] = {w0 + gq, w0 + gq + 8};

  const size_t q_row = (size_t)H * D;     // stride between query positions
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's normaliser

  // the keys any row of this block may attend: [k_begin, k_end)
  const int q_last = min(q0 + kBM, S) - 1;
  const int k_end = causal ? min(L, q_last + 1) : L;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const size_t kv_row = (size_t)KV * D;  // stride between key positions
  const __nv_bfloat16* kb = k + (size_t)b * L * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * L * kv_row + (size_t)kvh * D;
  auto copy_tile = [&](int tile, int stage) {
    const int k0 = k_begin + tile * BN;
    __nv_bfloat16* kd = tiles + stage * 2 * kTile;
    __nv_bfloat16* vd = kd + kTile;
    for (int e = threadIdx.x; e < BN * kRowVecs; e += kMmaThreads) {
      const int j = e / kRowVecs, c = (e % kRowVecs) * 8;
      const bool valid = k0 + j < L;  // keys past L: zeros, then masked
      const size_t off = valid ? (size_t)(k0 + j) * kv_row + c : 0;
      cp_async16(kd + j * RS + c, kb + off, valid);
      cp_async16(vd + j * RS + c, vb + off, valid);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) {
    // the block's 64 query rows, in the first tile's commit group (rows
    // past S: zeros; their outputs are never written)
    for (int e = threadIdx.x; e < kBM * kRowVecs; e += kMmaThreads) {
      const int r = e / kRowVecs, c = (e % kRowVecs) * 8;
      const bool valid = q0 + r < S;
      const size_t off = valid ? (size_t)(q0 + r) * q_row + c : 0;
      cp_async16(qs + r * RS + c, qb + off, valid);
    }
  }
  if (n_tiles > 0) copy_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    if (it + 1 < n_tiles) {
      copy_tile(it + 1, (it + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every thread

    const int k0 = k_begin + it * BN;
    const bool skip = w0 >= S || (causal && k0 > w1) ||
                      (window > 0 && k0 + BN - 1 <= w0 - window);
    if (!skip) {
      const __nv_bfloat16* ks_tile = tiles + stage * 2 * kTile;
      const __nv_bfloat16* vs_tile = ks_tile + kTile;

      // S = Q K^T: matrix i of each ldmatrix is keys 8 (i / 2) .. + 7 of a
      // pair of n-tiles at dimensions 8 (i % 2) .. + 7 of a k-step
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int mi = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // this k-step's A fragment: matrix i of the ldmatrix is rows
        // 8 (i % 2) .. + 7 of the warp's 16 at dimensions 8 (i / 2) .. + 7
        unsigned qa[4];
        ldmatrix_x4(qa, qs + (16 * warp + 8 * (mi & 1) + (lane & 7)) * RS +
                            16 * ks + 8 * (mi >> 1));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kf[4];
          ldmatrix_x4(kf, ks_tile + (16 * np + 8 * (mi >> 1) + (lane & 7)) * RS +
                              16 * ks + 8 * (mi & 1));
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }

      // scale into log2 units; mask only where the tile crosses this warp's
      // diagonal, its window's edge or the end of the keys
      const bool need_mask = k0 + BN > L || (causal && k0 + BN - 1 > w0) ||
                             (window > 0 && k0 <= w1 - window);
      unsigned keep = 0xffffffffu;  // bit 4 n + i: s[n][i] is attended
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] *= scale_log2;
          if (need_mask) {
            const int kp = k0 + 8 * n + 2 * tq + (i & 1);
            const int r = row[i >> 1];
            const bool ok = kp < L && (!causal || kp <= r) &&
                            (window <= 0 || kp > r - window);
            if (!ok) {
              keep &= ~(1u << (4 * n + i));
              s[n][i] = kNegInf;
            }
          }
        }
      }

      // online softmax over the tile, two rows per lane
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = exp2f(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 2 * r + c;
            // masked probabilities are exactly 0, also where the whole row
            // is masked so far and s - m_new = NEG_INF - NEG_INF = 0
            const float p =
                (keep >> (4 * n + i)) & 1u ? exp2f(s[n][i] - m_new) : 0.f;
            s[n][i] = p;
            psum += p;
          }
        }
        l[r] = alpha[r] * l[r] + psum;
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: the C fragments of S n-tiles 2 kk and 2 kk + 1 are the A
      // fragment of k-step kk; matrix i of each ldmatrix.trans is keys
      // 8 (i % 2) .. + 7 of the k-step at dimensions 8 (i / 2) .. + 7 of a
      // pair of n-tiles
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        unsigned ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          unsigned vf[4];
          ldmatrix_x4_trans(vf, vs_tile + (16 * kk + 8 * (mi & 1) + (lane & 7)) *
                                              RS +
                                    16 * np + 8 * (mi >> 1));
          mma_bf16(o[2 * np], ph, vf[0], vf[1]);
          mma_bf16(o[2 * np], pl, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  // out = acc / max(l, 1e-30), two bf16 per store
  const size_t o_row = (size_t)H * D;
  __nv_bfloat16* ob = out + (size_t)b * S * o_row + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row[r] < S) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<unsigned*>(ob + (size_t)row[r] * o_row + 8 * n +
                                     2 * tq) =
            pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int L, int H, int KV, int causal, int window,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, L, H, KV, causal, window,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  causal: 0 or 1.  window <= 0 means no window.  H % KV == 0,
// the layouts, the alignment and the grid limits are checked by the Python
// wrapper.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int L, int H, int KV, int D, int causal,
                                      int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32:
        return launch_simt<32>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 64:
        return launch_simt<64>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 128:
        return launch_simt<128>(q, k, v, out, B, S, L, H, KV, causal, window,
                                s);
      case 192:
        return launch_simt<192>(q, k, v, out, B, S, L, H, KV, causal, window,
                                s);
      case 256:
        return launch_simt<256>(q, k, v, out, B, S, L, H, KV, causal, window,
                                s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32:
        return launch_mma<32>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 64:
        return launch_mma<64>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 128:
        return launch_mma<128>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 192:
        return launch_mma<192>(q, k, v, out, B, S, L, H, KV, causal, window, s);
      case 256:
        return launch_mma<256>(q, k, v, out, B, S, L, H, KV, causal, window, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
