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
// bf16: about 770 flops per byte, above the ~295 at which the H100's
// bf16 tensor cores would outrun its memory.  The least time is 0.065 ms
// at the 989 TFLOP/s bf16 tensor-core peak.  This first version computes
// in float32 on the CUDA cores, whose 67 TFLOP/s put its own floor at
// 0.96 ms; tensor cores (mma.sync / wgmma on bf16 tiles) and TMA loads are
// the next step.
//
// Design (simple first): one thread block per (b, KV head, 64 query rows)
// serves the query heads of that KV head (up to 384 / (64 * D / 32) of
// them, 3 at D = 64; a larger group is split over grid.y), so each K/V tile
// is read once for all of them.  Each query row belongs to D/32
// neighbouring lanes, each holding 32 of its dimensions (as 8 interleaved
// float4 chunks, so the lanes of a row read neighbouring shared-memory
// words) of q and of the accumulator in registers; a score is their
// partial dot products summed with warp shuffles.  Each 16-byte
// shared-memory load of K or V feeds only 4 FMAs of one row; register
// tiles over several rows per thread would reuse it.  Tiles of 32 keys are copied into shared memory by
// cp.async, double-buffered so the next tile's copy overlaps this tile's
// compute, and (bf16) widened to float32 once per tile.  Every reduction
// runs in a fixed order and nothing is atomic, so a run repeats bit for
// bit.  Key tiles that lie wholly above the causal diagonal or wholly
// outside the window of every row of a block are skipped: in the reference
// such a tile leaves m, l and acc unchanged.  Blocks take the latest query
// tiles (the most keys under a causal mask) first.
//
// The wrapper guarantees contiguous q, k, v and out with 16-byte aligned
// base pointers; with D a multiple of 8 every row slice is then 16-byte
// aligned too.
//
// Plain C interface for ctypes: flash_attention_launch() launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;           // query positions per block
constexpr int kTK = 32;           // keys per shared-memory tile
constexpr int kMaxThreads = 384;  // threads per block, at most (no spills)
constexpr int kChunks = 8;        // float4 chunks of a row held per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

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

template <typename T, int D>
constexpr size_t smem_bytes() {
  // two buffers of raw K and V tiles, and (bf16) one float32 K and V tile
  return 2 * 2 * kTK * D * sizeof(T) +
         (std::is_same<T, float>::value ? 0 : 2 * kTK * D * sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int L, int H, int KV, int heads_per_block,
                           int causal, int window, float scale) {
  constexpr int TPR = D / 32;         // lanes per query row
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = D / kVec;  // 16-byte copies per key row
  constexpr int kTile = kTK * D;      // elements of one K (or V) tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);  // [2 buffers][K, V][kTK][D]
  float* kf = reinterpret_cast<float*>(smem + 2 * 2 * kTile * sizeof(T));
  float* vf = kf + kTile;               // bf16 only: the tile as float32

  const int G = H / KV;
  const int n_hchunks = (G + heads_per_block - 1) / heads_per_block;
  const int kvh = blockIdx.y / n_hchunks;
  const int g = (blockIdx.y % n_hchunks) * heads_per_block +
                threadIdx.x / (TPR * kBQ);
  const int b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest tiles first
  const int t = threadIdx.x % TPR;                    // which 32 dimensions
  const int qpos = q0 + (threadIdx.x / TPR) % kBQ;
  const bool active = g < G && qpos < S;
  const size_t qrow = (((size_t)b * S + qpos) * H + kvh * G + g) * D;

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = 4 * (t + TPR * c);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) x = load4(q + qrow + d0);
    qr[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // the keys any row of this block may attend: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? min(L, q_last + 1) : L;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kTK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTK - 1) / kTK : 0;

  const size_t kv_row = (size_t)KV * D;  // stride between key positions
  const T* kb = k + (size_t)b * L * kv_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * L * kv_row + (size_t)kvh * D;
  auto copy_tile = [&](int tile, int buf) {
    const int k0 = k_begin + tile * kTK;
    T* kd = raw + buf * 2 * kTile;
    T* vd = kd + kTile;
    for (int e = threadIdx.x; e < kTK * kRowVecs; e += blockDim.x) {
      const int j = e / kRowVecs, c = (e % kRowVecs) * kVec;
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
    const float* ks;
    const float* vs;
    if constexpr (std::is_same<T, float>::value) {
      ks = raw + buf * 2 * kTile;
      vs = ks + kTile;
    } else {
      const T* src = raw + buf * 2 * kTile;  // K then V, contiguous
      for (int e = threadIdx.x; e < 2 * kTile / 8; e += blockDim.x) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + 8 * e);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h2[0]), b2 = __bfloat1622float2(h2[1]);
        const float2 c2 = __bfloat1622float2(h2[2]), d2 = __bfloat1622float2(h2[3]);
        float* dst = kf + 8 * e;  // vf follows kf
        *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b2.x, b2.y);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(c2.x, c2.y, d2.x, d2.y);
      }
      __syncthreads();
      ks = kf;
      vs = vf;
    }

    // scores of this row against the tile's keys: partial dots over this
    // lane's 32 dimensions, then summed over the row's lanes
    float s[kTK];
#pragma unroll
    for (int j = 0; j < kTK; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
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
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
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
    for (int c = 0; c < kChunks; ++c) {
      const float4 a = acc[c];
      store4(out + qrow + 4 * (t + TPR * c),
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int L, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  constexpr int TPR = D / 32;
  const int G = H / KV;
  const int max_heads = kMaxThreads / (kBQ * TPR);
  const int heads = G < max_heads ? G : max_heads;
  const int n_hchunks = (G + heads - 1) / heads;
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, KV * n_hchunks, B);
  flash_attention_kernel<T, D><<<grid, heads * kBQ * TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, L, H, KV, heads,
      causal, window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int L, int H, int KV, int D, int causal,
                 int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, L, H, KV, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, L, H, KV, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, L, H, KV, causal, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: 0 or 1.  window <= 0 means no
// window.  H % KV == 0, the layouts and the alignment are checked by the
// Python wrapper.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int L, int H, int KV, int D, int causal,
                                      int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, out, B, S, L, H, KV, D, causal,
                               window, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, B, S, L, H, KV, D,
                                       causal, window, s);
  return (int)cudaErrorInvalidValue;
}
