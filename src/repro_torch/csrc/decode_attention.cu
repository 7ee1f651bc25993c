// Single-query GQA attention against a KV cache, hand-written for sm_90a.
//
// Replaces decode_attention_pallas (src/repro/kernels/decode_attention/
// kernel.py, body _decode_kernel): q [B,1,H,D] attends to the rows
// [max(0, index[b] - window + 1), index[b]] of k and v [B,L,KV,D]; query
// head h reads KV head h / (H / KV); scale 1/sqrt(D); float32 softmax with
// the normaliser floored at 1e-30; output [B,1,H,D] in q's dtype.  Unlike
// the TPU kernel, `index` is an int32 [B] device tensor (one position per
// batch row) that the kernel reads itself, and L need not be a multiple of
// any block: the ragged last tile is masked.
//
// What bounds it: memory.  Each row's K and V up to index[b] must be read
// once, about 2*G*D flops per byte, far below the ~295 flops per byte the
// H100 needs before compute could matter; the least time is those bytes
// over 3.35 TB/s.
//
// Design: flash-decoding, two kernels.  The split kernel's grid is
// (b * KV + kv_head, split): each block walks one contiguous chunk of the
// cache and serves all G = H / KV query heads of its KV head, so each K and
// V row is read from device memory once.  Within the chunk it walks the
// attended rows in tiles of TK keys staged through shared memory as
// float32 (rows padded by one float so the score and PV loops are free of
// bank conflicts), with an online softmax whose running max and sum live in
// shared memory; each thread loads its share of a tile as 16-byte vectors
// into registers, and issues the next tile's loads before computing on the
// current one.  It writes the chunk's float32 statistics (m, l, acc[G, D],
// acc not yet divided by l) to scratch; a chunk wholly past index[b], or
// wholly before the window, writes m = NEG_INF, l = 0 and returns.  The
// combine kernel (one block per (b, kv_head)) merges the chunks in a fixed
// order, out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// over the chunks with l_s > 0, so nothing is atomic and a run repeats bit
// for bit.  The combine is a programmatic dependent launch: its blocks are
// scheduled while the split grid runs and wait (griddepcontrol.wait) for
// its completion, which hides the second launch's latency.  The chunk size comes from the shapes (B, KV, L) alone, never
// from the values of `index`, and nothing reads `index` on the host, so a
// decode step stays capturable as a CUDA graph.  At the serving shape
// (B=8, KV=5, L=512) the wrapper's plan gives 8 chunks of 64 rows: 320
// blocks on 132 SMs, where one block per (b, kv_head) gave 40.
//
// Head dims 32, 64, 128, 192 and 256.  The split kernel stages q, a tile
// of K and V, and the tile's scores in dynamic shared memory as float32:
// q [16][D], k and v [TK][D+1], p [16][TK].  TK (keys per tile) shrinks as
// D grows, 64 up to D = 64, 32 up to 128, 16 above, which keeps a block at
// 23-51 KB and four blocks on an SM; only D = 256 (50.5 KB) passes the
// 48 KB a kernel gets without asking, and its launch raises the kernel's
// limit first (cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// The wrapper guarantees 16-byte aligned k and v base pointers; with D a
// multiple of 8 every row slice is then 16-byte aligned too.  It allocates
// the scratch; the kernels allocate nothing.
//
// Plain C interface for ctypes: decode_attention_launch() launches both
// kernels on the given stream, does not synchronise, and returns the first
// launch error (0 when both launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr float kNegInf = -1e30f;
constexpr int kStaticSmemLimit = 48 * 1024;  // bytes without an opt-in

// keys per tile of the split kernel, and its dynamic shared memory in floats
__host__ __device__ constexpr int tile_keys(int D) {
  return D <= 64 ? 64 : D <= 128 ? 32 : 16;
}
__host__ __device__ constexpr int split_smem_floats(int D) {
  return kMaxGroup * D + 2 * tile_keys(D) * (D + 1) +
         kMaxGroup * tile_keys(D) + 3 * kMaxGroup;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One tile of K and V rows, held in registers as 16-byte vectors between
// its global load and its store to shared memory.
template <typename T, int D, int TK>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);   // elements per vector
  static constexpr int kRowVecs = D / kVec;     // vectors per cache row
  static constexpr int kPer = TK * kRowVecs / kThreads;  // per thread
  static_assert(TK * kRowVecs % kThreads == 0, "tile must split evenly");
  uint4 k[kPer], v[kPer];

  // rows t0 .. t0+n-1 of this (b, kv_head); rows past n load as zeros
  __device__ __forceinline__ void load(const T* kb, const T* vb, size_t row,
                                       int t0, int n, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kRowVecs, c = e % kRowVecs;
      if (j < n) {
        const size_t off = (size_t)(t0 + j) * row + c * kVec;
        k[i] = *reinterpret_cast<const uint4*>(kb + off);
        v[i] = *reinterpret_cast<const uint4*>(vb + off);
      } else {
        k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);   // zero bits: 0.0
      }
    }
  }

  template <int RS>
  __device__ __forceinline__ void store(float (*k_s)[RS], float (*v_s)[RS],
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kRowVecs, c = e % kRowVecs;
      const T* kx = reinterpret_cast<const T*>(&k[i]);
      const T* vx = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        k_s[j][c * kVec + t] = to_float(kx[t]);
        v_s[j][c * kVec + t] = to_float(vx[t]);
      }
    }
  }
};

// x, as a value the compiler cannot reason about.  nvcc's optimizer does
// not finish the split kernel when it can see that the walked rows [lo, hi]
// lie inside [split * chunk, split * chunk + chunk - 1]; hiding the chunk's
// bounds behind a move keeps the loop as the single-pass kernel had it.
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// One chunk of the cache for one (b, kv_head): its statistics into scratch.
// part_acc is [B * KV][n_splits][G][D] and part_ml [B * KV][n_splits][G][2]
// (m, l), both float32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ index,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int L, int H, int KV,
                        int window, int chunk, float scale) {
  constexpr int TK = tile_keys(D);  // keys per tile
  constexpr int RS = D + 1;         // padded shared row
  constexpr int ACC = (kMaxGroup * D + kThreads - 1) / kThreads;

  // split_smem_floats(D) floats, carved in this order
  extern __shared__ float smem[];
  float(*q_s)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*k_s)[RS] = reinterpret_cast<float(*)[RS]>(smem + kMaxGroup * D);
  float(*v_s)[RS] = k_s + TK;
  float(*p_s)[TK] = reinterpret_cast<float(*)[TK]>(v_s + TK);  // scores, then
                                                              // probabilities
  float* m_s = &p_s[kMaxGroup][0];  // running max
  float* l_s = m_s + kMaxGroup;     // running sum
  float* alpha_s = l_s + kMaxGroup;  // this tile's rescale factor

  const int bk = blockIdx.x;            // b * KV + kv_head
  const int split = blockIdx.y;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* ml = part_ml + ((size_t)bk * gridDim.y + split) * G * 2;
  float* pacc = part_acc + ((size_t)bk * gridDim.y + split) * G * D;

  // attended cache rows of this chunk, [lo, hi]; the last row is clamped
  // so a bad index cannot read past the cache.  An empty range (the chunk
  // lies wholly past index[b] or before the window) writes the empty
  // statistics m = NEG_INF, l = 0 and returns before it loads q or waits
  // at a barrier; the range is the same for the whole block.
  // the combine grid may launch now (it waits for this grid to finish)
  asm volatile("griddepcontrol.launch_dependents;");
  const int idx = index[b];
  const int c0 = opaque(split * chunk);
  const int c1 = opaque(split * chunk + chunk - 1);
  const int hi = min(min(idx, L - 1), c1);
  const int lo = max(window > 0 ? idx - window + 1 : 0, c0);
  if (lo > hi) {
    if (tid < G) {
      ml[2 * tid] = kNegInf;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    q_s[g][d] = to_float(q[((size_t)b * H + kvh * G + g) * D + d]) * scale;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const size_t row = (size_t)KV * D;  // stride between cache positions
  const T* kb = k + (size_t)b * L * row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * L * row + (size_t)kvh * D;

  TileRegs<T, D, TK> regs;
  regs.load(kb, vb, row, lo, min(TK, hi - lo + 1), tid);
  for (int t0 = lo; t0 <= hi; t0 += TK) {
    const int n = min(TK, hi - t0 + 1);  // valid keys in this tile
    __syncthreads();  // last tile's readers are done; q_s, m_s published
    regs.store(k_s, v_s, tid);
    __syncthreads();
    const int t1 = t0 + TK;  // prefetch the next tile while this one computes
    if (t1 <= hi) regs.load(kb, vb, row, t1, min(TK, hi - t1 + 1), tid);

    for (int e = tid; e < G * TK; e += kThreads) {
      const int g = e / TK, j = e % TK;
      float s = kNegInf;
      if (j < n) {
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[j][d];
      }
      p_s[g][j] = s;
    }
    __syncthreads();

    // one warp per query head: tile max, probabilities, running sum
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, p_s[g][j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = j < n ? expf(p_s[g][j] - m_new) : 0.f;
        p_s[g][j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // each thread owns the same (g, d) outputs across all tiles
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[i] * alpha_s[g];
        for (int j = 0; j < n; ++j) a += p_s[g][j] * v_s[j][d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) pacc[e] = acc[i];  // e = g * D + d
  }
  if (tid < G) {
    ml[2 * tid] = m_s[tid];
    ml[2 * tid + 1] = l_s[tid];
  }
}

// Merge one (b, kv_head)'s chunks in chunk order into [B,1,H,D].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          T* __restrict__ out, int H, int KV, int n_splits) {
  const int bk = blockIdx.x;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int G = H / KV;
  // wait until the split grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* ml = part_ml + (size_t)bk * n_splits * G * 2;
  const float* pacc = part_acc + (size_t)bk * n_splits * G * D;
  // not unrolled: unrolled, ptxas spilled a register at D = 192
#pragma unroll 1
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float m = kNegInf;
#pragma unroll 1
    for (int s = 0; s < n_splits; ++s)
      if (ml[2 * (s * G + g) + 1] > 0.f) m = fmaxf(m, ml[2 * (s * G + g)]);
    float num = 0.f, den = 0.f;
#pragma unroll 1
    for (int s = 0; s < n_splits; ++s) {
      const float l = ml[2 * (s * G + g) + 1];
      if (l > 0.f) {  // an empty chunk's acc was never written
        const float w = expf(ml[2 * (s * G + g)] - m);
        num += w * pacc[(s * G + g) * D + d];
        den += w * l;
      }
    }
    store(&out[((size_t)b * H + kvh * G + g) * D + d],
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* index,
            void* out, float* scratch, int B, int L, int H, int KV,
            int window, int chunk, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const int n_splits = (L + chunk - 1) / chunk;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * H * n_splits * D;  // B*KV*n*G*D
  constexpr int smem = split_smem_floats(D) * (int)sizeof(float);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  decode_split_kernel<T, D><<<dim3(B * KV, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(index), part_acc,
      part_ml, L, H, KV, window, chunk, scale);
  // programmatic dependent launch: the combine's blocks may be scheduled
  // once every split block has started, and wait in the kernel for the
  // split grid's completion, so its launch overlaps the split's work
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaGetLastError();  // the split's launch
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D>,
                            static_cast<const float*>(part_acc),
                            static_cast<const float*>(part_ml),
                            static_cast<T*>(out), H, KV, n_splits);
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* index, void* out, float* scratch, int B, int L,
                 int H, int KV, int D, int window, int chunk,
                 cudaStream_t stream) {
  switch (D) {
    case 32:
      return (int)launch<T, 32>(q, k, v, index, out, scratch, B, L, H, KV,
                                window, chunk, stream);
    case 64:
      return (int)launch<T, 64>(q, k, v, index, out, scratch, B, L, H, KV,
                                window, chunk, stream);
    case 128:
      return (int)launch<T, 128>(q, k, v, index, out, scratch, B, L, H, KV,
                                 window, chunk, stream);
    case 192:
      return (int)launch<T, 192>(q, k, v, index, out, scratch, B, L, H, KV,
                                 window, chunk, stream);
    case 256:
      return (int)launch<T, 256>(q, k, v, index, out, scratch, B, L, H, KV,
                                 window, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  chunk:
// cache rows per split, >= 1.  scratch: B * H * ceil(L / chunk) * (D + 2)
// float32.  H % KV == 0 and H / KV <= 16 are checked by the Python wrapper.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* index,
                                       void* out, void* scratch, int B, int L,
                                       int H, int KV, int D, int window,
                                       int chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, index, out, sc, B, L, H, KV, D,
                               window, chunk, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, index, out, sc, B, L, H, KV,
                                       D, window, chunk, s);
  return (int)cudaErrorInvalidValue;
}
