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
// Design (simple first): one thread block per (b, kv_head) serves all
// G = H / KV query heads of that KV head, so each K and V row is read from
// device memory once.  A loop walks the attended rows in tiles of TK keys
// staged through shared memory as float32 (rows padded by one float so the
// score and PV loops are free of bank conflicts), with an online softmax
// whose running max and sum live in shared memory.  Each thread loads its
// share of a tile as 16-byte vectors into registers, and issues the next
// tile's loads before computing on the current one, so a tile's global
// latency hides behind the previous tile's compute.  The loop covers only
// the attended rows, where the TPU kernel streams the whole cache and
// masks it.  At the serving shape (B=8, KV=5) this launches only 40 blocks
// on 132 SMs; split-KV with a combine pass, cp.async or TMA loads, and a
// CUDA graph around the decode step are later work.
//
// The wrapper guarantees 16-byte aligned k and v base pointers; with D a
// multiple of 8 every row slice is then 16-byte aligned too.
//
// Plain C interface for ctypes: decode_attention_launch() launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr float kNegInf = -1e30f;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ index, T* __restrict__ out,
                            int L, int H, int KV, int window, float scale) {
  constexpr int TK = D <= 64 ? 64 : 32;  // keys per tile (static smem < 48 KB)
  constexpr int RS = D + 1;              // padded shared row
  constexpr int ACC = (kMaxGroup * D + kThreads - 1) / kThreads;

  __shared__ float q_s[kMaxGroup][D];
  __shared__ float k_s[TK][RS];
  __shared__ float v_s[TK][RS];
  __shared__ float p_s[kMaxGroup][TK];  // scores, then probabilities
  __shared__ float m_s[kMaxGroup];      // running max
  __shared__ float l_s[kMaxGroup];      // running sum
  __shared__ float alpha_s[kMaxGroup];  // this tile's rescale factor

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // attended cache rows [lo, hi]; hi is clamped so a bad index cannot read
  // past the cache, and an empty range gives a zero output
  const int idx = index[b];
  const int hi = idx < L - 1 ? idx : L - 1;
  int lo = 0;
  if (window > 0) lo = max(idx - window + 1, 0);

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
  if (lo <= hi) regs.load(kb, vb, row, lo, min(TK, hi - lo + 1), tid);
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
    if (e < G * D) {
      const int g = e / D, d = e % D;
      store(&out[((size_t)b * H + kvh * G + g) * D + d],
            acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* index,
            void* out, int B, int L, int H, int KV, int window,
            cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  decode_attention_kernel<T, D><<<B * KV, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), L, H, KV, window, scale);
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* index, void* out, int B, int L, int H, int KV,
                 int D, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch<T, 32>(q, k, v, index, out, B, L, H, KV, window, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, index, out, B, L, H, KV, window, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, index, out, B, L, H, KV, window, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// H % KV == 0 and H / KV <= 16 are checked by the Python wrapper.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* index,
                                       void* out, int B, int L, int H, int KV,
                                       int D, int window, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, index, out, B, L, H, KV, D, window, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, index, out, B, L, H, KV, D,
                                       window, s);
  return (int)cudaErrorInvalidValue;
}
