// Length-aware GQA decode attention (flash-decode) for Hopper (sm_90a).
//
// Replaces: langstream_tpu/ops/decode_kernel.py::_decode_kernel (the
// Pallas TPU kernel whose body is _decode_kernel_body, public API
// flash_decode_attention). Same function: one new query token per slot
// against the dense cache [S, T, KVH, D], live rows only (length mask),
// optional sliding window anchored at the query position (length - 1),
// optional logit softcap before masking, custom score scale, online
// softmax in f32, p rounded to the cache type before p.v, and an empty
// slot (length 0) writes zeros.
//
// Also replaces ::_decode_kernel_quant (flash_decode_attention_quant): the
// same walk over an int8 cache [S, T, KVH, D] with one f32 scale per
// (position, kv head) in [S, T, KVH]; entry point flash_decode_quant, the
// KV = int8_t instantiation. Tiles arrive as int8 (16 values per 16-byte
// load) and stay int8 in shared memory; the k scale multiplies the score
// after q.k, before the softcap and the mask; l sums the masked p; then
// p * v_scale (f32) multiplies v in f32, as the Pallas body does. Its
// bytes per live position and kv head are 2*D + 8 instead of 4*D.
// head_dim must be a multiple of 16 for int8.
//
// What bounds it on the H100: bytes. Per slot it does 4*H*len*D FLOPs
// over 2*KVH*len*D cache elements, i.e. ~G FLOPs per byte (G = H/KVH = 4
// for Llama-3-8B), far below the ~295 FLOPs per byte where the tensor
// cores would take over. The only lever is to read fewer, and sequential,
// bytes: the live context, not the allocated buffer.
//
// Design:
// - One CTA per (kv head, slot). The G query heads of the group share
//   every k/v tile the CTA loads, so each cache byte is read once.
// - The CTA walks only the 64-row tiles from the first tile inside the
//   window (_first_valid_block) to the last live tile, so its bytes scale
//   with the live context as the TPU kernel's did. One slot is never
//   split across CTAs, so the reduction order is fixed.
// - Tiles are copied with 16-byte loads into shared memory (k rows padded
//   for conflict-free reads); scores, the online softmax statistics and
//   the f32 accumulator live in shared memory, each owned by one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;   // cache rows per tile
constexpr int NT = 128;  // threads per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float4 load_quad(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// k rows in shared memory are padded so that row j starts at bank j
// (an odd number of 32-bit words per row): one word of elements
template <typename T> __host__ __device__ constexpr int k_pad() { return 4 / sizeof(T); }

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Layout {
  size_t v, k, q, acc, s, stats, scales, total;
};

// KV: the cache element type (the k/v tiles); int8 adds the tile's scales
template <typename KV>
Layout layout(int dim, int group) {
  Layout L;
  L.v = 0;
  L.k = L.v + align16(sizeof(KV) * size_t(BK) * dim);
  L.q = L.k + align16(sizeof(KV) * size_t(BK) * (dim + k_pad<KV>()));
  L.acc = L.q + align16(sizeof(float) * size_t(group) * dim);
  L.s = L.acc + align16(sizeof(float) * size_t(group) * dim);
  L.stats = L.s + align16(sizeof(float) * size_t(group) * BK);
  L.scales = L.stats + align16(sizeof(float) * 3 * size_t(group));
  L.total = L.scales + (is_int8<KV>() ? align16(sizeof(float) * 2 * BK) : 0);
  return L;
}

// T: the type of q and out. KV: the cache's, T itself, or int8_t with
// k_scale/v_scale [S, T, KVH] f32.
template <typename T, typename KV>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                    const KV* __restrict__ vc, T* __restrict__ out,
                    const int* __restrict__ lengths, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, int max_len, int heads,
                    int kv_heads, int dim, float scale, float softcap, int window,
                    Layout L) {
  constexpr bool QUANT = is_int8<KV>();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  KV* sV = reinterpret_cast<KV*>(base + L.v);
  KV* sK = reinterpret_cast<KV*>(base + L.k);
  float* sQ = reinterpret_cast<float*>(base + L.q);
  float* sAcc = reinterpret_cast<float*>(base + L.acc);
  float* sS = reinterpret_cast<float*>(base + L.s);
  const int group = heads / kv_heads;
  float* sM = reinterpret_cast<float*>(base + L.stats);
  float* sL = sM + group;
  float* sAlpha = sL + group;
  float* sKs = reinterpret_cast<float*>(base + L.scales);  // int8 only
  float* sVs = sKs + BK;

  const int kvh = blockIdx.x;
  const int slot = blockIdx.y;
  const int length = lengths[slot];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KP = dim + k_pad<KV>();
  const int gd = group * dim;

  const T* q_base = q + (size_t(slot) * heads + size_t(kvh) * group) * dim;
  for (int o = tid; o < gd; o += NT) {
    sQ[o] = to_f(q_base[o]);
    sAcc[o] = 0.f;
  }
  for (int gi = tid; gi < group; gi += NT) {
    sM[gi] = NEG_INF;
    sL[gi] = 0.f;
  }

  // live tiles: [first tile inside the window, last tile holding a live row]
  int first = 0;
  if (window > 0 && length - window > 0) first = (length - window) / BK;
  const int last = (length + BK - 1) / BK;  // exclusive

  const size_t row_stride = size_t(kv_heads) * dim;
  const KV* k_base = kc + size_t(slot) * max_len * row_stride + size_t(kvh) * dim;
  const KV* v_base = vc + size_t(slot) * max_len * row_stride + size_t(kvh) * dim;
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte load
  const int vecs_per_row = dim / VEC;
  const int words_per_vec = 4;

  for (int kt = first; kt < last; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * vecs_per_row; idx += NT) {
      const int j = idx / vecs_per_row;
      const int d = (idx % vecs_per_row) * VEC;
      const int t = k_start + j;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (t < max_len) {
        kw = *reinterpret_cast<const uint4*>(k_base + size_t(t) * row_stride + d);
        vw = *reinterpret_cast<const uint4*>(v_base + size_t(t) * row_stride + d);
      }
      *reinterpret_cast<uint4*>(sV + j * dim + d) = vw;
      uint32_t* kdst = reinterpret_cast<uint32_t*>(sK + j * KP + d);
      const uint32_t kwords[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int w = 0; w < words_per_vec; ++w) kdst[w] = kwords[w];
    }
    if constexpr (QUANT) {
      for (int j = tid; j < BK; j += NT) {
        const int t = k_start + j;
        const size_t at = (size_t(slot) * max_len + t) * kv_heads + kvh;
        sKs[j] = t < max_len ? k_scale[at] : 0.f;
        sVs[j] = t < max_len ? v_scale[at] : 0.f;
      }
    }
    __syncthreads();

    // scores: one thread per (query head of the group, cache row)
    for (int idx = tid; idx < group * BK; idx += NT) {
      const int gi = idx / BK, j = idx % BK;
      const float* qrow = sQ + gi * dim;
      const KV* krow = sK + j * KP;
      float acc = 0.f;
      if constexpr (QUANT) {
        for (int d = 0; d < dim; d += 4) {
          const float4 kv = load_quad(krow + d);
          acc += qrow[d] * kv.x + qrow[d + 1] * kv.y + qrow[d + 2] * kv.z + qrow[d + 3] * kv.w;
        }
      } else {
        for (int d = 0; d < dim; d += 2) {
          const float2 kv = load_pair(krow + d);
          acc += qrow[d] * kv.x + qrow[d + 1] * kv.y;
        }
      }
      // int8: the k scale multiplies the score of its row first
      float x = QUANT ? acc * sKs[j] * scale : acc * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sS[idx] = x;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int gi = warp; gi < group; gi += NT / 32) {
      float sv[BK / 32];
      bool ok[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u;
        const int col = k_start + j;
        ok[u] = col < length && (window <= 0 || col > (length - 1) - window);
        sv[u] = ok[u] ? sS[gi * BK + j] : NEG_INF;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[gi];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = ok[u] ? expf(sv[u] - m_new) : 0.f;
        psum += p;
        // int8: the v scale folds into p after l has summed it; f32 p.v
        sS[gi * BK + lane + 32 * u] = QUANT ? p * sVs[lane + 32 * u] : round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[gi] = alpha;
        sL[gi] = sL[gi] * alpha + psum;
        sM[gi] = m_new;
      }
    }
    __syncthreads();

    // p.v into the f32 accumulator: one thread per (query head, column)
    for (int o = tid; o < gd; o += NT) {
      const int gi = o / dim, d = o % dim;
      const float* prow = sS + gi * BK;
      float a = sAcc[o] * sAlpha[gi];
      for (int j = 0; j < BK; ++j) a += prow[j] * to_f(sV[j * dim + d]);
      sAcc[o] = a;
    }
  }
  __syncthreads();

  T* o_base = out + (size_t(slot) * heads + size_t(kvh) * group) * dim;
  for (int o = tid; o < gd; o += NT) {
    const float l = sL[o / dim];
    o_base[o] = from_f<T>(sAcc[o] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   const void* lengths, const void* k_scale, const void* v_scale, int slots,
                   int max_len, int heads, int kv_heads, int dim, float scale, float softcap,
                   int window, cudaStream_t stream) {
  const Layout L = layout<KV>(dim, heads / kv_heads);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
  if (err != cudaSuccess) return err;
  dim3 grid(kv_heads, slots);
  flash_decode_kernel<T, KV><<<grid, NT, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<T*>(out), static_cast<const int*>(lengths),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), max_len, heads,
      kv_heads, dim, scale, softcap, window, L);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. dim must be a multiple of 8 and at
// most 256. softcap <= 0 disables capping; window <= 0 is full attention.
// Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            void* out, const void* lengths, int slots,
                            int max_len, int heads, int kv_heads, int dim,
                            int dtype, float scale, float softcap, int window,
                            void* stream) {
  if (slots <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || dim % 8 != 0 || dim > 256 || dim <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, out, lengths, nullptr, nullptr, slots,
                                               max_len, heads, kv_heads, dim, scale, softcap,
                                               window, s);
  } else if (dtype == 1) {
    err = launch<float, float>(q, kc, vc, out, lengths, nullptr, nullptr, slots, max_len, heads,
                               kv_heads, dim, scale, softcap, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

// The int8 cache: kc/vc int8 [S, T, KVH, D] with k_scale/v_scale [S, T,
// KVH] f32; q/out of ``dtype`` (0 = bfloat16, 1 = float32). dim must be a
// multiple of 16 up to 256. Returns cudaGetLastError().
extern "C" int flash_decode_quant(const void* q, const void* kc, const void* k_scale,
                                  const void* vc, const void* v_scale, void* out,
                                  const void* lengths, int slots, int max_len, int heads,
                                  int kv_heads, int dim, int dtype, float scale, float softcap,
                                  int window, void* stream) {
  if (slots <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0 || dim % 16 != 0 || dim > 256 || dim <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<__nv_bfloat16, int8_t>(q, kc, vc, out, lengths, k_scale, v_scale, slots,
                                        max_len, heads, kv_heads, dim, scale, softcap, window, s);
  } else if (dtype == 1) {
    err = launch<float, int8_t>(q, kc, vc, out, lengths, k_scale, v_scale, slots, max_len,
                                heads, kv_heads, dim, scale, softcap, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}
