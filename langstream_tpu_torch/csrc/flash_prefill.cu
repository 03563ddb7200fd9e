// Causal GQA flash attention for prefill, written for Hopper (sm_90a).
//
// Replaces: langstream_tpu/ops/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _pallas_flash, public API
// flash_prefill_attention). Same function: causal attention over
// right-padded prompts, per-row valid lengths, optional logit softcap
// (applied before masking), optional sliding window, custom score scale,
// online softmax in f32, p rounded to the input type before p.v.
//
// Also replaces ::_flash_kernel_quant (flash_prefill_attention_quant), the
// same kernel over an int8 k/v window with one f32 scale per (position,
// kv head): entry point flash_prefill_quant, the KV = int8_t
// instantiation. k and v arrive as int8 (16 values per 16-byte load) and
// are widened to f32 in shared memory (exact); the k scale multiplies
// the score after q.k, before the softcap and the mask; l sums the
// masked p; then p * v_scale (f32, NOT rounded to q's type) multiplies v.
// The Pallas body rounds the scale-folded p to q's dtype before p.v; this
// kernel keeps it in f32 so that every int8 cold prefill on the card
// (there is no length threshold) agrees with chunk_attention_quant, the
// path that warm and long prefills take, and greedy decode does not
// drift between the two. head_dim may be any multiple of 16 up to 256:
// the tiles are sized for the next of 32/64/128/256 and the columns past
// head_dim are zeros.
//
// What bounds it on the H100: at the serving path's prompt buckets
// (T <= 1024, D = 128) causal prefill attention does ~2*B*H*T^2*D FLOPs
// over (q + k + v + out) bytes, i.e. ~T/2 FLOPs per byte: past T ~ 600
// the tensor cores (989 TFLOP/s bf16), below it HBM (3.35 TB/s) bound a
// perfect kernel. This first version does its products with FP32 FMAs on
// the CUDA cores (67 TFLOP/s), so it is compute bound at every T; moving
// the two products onto mma/wgmma is the next step.
//
// Design:
// - One CTA per (64-row q tile, q head, batch row); a loop inside the CTA
//   over 64-row k tiles takes the place of the TPU's sequential grid axis.
// - The CTA reads q/k/v straight from the model's [B, T, H, D] layout (no
//   transposed copies); GQA is by index (kv head = h / (H / KVH)).
// - k tiles wholly above the diagonal, wholly past the row's length, or
//   wholly before every row's window are never loaded.
// - q, k and v tiles are staged in shared memory as f32 with padded rows
//   (conflict-free float4 reads); each thread owns one q row and a quarter
//   of its columns; the online softmax state lives in registers and the
//   four threads of a row agree through warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;    // q rows per CTA
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads: 4 per q row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// the int8 kernel adds the k and v scales of one tile
template <typename KV, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 4) + 2 * size_t(BK) * (D + 4) +
                          size_t(BQ) * (BK + 4) + (is_int8<KV>() ? 2 * BK : 0));
}

// 16 int8 values (one 16-byte load) widened to f32 into 16 floats of a
// 16-byte aligned shared row
__device__ __forceinline__ void widen16(const uint4 w, float* dst) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&words[i]);
    reinterpret_cast<float4*>(dst)[i] = make_float4(c.x, c.y, c.z, c.w);
  }
}

// T: the type of q and out. KV: the type of k and v, T itself, or int8_t
// with k_scale/v_scale [B, T, KVH] f32. D: the tile width, head_dim for
// T-typed k/v; for int8 the next of 32/64/128/256 at or above ``dim``.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ lengths,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, int seq, int heads,
                     int kv_heads, int dim, float scale, float softcap, int window) {
  constexpr bool QUANT = is_int8<KV>();
  constexpr int DP = D + 4;   // padded f32 row of q/k/v tiles
  constexpr int PP = BK + 4;  // padded f32 row of the p tile
  constexpr int NX = D / 16;  // float4 column groups per thread in p.v
  constexpr int CH = D / 16;  // 16-column chunks of an int8 row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * DP;
  float* sKs = sP + BQ * PP;  // int8 only: the tile's k and v scales
  float* sVs = sKs + BK;
  // the model's head_dim: D itself unless the tiles are padded (int8)
  const int width = QUANT ? dim : D;

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int length = lengths[b];
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row within the tile
  const int g = tid & 3;   // column phase within the row
  const int row = q_start + r;

  const size_t q_stride = size_t(heads) * width;
  const size_t kv_stride = size_t(kv_heads) * width;
  const T* q_base = q + size_t(b) * seq * q_stride + size_t(h) * width;
  const KV* k_base = k + size_t(b) * seq * kv_stride + size_t(kvh) * width;
  const KV* v_base = v + size_t(b) * seq * kv_stride + size_t(kvh) * width;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int rr = idx / D, dd = idx % D;
    const int t = q_start + rr;
    if constexpr (QUANT) {
      sQ[rr * DP + dd] = t < seq && dd < width ? to_f(q_base[size_t(t) * q_stride + dd]) : 0.f;
    } else {
      sQ[rr * DP + dd] = t < seq ? to_f(q_base[size_t(t) * q_stride + dd]) : 0.f;
    }
  }

  // live k tiles: keys < min(last row of the tile + 1, length), and with
  // a window, keys > q_start - window (the earliest window start)
  const int k_end = min(q_start + BQ, length);
  const int kt_hi = (k_end + BK - 1) / BK;
  int kt_lo = 0;
  if (window > 0 && q_start - window + 1 > 0) kt_lo = (q_start - window + 1) / BK;

  float m = NEG_INF, l = 0.f;
  float acc[NX][4];
#pragma unroll
  for (int x = 0; x < NX; ++x) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[x][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    if constexpr (QUANT) {
      for (int idx = tid; idx < BK * CH; idx += NT) {
        const int rr = idx / CH, dd = (idx % CH) * 16;
        const int t = k_start + rr;
        uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
        if (t < seq && dd < width) {
          kw = *reinterpret_cast<const uint4*>(k_base + size_t(t) * kv_stride + dd);
          vw = *reinterpret_cast<const uint4*>(v_base + size_t(t) * kv_stride + dd);
        }
        widen16(kw, sK + rr * DP + dd);
        widen16(vw, sV + rr * DP + dd);
      }
      for (int rr = tid; rr < BK; rr += NT) {
        const int t = k_start + rr;
        const size_t at = (size_t(b) * seq + t) * kv_heads + kvh;
        sKs[rr] = t < seq ? k_scale[at] : 0.f;
        sVs[rr] = t < seq ? v_scale[at] : 0.f;
      }
    } else {
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int rr = idx / D, dd = idx % D;
        const int t = k_start + rr;
        const bool in = t < seq;
        sK[rr * DP + dd] = in ? to_f(k_base[size_t(t) * kv_stride + dd]) : 0.f;
        sV[rr * DP + dd] = in ? to_f(v_base[size_t(t) * kv_stride + dd]) : 0.f;
      }
    }
    __syncthreads();

    // s[i] = q[row] . k[k_start + 4 i + g]
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQ[r * DP + d]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[(i * 4 + g) * DP + d]);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    unsigned live = 0;
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = k_start + i * 4 + g;
      // int8: the k scale multiplies the score of its column first
      float x = QUANT ? s[i] * sKs[i * 4 + g] * scale : s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool ok = col <= row && col < length && (window <= 0 || col > row - window);
      s[i] = ok ? x : NEG_INF;
      live |= unsigned(ok) << i;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // p is zeroed (not just -inf shifted) so fully masked rows stay 0
      const float p = ((live >> i) & 1u) ? expf(s[i] - m_new) : 0.f;
      psum += p;
      // int8: the v scale folds into p after l has summed it; f32 p.v
      sP[r * PP + i * 4 + g] = QUANT ? p * sVs[i * 4 + g] : round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's p values come from the same warp

#pragma unroll
    for (int x = 0; x < NX; ++x) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[x][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = sP[r * PP + j];
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[j * DP + x * 16 + g * 4]);
        acc[x][0] += p * vv.x;
        acc[x][1] += p * vv.y;
        acc[x][2] += p * vv.z;
        acc[x][3] += p * vv.w;
      }
    }
  }

  if (row < seq) {
    const float denom = l == 0.f ? 1.f : l;
    T* o = out + (size_t(b) * seq + row) * q_stride + size_t(h) * width;
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      if (QUANT && x * 16 + g * 4 >= width) continue;  // a padded column group
#pragma unroll
      for (int c = 0; c < 4; ++c) o[x * 16 + g * 4 + c] = from_f<T>(acc[x][c] / denom);
    }
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* lengths, const void* k_scale, const void* v_scale,
                   int batch, int seq, int heads, int kv_heads, int dim, float scale,
                   float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<KV, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_prefill_kernel<T, KV, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<T*>(out), static_cast<const int*>(lengths),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), seq, heads,
      kv_heads, dim, scale, softcap, window);
  return cudaGetLastError();
}

// T-typed k/v: head_dim 64, 128 or 256, each its own tile width
template <typename T>
cudaError_t dispatch_dim(int dim, const void* q, const void* k, const void* v,
                         void* out, const void* lengths, int batch, int seq,
                         int heads, int kv_heads, float scale, float softcap,
                         int window, cudaStream_t stream) {
  switch (dim) {
    case 64:
      return launch<T, T, 64>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                              kv_heads, dim, scale, softcap, window, stream);
    case 128:
      return launch<T, T, 128>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                               kv_heads, dim, scale, softcap, window, stream);
    case 256:
      return launch<T, T, 256>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                               kv_heads, dim, scale, softcap, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// int8 k/v: any multiple of 16 up to 256, in the next tile width
template <typename T>
cudaError_t dispatch_quant(int dim, const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale, void* out,
                           const void* lengths, int batch, int seq, int heads,
                           int kv_heads, float scale, float softcap, int window,
                           cudaStream_t stream) {
  if (dim <= 0 || dim % 16 != 0 || dim > 256) return cudaErrorInvalidValue;
  if (dim <= 32)
    return launch<T, int8_t, 32>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                 kv_heads, dim, scale, softcap, window, stream);
  if (dim <= 64)
    return launch<T, int8_t, 64>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                 kv_heads, dim, scale, softcap, window, stream);
  if (dim <= 128)
    return launch<T, int8_t, 128>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                  kv_heads, dim, scale, softcap, window, stream);
  return launch<T, int8_t, 256>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                kv_heads, dim, scale, softcap, window, stream);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. softcap <= 0 disables capping;
// window <= 0 is full causal attention. Returns cudaGetLastError().
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* lengths, int batch,
                             int seq, int heads, int kv_heads, int dim,
                             int dtype, float scale, float softcap, int window,
                             void* stream) {
  if (batch <= 0 || seq <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dim<__nv_bfloat16>(dim, q, k, v, out, lengths, batch, seq, heads,
                                      kv_heads, scale, softcap, window, s);
  } else if (dtype == 1) {
    err = dispatch_dim<float>(dim, q, k, v, out, lengths, batch, seq, heads,
                              kv_heads, scale, softcap, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

// The int8 window: k/v int8 [B, T, KVH, D] with k_scale/v_scale
// [B, T, KVH] f32; q/out of ``dtype`` (0 = bfloat16, 1 = float32). dim
// must be a multiple of 16 up to 256. Returns cudaGetLastError().
extern "C" int flash_prefill_quant(const void* q, const void* k, const void* k_scale,
                                   const void* v, const void* v_scale, void* out,
                                   const void* lengths, int batch, int seq, int heads,
                                   int kv_heads, int dim, int dtype, float scale,
                                   float softcap, int window, void* stream) {
  if (batch <= 0 || seq <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_quant<__nv_bfloat16>(dim, q, k, v, k_scale, v_scale, out, lengths, batch,
                                        seq, heads, kv_heads, scale, softcap, window, s);
  } else if (dtype == 1) {
    err = dispatch_quant<float>(dim, q, k, v, k_scale, v_scale, out, lengths, batch, seq,
                                heads, kv_heads, scale, softcap, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}
