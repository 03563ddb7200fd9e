// Causal GQA flash attention for prefill, written for Hopper (sm_90a).
//
// Replaces: langstream_tpu/ops/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _pallas_flash, public API
// flash_prefill_attention). Same function: causal attention over
// right-padded prompts, per-row valid lengths, optional logit softcap
// (applied before masking), optional sliding window, custom score scale,
// online softmax in f32, p rounded to the input type before p.v.
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

namespace {

constexpr int BQ = 64;    // q rows per CTA
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads: 4 per q row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 4) + 2 * size_t(BK) * (D + 4) +
                          size_t(BQ) * (BK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ lengths, int seq, int heads,
                     int kv_heads, float scale, float softcap, int window) {
  constexpr int DP = D + 4;   // padded f32 row of q/k/v tiles
  constexpr int PP = BK + 4;  // padded f32 row of the p tile
  constexpr int NX = D / 16;  // float4 column groups per thread in p.v
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * DP;

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int length = lengths[b];
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row within the tile
  const int g = tid & 3;   // column phase within the row
  const int row = q_start + r;

  const size_t q_stride = size_t(heads) * D;
  const size_t kv_stride = size_t(kv_heads) * D;
  const T* q_base = q + size_t(b) * seq * q_stride + size_t(h) * D;
  const T* k_base = k + size_t(b) * seq * kv_stride + size_t(kvh) * D;
  const T* v_base = v + size_t(b) * seq * kv_stride + size_t(kvh) * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int rr = idx / D, dd = idx % D;
    const int t = q_start + rr;
    sQ[rr * DP + dd] = t < seq ? to_f(q_base[size_t(t) * q_stride + dd]) : 0.f;
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
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int rr = idx / D, dd = idx % D;
      const int t = k_start + rr;
      const bool in = t < seq;
      sK[rr * DP + dd] = in ? to_f(k_base[size_t(t) * kv_stride + dd]) : 0.f;
      sV[rr * DP + dd] = in ? to_f(v_base[size_t(t) * kv_stride + dd]) : 0.f;
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
      float x = s[i] * scale;
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
      sP[r * PP + i * 4 + g] = round_to<T>(p);
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
    T* o = out + (size_t(b) * seq + row) * q_stride + size_t(h) * D;
#pragma unroll
    for (int x = 0; x < NX; ++x) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[x * 16 + g * 4 + c] = from_f<T>(acc[x][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* lengths, int batch, int seq, int heads,
                   int kv_heads, float scale, float softcap, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_prefill_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(lengths), seq, heads, kv_heads,
      scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int dim, const void* q, const void* k, const void* v,
                         void* out, const void* lengths, int batch, int seq,
                         int heads, int kv_heads, float scale, float softcap,
                         int window, cudaStream_t stream) {
  switch (dim) {
    case 64:
      return launch<T, 64>(q, k, v, out, lengths, batch, seq, heads, kv_heads,
                           scale, softcap, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lengths, batch, seq, heads, kv_heads,
                            scale, softcap, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lengths, batch, seq, heads, kv_heads,
                            scale, softcap, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
