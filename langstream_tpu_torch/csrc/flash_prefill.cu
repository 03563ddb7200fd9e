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
// instantiations. k and v are widened in shared memory (exact); the k
// scale multiplies the score after q.k, before the softcap and the mask;
// l sums the masked p; then p * v_scale (NOT rounded to q's type)
// multiplies v. The Pallas body rounds the scale-folded p to q's dtype
// before p.v; this kernel keeps it at ~16 bits (f32 in the f32-q body) so
// that every int8 cold prefill on the card (there is no length threshold)
// agrees with chunk_attention_quant, the path that warm and long
// prefills take, and greedy decode does not drift between the two.
// head_dim may be any multiple of 16 up to 256: the tiles are sized for
// the next of 64/128/256 (32/64/128/256 in the f32-q body) and the
// columns past head_dim are zeros.
//
// What bounds it on the H100: at the serving path's prompt buckets
// (T <= 1024, D = 128) causal prefill attention does ~2*B*H*T^2*D FLOPs
// over (q + k + v + out) bytes, i.e. ~T/2 FLOPs per byte: past T ~ 600
// the tensor cores (989 TFLOP/s bf16), below it HBM (3.35 TB/s) bound a
// perfect kernel. So both products run on the tensor cores, fed by TMA.
//
// Design of the bf16-q body (flash_prefill_wgmma_kernel; B1, and B4 over
// int8 k/v), the shape of FlashAttention-3:
// - One CTA per (q tile, q head, batch row), q tiles walked from the last
//   (the longest) first. The CTA holds NWG consumer warpgroups of 64 q
//   rows each (two; one at D 256, where O alone is 128 f32 registers a
//   thread) and a producer warpgroup. With two consumer warpgroups the
//   CTA is 384 threads at 168 registers; setmaxnreg moves registers from
//   the producer (56) to the consumers (224).
// - The producer brings the q tile once, then the k and v tiles of 64 keys
//   (32 at D 256) into a three-stage ring, by TMA through 4-D tensor maps
//   over [B, T, KVH, D] (dims D, KVH, T, B): a tile never reaches into the
//   next batch row, and rows past T arrive as zeros. mbarriers hand the
//   stages over: "full" when the bytes have landed, "empty" when every
//   consumer warp is done with them. bf16 rows come in 64-column panels,
//   so that a panel's row is the 128-byte swizzle span; the wgmma
//   descriptors read the same swizzle.
// - Each consumer warpgroup computes S = Q.K^T with wgmma (both operands
//   in shared memory, K-major), applies scale, softcap and the
//   causal/length/window mask on the accumulator fragments (tiles inside
//   every bound skip the mask), runs the online softmax in registers
//   (hardware exp2; a row's state is shared by the four threads of a
//   quad), and computes O += P.V with wgmma, P from registers (the
//   accumulator fragment of S is the A fragment) and V from shared memory,
//   MN-major. S of the next tile is started before P.V of this one, and
//   the next softmax runs while P.V does. Tiles outside the warpgroup's
//   own rows' bounds are skipped; only the CTA's span is loaded (no tile
//   above the diagonal, none wholly past the length, none wholly before
//   every row's window).
// - int8 k/v (B4): TMA brings the int8 tiles (half the bytes, rows of
//   head_dim bytes, no swizzle). The producer warpgroup widens each into a
//   bf16 tile of the swizzled layout (byte permutes, exact) and stores the
//   tile's f32 scales beside it ([B, T, KVH] rows are 4 bytes, under TMA's
//   16-byte box; loaded a tile ahead). The k scale multiplies S after the
//   product; p * v_scale is split into a bf16 high part and the bf16
//   rounding of the rest, two P.V products, so p.v keeps ~16 bits. Tiles
//   are 64/128/256 wide; q's columns past head_dim arrive as zeros (TMA's
//   out-of-bounds fill) and so do the widened k/v columns.
// - No split over keys and no atomics: each CTA owns its output rows, and
//   the output is the same bit for bit from run to run.
//
// f32 q (tests only) keeps the first version's body,
// flash_prefill_fma_kernel: FP32 FMAs over f32 tiles in shared memory,
// one CTA per (64-row q tile, q head, batch row), a q row per four
// threads.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;    // q rows per CTA
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads: 4 per q row
constexpr float NEG_INF = -1e30f;

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

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

// f32 q and out (bf16 q takes the wgmma body below). KV: the type of k
// and v, float, or int8_t with k_scale/v_scale [B, T, KVH] f32. D: the
// tile width, head_dim for f32 k/v; for int8 the next of 32/64/128/256 at
// or above ``dim``.
template <typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_prefill_fma_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                         const KV* __restrict__ v, float* __restrict__ out,
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
  // warp-uniform to the compiler (a shuffle's result), so that branches
  // around the asynchronous products are known not to diverge
  const int length = __shfl_sync(0xffffffffu, lengths[b], 0);
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // q row within the tile
  const int g = tid & 3;   // column phase within the row
  const int row = q_start + r;

  const size_t q_stride = size_t(heads) * width;
  const size_t kv_stride = size_t(kv_heads) * width;
  const float* q_base = q + size_t(b) * seq * q_stride + size_t(h) * width;
  const KV* k_base = k + size_t(b) * seq * kv_stride + size_t(kvh) * width;
  const KV* v_base = v + size_t(b) * seq * kv_stride + size_t(kvh) * width;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int rr = idx / D, dd = idx % D;
    const int t = q_start + rr;
    if constexpr (QUANT) {
      sQ[rr * DP + dd] = t < seq && dd < width ? q_base[size_t(t) * q_stride + dd] : 0.f;
    } else {
      sQ[rr * DP + dd] = t < seq ? q_base[size_t(t) * q_stride + dd] : 0.f;
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
        sK[rr * DP + dd] = in ? float(k_base[size_t(t) * kv_stride + dd]) : 0.f;
        sV[rr * DP + dd] = in ? float(v_base[size_t(t) * kv_stride + dd]) : 0.f;
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
      sP[r * PP + i * 4 + g] = QUANT ? p * sVs[i * 4 + g] : p;
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
    float* o = out + (size_t(b) * seq + row) * q_stride + size_t(h) * width;
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      if (QUANT && x * 16 + g * 4 >= width) continue;  // a padded column group
#pragma unroll
      for (int c = 0; c < 4; ++c) o[x * 16 + g * 4 + c] = acc[x][c] / denom;
    }
  }
}

template <typename KV, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       const void* lengths, const void* k_scale, const void* v_scale,
                       int batch, int seq, int heads, int kv_heads, int dim, float scale,
                       float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<KV, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_fma_kernel<KV, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_prefill_fma_kernel<KV, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<float*>(out), static_cast<const int*>(lengths),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), seq, heads,
      kv_heads, dim, scale, softcap, window);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16-q body: TMA into an mbarrier ring, wgmma for both products
// ------------------------------------------------------------------------

constexpr int WG_ROWS = 64;  // q rows of a consumer warpgroup (the wgmma M)
constexpr int STAGES = 3;    // k/v tiles in flight
constexpr int PANEL = 64;    // bf16 columns of a 128-byte swizzle span
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;

template <typename KV, int D, int NWG>
struct Wg {
  static constexpr bool QUANT = is_int8<KV>();
  // keys of a k/v tile: 32 at D 256, where O (128 registers a thread)
  // leaves no room for two 64-key score tiles and the p fragments
  static constexpr int KT = D == 256 ? 32 : 64;
  static constexpr int NP = D / PANEL;          // 64-column panels of a row
  static constexpr int NC = 128 * NWG;          // consumer threads
  // the producer warpgroup: one thread starts the TMA copies; for int8
  // all 128 also widen the tiles and store their scales
  static constexpr int NPROD = 128;
  static constexpr int NT = NC + NPROD;
  static constexpr int BQ = WG_ROWS * NWG;      // q rows of the CTA
  static constexpr uint32_t Q_PANEL = WG_ROWS * 128;
  static constexpr uint32_t KV_PANEL = KT * 128;
  static constexpr uint32_t TILE = NP * KV_PANEL;               // a bf16 k or v tile
  static constexpr uint32_t Q_BYTES = NWG * NP * Q_PANEL;
  static constexpr uint32_t SLOT = QUANT ? KT * D : TILE;       // a k or v tile of the TMA ring
  // byte offsets from a 1024-aligned base (the 128-byte swizzle repeats
  // every 8 rows of 128 bytes, and TMA and wgmma both count from there)
  static constexpr uint32_t Q_AT = 0;
  static constexpr uint32_t RING_AT = Q_AT + Q_BYTES;                // [STAGES][k, v]
  static constexpr uint32_t WIDE_AT = RING_AT + STAGES * 2 * SLOT;    // int8: [STAGES][k, v]
  static constexpr uint32_t SCALES_AT = WIDE_AT + (QUANT ? STAGES * 2 * TILE : 0);
  static constexpr uint32_t BARS_AT = SCALES_AT + (QUANT ? STAGES * 2 * KT * 4 : 0);
  static constexpr size_t SMEM = BARS_AT + (3 * STAGES + 1) * 8 + 1024;
  static_assert(SLOT % 1024 == 0 && Q_BYTES % 1024 == 0, "tiles stay 1024-aligned");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  // two consumer warpgroups make 384 threads, 168 registers each at
  // launch: the producer warpgroup hands registers to the consumers
  // (128 x 56 + 256 x 224 = 384 x 168)
  static constexpr bool REBALANCE = NWG == 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the int8 producer warpgroup's threads meet at named barrier 1
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major tiles (q, k):
// 8-row groups of 128-byte rows, SBO 1024 between them, LBO unused.
// MN-major (v, read as [key][column]): SBO 1024 between 8-key groups, LBO
// the stride between 64-column panels.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// d (64 x 64, f32) = a (64 x 16) . b (16 x 64) (+ d unless scale_d is 0), a
// and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// the same product at n 32 (32-key tiles)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += a (64 x 16, bf16 pairs in registers, the m16n8k16 A
// fragment of each warp's 16 rows) . b (16 x 64, shared memory, MN-major:
// stored [k][n] with n contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x, the hardware approximation (subnormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 values (one word) as two bf16 pairs, exactly and without
// int-to-float conversions: each byte + 128 becomes the low byte of the
// float 2^23 + (x + 128), less 2^23 + 128 that is x, whose top half is
// bf16(x) (x has at most 8 significant bits)
__device__ __forceinline__ void widen4(uint32_t w, uint32_t* lo, uint32_t* hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
  *lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  *hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// an int8 tile (KT rows of ``dim`` bytes, as TMA left it) widened by N
// threads into a bf16 tile of D columns in 64-column panels, 128-byte
// swizzled as TMA would have stored it; columns past ``dim`` are zeros
template <int D, int KT, int N>
__device__ __forceinline__ void widen_tile(const uint8_t* src, uint8_t* dst, int dim, int tid) {
  constexpr int CH = D / 16;  // 16-value chunks of a row
#pragma unroll
  for (int idx = tid; idx < KT * CH; idx += N) {
    const int r = idx / CH, j = idx % CH;
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (j * 16 < dim) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + r * dim + j * 16);
      widen4(x.x, &w[0], &w[1]);
      widen4(x.y, &w[2], &w[3]);
      widen4(x.z, &w[4], &w[5]);
      widen4(x.w, &w[6], &w[7]);
    }
    uint8_t* row = dst + (j / 4) * (KT * 128) + r * 128;
    const int c = (j % 4) * 2;  // the first of the two 16-byte chunks
    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// KV: __nv_bfloat16 (B1) or int8_t with k_scale/v_scale [B, T, KVH] f32
// (B4). D: the tile width, head_dim for bf16 k/v, the next of 64/128/256
// for int8. NWG: consumer warpgroups of 64 q rows.
template <typename KV, int D, int NWG>
__global__ void __launch_bounds__(Wg<KV, D, NWG>::NT, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out, const int* __restrict__ lengths,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, int seq, int heads,
                           int kv_heads, int dim, float scale, float softcap, int window) {
  using L = Wg<KV, D, NWG>;
  constexpr bool QUANT = L::QUANT;
  constexpr int KT = L::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // full: a stage's TMA bytes have landed; empty: every consumer warp is
  // done with the stage; ready (int8): the stage is widened, its scales
  // stored
  const uint32_t full_bar = base + L::BARS_AT;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t ready_bar = empty_bar + 8 * STAGES;
  const uint32_t q_bar = ready_bar + 8 * STAGES;
  float* scales = reinterpret_cast<float*>(smem + L::SCALES_AT);  // int8: [STAGES][k, v][KT]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * L::BQ;  // the longest tiles first
  const int kvh = h / (heads / kv_heads);
  // warp-uniform to the compiler (a shuffle's result), so that branches
  // around the asynchronous products are known not to diverge
  const int length = __shfl_sync(0xffffffffu, lengths[b], 0);
  // the CTA's key tiles: keys < min(last row + 1, length), and with a
  // window, keys > q_start - window (the earliest window start)
  const int k_end = min(q_start + L::BQ, length);
  const int kt_hi = k_end > 0 ? (k_end + KT - 1) / KT : 0;
  const int kt_lo = window > 0 && q_start - window + 1 > 0 ? (q_start - window + 1) / KT : 0;
  const int tiles = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, L::NC / 32);  // one arrival per consumer warp
      mbar_init(ready_bar + 8 * s, L::NPROD);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  if (warp >= 4 * NWG) {  // the producer
    if constexpr (L::REBALANCE) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tiles <= 0) return;
    const int pt = threadIdx.x - L::NC;
    const auto load_kv = [&](int i) {  // tile i's k and v into stage i % STAGES
      const int s = i % STAGES, k0 = (kt_lo + i) * KT;
      const uint32_t full = full_bar + 8 * s;
      const uint32_t k_dst = base + L::RING_AT + 2 * s * L::SLOT, v_dst = k_dst + L::SLOT;
      if constexpr (QUANT) {  // whole rows of head_dim bytes
        mbar_expect_tx(full, 2u * KT * dim);
        tma_load(k_dst, &tk, full, 0, kvh, k0, b);
        tma_load(v_dst, &tv, full, 0, kvh, k0, b);
      } else {
        mbar_expect_tx(full, 2 * L::TILE);
        for (int p = 0; p < L::NP; ++p) {
          tma_load(k_dst + p * L::KV_PANEL, &tk, full, p * PANEL, kvh, k0, b);
          tma_load(v_dst + p * L::KV_PANEL, &tv, full, p * PANEL, kvh, k0, b);
        }
      }
    };
    if (pt == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int g = 0; g < NWG; ++g)
        for (int p = 0; p < L::NP; ++p)
          tma_load(base + L::Q_AT + (g * L::NP + p) * L::Q_PANEL, &tq, q_bar, p * PANEL, h,
                   q_start + g * WG_ROWS, b);
    }
    if constexpr (!QUANT) {
      if (pt != 0) return;
      for (int i = 0; i < tiles; ++i) {
        mbar_wait(empty_bar + 8 * (i % STAGES), ((i / STAGES) & 1) ^ 1);  // round 0 passes
        load_kv(i);
      }
    } else {
      // the TMA ring feeds this warpgroup, which widens each stage into
      // the consumers' bf16 tiles; the ring's slot is free again once all
      // 128 threads have read it
      if (pt == 0)
        for (int i = 0; i < min(tiles, STAGES); ++i) load_kv(i);
      // threads pt < 2 KT each carry one scale of a tile (k scales, then v
      // scales), loaded a tile ahead so that the load's latency is hidden
      const auto scale_of = [&](int i) {
        const int t = (kt_lo + i) * KT + pt % KT;
        const size_t at = (size_t(b) * seq + t) * kv_heads + kvh;
        return pt < 2 * KT && t < seq ? (pt < KT ? k_scale : v_scale)[at] : 0.f;
      };
      float scale_next = scale_of(0);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        const float scale_here = scale_next;
        if (i + 1 < tiles) scale_next = scale_of(i + 1);
        mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint8_t* ring = smem + L::RING_AT + 2 * s * L::SLOT;
        uint8_t* wide = smem + L::WIDE_AT + 2 * s * L::TILE;
        widen_tile<D, KT, 128>(ring, wide, dim, pt);
        widen_tile<D, KT, 128>(ring + L::SLOT, wide + L::TILE, dim, pt);
        if (pt < 2 * KT) scales[(2 * s) * KT + pt] = scale_here;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(ready_bar + 8 * s);
        producers_sync();
        if (pt == 0 && i + STAGES < tiles) load_kv(i + STAGES);
      }
    }
    return;
  }

  if constexpr (L::REBALANCE) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");

  // a consumer warpgroup: rows r_lo .. r_lo + 63 of the CTA's q tile
  const int g = warp / 4;
  const int r_lo = q_start + g * WG_ROWS;
  // the accumulator fragment: this thread's rows (row0, row0 + 8) and, in
  // every 8 columns, the pair of columns at cq
  const int row0 = r_lo + (warp % 4) * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  // the warpgroup's own key tiles, loop steps [i0, i1) of the CTA's
  const int w_end = r_lo < seq ? min(r_lo + WG_ROWS, length) : 0;  // none: rows past T
  const int w_hi = w_end > 0 ? (w_end + KT - 1) / KT : 0;
  const int w_lo = window > 0 && r_lo - window + 1 > 0 ? (r_lo - window + 1) / KT : 0;
  const int i0 = min(max(w_lo - kt_lo, 0), max(tiles, 0));
  const int i1 = max(min(w_hi - kt_lo, tiles), i0);
  const uint32_t q_tile = base + L::Q_AT + g * L::NP * L::Q_PANEL;
  const float scale_log2 = scale * LOG2E;

  const auto wait_tile = [&](int i) {
    mbar_wait((QUANT ? ready_bar : full_bar) + 8 * (i % STAGES), (i / STAGES) & 1);
  };
  // a warp's threads have all passed the wait that retired the stage's
  // products (it is warp-synchronous), so one of them arrives for all
  const auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty_bar + 8 * (i % STAGES));
  };
  const auto k_tile_of = [&](int i) -> uint32_t {
    const int s = i % STAGES;
    return base + (QUANT ? L::WIDE_AT + 2 * s * L::TILE : L::RING_AT + 2 * s * L::SLOT);
  };
  // S = Q K^T of step i into acc, started and committed, not waited for
  const auto start_scores = [&](float (&acc)[KT / 2], int i) {
    const uint32_t k_tile = k_tile_of(i);
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) acc[e] = 0.f;
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // int8: columns past dim are zeros
      const uint32_t at = (kk % 4) * 32;     // 16 columns = 32 bytes into the panel
      wgmma_ss(acc, desc_sw128(q_tile + (kk / 4) * L::Q_PANEL + at, 16, 1024),
               desc_sw128(k_tile + (kk / 4) * L::KV_PANEL + at, 16, 1024), kk);
    }
    wgmma_commit();
  };

  float o[L::NP][32];
#pragma unroll
  for (int c = 0; c < L::NP; ++c) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (tiles > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < i0; ++i) {  // tiles before the warpgroup's rows' windows
    wait_tile(i);
    release(i);
  }
  // The live steps, pipelined as FlashAttention-3 does within a
  // warpgroup: S of step i + 1 is started before O += P V of step i, and
  // the softmax of step i + 1 runs on the CUDA cores while P V of step i
  // runs on the tensor cores. Each step begins with nothing in flight and
  // every wait retires a known group; a stage is released once P V of its
  // step has completed.
  float sacc[KT / 2];
  using Frag = uint32_t[KT / 16][4];
  Frag pa, pb;  // pb: int8 only
  float alpha[2];

  // sacc of step i: scale, softcap, mask (log2 units; each a uniform
  // branch around a whole loop; tiles inside every bound of every row of
  // the warpgroup skip the mask), then the online softmax: sacc becomes p,
  // alpha the rescale of O for this step
  const auto softmax = [&](int i) {
    const int k0 = (kt_lo + i) * KT;
    const float* sc = scales + 2 * (i % STAGES) * KT;  // int8: k scales, then v scales
    if constexpr (QUANT) {  // the k scale multiplies the score first
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const float2 ks = *reinterpret_cast<const float2*>(sc + 8 * n + cq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sacc[4 * n + 2 * r] *= ks.x;
          sacc[4 * n + 2 * r + 1] *= ks.y;
        }
      }
    }
    if (softcap > 0.f) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        sacc[e] = softcap * tanhf(sacc[e] * scale / softcap) * LOG2E;
    } else {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) sacc[e] *= scale_log2;
    }
    const bool masked = !(k0 + KT - 1 <= r_lo && k0 + KT <= length &&
                          (window <= 0 || k0 > r_lo + WG_ROWS - 1 - window));
    if (masked) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + cq + (e & 1), row = (e & 2) ? row1 : row0;
        const bool ok = col <= row && col < length && (window <= 0 || col > row - window);
        sacc[e] = ok ? sacc[e] : NEG_INF;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);  // 1 while the row has seen no key
      m[r] = mx[r];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) {
      const int half = (e >> 1) & 1;
      const float p = fast_exp2(sacc[e] - m[half]);
      // a masked p is zeroed, not just shifted, so that rows with no key
      // so far (m still the sentinel) stay 0
      sacc[e] = masked && sacc[e] == NEG_INF ? 0.f : p;
      psum[half] += sacc[e];
    }
    l[0] = l[0] * alpha[0] + psum[0];  // this thread's part of the row sum
    l[1] = l[1] * alpha[1] + psum[1];
  };
  // p of step i as the A fragments of 16-key steps: keys 16 kk .. 16 kk +
  // 15 are the accumulator's column groups 2 kk and 2 kk + 1. B1 rounds p
  // to bf16; B4 folds the v scale into p and splits it in two bf16 parts
  const auto pack = [&](int i) {
    const float* sc = scales + 2 * (i % STAGES) * KT + KT;  // int8: the v scales
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // f: row half f & 1 of column group 2 kk + f / 2
        const int idx = 8 * kk + 4 * (f >> 1) + 2 * (f & 1);
        if constexpr (QUANT) {
          const float2 vs = *reinterpret_cast<const float2*>(sc + 8 * (idx / 4) + cq);
          const float x0 = sacc[idx] * vs.x, x1 = sacc[idx + 1] * vs.y;
          const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
          const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
          pa[kk][f] = pack_bf16(h0, h1);
          pb[kk][f] = pack_bf16(x0 - h0, x1 - h1);
        } else {
          pa[kk][f] = pack_bf16(sacc[idx], sacc[idx + 1]);
        }
      }
    }
  };
  // O *= alpha, then O += P V of step i (64 columns of O per product, 16
  // keys per step), started and committed, not waited for
  const auto start_pv = [&](int i) {
#pragma unroll
    for (int c = 0; c < L::NP; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    }
    const uint32_t v_tile = k_tile_of(i) + L::TILE;
    hold(pa);
    if constexpr (QUANT) hold(pb);
#pragma unroll
    for (int c = 0; c < L::NP; ++c) hold(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < L::NP; ++c) {
        const uint64_t vd =
            desc_sw128(v_tile + c * L::KV_PANEL + kk * 16 * 128, L::KV_PANEL, 1024);
        wgmma_rs(o[c], pa[kk], vd);
        if constexpr (QUANT) wgmma_rs(o[c], pb[kk], vd);
      }
    }
    wgmma_commit();
  };
  const auto hold_o = [&]() {
#pragma unroll
    for (int c = 0; c < L::NP; ++c) hold(o[c]);
  };

  if (i0 < i1) {
    wait_tile(i0);
    start_scores(sacc, i0);
    wgmma_wait<0>();
    hold(sacc);
    softmax(i0);
    pack(i0);
    for (int i = i0; i < i1 - 1; ++i) {
      wait_tile(i + 1);
      start_scores(sacc, i + 1);  // sacc is free: p of step i is in pa
      start_pv(i);
      wgmma_wait<1>();  // the scores of step i + 1
      hold(sacc);
      softmax(i + 1);
      wgmma_wait<0>();  // P V of step i
      hold_o();
      release(i);
      pack(i + 1);
    }
    start_pv(i1 - 1);
    wgmma_wait<0>();
    hold_o();
    release(i1 - 1);
  }
  for (int i = i1; i < tiles; ++i) {  // tiles past the warpgroup's rows
    wait_tile(i);
    release(i);
  }

  // the row sums over the quad; rows that saw no key write zeros
  const int width = QUANT ? dim : D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r ? row1 : row0;
    if (row >= seq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    __nv_bfloat16* dst = out + (size_t(b) * seq + row) * heads * width + size_t(h) * width;
#pragma unroll
    for (int c = 0; c < L::NP; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * PANEL + 8 * n + cq;
        if (QUANT && col >= width) continue;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[c][4 * n + 2 * r] * inv, o[c][4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// the result of a failed tensor-map encode: ENCODE_FAILED + the CUresult
constexpr int ENCODE_FAILED = 10000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over a contiguous [batch, seq, n, width] tensor (dims width, n,
// seq, batch) with boxes of {box0, 1, rows, 1}; out-of-bounds elements
// arrive as zeros
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, uint64_t elem, const void* ptr,
                int batch, int seq, int n, int width, int box0, int rows, bool swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(n), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {elem * width, elem * width * n, elem * width * n * seq};
  const cuuint32_t box[4] = {cuuint32_t(box0), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename KV, int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const void* lengths,
                 const void* k_scale, const void* v_scale, int batch, int seq, int heads,
                 int kv_heads, int dim, float scale, float softcap, int window,
                 cudaStream_t stream) {
  using L = Wg<KV, D, NWG>;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  // int8 k/v: whole rows of head_dim bytes, unswizzled, widened later
  const auto encode_kv = [&](CUtensorMap* map, const void* ptr) {
    return L::QUANT ? encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, batch, seq, kv_heads,
                             dim, dim, L::KT, false)
                    : encode(map, BF16, 2, ptr, batch, seq, kv_heads, dim, PANEL, L::KT, true);
  };
  CUresult r = encode(&tq, BF16, 2, q, batch, seq, heads, dim, PANEL, WG_ROWS, true);
  if (r == CUDA_SUCCESS) r = encode_kv(&tk, k);
  if (r == CUDA_SUCCESS) r = encode_kv(&tv, v);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + int(r);
  const cudaError_t err = cudaFuncSetAttribute(flash_prefill_wgmma_kernel<KV, D, NWG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(L::SMEM));
  if (err != cudaSuccess) return int(err);
  dim3 grid(heads, batch, (seq + L::BQ - 1) / L::BQ);
  flash_prefill_wgmma_kernel<KV, D, NWG><<<grid, L::NT, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<const int*>(lengths),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), seq, heads,
      kv_heads, dim, scale, softcap, window);
  return int(cudaGetLastError());
}

// bf16 q, k, v: head_dim 64, 128 or 256; two consumer warpgroups, one at
// D 256 (O is then 128 f32 registers a thread)
int dispatch_bf16(int dim, const void* q, const void* k, const void* v, void* out,
                  const void* lengths, int batch, int seq, int heads, int kv_heads, float scale,
                  float softcap, int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  switch (dim) {
    case 64:
      return launch_wgmma<T, 64, 2>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                                    kv_heads, dim, scale, softcap, window, stream);
    case 128:
      return launch_wgmma<T, 128, 2>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                                     kv_heads, dim, scale, softcap, window, stream);
    case 256:
      return launch_wgmma<T, 256, 1>(q, k, v, out, lengths, nullptr, nullptr, batch, seq, heads,
                                     kv_heads, dim, scale, softcap, window, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// bf16 q over int8 k/v: any multiple of 16 up to 256, in the next tile width
int dispatch_bf16_quant(int dim, const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale, void* out, const void* lengths,
                        int batch, int seq, int heads, int kv_heads, float scale, float softcap,
                        int window, cudaStream_t stream) {
  if (dim <= 0 || dim % 16 != 0 || dim > 256) return int(cudaErrorInvalidValue);
  if (dim <= 64)
    return launch_wgmma<int8_t, 64, 2>(q, k, v, out, lengths, k_scale, v_scale, batch, seq,
                                       heads, kv_heads, dim, scale, softcap, window, stream);
  if (dim <= 128)
    return launch_wgmma<int8_t, 128, 2>(q, k, v, out, lengths, k_scale, v_scale, batch, seq,
                                        heads, kv_heads, dim, scale, softcap, window, stream);
  return launch_wgmma<int8_t, 256, 1>(q, k, v, out, lengths, k_scale, v_scale, batch, seq,
                                      heads, kv_heads, dim, scale, softcap, window, stream);
}

// f32 q, k, v (the FMA body): head_dim 64, 128 or 256
int dispatch_f32(int dim, const void* q, const void* k, const void* v, void* out,
                 const void* lengths, int batch, int seq, int heads, int kv_heads, float scale,
                 float softcap, int window, cudaStream_t stream) {
  switch (dim) {
    case 64:
      return launch_fma<float, 64>(q, k, v, out, lengths, nullptr, nullptr, batch, seq,
                                          heads, kv_heads, dim, scale, softcap, window, stream);
    case 128:
      return launch_fma<float, 128>(q, k, v, out, lengths, nullptr, nullptr, batch, seq,
                                           heads, kv_heads, dim, scale, softcap, window, stream);
    case 256:
      return launch_fma<float, 256>(q, k, v, out, lengths, nullptr, nullptr, batch, seq,
                                           heads, kv_heads, dim, scale, softcap, window, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// f32 q over int8 k/v (the FMA body): tiles of the next of 32/64/128/256
int dispatch_f32_quant(int dim, const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, void* out, const void* lengths, int batch, int seq,
                       int heads, int kv_heads, float scale, float softcap, int window,
                       cudaStream_t stream) {
  if (dim <= 0 || dim % 16 != 0 || dim > 256) return int(cudaErrorInvalidValue);
  if (dim <= 32)
    return launch_fma<int8_t, 32>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                     kv_heads, dim, scale, softcap, window, stream);
  if (dim <= 64)
    return launch_fma<int8_t, 64>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                     kv_heads, dim, scale, softcap, window, stream);
  if (dim <= 128)
    return launch_fma<int8_t, 128>(q, k, v, out, lengths, k_scale, v_scale, batch, seq,
                                      heads, kv_heads, dim, scale, softcap, window, stream);
  return launch_fma<int8_t, 256>(q, k, v, out, lengths, k_scale, v_scale, batch, seq, heads,
                                    kv_heads, dim, scale, softcap, window, stream);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. softcap <= 0 disables capping;
// window <= 0 is full causal attention. Returns cudaGetLastError(), or
// 10000 + the CUresult when a tensor map cannot be encoded (bf16: q, k
// and v must be 16-byte aligned).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* lengths, int batch,
                             int seq, int heads, int kv_heads, int dim,
                             int dtype, float scale, float softcap, int window,
                             void* stream) {
  if (batch <= 0 || seq <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bf16(dim, q, k, v, out, lengths, batch, seq, heads, kv_heads, scale,
                         softcap, window, s);
  if (dtype == 1)
    return dispatch_f32(dim, q, k, v, out, lengths, batch, seq, heads, kv_heads, scale, softcap,
                        window, s);
  return int(cudaErrorInvalidValue);
}

// The int8 window: k/v int8 [B, T, KVH, D] with k_scale/v_scale
// [B, T, KVH] f32; q/out of ``dtype`` (0 = bfloat16, 1 = float32). dim
// must be a multiple of 16 up to 256. Returns as flash_prefill.
extern "C" int flash_prefill_quant(const void* q, const void* k, const void* k_scale,
                                   const void* v, const void* v_scale, void* out,
                                   const void* lengths, int batch, int seq, int heads,
                                   int kv_heads, int dim, int dtype, float scale,
                                   float softcap, int window, void* stream) {
  if (batch <= 0 || seq <= 0) return int(cudaSuccess);
  if (kv_heads <= 0 || heads % kv_heads != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bf16_quant(dim, q, k, v, k_scale, v_scale, out, lengths, batch, seq, heads,
                               kv_heads, scale, softcap, window, s);
  if (dtype == 1)
    return dispatch_f32_quant(dim, q, k, v, k_scale, v_scale, out, lengths, batch, seq, heads,
                              kv_heads, scale, softcap, window, s);
  return int(cudaErrorInvalidValue);
}
