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
// KV = int8_t instantiation. The k scale multiplies the score after q.k,
// before the softcap and the mask; l sums the masked p; then p * v_scale
// multiplies v at about f32 precision, as the Pallas body does. Its bytes
// per live position and kv head are 2*D + 8 instead of 4*D. head_dim must
// be a multiple of 16 for int8.
//
// What bounds it on the H100: bytes. Per slot it does 4*H*len*D FLOPs
// over 2*KVH*len*D cache elements, i.e. ~G FLOPs per byte (G = H/KVH = 4
// for Llama-3-8B), far below the ~295 FLOPs per byte where the tensor
// cores would take over. The levers are to read only the live context,
// to keep enough of it in flight to fill HBM, and to spread a long slot
// over many SMs so that the longest slot does not set the time.
//
// Design of the bf16-q body (flash_decode_mma_kernel, B2 and B5):
// - The grid is (kv head x 16-head tile of its group, slot, CTA of the
//   slot). A slot has one CTA per MIN_CHUNK allocated keys, at most
//   MAX_CLUSTER (ctas_per_slot): the grid depends on the shapes only,
//   never on the lengths, so it is known on the host without a read from
//   the card and the launch is capturable. The CTAs of one (kv head,
//   slot) are one thread-block cluster.
// - The slot's live key tiles, from the tile holding the window's first
//   key to the tile holding the last live key, are split evenly over the
//   first CTAs of the cluster, at least one tile each (the split depends
//   on the length, read on the card). Rows outside [window start, length)
//   are zero-filled by the copy, never read, so the bytes follow the live
//   context. The CTAs past the used ones leave at once.
// - Inside a CTA each key group (one warp, two at D > 128 with half of
//   O's columns each) owns 16 keys of every key tile and its own copy
//   ring of STAGES stages, filled by 16-byte cp.async.cg copies, so the
//   walk needs no CTA-wide barrier and every warp computes. The G query
//   heads of the tile are the rows of one m16 tile: S = Q.K^T and
//   O += P.V run on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//   ldmatrix (.trans for V); q's fragments stay in registers (read from
//   shared memory at each tile at D 256); m, l and O stay in registers;
//   the online softmax runs on the S fragments in log2 units (ex2.approx)
//   with alpha exactly 1 where the max holds; P goes from the S accumulators to the
//   A operand of P.V without shared memory.
// - int8 (B5): the ring carries the int8 rows and their scales (4-byte
//   cp.async in the same stage); each key group widens its landed rows
//   to bf16 in one pass (byte permutes, exact). p * v_scale runs through
//   P.V as a bf16 high part and a bf16 low part.
// - The partial results (m, l, O) are combined in a fixed order with the
//   usual rescale: first over the key groups of a CTA, through shared
//   memory; then over the used CTAs of the cluster, in key order, through
//   distributed shared memory (mapa, ld.shared::cluster), each CTA writing
//   its share of the output. No atomics: the output is the same bits from
//   launch to launch. A CTA that is read stays until the second cluster
//   barrier; an exited CTA counts as arrived at both.
// - What sets the sizes (measured on the H100, PERF.md): occupancy. Two
//   ring stages keep a D 128 CTA at ~74 KB of shared memory and 168
//   registers or fewer, 3 CTAs an SM; a third stage (2 CTAs an SM) and
//   larger clusters (more CTAs for the same tiles) were slower.
// - Head dims are padded with zeros in shared memory to DP, the next of
//   64, 128, 256, so D 16, 72, 80 and the like run through the same code.
//
// f32 q (tests only; the model on the card is bf16) keeps the first
// version's body (fp32::flash_decode_fma_kernel): one CTA per (kv head,
// slot), synchronous 16-byte loads, FP32 FMAs with the scores, the
// softmax statistics and the accumulator in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Launches of each kernel form of this library, counted on the card by
// the grid's first thread, so a kernel replayed from a CUDA graph counts
// once per replay; read and zeroed through flash_decode_launch_counts.
// Forms: 0 bf16 KV (B2), 1 int8 KV (B5).
constexpr int FORMS = 2;
__device__ unsigned long long g_launches[FORMS];

__device__ __forceinline__ void count_launch(int form) {
  if (threadIdx.x + threadIdx.y + threadIdx.z == 0 && blockIdx.x + blockIdx.y + blockIdx.z == 0)
    atomicAdd(&g_launches[form], 1ull);
}

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// ====================================================================== //
// The f32 body: FP32 FMAs, one CTA per (kv head, slot).
// ====================================================================== //
namespace fp32 {

constexpr int BK = 64;   // cache rows per tile
constexpr int NT = 128;  // threads per CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }

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
flash_decode_fma_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                    const KV* __restrict__ vc, T* __restrict__ out,
                    const int* __restrict__ lengths, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, int max_len, int heads,
                    int kv_heads, int dim, float scale, float softcap, int window,
                    Layout L) {
  constexpr bool QUANT = is_int8<KV>();
  count_launch(QUANT);
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

}  // namespace fp32

// ====================================================================== //
// The bf16-q body: a slot's key tiles over a cluster, a cp.async ring per
// key group, tensor-core products, state in registers.
// ====================================================================== //
constexpr int STAGES = 2;        // ring stages of each key group
constexpr int KW = 16;           // keys of a key tile per key group (the mma's k)
constexpr int MIN_CHUNK = 512;   // allocated keys per CTA of a slot's cluster, at the least
constexpr int MAX_CLUSTER = 2;   // CTAs per slot, at the most

// DP: the head dim padded to the mma's k (64, 128 or 256)
template <typename KV, int DP>
struct Mma {
  static constexpr bool QUANT = is_int8<KV>();
  // warps per key group, each with its share of O's columns: at D 256 a
  // whole row of O (128 f32 registers) beside the rest would spill
  static constexpr int COLS = DP <= 128 ? 1 : 2;
  static constexpr int KG = DP <= 128 ? 4 : 2;  // key groups
  static constexpr int BK = KG * KW;            // keys per key tile: dim alone sets it
  static constexpr int NT = 32 * KG * COLS;
  // CTAs an SM should hold (registers for them): shared memory allows 3
  // at D <= 128
  static constexpr int MIN_BLOCKS = DP <= 128 ? 3 : 1;
  static constexpr int PITCH = DP + 8;          // bf16 row pitch: ldmatrix without conflicts
  static constexpr bool Q_IN_REGS = DP <= 128;
  // a key group's share of a ring stage: its k rows, then its v rows, as
  // they land (bf16 at PITCH, or int8 rows of DP bytes and their scales)
  static constexpr size_t ROWS = QUANT ? size_t(KW) * DP : sizeof(__nv_bfloat16) * KW * PITCH;
  static constexpr size_t SHARE = align16(2 * ROWS + (QUANT ? 2 * sizeof(float) * KW : 0));
  static constexpr size_t WIDE = sizeof(__nv_bfloat16) * KW * PITCH;  // int8 rows widened
  static constexpr size_t RING = 0;
  static constexpr size_t WIDE_AT = RING + size_t(STAGES) * KG * SHARE;
  static constexpr size_t Q_AT = WIDE_AT + (QUANT ? size_t(KG) * 2 * WIDE : 0);
  static constexpr size_t WALK = Q_AT + sizeof(__nv_bfloat16) * 16 * PITCH;
  // after the walk, over the same bytes: each key group's partial (O, then
  // m and l of its 16 rows), then the CTA's, which the cluster reads
  static constexpr size_t PART_O = sizeof(float) * 16 * DP;
  static constexpr size_t STATS_AT = size_t(KG + 1) * PART_O;
  static constexpr size_t EPILOGUE = STATS_AT + size_t(KG + 1) * 2 * sizeof(float) * 16;
  static constexpr size_t TOTAL = WALK > EPILOGUE ? WALK : EPILOGUE;
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; valid false reads nothing and
// fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// x as a bf16 high part and the bf16 rounding of what is left
__device__ __forceinline__ void split_bf16(float x, float* hi, float* lo) {
  const float h = __bfloat162float(__float2bfloat16_rn(x));
  *hi = h;
  *lo = x - h;  // exact in f32; rounded to bf16 when packed
}

// 2^x on the SFU (ex2.approx, denormals flushed): what exp2f compiles
// to, without its range handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float score_of(float acc, float kscale, bool quant, float scale,
                                          float softcap) {
  float x = quant ? acc * kscale * scale : acc * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  return x;
}

// the whole cluster: arrive (release this CTA's shared-memory writes) and
// wait for every CTA (acquire theirs)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory byte in the CTA of ``rank``
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float2 cluster_load2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// CTAs per slot (the cluster): one per MIN_CHUNK allocated keys, 1 to
// MAX_CLUSTER. It depends on the allocated length only.
constexpr int ctas_per_slot(int max_len) {
  const int n = (max_len + MIN_CHUNK - 1) / MIN_CHUNK;
  return n < 1 ? 1 : n > MAX_CLUSTER ? MAX_CLUSTER : n;
}

template <typename KV, int DP>
__global__ void __launch_bounds__(Mma<KV, DP>::NT, Mma<KV, DP>::MIN_BLOCKS)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kc,
                        const KV* __restrict__ vc, __nv_bfloat16* __restrict__ out,
                        const int* __restrict__ lengths, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, int max_len, int heads,
                        int kv_heads, int dim, float scale, float softcap, int window) {
  using M = Mma<KV, DP>;
  constexpr bool QUANT = M::QUANT;
  constexpr int BK = M::BK, PITCH = M::PITCH, NTH = M::NT, KG = M::KG;
  count_launch(QUANT);
  constexpr int GT = 32 * M::COLS;      // threads of a key group
  constexpr int NO = DP / 8 / M::COLS;  // n8 column sub-tiles of this warp's O
  constexpr int KQ = DP / 16;           // k-steps of Q.K^T
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);

  const int group = heads / kv_heads;
  const int row_tiles = (group + 15) / 16;
  const int kvh = blockIdx.x / row_tiles;
  const int head0 = (blockIdx.x % row_tiles) * 16;  // the tile's first head of the group
  const int rows = min(16, group - head0);          // its live mma rows
  const int slot = blockIdx.y;
  const int rank = blockIdx.z;  // the CTA's rank in its cluster: its share of the keys
  const int n_ctas = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kg = warp / M::COLS;  // this warp's key group
  const int gt = tid - kg * GT;   // thread within the key group
  const int col0 = (warp % M::COLS) * (DP / M::COLS);  // this warp's first O column

  // the live keys [lo, hi): inside the window, before the length and T
  const int length = max(lengths[slot], 0);
  const int hi = min(length, max_len);
  const int lo = window > 0 ? max(0, length - window) : 0;
  // The slot's key tiles that hold a live key, [lo / BK, ceil(hi / BK)),
  // are split evenly over the first ``used`` CTAs of the cluster, at least
  // one tile each. This CTA walks [t0, t0 + n_tiles * BK). The split
  // depends on the length only, so the order of every sum is fixed.
  const int live_tiles = max((hi + BK - 1) / BK - lo / BK, 0);
  const int used = min(n_ctas, live_tiles);
  const int first = rank < used ? lo / BK + rank * live_tiles / used : 0;
  const int n_tiles = rank < used ? lo / BK + (rank + 1) * live_tiles / used - first : 0;
  const int t0 = first * BK;
  // The CTAs past the used ones hold no partial and are never read: they
  // leave at once, freeing their SM (an exited thread counts as arrived
  // at the cluster barriers). Rank 0 stays for a slot with no live key,
  // to write its zeros.
  if (rank >= max(used, 1)) return;

  const size_t row_stride = size_t(kv_heads) * dim;
  const size_t slot_at = size_t(slot) * max_len * row_stride + size_t(kvh) * dim;
  const size_t scale_at = size_t(slot) * max_len * kv_heads + kvh;
  // this key group's share of ring stage s
  auto share = [&](int s) -> char* {
    return base + M::RING + (size_t(s) * KG + kg) * M::SHARE;
  };
  // bf16 rows the products read: the ring's, or the widened int8 rows
  auto k_rows = [&](int s) -> __nv_bfloat16* {
    return reinterpret_cast<__nv_bfloat16*>(QUANT ? base + M::WIDE_AT + size_t(2 * kg) * M::WIDE
                                                  : share(s));
  };
  auto v_rows = [&](int s) -> __nv_bfloat16* {
    return reinterpret_cast<__nv_bfloat16*>(
        QUANT ? base + M::WIDE_AT + size_t(2 * kg + 1) * M::WIDE : share(s) + M::ROWS);
  };
  // the key group's rows of tile i into its share of stage i % STAGES: one
  // commit group per tile, empty past the last, so that the wait count
  // stays the same at every step; rows that are not live read nothing
  auto load_tile = [&](int i) {
    if (i < n_tiles) {
      char* stage = share(i % STAGES);
      const int key0 = t0 + i * BK + kg * KW;
      constexpr int VEC = 16 / sizeof(KV);
      constexpr int CPR = DP / VEC;  // 16-byte chunks per padded row: shifts, not divisions
      constexpr int ROW_BYTES = QUANT ? DP : int(sizeof(__nv_bfloat16)) * PITCH;
      for (int idx = gt; idx < KW * CPR; idx += GT) {
        const int j = idx / CPR;
        const int d = (idx % CPR) * VEC;
        if (d >= dim) continue;
        const int c = key0 + j;
        const bool valid = c >= lo && c < hi;
        const size_t off = slot_at + (valid ? size_t(c) * row_stride + d : 0);
        const uint32_t dst = smem_addr(stage + j * ROW_BYTES + d * sizeof(KV));
        cp_async16(dst, kc + off, valid);
        cp_async16(dst + uint32_t(M::ROWS), vc + off, valid);
      }
      if constexpr (QUANT) {
        float* scales = reinterpret_cast<float*>(stage + 2 * M::ROWS);
        if (gt < KW) {
          const int c = key0 + gt;
          const bool valid = c >= lo && c < hi;
          const size_t at = scale_at + (valid ? size_t(c) * kv_heads : 0);
          cp_async4(smem_addr(scales + gt), k_scale + at, valid);
          cp_async4(smem_addr(scales + KW + gt), v_scale + at, valid);
        }
      }
    }
    cp_async_commit();
  };
  auto group_sync = [&]() {
    if constexpr (M::COLS == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "r"(GT) : "memory");
    }
  };

  const int g = lane >> 2, t4 = lane & 3;  // this thread's rows g, g + 8; columns 2 t4, +1
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // head-dim padding [dim, DP) of every bf16 row buffer is zero (no copy
    // lands there)
    if (dim < DP) {
      const int pad = (DP - dim) / 8;  // 16-byte chunks per row
      constexpr int BUFS = QUANT ? 2 : 2 * STAGES;
      for (int idx = gt; idx < BUFS * KW * pad; idx += GT) {
        const int b = idx / (KW * pad), j = (idx / pad) % KW, c = idx % pad;
        __nv_bfloat16* t = (b & 1) ? v_rows(b >> 1) : k_rows(b >> 1);
        *reinterpret_cast<uint4*>(t + j * PITCH + dim + 8 * c) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int i = 0; i < STAGES - 1; ++i) load_tile(i);

    // the tile's q rows into shared memory, the rest and the padding zero
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base + M::Q_AT);
    const __nv_bfloat16* q_base = q + (size_t(slot) * heads + size_t(kvh) * group + head0) * dim;
    for (int idx = tid; idx < 16 * DP; idx += NTH) {
      const int r = idx / DP, d = idx % DP;
      sQ[r * PITCH + d] = r < rows && d < dim ? q_base[size_t(r) * dim + d]
                                              : __float2bfloat16(0.f);
    }
    __syncthreads();

    // ldmatrix lane addressing: the row (A: q row; B: key) and column
    // offsets of the 8x8 matrix this lane points at
    const int lr = lane & 7, lm = lane >> 3;
    const uint32_t q_lane = smem_addr(sQ + (lr + 8 * (lm & 1)) * PITCH + 8 * (lm >> 1));
    uint32_t qf[M::Q_IN_REGS ? KQ : 1][4];
    if constexpr (M::Q_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
    }

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
      group_sync();                 // the group's copies; its reads of tile i - 1 are done
      load_tile(i + STAGES - 1);    // into the stage tile i - 1 held
      const int s = i % STAGES;
      const int k0 = t0 + i * BK + kg * KW;  // the group's first key of the tile
      if (k0 >= hi || k0 + KW <= lo) continue;  // none of its keys is live
      const float* scales = nullptr;
      if constexpr (QUANT) {
        // widen the landed int8 rows to bf16 in one pass
        const char* stage = share(s);
        constexpr int CH = DP / 16;
        for (int idx = gt; idx < 2 * KW * CH; idx += GT) {
          const int which = idx / (KW * CH), j = (idx / CH) % KW, d = (idx % CH) * 16;
          if (d >= dim) continue;
          const uint4 w = *reinterpret_cast<const uint4*>(stage + which * M::ROWS + j * DP + d);
          uint32_t packed[8];
          widen4(w.x, &packed[0], &packed[1]);
          widen4(w.y, &packed[2], &packed[3]);
          widen4(w.z, &packed[4], &packed[5]);
          widen4(w.w, &packed[6], &packed[7]);
          __nv_bfloat16* dst = (which ? v_rows(s) : k_rows(s)) + j * PITCH + d;
          reinterpret_cast<uint4*>(dst)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          reinterpret_cast<uint4*>(dst)[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
        }
        scales = reinterpret_cast<const float*>(stage + 2 * M::ROWS);
        group_sync();
      }

      // S = Q . K^T over the group's KW keys: two n8 sub-tiles
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const uint32_t k_lane = smem_addr(k_rows(s) + (lr + 8 * (lm >> 1)) * PITCH + 8 * (lm & 1));
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t a[4];
        if constexpr (M::Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, q_lane + kk * 32);
        }
        uint32_t bb[4];
        ldmatrix_x4(bb, k_lane + kk * 32);
        mma_bf16(sc[0], a, bb[0], bb[1]);
        mma_bf16(sc[1], a, bb[2], bb[3]);
      }

      // online softmax on the fragments: element e of sub-tile n is row
      // g + 8 (e >> 1), key k0 + 8 n + 2 t4 + (e & 1)
      float mx[2] = {NEG_INF, NEG_INF};
      bool live[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t4 + (e & 1);
          // in log2 units: p = 2^(x log2 e - m)
          const float x =
              score_of(sc[n][e], QUANT ? scales[j] : 1.f, QUANT, scale, softcap) * LOG2E;
          sc[n][e] = x;
          live[n][e] = k0 + j >= lo && k0 + j < hi;
          if (live[n][e]) mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = m_new == m[h] ? 1.f : ex2(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = live[n][e] ? ex2(sc[n][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += p;
          sc[n][e] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l[h] = l[h] * alpha[h] + psum[h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P . V: p rounded to bf16 (B2), or p * v_scale as a bf16 high
      // and low part (B5), straight from the S fragments
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* f = sc[half];
        if constexpr (QUANT) {
          const int j = 8 * half + 2 * t4;
          float hi_part[4], lo_part[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_bf16(f[e] * scales[KW + j + (e & 1)], &hi_part[e], &lo_part[e]);
          pa[2 * half] = pack_bf16(hi_part[0], hi_part[1]);
          pa[2 * half + 1] = pack_bf16(hi_part[2], hi_part[3]);
          pl[2 * half] = pack_bf16(lo_part[0], lo_part[1]);
          pl[2 * half + 1] = pack_bf16(lo_part[2], lo_part[3]);
        } else {
          pa[2 * half] = pack_bf16(f[0], f[1]);
          pa[2 * half + 1] = pack_bf16(f[2], f[3]);
        }
      }
      const uint32_t v_lane =
          smem_addr(v_rows(s) + (lr + 8 * (lm & 1)) * PITCH + col0 + 8 * (lm >> 1));
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_lane + n * 16);
        mma_bf16(o[n], pa, bb[0], bb[1]);
        mma_bf16(o[n + 1], pa, bb[2], bb[3]);
        if constexpr (QUANT) {
          mma_bf16(o[n], pl, bb[0], bb[1]);
          mma_bf16(o[n + 1], pl, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<0>();  // no copy outlives the walk
  }

  // The CTA's partial over its key groups, in group order: O (unscaled by
  // 1/l), m and l of its 16 rows. The walk's bytes are free once every
  // warp is past it.
  float* part_o = reinterpret_cast<float*>(base);                   // [KG + 1][16][DP]
  float* part_m = reinterpret_cast<float*>(base + M::STATS_AT);     // [KG + 1][16]
  float* part_l = part_m + (KG + 1) * 16;                           // [KG + 1][16]
  float* cta_o = part_o + KG * 16 * DP;
  float* cta_m = part_m + KG * 16;
  float* cta_l = part_l + KG * 16;
  __syncthreads();
  if (n_tiles > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      float* dst = part_o + (kg * 16 + r) * DP;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(dst + col0 + 8 * n + 2 * t4) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (col0 == 0 && t4 == 0) {
        part_m[kg * 16 + r] = m[h];
        part_l[kg * 16 + r] = l[h];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rows * DP; idx += NTH) {
      const int r = idx / DP, d = idx % DP;
      float m_all = NEG_INF;
#pragma unroll
      for (int k = 0; k < KG; ++k) m_all = fmaxf(m_all, part_m[k * 16 + r]);
      float l_all = 0.f, acc = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float lk = part_l[k * 16 + r];
        if (lk > 0.f) {  // a group with no live key adds nothing
          const float w = ex2(part_m[k * 16 + r] - m_all);
          l_all += w * lk;
          acc += w * part_o[(k * 16 + r) * DP + d];
        }
      }
      cta_o[r * DP + d] = acc;
      if (d == 0) {
        cta_m[r] = m_all;
        cta_l[r] = l_all;
      }
    }
  }
  cluster_sync();  // every CTA's partial is written

  // The output over the cluster's partials, in rank (key) order; each CTA
  // writes its share of the tile's (row, column pair)s.
  const uint32_t o_addr = smem_addr(cta_o), m_addr = smem_addr(cta_m),
                 l_addr = smem_addr(cta_l);
  const int pairs = dim / 2;
  __nv_bfloat16* o_base = out + (size_t(slot) * heads + size_t(kvh) * group + head0) * dim;
  for (int idx = rank * NTH + tid; idx < rows * pairs; idx += max(used, 1) * NTH) {
    const int r = idx / pairs, d = 2 * (idx % pairs);
    float m_all = NEG_INF;
    for (int c = 0; c < used; ++c)
      m_all = fmaxf(m_all, cluster_load(cluster_addr(m_addr + 4 * r, c)));
    float l_all = 0.f, a0 = 0.f, a1 = 0.f;
    for (int c = 0; c < used; ++c) {
      const float lc = cluster_load(cluster_addr(l_addr + 4 * r, c));
      if (lc > 0.f) {
        const float w = ex2(cluster_load(cluster_addr(m_addr + 4 * r, c)) - m_all);
        const float2 oc = cluster_load2(cluster_addr(o_addr + 4 * (r * DP + d), c));
        l_all += w * lc;
        a0 += w * oc.x;
        a1 += w * oc.y;
      }
    }
    const float denom = l_all == 0.f ? 1.f : l_all;  // no live key (used 0): zeros
    *reinterpret_cast<__nv_bfloat162*>(o_base + size_t(r) * dim + d) =
        __floats2bfloat162_rn(a0 / denom, a1 / denom);
  }
  cluster_sync();  // no CTA leaves while another may still read its partial
}

// Everything a launch needs besides the kernel's types.
struct Args {
  const void *q, *kc, *vc;
  void* out;
  const int* lengths;
  const float *k_scale, *v_scale;
  int slots, max_len, heads, kv_heads, dim;
  float scale, softcap;
  int window;
  cudaStream_t stream;
};

template <typename T, typename KV>
cudaError_t launch_fma(const Args& a) {
  const fp32::Layout L = fp32::layout<KV>(a.dim, a.heads / a.kv_heads);
  if (L.total > SMEM_LIMIT) return cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(fp32::flash_decode_fma_kernel<T, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  dim3 grid(a.kv_heads, a.slots);
  fp32::flash_decode_fma_kernel<T, KV><<<grid, fp32::NT, L.total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kc), static_cast<const KV*>(a.vc),
      static_cast<T*>(a.out), a.lengths, a.k_scale, a.v_scale, a.max_len, a.heads, a.kv_heads,
      a.dim, a.scale, a.softcap, a.window, L);
  return cudaGetLastError();
}

template <typename KV, int DP>
cudaError_t launch_mma(const Args& a) {
  using M = Mma<KV, DP>;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(flash_decode_mma_kernel<KV, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(M::TOTAL));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const int n_ctas = ctas_per_slot(a.max_len);
  const int group = a.heads / a.kv_heads;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.kv_heads * ((group + 15) / 16), a.slots, n_ctas);
  config.blockDim = dim3(M::NT);
  config.dynamicSmemBytes = M::TOTAL;
  config.stream = a.stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = 1;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = n_ctas;  // the CTAs of one (kv head, slot)
  config.attrs = attribute;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, flash_decode_mma_kernel<KV, DP>, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const KV*>(a.kc), static_cast<const KV*>(a.vc),
      static_cast<__nv_bfloat16*>(a.out), a.lengths, a.k_scale, a.v_scale, a.max_len, a.heads,
      a.kv_heads, a.dim, a.scale, a.softcap, a.window);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the head dim padded to the next of 64, 128, 256
inline int padded_dim(int dim) { return dim <= 64 ? 64 : dim <= 128 ? 128 : 256; }

// bf16 q: the tensor-core body at DP; f32 q: the FMA body
template <typename KV>
cudaError_t dispatch(int dtype, const Args& a) {
  if (dtype == 0) {
    switch (padded_dim(a.dim)) {
      case 64: return launch_mma<KV, 64>(a);
      case 128: return launch_mma<KV, 128>(a);
      default: return launch_mma<KV, 256>(a);
    }
  }
  if (dtype == 1) return launch_fma<float, std::conditional_t<is_int8<KV>(), int8_t, float>>(a);
  return cudaErrorInvalidValue;
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
  const Args a{q, kc, vc, out, static_cast<const int*>(lengths), nullptr, nullptr, slots,
               max_len, heads, kv_heads, dim, scale, softcap, window,
               static_cast<cudaStream_t>(stream)};
  return int(dispatch<__nv_bfloat16>(dtype, a));
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
  const Args a{q, kc, vc, out, static_cast<const int*>(lengths),
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), slots,
               max_len, heads, kv_heads, dim, scale, softcap, window,
               static_cast<cudaStream_t>(stream)};
  return int(dispatch<int8_t>(dtype, a));
}

// Copies the launch counts of this library's kernel forms (see
// g_launches) into out[FORMS] and, with reset, zeroes them. Waits for the
// device first. Returns the cudaError_t.
extern "C" int flash_decode_launch_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[FORMS] = {};
    err = cudaMemcpyToSymbol(g_launches, zeros, sizeof(g_launches));
  }
  return int(err);
}
