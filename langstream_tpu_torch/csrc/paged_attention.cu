// Ragged GQA attention over a paged KV block pool, for Hopper (sm_90a).
//
// Replaces: langstream_tpu/ops/paged_attention.py::_ragged_kernel (the
// Pallas TPU kernel whose body is _ragged_kernel_body, public API
// ragged_paged_attention). Same function: query token t of row b sits at
// global position starts[b] + t and attends causally over the row's keys
// below lengths[b] (its total live context), each key c read from pool
// block tables[b][c / Bs] at offset c % Bs; optional sliding window
// anchored at the query, optional logit softcap after the scale and
// before the mask, online softmax in f32, p zeroed where masked and
// rounded to the pool type before p.v, and a row with no live key writes
// zeros. One launch serves decode (Tq = 1, start = length - 1),
// prefill-at-offset (start = offset) and cold paged prefill (start = 0).
//
// Also replaces ::_ragged_kernel_quant (ragged_paged_attention_quant):
// the same walk over int8 pools [N, Bs, KVH, D] with one f32 scale per
// (block, offset, kv head) in [N, Bs, KVH], reached through the same table
// entry as the values; entry point paged_attention_quant, the KV = int8_t
// instantiation. Tiles arrive as int8 (16 values per 16-byte load) and
// stay int8 in shared memory; the k scale multiplies the score after q.k,
// before the softcap and the mask; l sums the masked p; then p * v_scale
// (f32) multiplies v in f32, as the Pallas body does. head_dim must be a
// multiple of 16 for int8.
//
// Also replaces ::_ragged_q_kernel and ::_ragged_q_kernel_quant (the
// token-ragged form, ragged_q_paged_attention(_quant), which the mixed
// prefill+decode step launches): entry points paged_attention_ragged_q
// and paged_attention_ragged_q_quant launch the SAME kernel body with a
// q_offsets operand. q and out are a flat [Q, H, D] tile; row b's span of
// max_q_len tokens starts at q_offsets[b] (cu_q_lens style) in place of
// b * Tq, the caller's block_q sets the q tile (cut to a divisor of it
// when its score rows would not fit a CTA), and the row's live count is
// lengths[b] - starts[b] (decode rows 1, prefill windows their width,
// idle rows 0). Tiles past it read nothing and write zeros to their own
// span. The key walk and the key-tile width are B3's for the same dim,
// and every score and p.v product is a fused multiply-add in a fixed
// order, so at window 0 each row's output is bitwise what B3 gives for
// that row, whatever the q tile.
//
// What bounds it on the H100: bytes at decode, where each live key is
// read once for G = H / KVH query heads (~G FLOPs per byte, far below the
// ~295 where the tensor cores would take over); at long prefill tiles
// the products, which this first version runs as FP32 FMAs on the CUDA
// cores. Moving them onto mma/wgmma and pipelining the block loads
// (cp.async/TMA) is later work.
//
// Design:
// - One CTA per (kv head, row, q tile). The CTA reads its row's start,
//   length and table row from global memory, in place of the TPU's
//   scalar prefetch.
// - It computes the [first, last] table-block range of its tile as
//   _block_bounds does (causal frontier of the tile's last query and the
//   row's length cap the top, the window of its first query floors the
//   bottom) and walks only the keys inside it, in tiles of up to 64 keys
//   gathered through the table, so a tile may span several pool blocks
//   (Bs < 64) or part of one; any Bs works.
// - Each key's [D] slab for the CTA's kv head (rows strided by KVH * D
//   in the pool) is copied with 16-byte loads into shared memory, where
//   the tile's query tokens x the G query heads of the kv head all read
//   it: each byte is read once per q tile.
// - A q tile wholly past the row's new tokens (a padded prefill row)
//   loads and computes nothing and writes zeros; so do the rows of a
//   partly live tile past them (a decode row in an 8-token tile of the
//   token-ragged form computes one token's rows, not eight).
// - One (row, head, tile) is never split across CTAs, so the reduction
//   order is fixed and the kernel is deterministic. A query row's result
//   does not depend on the other rows of its tile: key tiles start at
//   the same keys (window 0), and a key tile past the row's causal
//   frontier leaves its running max, sum and accumulator bit for bit as
//   they were (p = 0, alpha = 1).
// - Scores: each thread owns one key of the tile and the tile's query
//   rows (up to 16, a compile-time count), so it loads every k pair once
//   for all its rows. p.v: one thread per (query row, column pair),
//   accumulating in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int MAX_ROWS = 64;   // score rows (q tokens x query heads) per CTA
constexpr int MAX_BK = 64;     // keys per tile
constexpr int MIN_BK = 16;
constexpr int SROWS = 16;      // score rows per thread: MAX_ROWS / (NT / MAX_BK)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
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

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

// q.k for one key (``krow``) against rows r0, r0 + rstep, ... of the q
// tile, NR of them at compile time so the loop carries no predicates: a
// thread past the last row repeats the last row's work and stores nothing.
// int8 keys: ``kscale`` (the key's scale) multiplies the score first.
template <typename KV, int NR>
__device__ __forceinline__ void tile_scores(const float* sQ, const KV* krow, float* sS, int dim,
                                            int rows, int r0, int rstep, int key, int bk,
                                            float scale, float softcap, float kscale) {
  const float* qrow[NR];
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    qrow[i] = sQ + size_t(min(r0 + i * rstep, rows - 1)) * dim;
    acc[i] = 0.f;
  }
  for (int d = 0; d < dim; d += 2) {
    const float2 kv = load_pair(krow + d);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float2 qv = *reinterpret_cast<const float2*>(qrow[i] + d);
      // explicit fmas: the same rounding in every NR instantiation
      acc[i] = __fmaf_rn(qv.y, kv.y, __fmaf_rn(qv.x, kv.x, acc[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r0 + i * rstep;
    if (r < rows) {
      float x = is_int8<KV>() ? acc[i] * kscale * scale : acc[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sS[r * bk + key] = x;
    }
  }
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// k rows in shared memory are padded to an odd number of 32-bit words so
// that the threads of a warp, one key each, read distinct banks: one word
// of elements
template <typename T> __host__ __device__ constexpr int k_pad() { return 4 / sizeof(T); }

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Layout {
  size_t v, k, q, acc, s, stats, rows, scales, total;
};

// KV: the pool element type (the k/v tiles); int8 adds the tile's scales
template <typename KV>
Layout layout(int dim, int rows, int bk) {
  Layout L;
  L.v = 0;
  L.k = L.v + align16(sizeof(KV) * size_t(bk) * dim);
  L.q = L.k + align16(sizeof(KV) * size_t(bk) * (dim + k_pad<KV>()));
  L.acc = L.q + align16(sizeof(float) * size_t(rows) * dim);
  L.s = L.acc + align16(sizeof(float) * size_t(rows) * dim);
  L.stats = L.s + align16(sizeof(float) * size_t(rows) * bk);
  L.rows = L.stats + align16(sizeof(float) * 3 * size_t(rows));
  L.scales = L.rows + align16(sizeof(long long) * size_t(bk));
  L.total = L.scales + (is_int8<KV>() ? align16(sizeof(float) * 2 * size_t(bk)) : 0);
  return L;
}

// T: the type of q and out. KV: the pools', T itself, or int8_t with
// k_scale/v_scale [N, Bs, KVH] f32. q_offsets: null for [B, seq, H, D]
// q/out (row b at b * seq), else the flat tile's row offsets, seq being
// the span capacity; a tile outside q/out's total_rows rows is skipped.
template <typename T, typename KV>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp, T* __restrict__ out,
                       const int* __restrict__ tables, const int* __restrict__ starts,
                       const int* __restrict__ lengths, const int* __restrict__ q_offsets,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, int total_rows, int seq, int heads,
                       int kv_heads, int dim, int num_blocks, int block_size,
                       int max_blocks, int block_q, int bk, float scale,
                       float softcap, int window, Layout L) {
  constexpr bool QUANT = is_int8<KV>();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  KV* sV = reinterpret_cast<KV*>(base + L.v);
  KV* sK = reinterpret_cast<KV*>(base + L.k);
  float* sQ = reinterpret_cast<float*>(base + L.q);
  float* sAcc = reinterpret_cast<float*>(base + L.acc);
  float* sS = reinterpret_cast<float*>(base + L.s);
  long long* sRow = reinterpret_cast<long long*>(base + L.rows);
  const int group = heads / kv_heads;
  const int rows = block_q * group;  // row r = token (r / group), head (r % group)
  float* sM = reinterpret_cast<float*>(base + L.stats);
  float* sL = sM + rows;
  float* sAlpha = sL + rows;
  float* sKs = reinterpret_cast<float*>(base + L.scales);  // int8 only
  float* sVs = sKs + bk;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * block_q;
  const int q_count = min(block_q, seq - q0);
  const int start = starts[b];
  const int length = max(lengths[b], 0);
  // queries of this tile that are new tokens of the row: the outputs past
  // them (t >= length - start) are discarded by every caller
  const int live_q = min(q_count, max(length - start - q0, 0));
  const int* table = tables + size_t(b) * max_blocks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KP = dim + k_pad<KV>();
  const int n_out = rows * dim;

  const size_t q_row_stride = size_t(heads) * dim;
  const size_t head_offset = size_t(kvh) * group * dim;
  const long long row0 = (q_offsets ? (long long)q_offsets[b] : (long long)b * seq) + q0;
  if (row0 < 0 || row0 + q_count > total_rows) return;  // the caller checks; never write outside
  T* o_base = out + row0 * q_row_stride + head_offset;
  if (live_q == 0) {
    // a tile wholly past the row's new tokens reads and computes nothing;
    // it writes zeros so the output is deterministic
    for (int o = tid; o < n_out; o += NT) {
      const int r = o / dim, d = o % dim;
      const int t = r / group, gi = r % group;
      if (t < q_count) o_base[size_t(t) * q_row_stride + size_t(gi) * dim + d] = from_f<T>(0.f);
    }
    return;
  }
  const T* q_base = q + row0 * q_row_stride + head_offset;
  for (int o = tid; o < n_out; o += NT) {
    const int r = o / dim, d = o % dim;
    const int t = r / group, gi = r % group;
    sQ[o] = t < q_count ? to_f(q_base[size_t(t) * q_row_stride + size_t(gi) * dim + d]) : 0.f;
    sAcc[o] = 0.f;
  }
  for (int r = tid; r < rows; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }

  // [first, last] table blocks of this tile (_block_bounds), then the keys
  // inside them that can be live: below the length and at or before the
  // tile's last new query
  const int last_query = start + q0 + live_q - 1;
  int last = min(max(1, (length + block_size - 1) / block_size) - 1,
                 floor_div(last_query, block_size));
  last = min(max(last, 0), max_blocks - 1);
  int first = 0;
  if (window > 0) first = max(0, floor_div(start + q0 - window + 1, block_size));
  first = min(first, last);
  const int k_lo = first * block_size;
  const int k_hi = min(min((last + 1) * block_size, length), last_query + 1);

  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte load
  const int vecs_per_row = dim / VEC;
  const int rstep = NT / bk;
  // score rows of the tile's new tokens: the rest compute nothing and
  // their outputs stay 0 (acc 0 over l 0)
  const int live_rows = live_q * group;
  const int rows_per_thread = (live_rows + rstep - 1) / rstep;
  const int score_key = tid % bk;
  const int score_row0 = tid / bk;

  for (int k0 = k_lo; k0 < k_hi; k0 += bk) {
    __syncthreads();  // the previous tile's readers are done
    // pool row of each key of the tile, through the table (-1 = not live)
    for (int j = tid; j < bk; j += NT) {
      const int c = k0 + j;
      long long row = -1;
      if (c < k_hi) {
        const int blk = min(max(table[c / block_size], 0), num_blocks - 1);
        row = (static_cast<long long>(blk) * block_size + c % block_size) * kv_heads + kvh;
      }
      sRow[j] = row;
    }
    __syncthreads();
    for (int idx = tid; idx < bk * vecs_per_row; idx += NT) {
      const int j = idx / vecs_per_row;
      const int d = (idx % vecs_per_row) * VEC;
      const long long row = sRow[j];
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (row >= 0) {
        kw = *reinterpret_cast<const uint4*>(kp + size_t(row) * dim + d);
        vw = *reinterpret_cast<const uint4*>(vp + size_t(row) * dim + d);
      }
      *reinterpret_cast<uint4*>(sV + size_t(j) * dim + d) = vw;
      uint32_t* kdst = reinterpret_cast<uint32_t*>(sK + size_t(j) * KP + d);
      kdst[0] = kw.x;
      kdst[1] = kw.y;
      kdst[2] = kw.z;
      kdst[3] = kw.w;
    }
    if constexpr (QUANT) {
      // a key's scale sits at its pool row: [N, Bs, KVH] is [N, Bs, KVH, D]
      // without the head dim
      for (int j = tid; j < bk; j += NT) {
        const long long row = sRow[j];
        sKs[j] = row >= 0 ? k_scale[row] : 0.f;
        sVs[j] = row >= 0 ? v_scale[row] : 0.f;
      }
    }
    __syncthreads();

    // scores: thread = one key x its query rows, as many as the tile has
    {
      const KV* krow = sK + size_t(score_key) * KP;
      const float ks = QUANT ? sKs[score_key] : 1.f;
      if (rows_per_thread <= 1) {
        tile_scores<KV, 1>(sQ, krow, sS, dim, live_rows, score_row0, rstep, score_key, bk, scale,
                           softcap, ks);
      } else if (rows_per_thread <= 2) {
        tile_scores<KV, 2>(sQ, krow, sS, dim, live_rows, score_row0, rstep, score_key, bk, scale,
                           softcap, ks);
      } else if (rows_per_thread <= 4) {
        tile_scores<KV, 4>(sQ, krow, sS, dim, live_rows, score_row0, rstep, score_key, bk, scale,
                           softcap, ks);
      } else if (rows_per_thread <= 8) {
        tile_scores<KV, 8>(sQ, krow, sS, dim, live_rows, score_row0, rstep, score_key, bk, scale,
                           softcap, ks);
      } else {
        tile_scores<KV, SROWS>(sQ, krow, sS, dim, live_rows, score_row0, rstep, score_key, bk, scale,
                               softcap, ks);
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < live_rows; r += NT / 32) {
      const int q_pos = start + q0 + r / group;
      float mx = NEG_INF;
      for (int j = lane; j < bk; j += 32) {
        const int c = k0 + j;
        const bool ok = c < k_hi && c <= q_pos && (window <= 0 || c > q_pos - window);
        if (ok) mx = fmaxf(mx, sS[r * bk + j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const int c = k0 + j;
        const bool ok = c < k_hi && c <= q_pos && (window <= 0 || c > q_pos - window);
        // p is zeroed (not just -inf shifted) so fully masked rows stay 0
        const float p = ok ? expf(sS[r * bk + j] - m_new) : 0.f;
        psum += p;
        // int8: the v scale folds into p after l has summed it; f32 p.v
        sS[r * bk + j] = QUANT ? p * sVs[j] : round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // p.v into the f32 accumulator: one thread per (query row, column pair)
    for (int o = 2 * tid; o < live_rows * dim; o += 2 * NT) {
      const int r = o / dim, d = o % dim;
      const float* prow = sS + r * bk;
      const float alpha = sAlpha[r];
      float a0 = sAcc[o] * alpha, a1 = sAcc[o + 1] * alpha;
      for (int j = 0; j < bk; ++j) {
        const float p = prow[j];
        const float2 v = load_pair(sV + size_t(j) * dim + d);
        a0 = __fmaf_rn(p, v.x, a0);
        a1 = __fmaf_rn(p, v.y, a1);
      }
      sAcc[o] = a0;
      sAcc[o + 1] = a1;
    }
  }
  __syncthreads();

  for (int o = tid; o < n_out; o += NT) {
    const int r = o / dim, d = o % dim;
    const int t = r / group, gi = r % group;
    if (t < q_count) {
      const float l = sL[r];
      o_base[size_t(t) * q_row_stride + size_t(gi) * dim + d] = from_f<T>(sAcc[o] / (l == 0.f ? 1.f : l));
    }
  }
}

// The q tile and key-tile width. B3 (block_q_req == 0): the most tokens
// whose rows fit, then halved until the shared-memory plan fits. B7
// (block_q_req > 0): the largest divisor of the caller's tile whose rows
// fit, cut the same way. Either shrinks the key tile only once a one-token
// tile does not fit, so both take the same bk at the same dim and group.
template <typename KV>
bool plan(int dim, int group, int seq, int block_q_req, int* block_q, int* bk, Layout* L) {
  if (group > MAX_ROWS) return false;
  auto next_tile = [&](int tile) {  // the next smaller candidate tile
    if (block_q_req == 0) return tile / 2;
    do --tile; while (tile > 0 && block_q_req % tile != 0);
    return tile;
  };
  int tile;
  if (block_q_req == 0) {
    tile = 1;
    while (tile * 2 * group <= MAX_ROWS && tile * 2 <= seq) tile *= 2;
  } else {
    tile = block_q_req;
    while (tile * group > MAX_ROWS) tile = next_tile(tile);
  }
  int width = MAX_BK;
  *L = layout<KV>(dim, tile * group, width);
  while (L->total > SMEM_LIMIT) {
    if (tile > 1) {
      tile = next_tile(tile);
    } else if (width > MIN_BK) {
      width /= 2;
    } else {
      return false;
    }
    *L = layout<KV>(dim, tile * group, width);
  }
  *block_q = tile;
  *bk = width;
  return true;
}

// q_offsets null: q/out [batch, seq, H, D], the tile B3 picks. Otherwise
// a flat [Q, H, D] tile with row spans of ``seq`` tokens at q_offsets and
// the caller's q tile ``block_q_req`` (B7).
template <typename T, typename KV>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* out,
                   const void* tables, const void* starts, const void* lengths,
                   const void* q_offsets, const void* k_scale, const void* v_scale, int batch,
                   int total_rows, int seq, int block_q_req, int heads, int kv_heads, int dim,
                   int num_blocks, int block_size, int max_blocks, float scale, float softcap,
                   int window, cudaStream_t stream) {
  int block_q, bk;
  Layout L;
  if (!plan<KV>(dim, heads / kv_heads, seq, block_q_req, &block_q, &bk, &L))
    return cudaErrorInvalidValue;
  static size_t granted = 0;  // the largest dynamic shared memory asked for so far
  if (L.total > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    granted = SMEM_LIMIT;
  }
  dim3 grid(kv_heads, batch, (seq + block_q - 1) / block_q);
  paged_attention_kernel<T, KV><<<grid, NT, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      static_cast<T*>(out), static_cast<const int*>(tables), static_cast<const int*>(starts),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offsets),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), total_rows, seq, heads,
      kv_heads, dim, num_blocks, block_size, max_blocks, block_q, bk, scale, softcap, window, L);
  return cudaGetLastError();
}

// One dispatch over the pool element type and q's dtype (0 = bfloat16,
// 1 = float32); ``quant`` selects the int8 pools.
cudaError_t dispatch(bool quant, int dtype, const void* q, const void* kp, const void* vp,
                     void* out, const void* tables, const void* starts, const void* lengths,
                     const void* q_offsets, const void* k_scale, const void* v_scale, int batch,
                     int total_rows, int seq, int block_q_req, int heads, int kv_heads, int dim,
                     int num_blocks, int block_size, int max_blocks, float scale, float softcap,
                     int window, void* stream) {
  if (batch <= 0 || seq <= 0) return cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0 || dim % (quant ? 16 : 8) != 0 || dim <= 0 ||
      dim > 256 || num_blocks <= 0 || block_size <= 0 || max_blocks <= 0 || block_q_req < 0 ||
      (block_q_req > 0 && seq % block_q_req != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, KV)                                                                     \
  launch<T, KV>(q, kp, vp, out, tables, starts, lengths, q_offsets, k_scale, v_scale, batch,    \
                total_rows, seq, block_q_req, heads, kv_heads, dim, num_blocks, block_size,     \
                max_blocks, scale, softcap, window, s)
  if (dtype == 0) return quant ? PAGED_LAUNCH(__nv_bfloat16, int8_t)
                               : PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1) return quant ? PAGED_LAUNCH(float, int8_t) : PAGED_LAUNCH(float, float);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. dim must be a multiple of 8 and at
// most 256; at most 64 query heads per kv head. softcap <= 0 disables
// capping; window <= 0 is full attention. tables [batch, max_blocks],
// starts and lengths [batch] are int32. Returns cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               void* out, const void* tables, const void* starts,
                               const void* lengths, int batch, int seq, int heads,
                               int kv_heads, int dim, int num_blocks, int block_size,
                               int max_blocks, int dtype, float scale, float softcap,
                               int window, void* stream) {
  return int(dispatch(false, dtype, q, kp, vp, out, tables, starts, lengths, nullptr, nullptr,
                      nullptr, batch, batch * seq, seq, 0, heads, kv_heads, dim, num_blocks,
                      block_size, max_blocks, scale, softcap, window, stream));
}

// The int8 pools: kp/vp int8 [N, Bs, KVH, D] with k_scale/v_scale [N, Bs,
// KVH] f32; q/out of ``dtype`` (0 = bfloat16, 1 = float32). dim must be a
// multiple of 16 up to 256; the rest as paged_attention. Returns
// cudaGetLastError().
extern "C" int paged_attention_quant(const void* q, const void* kp, const void* k_scale,
                                     const void* vp, const void* v_scale, void* out,
                                     const void* tables, const void* starts,
                                     const void* lengths, int batch, int seq, int heads,
                                     int kv_heads, int dim, int num_blocks, int block_size,
                                     int max_blocks, int dtype, float scale, float softcap,
                                     int window, void* stream) {
  return int(dispatch(true, dtype, q, kp, vp, out, tables, starts, lengths, nullptr, k_scale,
                      v_scale, batch, batch * seq, seq, 0, heads, kv_heads, dim, num_blocks,
                      block_size, max_blocks, scale, softcap, window, stream));
}

// The token-ragged form (B7): q/out a flat [total_q, H, D] tile, row b's
// span of max_q_len tokens at q_offsets[b] ([batch] int32), block_q the q
// tile (a divisor of max_q_len); the rest as paged_attention. Returns
// cudaGetLastError().
extern "C" int paged_attention_ragged_q(const void* q, const void* kp, const void* vp,
                                        void* out, const void* tables, const void* starts,
                                        const void* lengths, const void* q_offsets, int batch,
                                        int total_q, int max_q_len, int block_q, int heads,
                                        int kv_heads, int dim, int num_blocks, int block_size,
                                        int max_blocks, int dtype, float scale, float softcap,
                                        int window, void* stream) {
  if (block_q <= 0) return int(cudaErrorInvalidValue);
  return int(dispatch(false, dtype, q, kp, vp, out, tables, starts, lengths, q_offsets, nullptr,
                      nullptr, batch, total_q, max_q_len, block_q, heads, kv_heads, dim,
                      num_blocks, block_size, max_blocks, scale, softcap, window, stream));
}

// B8: paged_attention_ragged_q over the int8 pools and scales of
// paged_attention_quant.
extern "C" int paged_attention_ragged_q_quant(
    const void* q, const void* kp, const void* k_scale, const void* vp, const void* v_scale,
    void* out, const void* tables, const void* starts, const void* lengths,
    const void* q_offsets, int batch, int total_q, int max_q_len, int block_q, int heads,
    int kv_heads, int dim, int num_blocks, int block_size, int max_blocks, int dtype,
    float scale, float softcap, int window, void* stream) {
  if (block_q <= 0) return int(cudaErrorInvalidValue);
  return int(dispatch(true, dtype, q, kp, vp, out, tables, starts, lengths, q_offsets, k_scale,
                      v_scale, batch, total_q, max_q_len, block_q, heads, kv_heads, dim,
                      num_blocks, block_size, max_blocks, scale, softcap, window, stream));
}
