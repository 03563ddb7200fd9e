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
// instantiation. The k scale multiplies the score after q.k, before the
// softcap and the mask; l sums the masked p; then p * v_scale (f32)
// multiplies v, as the Pallas body does. head_dim must be a multiple of
// 16 for int8.
//
// Also replaces ::_ragged_q_kernel and ::_ragged_q_kernel_quant (the
// token-ragged form, ragged_q_paged_attention(_quant), which the mixed
// prefill+decode step launches): entry points paged_attention_ragged_q
// and paged_attention_ragged_q_quant launch the SAME kernel bodies with a
// q_offsets operand. q and out are a flat [Q, H, D] tile; row b's span of
// max_q_len tokens starts at q_offsets[b] (cu_q_lens style) in place of
// b * Tq, the caller's block_q sets the q tile (cut to a divisor of it
// when its score rows would not fit a CTA), and the row's live count is
// lengths[b] - starts[b] (decode rows 1, prefill windows their width,
// idle rows 0). Tiles past it read nothing and write zeros to their own
// span. The key walk and the key-tile width are B3's for the same dim and
// pool type, and a row's arithmetic does not depend on the other rows of
// its tile, so at window 0 each row's output is bitwise what B3 gives for
// that row, whatever the q tile.
//
// What bounds it on the H100, per shape (Llama-3-8B heads, G = 4, D 128):
// - decode (Tq = 1, 4 score rows a CTA): bytes on paper (each live key is
//   read once for G query heads, ~G FLOPs a byte against the ~295 where
//   the tensor cores would take over), but on the card the one warp that
//   computes a decode tile sets the pace: 4 of its 16 mma rows are live
//   and a long row walks its key tiles one after another. The k/v tiles
//   stream through a cp.async ring of three stages (two in flight while
//   one computes, two CTAs an SM); a fourth stage did not move it.
// - prefill-at-offset (16-token q tiles, 64 score rows a CTA, up to 12
//   key tiles): still bytes on paper (2.6 GFLOP is ~3 us on the tensor
//   cores), in practice latency and the uneven key ranges of the CTAs.
//   The products run on the tensor cores, the softmax state and the
//   accumulator stay in registers, the ring hides the loads, and the grid
//   starts the CTAs of the last q tiles (the longest key ranges) first.
//
// Design of the bf16-q body (paged_attention_mma_kernel, B3 and B6, and B7
// and B8 with q_offsets):
// - One CTA of 4 warps per (kv head, row, q tile); score row r of the tile
//   is query token r / G, head r % G. Warp w owns rows 16w .. 16w + 15, one
//   m16 tile, and a warp none of whose rows is a live new token computes
//   nothing (decode uses warp 0, 4 of its 16 rows at G 4). At D > 128 two
//   warps share a row tile, each with half of O's columns (both compute
//   the same S), so that O fits the registers without spilling.
// - S = Q.K^T and O += P.V with mma.sync.m16n8k16 bf16 -> f32 and ldmatrix
//   from shared memory (.trans for V). wgmma is not used: its 64-row tile
//   is a whole CTA's rows only in prefill, and decode needs 4 rows. The
//   q fragments sit in registers for the whole key walk (read from shared
//   memory at each tile at D 256, where they would not fit beside the
//   accumulator); m, l and O stay in registers in the accumulator layout;
//   the softmax runs on the S fragments, row max and row sum over the
//   quad of threads holding a row (xor 1, then 2). P goes from the S
//   accumulators to the A operand of P.V without shared memory.
// - int8 pools (B6, B8): each landed int8 tile is widened to bf16 (exact
//   for -128..127) in one pass into a bf16 tile, before the products, with
//   byte permutes and float adds (int-to-float conversions run at a
//   fraction of their rate). The
//   score is acc * k_scale * scale. p * v_scale is split into a bf16 high
//   part and a bf16 low part, each run through the P.V mma, so p.v keeps
//   about 16 bits of p, near the f32 body's error.
// - Keys walk in tiles of BK (64, or 32 at D > 128: it depends on dim
//   only), gathered through the table into a ring of STAGES shared-memory
//   stages with 16-byte cp.async.cg copies (zero-filled past the live
//   keys); int8 scales ride the same stage as 4-byte copies. The table
//   rows of a tile are read one tile ahead of its copy, by the last warps.
// - Head dims are padded with zeros in shared memory to DP, the next of
//   64, 128, 256 (a multiple of 16 for the mma's k), so D 16, 40, 72, 80
//   and the like run through the same code.
// - A row's result does not depend on the other rows of its tile: each
//   mma row is its own dot products, the softmax state is per row, key
//   tiles start at the same keys (window 0), and a key tile past the
//   row's causal frontier leaves its max, sum and accumulator bit for bit
//   as they were (p = 0, alpha = exp(0) = 1).
// - A q tile wholly past the row's new tokens (a padded prefill row)
//   loads and computes nothing and writes zeros; rows of a live tile past
//   its new tokens write zeros too. One (row, head, tile) is never split
//   across CTAs, so the reduction order is fixed and the kernel is
//   deterministic.
//
// f32 q/pools (tests only; the model on the card is bf16) keep the first
// version's body (paged_attention_fma_kernel): each thread owns one key of
// the tile for the scores (FP32 FMAs over q and the accumulator held in
// shared memory) and one (row, column pair) for p.v, with synchronous
// loads. TF32 would break the f32 tolerance, and B7 == B3 in f32 holds
// because both take that body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Launches of each kernel form of this library, counted on the card by
// the grid's first thread, so a kernel replayed from a CUDA graph counts
// once per replay; read and zeroed through paged_attention_launch_counts.
// Forms: 0 B3, 1 B6 (int8 pools), 2 B7 (the token-ragged form:
// q_offsets set), 3 B8; and, counted besides 0 and 1, 4 and 5: B3 and B6
// launched with more than one q token per slot (seq > 1, a prefill call
// cold or at an offset, where a decode step has one), unless the caller
// marks the launch a speculative verify block (verify set), counted in
// 6 and 7 instead.
constexpr int FORMS = 8;
__device__ unsigned long long g_launches[FORMS];

__device__ __forceinline__ void count_launch(bool quant, const int* q_offsets, int seq,
                                             int verify) {
  if (threadIdx.x + threadIdx.y + threadIdx.z == 0 && blockIdx.x + blockIdx.y + blockIdx.z == 0) {
    atomicAdd(&g_launches[(q_offsets ? 2 : 0) + quant], 1ull);
    if (verify) atomicAdd(&g_launches[6 + quant], 1ull);
    else if (!q_offsets && seq > 1) atomicAdd(&g_launches[4 + quant], 1ull);
  }
}

constexpr int MAX_ROWS = 64;   // score rows (q tokens x query heads) per CTA
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename KV>
__host__ __device__ constexpr bool is_int8() { return std::is_same<KV, int8_t>::value; }

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// What every CTA of either body reads first: its row's span and live
// count, and the [k_lo, k_hi) keys its tile can see.
struct Tile {
  int q0, q_count, start, live_q;
  long long row0;  // first q/out row of the tile
  int k_lo, k_hi;
};

// q tile ``qt`` of row ``b``: _block_bounds' [first, last] table blocks
// (the causal frontier of the tile's last new query and the row's length
// cap the top, the window of its first query floors the bottom), then the
// keys inside them that can be live.
__device__ __forceinline__ Tile tile_of(int b, int qt, int block_q, int seq, const int* starts,
                                        const int* lengths, const int* q_offsets, int block_size,
                                        int max_blocks, int window) {
  Tile t;
  t.q0 = qt * block_q;
  t.q_count = min(block_q, seq - t.q0);
  t.start = starts[b];
  const int length = max(lengths[b], 0);
  // queries of this tile that are new tokens of the row: the outputs past
  // them (t >= length - start) are discarded by every caller
  t.live_q = min(t.q_count, max(length - t.start - t.q0, 0));
  t.row0 = (q_offsets ? (long long)q_offsets[b] : (long long)b * seq) + t.q0;
  const int last_query = t.start + t.q0 + t.live_q - 1;
  int last = min(max(1, (length + block_size - 1) / block_size) - 1,
                 floor_div(last_query, block_size));
  last = min(max(last, 0), max_blocks - 1);
  int first = 0;
  if (window > 0) first = max(0, floor_div(t.start + t.q0 - window + 1, block_size));
  first = min(first, last);
  t.k_lo = first * block_size;
  t.k_hi = min(min((last + 1) * block_size, length), last_query + 1);
  return t;
}

// pool row of key c through the row's table: (block, offset, kv head)
__device__ __forceinline__ long long pool_row(const int* table, int c, int block_size,
                                              int num_blocks, int kv_heads, int kvh) {
  const int blk = min(max(table[c / block_size], 0), num_blocks - 1);
  return (static_cast<long long>(blk) * block_size + c % block_size) * kv_heads + kvh;
}

__device__ __forceinline__ float score_of(float acc, float kscale, bool quant, float scale,
                                          float softcap) {
  float x = quant ? acc * kscale * scale : acc * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  return x;
}

// ====================================================================== //
// The f32 body: FP32 FMAs, q and the accumulator in shared memory.
// ====================================================================== //
constexpr int NT = 256;        // threads per CTA
constexpr int MAX_BK = 64;     // keys per tile
constexpr int MIN_BK = 16;
constexpr int SROWS = 16;      // score rows per thread: MAX_ROWS / (NT / MAX_BK)

__device__ __forceinline__ bool key_ok(int c, int k_hi, int q_pos, int window) {
  return c < k_hi && c <= q_pos && (window <= 0 || c > q_pos - window);
}

__device__ __forceinline__ float2 load_pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}

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
    if (r < rows) sS[r * bk + key] = score_of(acc[i], kscale, is_int8<KV>(), scale, softcap);
  }
}

// k rows in shared memory are padded to an odd number of 32-bit words so
// that the threads of a warp, one key each, read distinct banks: one word
// of elements
template <typename T> __host__ __device__ constexpr int k_pad() { return 4 / sizeof(T); }

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

// q/out f32. KV: float, or int8_t with k_scale/v_scale [N, Bs, KVH] f32.
// q_offsets: null for [B, seq, H, D] q/out (row b at b * seq), else the
// flat tile's row offsets, seq being the span capacity; a tile outside
// q/out's total_rows rows is skipped.
template <typename KV>
__global__ void __launch_bounds__(NT)
paged_attention_fma_kernel(const float* __restrict__ q, const KV* __restrict__ kp,
                           const KV* __restrict__ vp, float* __restrict__ out,
                           const int* __restrict__ tables, const int* __restrict__ starts,
                           const int* __restrict__ lengths, const int* __restrict__ q_offsets,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, int total_rows, int seq, int heads,
                           int kv_heads, int dim, int num_blocks, int block_size,
                           int max_blocks, int block_q, int bk, float scale,
                           float softcap, int window, int verify, Layout L) {
  constexpr bool QUANT = is_int8<KV>();
  count_launch(QUANT, q_offsets, seq, verify);
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
  // the last q tiles (the longest key ranges) start first
  const Tile tl = tile_of(b, gridDim.z - 1 - blockIdx.z, block_q, seq, starts, lengths,
                          q_offsets, block_size, max_blocks, window);
  const int q0 = tl.q0, q_count = tl.q_count, start = tl.start, live_q = tl.live_q;
  const int* table = tables + size_t(b) * max_blocks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KP = dim + k_pad<KV>();
  const int n_out = rows * dim;

  const size_t q_row_stride = size_t(heads) * dim;
  const size_t head_offset = size_t(kvh) * group * dim;
  if (tl.row0 < 0 || tl.row0 + q_count > total_rows) return;  // the caller checks; never write outside
  float* o_base = out + tl.row0 * q_row_stride + head_offset;
  if (live_q == 0) {
    // a tile wholly past the row's new tokens reads and computes nothing;
    // it writes zeros so the output is deterministic
    for (int o = tid; o < n_out; o += NT) {
      const int r = o / dim, d = o % dim;
      const int t = r / group, gi = r % group;
      if (t < q_count) o_base[size_t(t) * q_row_stride + size_t(gi) * dim + d] = 0.f;
    }
    return;
  }
  const float* q_base = q + tl.row0 * q_row_stride + head_offset;
  for (int o = tid; o < n_out; o += NT) {
    const int r = o / dim, d = o % dim;
    const int t = r / group, gi = r % group;
    sQ[o] = t < q_count ? q_base[size_t(t) * q_row_stride + size_t(gi) * dim + d] : 0.f;
    sAcc[o] = 0.f;
  }
  for (int r = tid; r < rows; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  const int k_lo = tl.k_lo, k_hi = tl.k_hi;

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
      sRow[j] = c < k_hi ? pool_row(table, c, block_size, num_blocks, kv_heads, kvh) : -1;
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
        if (key_ok(k0 + j, k_hi, q_pos, window)) mx = fmaxf(mx, sS[r * bk + j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        // p is zeroed (not just -inf shifted) so fully masked rows stay 0
        const float p = key_ok(k0 + j, k_hi, q_pos, window) ? expf(sS[r * bk + j] - m_new) : 0.f;
        psum += p;
        // int8: the v scale folds into p after l has summed it; f32 p.v
        sS[r * bk + j] = QUANT ? p * sVs[j] : p;
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
      o_base[size_t(t) * q_row_stride + size_t(gi) * dim + d] = sAcc[o] / (l == 0.f ? 1.f : l);
    }
  }
}

// ====================================================================== //
// The bf16-q body: tensor cores, a cp.async ring, state in registers.
// ====================================================================== //
constexpr int ROW_TILES = MAX_ROWS / 16;  // m16 row tiles of a CTA
constexpr int STAGES = 3;  // k/v tiles in the ring: two CTAs an SM at D 128

// DP: the head dim padded to the mma's k (a multiple of 16)
template <typename KV, int DP>
struct Mma {
  static constexpr bool QUANT = is_int8<KV>();
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys per tile: dim alone sets it
  static constexpr int PITCH = DP + 8;             // bf16 row pitch: ldmatrix without conflicts
  static constexpr bool Q_IN_REGS = DP <= 128;
  // warps per row tile, each with its share of O's columns: at D 256 a
  // whole row of O (128 f32 registers) beside the rest would spill
  static constexpr int COLS = DP <= 128 ? 1 : 2;
  static constexpr int NT = 32 * ROW_TILES * COLS;
  // a ring stage: the k and v tiles as they land (bf16 rows at PITCH, or
  // int8 rows of DP bytes and the tile's k and v scales)
  static constexpr size_t TILE = QUANT ? size_t(BK) * DP : sizeof(__nv_bfloat16) * BK * PITCH;
  static constexpr size_t STAGE = align16(2 * TILE + (QUANT ? 2 * sizeof(float) * BK : 0));
  static constexpr size_t WIDE = sizeof(__nv_bfloat16) * BK * PITCH;  // an int8 tile widened
  static constexpr size_t Q_BYTES = sizeof(__nv_bfloat16) * MAX_ROWS * PITCH;
  static constexpr size_t RING = 0;
  static constexpr size_t WIDE_AT = RING + STAGES * STAGE;              // int8: k, then v
  static constexpr size_t ROWS_AT = WIDE_AT + (QUANT ? 2 * WIDE : 0);   // [STAGES][BK] pool rows
  static constexpr size_t OWN_Q_AT = ROWS_AT + align16(sizeof(long long) * STAGES * BK);
  // q is staged where the first products will find free room: with q in
  // registers, in the last stage's k tile (bf16, filled after q is read)
  // or the widened k tile (int8); else a region of its own
  static constexpr size_t Q_AT = !Q_IN_REGS ? OWN_Q_AT
                                 : QUANT    ? WIDE_AT
                                            : RING + (STAGES - 1) * STAGE;
  static constexpr size_t TOTAL = OWN_Q_AT + (Q_IN_REGS ? 0 : Q_BYTES);
  static_assert(!Q_IN_REGS || BK * PITCH >= MAX_ROWS * PITCH, "q must fit the tile it borrows");
  static_assert(TOTAL <= SMEM_LIMIT, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros
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

template <typename KV, int DP>
__global__ void __launch_bounds__(Mma<KV, DP>::NT)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kp,
                           const KV* __restrict__ vp, __nv_bfloat16* __restrict__ out,
                           const int* __restrict__ tables, const int* __restrict__ starts,
                           const int* __restrict__ lengths, const int* __restrict__ q_offsets,
                           const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                           int total_rows, int seq, int heads, int kv_heads, int dim,
                           int num_blocks, int block_size, int max_blocks, int block_q,
                           float scale, float softcap, int window, int verify) {
  using M = Mma<KV, DP>;
  constexpr bool QUANT = M::QUANT;
  constexpr int BK = M::BK, PITCH = M::PITCH;
  count_launch(QUANT, q_offsets, seq, verify);
  constexpr int NS = BK / 8;   // n8 key sub-tiles of S
  constexpr int NO = DP / 8 / M::COLS;  // n8 column sub-tiles of this warp's O
  constexpr int NTH = M::NT;
  constexpr int KQ = DP / 16;  // k-steps of Q.K^T
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  long long* sRow = reinterpret_cast<long long*>(base + M::ROWS_AT);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = heads / kv_heads;
  const int rows = block_q * group;  // row r = token (r / group), head (r % group)
  // the last q tiles (the longest key ranges) start first
  const Tile tl = tile_of(b, gridDim.z - 1 - blockIdx.z, block_q, seq, starts, lengths,
                          q_offsets, block_size, max_blocks, window);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t q_row_stride = size_t(heads) * dim;
  const size_t head_offset = size_t(kvh) * group * dim;
  if (tl.row0 < 0 || tl.row0 + tl.q_count > total_rows) return;  // the caller checks
  __nv_bfloat16* o_base = out + tl.row0 * q_row_stride + head_offset;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  if (tl.live_q == 0) {
    // a tile wholly past the row's new tokens reads and computes nothing;
    // it writes zeros so the output is deterministic
    for (int o = 2 * tid; o < rows * dim; o += 2 * NTH) {
      const int r = o / dim, d = o % dim;
      const int t = r / group, gi = r % group;
      if (t < tl.q_count)
        *reinterpret_cast<__nv_bfloat162*>(o_base + size_t(t) * q_row_stride + size_t(gi) * dim +
                                           d) = zero2;
    }
    return;
  }
  const int live_rows = tl.live_q * group;
  const int k_lo = tl.k_lo, k_hi = tl.k_hi;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int* table = tables + size_t(b) * max_blocks;

  // pool rows of tile i's keys into slot i % STAGES (-1: not live), by the
  // last warps: decode computes on warp 0 only
  auto fill_rows = [&](int i) {
    const int j = tid - (NTH - BK);
    if (j >= 0) {
      const int c = k_lo + i * BK + j;
      sRow[(i % STAGES) * BK + j] = i < n_tiles && c < k_hi
          ? pool_row(table, c, block_size, num_blocks, kv_heads, kvh) : -1;
    }
  };
  // one commit group per tile, empty past the last, so that the wait
  // count stays the same at every step
  auto load_tile = [&](int i) {
    if (i < n_tiles) {
      const int s = i % STAGES;
      char* stage = base + M::RING + s * M::STAGE;
      const long long* rws = sRow + s * BK;
      constexpr int VEC = 16 / sizeof(KV);
      constexpr int CPR = DP / VEC;  // 16-byte chunks per padded row: shifts, not divisions
      constexpr int ROW_BYTES = QUANT ? DP : int(sizeof(__nv_bfloat16)) * PITCH;
      for (int idx = tid; idx < BK * CPR; idx += NTH) {
        const int j = idx / CPR;
        const int d = (idx % CPR) * VEC;
        if (d >= dim) continue;
        const long long row = rws[j];
        const bool valid = row >= 0;
        const size_t off = valid ? size_t(row) * dim + d : 0;
        const uint32_t dst = smem_addr(stage + j * ROW_BYTES + d * sizeof(KV));
        cp_async16(dst, kp + off, valid);
        cp_async16(dst + uint32_t(M::TILE), vp + off, valid);
      }
      if constexpr (QUANT) {
        float* scales = reinterpret_cast<float*>(stage + 2 * M::TILE);
        for (int j = tid; j < BK; j += NTH) {
          const long long row = rws[j];
          const bool valid = row >= 0;
          cp_async4(smem_addr(scales + j), k_scale + (valid ? row : 0), valid);
          cp_async4(smem_addr(scales + BK + j), v_scale + (valid ? row : 0), valid);
        }
      }
    }
    cp_async_commit();
  };

  // bf16 tiles the products read: the ring's stages, or the widened tile
  auto k_tile = [&](int s) -> __nv_bfloat16* {
    return reinterpret_cast<__nv_bfloat16*>(QUANT ? base + M::WIDE_AT
                                                  : base + M::RING + s * M::STAGE);
  };
  auto v_tile = [&](int s) -> __nv_bfloat16* {
    return reinterpret_cast<__nv_bfloat16*>(QUANT ? base + M::WIDE_AT + M::WIDE
                                                  : base + M::RING + s * M::STAGE + M::TILE);
  };

  for (int i = 0; i < STAGES; ++i) fill_rows(i);
  // head-dim padding [dim, DP) of every bf16 tile is zero (no copy lands
  // there); q's is zeroed below with q
  if (dim < DP) {
    const int pad = (DP - dim) / 8;  // 16-byte chunks per row
    const int n_bf16_tiles = QUANT ? 2 : 2 * STAGES;
    for (int idx = tid; idx < n_bf16_tiles * BK * pad; idx += NTH) {
      const int tile = idx / (BK * pad), j = (idx / pad) % BK, c = idx % pad;
      __nv_bfloat16* t = (tile & 1) ? v_tile(tile >> 1) : k_tile(tile >> 1);
      *reinterpret_cast<uint4*>(t + j * PITCH + dim + 8 * c) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();  // the first tiles' pool rows
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);

  // the q tile into shared memory: live rows from q, the rest and the
  // head-dim padding zero
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base + M::Q_AT);
  {
    const __nv_bfloat16* q_base = q + tl.row0 * q_row_stride + head_offset;
    constexpr int CH = DP / 8;
    for (int idx = tid; idx < MAX_ROWS * CH; idx += NTH) {
      const int r = idx / CH, d = (idx % CH) * 8;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (r < live_rows && d < dim)
        w = *reinterpret_cast<const uint4*>(q_base + size_t(r / group) * q_row_stride +
                                            size_t(r % group) * dim + d);
      *reinterpret_cast<uint4*>(sQ + r * PITCH + d) = w;
    }
  }
  __syncthreads();

  const int r_base = (warp % ROW_TILES) * 16;
  const int col0 = (warp / ROW_TILES) * (DP / M::COLS);  // this warp's first O column
  const bool warp_live = r_base < live_rows;
  // ldmatrix lane addressing: the row (A: q row; B: key) and column
  // offsets of the 8x8 matrix this lane points at
  const int lr = lane & 7, lm = lane >> 3;
  uint32_t qf[Mma<KV, DP>::Q_IN_REGS ? KQ : 1][4];
  const uint32_t q_lane = smem_addr(sQ + (r_base + lr + 8 * (lm & 1)) * PITCH + 8 * (lm >> 1));
  if constexpr (M::Q_IN_REGS) {
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
    }
  }

  // this thread's rows of the warp tile: g and g + 8; its columns 2 t4, +1
  const int g = lane >> 2, t4 = lane & 3;
  // each row's live keys are (key_lo, key_hi]: below the tile's key cap
  // and at or before the query, inside its window
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q_pos = tl.start + tl.q0 + (r_base + g + 8 * h) / group;
    key_hi[h] = min(k_hi - 1, q_pos);
    key_lo[h] = window > 0 ? q_pos - window : INT_MIN;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();              // everyone's copies; tile i - 1's readers done
    load_tile(i + STAGES - 1);    // into the stage tile i - 1 held
    fill_rows(i + STAGES);        // into the slot tile i's copies used
    const int s = i % STAGES;
    const int k0 = k_lo + i * BK;
    const float* scales = nullptr;
    if constexpr (QUANT) {
      // widen the landed int8 tiles to bf16 in one pass
      const char* stage = base + M::RING + s * M::STAGE;
      constexpr int CH = DP / 16;
      for (int idx = tid; idx < 2 * BK * CH; idx += NTH) {
        const int which = idx / (BK * CH), j = (idx / CH) % BK, d = (idx % CH) * 16;
        if (d >= dim) continue;
        const uint4 w = *reinterpret_cast<const uint4*>(stage + which * M::TILE + j * DP + d);
        uint32_t packed[8];
        widen4(w.x, &packed[0], &packed[1]);
        widen4(w.y, &packed[2], &packed[3]);
        widen4(w.z, &packed[4], &packed[5]);
        widen4(w.w, &packed[6], &packed[7]);
        __nv_bfloat16* dst = (which ? v_tile(s) : k_tile(s)) + j * PITCH + d;
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      scales = reinterpret_cast<const float*>(stage + 2 * M::TILE);
      __syncthreads();
    }
    if (!warp_live) continue;

    // S = Q . K^T over the tile's BK keys
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const uint32_t k_lane =
        smem_addr(k_tile(s) + (lr + 8 * (lm >> 1)) * PITCH + 8 * (lm & 1));
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (M::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_lane + kk * 32);
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, k_lane + (n * 8 * PITCH + kk * 16) * 2);
        mma_bf16(sc[n], a, bb[0], bb[1]);
        mma_bf16(sc[n + 1], a, bb[2], bb[3]);
      }
    }

    // online softmax on the fragments: element e of sub-tile n is row
    // g + 8 (e >> 1), key k0 + 8 n + 2 t4 + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        // in log2 units: p = 2^(x log2 e - m)
        const float x =
            score_of(sc[n][e], QUANT ? scales[j] : 1.f, QUANT, scale, softcap) * LOG2E;
        sc[n][e] = x;
        const int c = k0 + j, h = e >> 1;
        if (c <= key_hi[h] && c > key_lo[h]) mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // exactly 1 where the max holds: a tile past the row's keys leaves O
      // and l as they were
      alpha[h] = m_new == m[h] ? 1.f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * n + 2 * t4 + (e & 1), h = e >> 1;
        // p is zeroed (not just -inf shifted) so fully masked rows stay 0
        const float p = c <= key_hi[h] && c > key_lo[h] ? exp2f(sc[n][e] - m[h]) : 0.f;
        psum[h] += p;
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

    // O += P . V: p rounded to bf16 (B3), or p * v_scale as a bf16 high
    // and low part (B6), straight from the S fragments
    const uint32_t v_lane =
        smem_addr(v_tile(s) + (lr + 8 * (lm & 1)) * PITCH + col0 + 8 * (lm >> 1));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* f = sc[2 * kk + half];
        if constexpr (QUANT) {
          const int j = 16 * kk + 8 * half + 2 * t4;
          float hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_bf16(f[e] * scales[BK + j + (e & 1)], &hi[e], &lo[e]);
          pa[2 * half] = pack_bf16(hi[0], hi[1]);
          pa[2 * half + 1] = pack_bf16(hi[2], hi[3]);
          pl[2 * half] = pack_bf16(lo[0], lo[1]);
          pl[2 * half + 1] = pack_bf16(lo[2], lo[3]);
        } else {
          pa[2 * half] = pack_bf16(f[0], f[1]);
          pa[2 * half + 1] = pack_bf16(f[2], f[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_lane + (kk * 16 * PITCH + n * 8) * 2);
        mma_bf16(o[n], pa, bb[0], bb[1]);
        mma_bf16(o[n + 1], pa, bb[2], bb[3]);
        if constexpr (QUANT) {
          mma_bf16(o[n], pl, bb[0], bb[1]);
          mma_bf16(o[n + 1], pl, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // out: live rows O / l; rows of the tile past its new tokens zero
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + g + 8 * h;
    const int t = r / group, gi = r % group;
    if (r >= rows || t >= tl.q_count) continue;
    const bool live = warp_live && r < live_rows;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* dst = o_base + size_t(t) * q_row_stride + size_t(gi) * dim;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = col0 + 8 * n + 2 * t4;
      if (d < dim)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            live ? __floats2bfloat162_rn(o[n][2 * h] / denom, o[n][2 * h + 1] / denom) : zero2;
    }
  }
}

// The q tile. B3 (block_q_req == 0): the most tokens (a power of two, at
// most seq) whose rows fit MAX_ROWS. B7 (block_q_req > 0): the largest
// divisor of the caller's tile whose rows fit. The key-tile width does not
// depend on it.
int next_tile(int tile, int block_q_req) {
  if (block_q_req == 0) return tile / 2;
  do --tile; while (tile > 0 && block_q_req % tile != 0);
  return tile;
}

int first_tile(int group, int seq, int block_q_req) {
  int tile;
  if (block_q_req == 0) {
    tile = 1;
    while (tile * 2 * group <= MAX_ROWS && tile * 2 <= seq) tile *= 2;
  } else {
    tile = block_q_req;
    while (tile * group > MAX_ROWS) tile = next_tile(tile, block_q_req);
  }
  return tile;
}

// The f32 body's plan: the q tile above, then halved until the
// shared-memory layout fits; the key tile shrinks only once a one-token
// tile does not fit, so B3 and B7 take the same bk at the same dim and
// group.
template <typename KV>
bool fma_plan(int dim, int group, int seq, int block_q_req, int* block_q, int* bk, Layout* L) {
  int tile = first_tile(group, seq, block_q_req);
  int width = MAX_BK;
  *L = layout<KV>(dim, tile * group, width);
  while (L->total > SMEM_LIMIT) {
    if (tile > 1) {
      tile = next_tile(tile, block_q_req);
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

// Everything a launch needs besides the kernel's types.
struct Args {
  const void *q, *kp, *vp;
  void* out;
  const int *tables, *starts, *lengths, *q_offsets;
  const float *k_scale, *v_scale;
  int batch, total_rows, seq, block_q_req, heads, kv_heads, dim, num_blocks, block_size,
      max_blocks;
  float scale, softcap;
  int window, verify;
  cudaStream_t stream;
};

template <typename KV>
cudaError_t launch_fma(const Args& a) {
  int block_q, bk;
  Layout L;
  if (!fma_plan<KV>(a.dim, a.heads / a.kv_heads, a.seq, a.block_q_req, &block_q, &bk, &L))
    return cudaErrorInvalidValue;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_fma_kernel<KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  dim3 grid(a.kv_heads, a.batch, (a.seq + block_q - 1) / block_q);
  paged_attention_fma_kernel<KV><<<grid, NT, L.total, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.kp), static_cast<const KV*>(a.vp),
      static_cast<float*>(a.out), a.tables, a.starts, a.lengths, a.q_offsets, a.k_scale,
      a.v_scale, a.total_rows, a.seq, a.heads, a.kv_heads, a.dim, a.num_blocks, a.block_size,
      a.max_blocks, block_q, bk, a.scale, a.softcap, a.window, a.verify, L);
  return cudaGetLastError();
}

template <typename KV, int DP>
cudaError_t launch_mma(const Args& a) {
  const int block_q = first_tile(a.heads / a.kv_heads, a.seq, a.block_q_req);
  constexpr size_t smem = Mma<KV, DP>::TOTAL;
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_mma_kernel<KV, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  dim3 grid(a.kv_heads, a.batch, (a.seq + block_q - 1) / block_q);
  paged_attention_mma_kernel<KV, DP><<<grid, Mma<KV, DP>::NT, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<__nv_bfloat16*>(a.out), a.tables, a.starts,
      a.lengths, a.q_offsets, a.k_scale, a.v_scale, a.total_rows, a.seq, a.heads, a.kv_heads,
      a.dim, a.num_blocks, a.block_size, a.max_blocks, block_q, a.scale, a.softcap, a.window,
      a.verify);
  return cudaGetLastError();
}

// bf16 q: the head dim padded to the next of 64, 128, 256
template <typename KV>
cudaError_t launch_bf16(const Args& a) {
  if (a.dim <= 64) return launch_mma<KV, 64>(a);
  if (a.dim <= 128) return launch_mma<KV, 128>(a);
  return launch_mma<KV, 256>(a);
}

// One dispatch over the pool element type and q's dtype (0 = bfloat16,
// 1 = float32); ``quant`` selects the int8 pools. q_offsets null: q/out
// [batch, seq, H, D], the tile B3 picks. Otherwise a flat [Q, H, D] tile
// with row spans of ``seq`` tokens at q_offsets and the caller's q tile
// ``block_q_req`` (B7).
cudaError_t dispatch(bool quant, int dtype, const void* q, const void* kp, const void* vp,
                     void* out, const void* tables, const void* starts, const void* lengths,
                     const void* q_offsets, const void* k_scale, const void* v_scale, int batch,
                     int total_rows, int seq, int block_q_req, int heads, int kv_heads, int dim,
                     int num_blocks, int block_size, int max_blocks, float scale, float softcap,
                     int window, int verify, void* stream) {
  if (batch <= 0 || seq <= 0) return cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0 || heads / kv_heads > MAX_ROWS ||
      dim % (quant ? 16 : 8) != 0 || dim <= 0 || dim > 256 || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0 || block_q_req < 0 ||
      (block_q_req > 0 && seq % block_q_req != 0))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, out,
               static_cast<const int*>(tables), static_cast<const int*>(starts),
               static_cast<const int*>(lengths), static_cast<const int*>(q_offsets),
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               batch, total_rows, seq, block_q_req, heads, kv_heads, dim, num_blocks, block_size,
               max_blocks, scale, softcap, window, verify, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return quant ? launch_bf16<int8_t>(a) : launch_bf16<__nv_bfloat16>(a);
  if (dtype == 1) return quant ? launch_fma<int8_t>(a) : launch_fma<float>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. dim must be a multiple of 8 and at
// most 256; at most 64 query heads per kv head. softcap <= 0 disables
// capping; window <= 0 is full attention. tables [batch, max_blocks],
// starts and lengths [batch] are int32. verify != 0 counts the launch as
// a speculative verify block (g_launches). Returns cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               void* out, const void* tables, const void* starts,
                               const void* lengths, int batch, int seq, int heads,
                               int kv_heads, int dim, int num_blocks, int block_size,
                               int max_blocks, int dtype, float scale, float softcap,
                               int window, int verify, void* stream) {
  return int(dispatch(false, dtype, q, kp, vp, out, tables, starts, lengths, nullptr, nullptr,
                      nullptr, batch, batch * seq, seq, 0, heads, kv_heads, dim, num_blocks,
                      block_size, max_blocks, scale, softcap, window, verify, stream));
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
                                     int window, int verify, void* stream) {
  return int(dispatch(true, dtype, q, kp, vp, out, tables, starts, lengths, nullptr, k_scale,
                      v_scale, batch, batch * seq, seq, 0, heads, kv_heads, dim, num_blocks,
                      block_size, max_blocks, scale, softcap, window, verify, stream));
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
                      num_blocks, block_size, max_blocks, scale, softcap, window, 0, stream));
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
                      num_blocks, block_size, max_blocks, scale, softcap, window, 0, stream));
}

// Copies the launch counts of this library's kernel forms (see
// g_launches) into out[FORMS] and, with reset, zeroes them. Waits for the
// device first. Returns the cudaError_t.
extern "C" int paged_attention_launch_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[FORMS] = {};
    err = cudaMemcpyToSymbol(g_launches, zeros, sizeof(g_launches));
  }
  return int(err);
}
