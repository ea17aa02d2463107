// flash_attention_lse: GQA attention over a dense fp32 or int8 KV cache,
// returning the normalised output and its log-sum-exp stats (m, l).
//
// Replaces the JAX package's Pallas kernels repro/kernels/flash.py
// (flash_attention_lse, body _flash_kernel) and, in its paged mode,
// repro/kernels/paged.py (paged_flash_attention_lse).  One kernel serves
// three call sites of the port: the committed-prefix half of tree
// verification, decode (n = 1) and causal prefill.
//
//   q     [B, H, n, hd] fp32, any strides with head_dim contiguous
//   k, v  [B, KV, L, hd] fp32 or int8 views, any strides with head_dim
//         contiguous (the port passes its [B, L, KV, hd] caches
//         transposed, with no copy)
//   k_scale, v_scale  [B, KV, L] fp32 per-row scales of int8 K/V (views
//         of the [B, L, KV] scale caches), one set of strides; null for
//         fp32 K/V.  An int8 row is dequantized, float(q) * scale, into
//         the shared-memory tile (the Pallas kernel's int8 mode)
//   kv_len [B] int32 valid prefix per batch row
//   qpos  [B, n] int32 absolute query positions, or null (needed for
//         causal and window masks)
//   o [B, H, n, hd], m [B, H, n], l [B, H, n] fp32, contiguous
//   work, counters  the wrapper's scratch: chunk and group partials, and
//         one int per (batch row, KV head, query tile, group) and one per
//         tile, zero between calls
//
// Key kpos is valid for a query at qpos when kpos < kv_len[b], and, if
// causal, kpos <= qpos, and, if window > 0, kpos > qpos - window.  A
// masked score is -1e30 and its probability 0; m starts at -1e30 and l is
// floored at 1e-30 in the division, so a row with no valid key returns
// o = 0, m = -1e30, l = 0 (the Pallas kernel's semantics).
//
// Paged mode (paged_flash_attention_lse_launch): K/V (and the int8
// scales) live in a block pool read through a per-row block table:
//   k, v  pools viewed as [Nb, KV, page, hd], any strides with head_dim
//         contiguous; k_scale, v_scale [Nb, KV, page]
//   table [B, mb] int32: logical key t of row b is row t % page of
//         physical block table[b, t / page]; L = mb * page
// Only a key's address changes (PagedRows against DenseRows, in
// attn_common.cuh): the plan, the tiles, the masks and the summation order
// are the dense kernel's, so the paged kernel over a pool gives the same
// bits as the dense kernel over the gathered view.  Masking stays
// logical; keys at or past a CTA's bound are zero-filled, never read, so
// the null block that unallocated logical blocks alias is never attended.
//
// What bounds it on an H100: bytes.  At the main path's sizes (B = 1, a
// few hundred cached keys, 8 KV heads of 128) launch latency and the
// serial chain of one CTA come first: a launch moves about 2 MB in fp32,
// under a microsecond at 3.35 TB/s.  Over long spans (long_500k's 524,288
// rows, decode_32k's 32,768 at batch 8) it is the rate at which the CTAs
// stream K/V, and the merge of the chunks' partials.  The design:
//   * Rows of a CTA: all `rep` query heads of one KV head times up to
//     64 / rep queries (64 rows, four m16 row tiles, at the main case), so
//     a K/V tile is read once per GQA group and query tile.  Two warps
//     share a row tile, each taking half of every key tile with its own
//     running softmax; the halves merge, in order, when the chunk ends.
//     A single warp's chain of dependent MMAs and fragment splits, not
//     the bytes, is what a CTA waits on at the main path's sizes.
//   * Split keys (flash-decoding), in absolute chunks and groups: chunk c
//     holds the logical keys [c C, (c + 1) C), C = chunk_keys() (64 for
//     head_dim > 64, else 128), and group g the chunks [g G, (g + 1) G),
//     G = group_chunks() (4096 keys); both are functions of head_dim
//     alone, the same for fp32, int8, dense and paged.  A query tile
//     computes the chunks [c_lo, c_hi) that hold a key some row of it may
//     attend (kv_len, causal, window).  A row's result depends only on its
//     own batch row's keys and bounds: never on B or on other rows'
//     kv_len.
//   * A grid bounded by the card, not by L.  Up to G chunks of L (4096
//     keys: every span of the main path) a chunk has a CTA of its own,
//     in the instance kLong = false, whose code has no chunk loop.  Past
//     G (kLong) grid.x = min(chunks of L, max(G, cap)), where cap spreads
//     two waves of resident CTAs over the tiles (B * KV * query tiles),
//     and CTA x of a tile computes the tile's chunk slots x, x + grid.x,
//     ... below its own chunk count; a decode tile's CTA copies its next
//     chunk's first tile during the last tile of this one.  A windowed
//     decode over 524,288 rows launches hundreds of CTAs, not 65,536, and
//     the host reads no kv_len or qpos (a CUDA graph captures the
//     launch).
//   * Asynchronous copies: 32-key K/V tiles are double-buffered with
//     cp.async (16 bytes; the int8 rows and their scales raw, then
//     dequantized into the fp32 tile), so the next tile's copy (and, in
//     the paged mode, its block-table reads) runs during this tile's
//     arithmetic.
//   * Tensor cores: QK^T and PV are mma.sync m16n8k8 TF32 in the 3xTF32
//     form (big and small parts of both operands, three products, small
//     ones first), which keeps fp32-level accuracy.  q is pre-scaled once
//     in shared memory; q, K, V and P are split as fragments are read.  PV
//     takes P straight from the QK accumulators: the k slots t and t + 4
//     of a thread are its keys 2t and 2t + 1, and V's fragment reads the
//     same keys.  Rows of K and V are padded to head_dim + 4 floats, so
//     the fragment reads hit 32 banks.
//   * One launch per call, a two-level merge: a tile with one chunk
//     writes (o, m, l) from its CTA.  Otherwise each chunk's unnormalised
//     (acc, m, l) goes to the scratch, strided by the tile's own rows;
//     the last CTA to finish a chunk of a group (a counter per (tile,
//     group), bumped after a __threadfence and reset by that CTA) merges
//     the group's chunks in chunk order: M = max m_c, l = sum l_c
//     exp(m_c - M), acc = sum acc_c exp(m_c - M).  A tile whose chunks lie
//     in one group normalises there, o = acc / max(l, 1e-30): the earlier
//     single-level merge, bit for bit.  Otherwise the group's (acc, M, l)
//     is a partial of its own, and the last group merger of the tile (a
//     counter per tile) merges the groups in group order the same way.
//     Each merge takes the max over the partials in parallel, stages the
//     weights and l in shared memory (in batches when they do not fit:
//     one group always fits), and keeps many partials' loads in flight.
// A tile, chunk or group with no valid key for a row adds exactly nothing
// to that row (p = 0, weight 0, l = 0), so a row's bits depend only on the
// chunks and groups that hold its valid keys: a row alone equals the row
// in a batch, chunked prefill equals one-shot prefill, paged equals
// dense, and a window's rows alone equal the same rows in a longer cache.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;           // 8 warps: a row tile and key half each
constexpr int kMaxRows = 64;            // (query, head) rows per CTA
constexpr int kTile = 32;               // keys per shared-memory tile
constexpr int kGroupKeys = 4096;        // logical keys per group of chunks
constexpr int kWaves = 2;               // resident CTAs' waves a grid holds
constexpr int kStreamRows = 16;         // a tile of up to this many rows
                                        // streams its chunks (below)

__host__ __device__ constexpr int chunk_keys(int hd) {
  return hd > 64 ? 64 : 128;
}

__host__ __device__ constexpr int group_chunks(int hd) {
  return kGroupKeys / chunk_keys(hd);
}

// Shared-memory layout of a CTA: q, pre-scaled, [64][HD + 4]; the K and V
// fp32 tiles [32][HD + 4], two of each for fp32 K/V, one for int8, whose
// raw K and V tiles [32][HD] and scales [32] are the two buffers instead
// (they are dequantized into the fp32 tiles once landed).  At head_dim
// 128 a CTA takes 99 KB (fp32) or 83 KB (int8), at 256 (Gemma) 195 KB or
// 163 KB; over 200 registers a thread keep it at one CTA an SM at head
// dim 128 and 256.  After a chunk's last tile, everything
// past q (kStage floats) holds the key halves' hand-over (kHandover
// floats), then a merge's staging: M and l [2][64], then the weights and
// the partials' l [2][rows][batch]; q stays for the CTA's next chunk.
template <int HD, bool kInt8>
struct Smem {
  static constexpr int kStride = HD + 4;
  static constexpr int kQ = kMaxRows * kStride;          // floats
  static constexpr int kKV = kTile * kStride;            // floats
  static constexpr int kBufs = kInt8 ? 1 : 2;            // fp32 tile pairs
  static constexpr int kRaw = kInt8 ? kTile * HD : 0;    // bytes
  static constexpr int kSc = kInt8 ? kTile : 0;          // floats
  static constexpr size_t kBytes =
      4 * ((size_t)kQ + 2 * kBufs * (size_t)kKV + 4 * (size_t)kSc) +
      4 * (size_t)kRaw;
  static constexpr int kStage = (int)(kBytes / 4) - kQ;  // floats past q
  // one warp's (acc, m, l) per m16 row tile, 32 lanes each
  static constexpr int kHandover = (kMaxRows / 16) * (HD / 2 + 4) * 32;
  static_assert(kHandover <= kStage,
                "the key halves' hand-over must fit past q");
  static_assert(2 * kMaxRows * (1 + group_chunks(HD)) <= kStage,
                "a group's weights and l must fit past q at 64 rows");
  // a streamed decode tile's hand-over and merge staging in one tile buffer
  static_assert((kStreamRows + 15) / 16 * (HD / 2 + 4) * 32 <= kKV &&
                2 * kMaxRows + 2 * kStreamRows * group_chunks(HD) <= kKV,
                "a 16-row tile's hand-over and group staging must fit a "
                "tile buffer");
  static_assert(kBytes <= 227 * 1024, "over the opt-in shared memory");
};

// Where a tile's row r goes in o [B, H, n, hd] and m, l [B, H, n].
struct OutRows {
  float* o;
  float* m;
  float* l;
  int b, H, n, g, rep, q0;
  __device__ __forceinline__ long long row(int r) const {
    return ((long long)b * H + g * rep + r % rep) * n + q0 + r / rep;
  }
};

// acc += sum over the `nb` partials at base + c pstride (c < nb) of
// acc_c[r][d..d+3] * wts[r][c] for kU items i = i0 + u kThreads (row r =
// i / per, columns (i % per) w4), partials in order, kB loads of each
// item in flight.
template <int kU, int kB>
__device__ __forceinline__ void accumulate(float (&a)[kU][4],
                                           const float* base, int nb,
                                           long long pstride, int i0,
                                           int items, int per, int w4,
                                           int hd, const float* wts,
                                           int wstride) {
  for (int c0 = 0; c0 < nb; c0 += kB) {
    float4 v[kU][kB];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / per;
      const int d = (i - r * per) * w4;
#pragma unroll
      for (int bb = 0; bb < kB; ++bb) {
        if (i < items && c0 + bb < nb) {
          const float* src = base + (c0 + bb) * pstride + r * hd + d;
          v[u][bb] = w4 == 4
              ? __ldcg(reinterpret_cast<const float4*>(src))
              : make_float4(__ldcg(src), 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / per;
#pragma unroll
      for (int bb = 0; bb < kB; ++bb) {
        const int c = c0 + bb;
        if (i < items && c < nb) {
          const float w = wts[r * wstride + c];
          a[u][0] += v[u][bb].x * w;
          a[u][1] += v[u][bb].y * w;
          a[u][2] += v[u][bb].z * w;
          a[u][3] += v[u][bb].w * w;
        }
      }
    }
  }
}

// Merge the `cnt` partials at base + i pstride (i < cnt; each acc
// [prows][hd] unnormalised, then m [prows], then l [prows]) in order,
// for the tile's rows r < rows: M = max_i m_i, w_i = exp(m_i - M),
// l = sum_i l_i w_i and acc = sum_i acc_i w_i, each sum from 0 in the
// order i.  With `dst` null it writes o = acc / max(l, 1e-30), M and l
// to the output rows; else (acc, M, l) to `dst` in the partial layout.
// `st` is the staging region (`stfloats` floats): M and l [2][64], then
// the partials' m (turned into their weights) and l [2][rows][nb], nb
// partials a batch, every batch's loads issued at once.  When every
// partial fits one batch, each row's thread takes M, the weights and l in
// one pass (the single-level merge's form); every thread calls it.
template <int kU, int kB>
__device__ __forceinline__ void merge_parts(const float* base, int cnt,
                                            long long pstride, int prows,
                                            int rows, int hd, float* st,
                                            int stfloats, float* dst,
                                            const OutRows& out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* stat = st;                          // M [64], then l [64]
  const int nb = min(cnt, (stfloats - 2 * kMaxRows) / (2 * rows));
  float* wts = st + 2 * kMaxRows;            // [rows][nb]
  float* lc = wts + rows * nb;               // [rows][nb]
  const float* mbase = base + (long long)prows * hd;
  const bool batched = nb < cnt;
  // the batch [c0, c0 + nbb): m to wts, and l to lc when `with_l`
  auto stage = [&](int c0, int nbb, bool with_l) {
    for (int i = tid; i < rows * nbb; i += kThreads) {
      const int r = i / nbb;
      const int c = i - r * nbb;
      const float* pc = mbase + (c0 + c) * pstride;
      wts[r * nb + c] = __ldcg(pc + r);
      if (with_l) lc[r * nb + c] = __ldcg(pc + prows + r);
    }
  };
  if (!batched) {
    stage(0, cnt, true);
    __syncthreads();
    if (tid < rows) {
      float mx = kNegInf;
      for (int c = 0; c < cnt; ++c) mx = fmaxf(mx, wts[tid * nb + c]);
      float l = 0.f;
      for (int c = 0; c < cnt; ++c) {
        const float w = exp2f((wts[tid * nb + c] - mx) * kLog2e);
        wts[tid * nb + c] = w;
        l += lc[tid * nb + c] * w;
      }
      stat[tid] = mx;
      stat[kMaxRows + tid] = l;
    }
    __syncthreads();
  }
  // else M per row over every batch, a warp a row (a max is exact in any
  // order), then the weights and l batch by batch
  if (batched && tid < rows) {
    stat[tid] = kNegInf;
    stat[kMaxRows + tid] = 0.f;
  }
  for (int c0 = 0; batched && c0 < cnt; c0 += nb) {
    const int nbb = min(nb, cnt - c0);
    if (c0 > 0) __syncthreads();
    stage(c0, nbb, false);
    __syncthreads();
    for (int r = warp; r < rows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < nbb; c += 32) mx = fmaxf(mx, wts[r * nb + c]);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, sh));
      }
      if (lane == 0) stat[r] = fmaxf(stat[r], mx);
    }
  }
  if (batched) __syncthreads();
  const int w4 = hd % 4 == 0 ? 4 : 1;
  const int per = hd / w4;
  const int items = rows * per;
  for (int i0 = 0; i0 < items; i0 += kThreads * kU) {
    float a[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[u][e] = 0.f;
    for (int c0 = 0; c0 < cnt; c0 += nb) {
      const int nbb = min(nb, cnt - c0);
      if (batched) {
        // the batch's weights and, on the first pass, each row's l from
        // its thread, in order
        __syncthreads();
        stage(c0, nbb, i0 == 0);
        __syncthreads();
        for (int i = tid; i < rows * nbb; i += kThreads) {
          const int r = i / nbb;
          const int c = i - r * nbb;
          wts[r * nb + c] = exp2f((wts[r * nb + c] - stat[r]) * kLog2e);
        }
        __syncthreads();
        if (i0 == 0 && tid < rows) {
          float l = stat[kMaxRows + tid];
          for (int c = 0; c < nbb; ++c) l += lc[tid * nb + c] * wts[tid * nb + c];
          stat[kMaxRows + tid] = l;
        }
      }
      accumulate<kU, kB>(a, base + c0 * pstride, nbb, pstride, i0 + tid,
                         items, per, w4, hd, wts, nb);
    }
    __syncthreads();                     // every row's l is complete
    if (i0 == 0 && tid < rows) {
      if (dst) {
        dst[(long long)prows * hd + tid] = stat[tid];
        dst[(long long)prows * hd + prows + tid] = stat[kMaxRows + tid];
      } else {
        out.m[out.row(tid)] = stat[tid];
        out.l[out.row(tid)] = stat[kMaxRows + tid];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + tid + u * kThreads;
      if (i >= items) continue;
      const int r = i / per;
      const int d = (i - r * per) * w4;
      float x[4];
      if (dst) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = a[u][e];
      } else {
        const float den = fmaxf(stat[kMaxRows + r], kMinL);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = a[u][e] / den;
      }
      float* op = dst ? dst + r * hd + d : out.o + out.row(r) * hd + d;
      if (w4 == 4) {
        *reinterpret_cast<float4*>(op) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
        op[0] = x[0];
      }
    }
  }
}

// merge_parts with its loads sized to the work: few items (a decode
// tile's rows) take 16 partials' loads each in flight, many take 4 items
// of 4 partials each
__device__ __forceinline__ void merge(const float* base, int cnt,
                                      long long pstride, int prows,
                                      int rows, int hd, float* st,
                                      int stfloats, float* dst,
                                      const OutRows& out) {
  if (rows * (hd % 4 == 0 ? hd / 4 : hd) <= kThreads) {
    merge_parts<1, 16>(base, cnt, pstride, prows, rows, hd, st, stfloats,
                       dst, out);
  } else {
    merge_parts<4, 4>(base, cnt, pstride, prows, rows, hd, st, stfloats,
                      dst, out);
  }
}

// merge, called: the long instance keeps its chunk loop's registers apart
// from the merges'
__device__ __noinline__ void merge_call(const float* base, int cnt,
                                        long long pstride, int prows,
                                        int rows, int hd, float* st,
                                        int stfloats, float* dst,
                                        const OutRows& out) {
  merge(base, cnt, pstride, prows, rows, hd, st, stfloats, dst, out);
}

// Up to head_dim 64 the one-chunk instance fits 128 registers a thread,
// so two CTAs share an SM (many query tiles: Whisper's encoder).
template <class Elem, bool kPaged, int HD, bool kLong>
__global__ void __launch_bounds__(kThreads, !kLong && HD <= 64 ? 2 : 1)
flash_attention_lse_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const int* __restrict__ table, int mb, int page,
    const int* __restrict__ kv_len, const int* __restrict__ qpos,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ work,
    int* __restrict__ counters, int KV, int H, int n, int L, int hd, int rep,
    int bq, int causal, int window, float scale, int vec) {
  constexpr bool kInt8 = sizeof(Elem) == 1;
  using SM = Smem<HD, kInt8>;
  constexpr int S = SM::kStride;
  constexpr int kDT = HD / 8;            // 8-column tiles of head_dim
  constexpr int C = chunk_keys(HD);
  constexpr int G = group_chunks(HD);
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                      // [64][S]
  float* kst = qf + SM::kQ;              // [kBufs][32][S]
  float* vst = kst + SM::kBufs * SM::kKV;
  float* kss = vst + SM::kBufs * SM::kKV;  // [2][32]
  float* vss = kss + 2 * SM::kSc;
  int8_t* kraw = reinterpret_cast<int8_t*>(vss + 2 * SM::kSc);  // [2][32][HD]
  int8_t* vraw = kraw + 2 * SM::kRaw;
  __shared__ int last;

  const int bg = blockIdx.z;             // b * KV + g
  const int b = bg / KV;
  const int g = bg - b * KV;
  const int qt = blockIdx.y;
  const int q0 = qt * bq;
  const int nq = min(bq, n - q0);
  const int rows = nq * rep;
  const int* qp = qpos ? qpos + (long long)b * n : nullptr;

  // the tile's key range: [start, end) holds every key some row may attend
  const int kvl = kv_len[b];
  int end = min(L, kvl);
  int start = 0;
  if (qp && (causal || window > 0)) {
    int lo = qp[q0], hi = qp[q0];
    for (int i = 1; i < nq; ++i) {
      lo = min(lo, qp[q0 + i]);
      hi = max(hi, qp[q0 + i]);
    }
    if (causal) end = min(end, hi + 1);
    if (window > 0) start = max(0, lo - window + 1);
  }
  const int c_lo = start < end ? start / C : 0;
  const int c_hi = max(c_lo + 1, (end + C - 1) / C);
  const int nchunks = c_hi - c_lo;
  if ((int)blockIdx.x >= nchunks) return;  // past the tile's bound

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp >> 1;              // m16 row tile
  const int kh = warp & 1;               // half of each tile's keys
  const int gq = lane >> 2;              // MMA group
  const int tq = lane & 3;               // thread in group

  const long long kbase = (kPaged ? 0 : b * ksb) + g * ksh;
  const long long sbase = (kPaged ? 0 : b * ssb) + g * ssh;
  using Rows = typename std::conditional<kPaged, PagedRows, DenseRows>::type;
  Rows keys;
  if constexpr (kPaged) {
    keys = PagedRows{table + (long long)b * mb, page, kbase, ksb, ksl,
                     sbase, ssb, ssl};
  } else {
    keys = DenseRows{kbase, ksl, sbase, ssl};
  }

  // this thread's two rows: r0 = 16 warp + gq and r0 + 8
  int qpr[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mt + gq + 8 * i;
    live[i] = r < rows;
    qpr[i] = (qp && live[i]) ? qp[q0 + r / rep] : 0;
  }
  const bool active = 16 * mt < rows;  // a warp with rows of its own
  const bool owner = kh == 0 && active;  // holds its row tile's result
  const bool qvec = hd % 4 == 0 && qsb % 4 == 0 && qsh % 4 == 0 &&
                    qsn % 4 == 0 && (uintptr_t)q % 16 == 0;

  // A decode tile (one row tile, full head_dim) of a long span streams
  // its chunks: the last tile of a chunk is computed while the first tile
  // of the CTA's next chunk is copied, and the chunk's hand-over, partial,
  // counter and merges use only the buffer that tile has left.  Other
  // tiles' chunks start their copies when they start.
  const bool stream = kLong && rows <= kStreamRows && hd == HD;
  int gt = 0;                            // the CTA's tiles so far: buffer gt & 1
  bool ahead = false;                    // this chunk's first tile is in flight
  float mrow[2], lrow[2];
  float acc[kDT][4];
  // shared memory free after a chunk, for its hand-over and merges
  float* free_st = kst;
  int free_floats = SM::kStage;

  // Chunk slot `slot` (chunk c_lo + slot) into the owner warps' (acc,
  // mrow, lrow), its key halves merged; with `next` >= 0 the first tile of
  // slot `next` is copied during the chunk's last tile.
  auto compute = [&](const int slot, const bool first, const int next) {
    const int cs = (c_lo + slot) * C;
    const int ce = min(cs + C, end);     // keys past ce are never read
    const int ntiles = ce > cs ? (ce - cs + kTile - 1) / kTile : 0;
    const bool prefetch = next >= 0;
    if (!first) __syncthreads();         // the last chunk's merges are done

    // zero the padding columns [hd, HD) of the fp32 tiles (loads never
    // write them; a hand-over or merge did)
    if (hd < HD) {
      for (int i = tid; i < 2 * SM::kBufs * kTile * (HD - hd); i += kThreads) {
        const int r = i / (HD - hd);
        const int d = hd + (i - r * (HD - hd));
        kst[r * S + d] = 0.f;   // the tiles are contiguous
      }
    }
    // q rows (r < rows) land as fp32 in the first tile's copy group and
    // are scaled in place once landed, for the CTA's first chunk.  Row r
    // is query q0 + r / rep of head g * rep + r % rep.  Rows past `rows`
    // are never attended or stored, so they are left as they are.
    if (ntiles > 0 && !ahead) {
      if (first) {
        const int per = qvec ? hd / 4 : hd;
        for (int i = tid; i < rows * per; i += kThreads) {
          const int r = i / per;
          const int d = (i - r * per) * (qvec ? 4 : 1);
          const float* src = q + b * qsb + (g * rep + r % rep) * qsh +
                             (q0 + r / rep) * qsn + d;
          if (qvec) {
            cp_async16(qf + r * S + d, src, true);
          } else {
            qf[r * S + d] = *src;
          }
        }
        for (int i = tid; i < rows * (HD - hd); i += kThreads) {
          const int r = i / (HD - hd);
          qf[r * S + hd + (i - r * (HD - hd))] = 0.f;
        }
      }
      const int b0 = gt & 1;
      load_tile<HD>(k, v, k_scale, v_scale, keys, cs, ce, kTile, kThreads,
                    hd, vec != 0, kst + (kInt8 ? 0 : b0 * SM::kKV),
                    vst + (kInt8 ? 0 : b0 * SM::kKV), kraw + b0 * SM::kRaw,
                    vraw + b0 * SM::kRaw, kss + b0 * SM::kSc,
                    vss + b0 * SM::kSc);
    }
    if (!ahead) cp_async_commit();

    mrow[0] = mrow[1] = kNegInf;
    lrow[0] = lrow[1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

    for (int it = 0; it < ntiles; ++it, ++gt) {
      const int buf = gt & 1;
      const int t0 = cs + it * kTile;
      // the next tile: this chunk's, else the first of the CTA's next
      const int nt0 = it + 1 < ntiles ? t0 + kTile : (c_lo + next) * C;
      if (it + 1 < ntiles || prefetch) {
        const int nb = buf ^ 1;
        load_tile<HD>(k, v, k_scale, v_scale, keys, nt0,
                      it + 1 < ntiles ? ce : min(nt0 + C, end), kTile,
                      kThreads, hd, vec != 0,
                      kst + (kInt8 ? 0 : nb * SM::kKV),
                      vst + (kInt8 ? 0 : nb * SM::kKV),
                      kraw + nb * SM::kRaw, vraw + nb * SM::kRaw,
                      kss + nb * SM::kSc, vss + nb * SM::kSc);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                   // this tile (and q) has landed
      if (it == 0 && first) {
        // q * scale, the Pallas kernels' order
        for (int i = tid; i < rows * HD; i += kThreads) {
          const int r = i / HD;
          qf[r * S + (i - r * HD)] *= scale;
        }
        if constexpr (!kInt8) __syncthreads();
      }
      float* ks = kst + (kInt8 ? 0 : buf * SM::kKV);
      float* vs = vst + (kInt8 ? 0 : buf * SM::kKV);
      if constexpr (kInt8) {
        dequant_tile<HD>(kraw + buf * SM::kRaw, vraw + buf * SM::kRaw,
                         kss + buf * SM::kSc, vss + buf * SM::kSc, kTile,
                         kThreads, hd, ks, vs);
        __syncthreads();
      }
      if (active) {
        // S = q K^T over this warp's half of the tile: key tiles 2 kh and
        // 2 kh + 1 of 8 keys.  The three products accumulate apart (6
        // independent MMA chains, 16 deep), then add, small ones first.
        float s[2][4], sx[2][4], sy[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = sx[j][c] = sy[j][c] = 0.f;
        const float* qr = qf + (16 * mt + gq) * S + tq;
#pragma unroll 4
        for (int kk = 0; kk < kDT; ++kk) {
          const float* qi = qr + 8 * kk;
          uint32_t ab[4], as[4];
          split_tf32(qi[0], ab[0], as[0]);
          split_tf32(qi[8 * S], ab[1], as[1]);
          split_tf32(qi[4], ab[2], as[2]);
          split_tf32(qi[8 * S + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float* kp = ks + (8 * (2 * kh + j) + gq) * S + 8 * kk + tq;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(kp[0], bb0, bs0);
            split_tf32(kp[4], bb1, bs1);
            mma_tf32(sx[j], as, bb0, bb1);
            mma_tf32(sy[j], ab, bs0, bs1);
            mma_tf32(s[j], ab, bb0, bb1);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] += sx[j][c] + sy[j][c];
        // online softmax over the warp's keys; element (row i, key
        // 8 (2 kh + j) + 2 tq + e) is s[j][2 i + e]
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = t0 + 8 * (2 * kh + j) + 2 * tq + e;
              bool ok = live[i] && kp < kvl;
              if (causal) ok = ok && kp <= qpr[i];
              if (window > 0) ok = ok && kp > qpr[i] - window;
              float& sv = s[j][2 * i + e];
              sv = ok ? sv : kNegInf;
              mx = fmaxf(mx, sv);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          const float mn = fmaxf(mrow[i], mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& sv = s[j][2 * i + e];
              sv = sv > kNegInf ? exp2f((sv - mn) * kLog2e) : 0.f;
              sum += sv;
            }
          }
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          alpha[i] = exp2f((mrow[i] - mn) * kLog2e);
          lrow[i] = lrow[i] * alpha[i] + sum;
          mrow[i] = mn;
        }
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          acc[dt][0] *= alpha[0];
          acc[dt][1] *= alpha[0];
          acc[dt][2] *= alpha[1];
          acc[dt][3] *= alpha[1];
        }
        // O += P V over the warp's keys: k slots tq and tq + 4 of key tile
        // 2 kh + j are its keys 2 tq and 2 tq + 1.  Each product runs over
        // all head_dim tiles before the next, so consecutive MMAs are
        // independent.
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t ab[4], as[4];
          split_tf32(s[j][0], ab[0], as[0]);
          split_tf32(s[j][2], ab[1], as[1]);
          split_tf32(s[j][1], ab[2], as[2]);
          split_tf32(s[j][3], ab[3], as[3]);
          pv_update<kDT, S>(acc, ab, as,
                            vs + (8 * (2 * kh + j) + 2 * tq) * S + gq);
        }
      }
      __syncthreads();                   // readers done before the refill
    }
    if (!prefetch) cp_async_wait<0>();
    ahead = prefetch;
    // shared memory free for the hand-over and the merges: the buffer of
    // the chunk's last tile (one row tile's hand-over and a 16-row merge
    // fit it) while the next chunk's first tile lands in the other, else
    // everything past q
    free_st = stream ? kst + (kInt8 ? 0 : ((gt + 1) & 1) * SM::kKV) : kst;
    free_floats = stream ? SM::kKV : SM::kStage;

    // the two key halves of each row tile, in order: warp kh = 1 hands
    // its (acc, m, l) to warp kh = 0 through shared memory, which merges
    // them as the chunks are merged
    {
      float* cb = free_st + mt * (kDT * 4 + 4) * 32 + lane;
      if (kh == 1 && active) {
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[(dt * 4 + c) * 32] = acc[dt][c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cb[(kDT * 4 + i) * 32] = mrow[i];
          cb[(kDT * 4 + 2 + i) * 32] = lrow[i];
        }
      }
      __syncthreads();
      if (owner) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m1 = cb[(kDT * 4 + i) * 32];
          const float mx = fmaxf(mrow[i], m1);
          const float a0 = exp2f((mrow[i] - mx) * kLog2e);
          const float a1 = exp2f((m1 - mx) * kLog2e);
          lrow[i] = lrow[i] * a0 + cb[(kDT * 4 + 2 + i) * 32] * a1;
          mrow[i] = mx;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * i + e;
              acc[dt][c] = acc[dt][c] * a0 + cb[(dt * 4 + c) * 32] * a1;
            }
          }
        }
      }
    }

  };

  // element (row i, column 8 dt + 2 tq + e) is acc[dt][2 i + e]
  // a tile of one chunk: (o, m, l) from the owner warps
  auto store = [&]() {
    if (!owner) return;
    const OutRows out{o, m_out, l_out, b, H, n, g, rep, q0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const int r = 16 * mt + gq + 8 * i;
      const long long orow = out.row(r);
      const float den = fmaxf(lrow[i], kMinL);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int d = 8 * dt + 2 * tq;
        store2(o + orow * hd + d, acc[dt][2 * i] / den,
               acc[dt][2 * i + 1] / den, hd - d);
      }
      if (tq == 0) {
        m_out[orow] = mrow[i];
        l_out[orow] = lrow[i];
      }
    }
  };

  // a chunk of a longer tile: its partial, its group's counter, and the
  // merges its CTA finishes last
  auto finish = [&](const int slot) {
    // the scratch: chunk partials of every tile by slot, then group
    // partials by absolute group, each prows (acc, m, l) rows padded to
    // whole 16-byte vectors; counters per (tile, group), then per tile
    const int nch = max(1, (L + C - 1) / C);
    const int ngr = (nch + G - 1) / G;
    const int prows = min(bq, n) * rep;
    const long long pstride = ((long long)prows * (hd + 2) + 3) & ~3ll;
    const long long tile = (long long)bg * gridDim.y + qt;
    float* cparts = work + tile * nch * pstride;
    int* count = counters + tile * (ngr + 1);
    // the chunk's partial: acc [prows][hd], then m, l [prows]
    float* part = cparts + slot * pstride;
    if (owner) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live[i]) continue;
        const int r = 16 * mt + gq + 8 * i;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const int d = 8 * dt + 2 * tq;
          store2(part + r * hd + d, acc[dt][2 * i], acc[dt][2 * i + 1],
                 hd - d);
        }
        if (tq == 0) {
          part[prows * hd + r] = mrow[i];
          part[prows * hd + prows + r] = lrow[i];
        }
      }
    }
    // its group's slots [s0, s1): the last CTA to finish one merges them
    const int ga = (c_lo + slot) / G;
    const int s0 = max(c_lo, ga * G) - c_lo;
    const int s1 = min(c_hi, (ga + 1) * G) - c_lo;
    // the CTA's stores, then one fence (cumulative over them, as the
    // barrier ordered them before it) and the counter
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(count + ga, 1) == s1 - s0 - 1;
      if (last) count[ga] = 0;           // ready for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int g_lo = c_lo / G;
    const int g_hi = (c_hi - 1) / G + 1;
    const bool one = !kLong || g_hi - g_lo == 1;  // normalise here, as ever
    const OutRows out{o, m_out, l_out, b, H, n, g, rep, q0};
    float* gparts = work + (long long)gridDim.z * gridDim.y * nch * pstride +
                    tile * ngr * pstride;
    if constexpr (kLong) {
      merge_call(cparts + s0 * pstride, s1 - s0, pstride, prows, rows, hd,
                 free_st, free_floats, one ? nullptr : gparts + ga * pstride,
                 out);
    } else {                             // the single-level merge
      merge_parts<4, 4>(cparts + s0 * pstride, s1 - s0, pstride, prows,
                        rows, hd, free_st, free_floats, nullptr, out);
    }
    if (one) return;
    // the tile's last group merger merges the groups in order
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(count + ngr, 1) == g_hi - g_lo - 1;
      if (last) count[ngr] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    merge_call(gparts + g_lo * pstride, g_hi - g_lo, pstride, prows, rows,
               hd, free_st, free_floats, nullptr, out);
  };

  if constexpr (kLong) {
    // the tile's chunk slots of this CTA: slot s is chunk c_lo + s
    for (int slot = blockIdx.x; slot < nchunks; slot += gridDim.x) {
      const int next = slot + gridDim.x;   // the CTA's next chunk slot
      compute(slot, slot == (int)blockIdx.x,
              stream && next < nchunks ? next : -1);
      if (nchunks == 1) {
        store();
        return;
      }
      finish(slot);
    }
  } else {                               // one chunk a CTA
    compute(blockIdx.x, true, -1);
    if (nchunks == 1) {
      store();
      return;
    }
    finish(blockIdx.x);
  }
}

// The CTAs one instance keeps resident on an SM, and the card's SMs
// (both read once a process; no stream work, so a CUDA graph may capture
// a launch that asks).
template <auto kernel>
cudaError_t residency(size_t smem, int* per_sm, int* sms) {
  static int resident = 0;
  static int count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  if (resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
  }
  *per_sm = resident;
  *sms = count[dev];
  return cudaSuccess;
}

// The grid of a launch of instance kLong: (chunks, query tiles, B * KV)
// up to G chunks of L, a CTA a chunk; past G (kLong) grid.x is
// min(chunks, max(G, cap)), cap = kWaves * resident CTAs / tiles (the
// mirror: flash.grid_x).
template <class Elem, bool kPaged, int HD, bool kLong>
cudaError_t grid_hd(int chunks, int qtiles, int bkv, dim3* grid) {
  constexpr size_t smem = Smem<HD, sizeof(Elem) == 1>::kBytes;
  cudaError_t err =
      allow_smem<flash_attention_lse_kernel<Elem, kPaged, HD, kLong>>(smem);
  if (err != cudaSuccess) return err;
  long long x = chunks;
  if constexpr (kLong) {
    int per_sm = 0, sms = 0;
    err = residency<flash_attention_lse_kernel<Elem, kPaged, HD, true>>(
        smem, &per_sm, &sms);
    if (err != cudaSuccess) return err;
    const long long tiles = (long long)qtiles * bkv;
    const long long cap =
        std::max(1ll, (long long)kWaves * per_sm * sms / tiles);
    x = std::min(x, std::max((long long)group_chunks(HD), cap));
  }
  *grid = dim3((unsigned)x, qtiles, bkv);
  return cudaSuccess;
}

// The instance a span takes: kLong past one group of chunks.
template <class Elem, bool kPaged, int HD>
cudaError_t grid_for(int chunks, int qtiles, int bkv, dim3* grid) {
  return chunks > group_chunks(HD)
             ? grid_hd<Elem, kPaged, HD, true>(chunks, qtiles, bkv, grid)
             : grid_hd<Elem, kPaged, HD, false>(chunks, qtiles, bkv, grid);
}

template <class Elem, bool kPaged, int HD, bool kLong>
cudaError_t launch_inst(int chunks, int qtiles, int bkv, const float* q,
                        long long qsb, long long qsh, long long qsn,
                        const void* k, const void* v, long long ksb,
                        long long ksh, long long ksl, const float* ksc,
                        const float* vsc, long long ssb, long long ssh,
                        long long ssl, const int* table, int mb, int page,
                        const int* kv_len, const int* qpos, float* o,
                        float* m, float* l, float* work, int* counters,
                        int KV, int H, int n, int L, int hd, int rep, int bq,
                        int causal, int window, float scale, int vec,
                        cudaStream_t s) {
  constexpr size_t smem = Smem<HD, sizeof(Elem) == 1>::kBytes;
  dim3 grid;
  cudaError_t err =
      grid_hd<Elem, kPaged, HD, kLong>(chunks, qtiles, bkv, &grid);
  if (err != cudaSuccess) return err;
  flash_attention_lse_kernel<Elem, kPaged, HD, kLong>
      <<<grid, kThreads, smem, s>>>(
          q, qsb, qsh, qsn, (const Elem*)k, (const Elem*)v, ksb, ksh, ksl,
          ksc, vsc, ssb, ssh, ssl, table, mb, page, kv_len, qpos, o, m, l,
          work, counters, KV, H, n, L, hd, rep, bq, causal, window, scale,
          vec);
  return cudaGetLastError();
}

template <class Elem, bool kPaged, int HD, class... Args>
cudaError_t launch_hd(int chunks, Args... args) {
  return chunks > group_chunks(HD)
             ? launch_inst<Elem, kPaged, HD, true>(chunks, args...)
             : launch_inst<Elem, kPaged, HD, false>(chunks, args...);
}

// The grid a launch of these sizes takes (`grid` x, y, z), or an error.
template <bool kPaged>
int grid_of(int B, int H, int KV, int n, int L, int hd, int bq, int int8,
            int* out) {
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || bq < 1 || hd < 1 ||
      hd > 256 || L < 0 || (long long)B * KV > 65535 ||
      bq * (H / KV) > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const int qtiles = (n + bq - 1) / bq;
  const int chunks = std::max(1, (L + chunk_keys(hd) - 1) / chunk_keys(hd));
  if (qtiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid;
  cudaError_t err;
  if (int8) {
    err = hd <= 64    ? grid_for<int8_t, kPaged, 64>(chunks, qtiles, B * KV,
                                                     &grid)
          : hd <= 128 ? grid_for<int8_t, kPaged, 128>(chunks, qtiles, B * KV,
                                                      &grid)
                      : grid_for<int8_t, kPaged, 256>(chunks, qtiles, B * KV,
                                                      &grid);
  } else {
    err = hd <= 64    ? grid_for<float, kPaged, 64>(chunks, qtiles, B * KV,
                                                    &grid)
          : hd <= 128 ? grid_for<float, kPaged, 128>(chunks, qtiles, B * KV,
                                                     &grid)
                      : grid_for<float, kPaged, 256>(chunks, qtiles, B * KV,
                                                     &grid);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)grid.x;
  out[1] = (int)grid.y;
  out[2] = (int)grid.z;
  return 0;
}

template <bool kPaged>
int launch(const void* q, long long qsb, long long qsh, long long qsn,
           const void* k, const void* v, long long ksb, long long ksh,
           long long ksl, const void* k_scale, const void* v_scale,
           long long ssb, long long ssh, long long ssl, const void* table,
           int mb, int page, const void* kv_len, const void* qpos, void* o,
           void* m, void* l, void* work, void* counters, int B, int H,
           int KV, int n, int L, int hd, int bq, int causal, int window,
           float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || bq < 1 || hd < 1 ||
      hd > 256 || L < 0 || (long long)B * KV > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (kPaged && (table == nullptr || mb < 1 || page < 1 || L > mb * page))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rep = H / KV;
  if (bq * rep > kMaxRows) return (int)cudaErrorInvalidValue;
  const int qtiles = (n + bq - 1) / bq;
  const int chunks = std::max(1, (L + chunk_keys(hd) - 1) / chunk_keys(hd));
  if (qtiles > 65535 ||
      (chunks > 1 && (work == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int8 = k_scale != nullptr;
  const int vec = (int)can_vec(k, v, ksb, ksh, ksl, hd, int8 ? 1 : 4) &&
                  (!int8 || hd % 16 == 0);
  // chunk_keys(hd) is the same for both head_dim templates of a head_dim
#define FLASH_ARGS                                                          \
  chunks, qtiles, B * KV, (const float*)q, qsb, qsh, qsn, k, v, ksb, ksh,   \
      ksl, (const float*)k_scale, (const float*)v_scale, ssb, ssh, ssl,     \
      (const int*)table, mb, page, (const int*)kv_len, (const int*)qpos,    \
      (float*)o, (float*)m, (float*)l, (float*)work, (int*)counters, KV, H, \
      n, L, hd, rep, bq, causal, window, scale, vec, s
  cudaError_t err;
  if (int8) {
    err = hd <= 64    ? launch_hd<int8_t, kPaged, 64>(FLASH_ARGS)
          : hd <= 128 ? launch_hd<int8_t, kPaged, 128>(FLASH_ARGS)
                      : launch_hd<int8_t, kPaged, 256>(FLASH_ARGS);
  } else {
    err = hd <= 64    ? launch_hd<float, kPaged, 64>(FLASH_ARGS)
          : hd <= 128 ? launch_hd<float, kPaged, 128>(FLASH_ARGS)
                      : launch_hd<float, kPaged, 256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)err;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).  The
// caller allocates every buffer; k and v share one set of strides (in
// elements), and so do k_scale and v_scale.  A null k_scale means fp32
// K/V; otherwise K/V are int8 and both scales are given.  `bq` queries of
// all rep heads make a CTA's rows (bq * rep <= 64).  When L spans more than
// one chunk (chunk_keys), with T = B * KV * ceil(n / bq) tiles, c =
// ceil(L / chunk) chunks, g = ceil(c / group_chunks) groups and p =
// min(bq, n) * (H / KV) * (hd + 2) rounded up to a multiple of 4, `work`
// holds T * (c + g) * p floats and `counters` T * (g + 1) zeroed ints
// (left zero).
extern "C" int flash_attention_lse_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* kv_len, const void* qpos, void* o, void* m,
    void* l, void* work, void* counters, int B, int H, int KV, int n, int L,
    int hd, int bq, int causal, int window, float scale, void* stream) {
  return launch<false>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                       ssb, ssh, ssl, nullptr, 0, 0, kv_len, qpos, o, m, l,
                       work, counters, B, H, KV, n, L, hd, bq, causal, window,
                       scale, stream);
}

// The paged mode: k/v are pools [Nb, KV, page, hd] given by their block,
// head and row strides (ksb, ksh, ksl), the scales likewise (ssb, ssh,
// ssl), and `table` [B, mb] int32 is contiguous; L = mb * page logical
// keys.  Every table entry must be a block of the pool.
extern "C" int paged_flash_attention_lse_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* table, int mb, int page, const void* kv_len,
    const void* qpos, void* o, void* m, void* l, void* work, void* counters,
    int B, int H, int KV, int n, int hd, int bq, int causal, int window,
    float scale, void* stream) {
  return launch<true>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                      ssb, ssh, ssl, table, mb, page, kv_len, qpos, o, m, l,
                      work, counters, B, H, KV, n, mb * page, hd, bq, causal,
                      window, scale, stream);
}

// The grid (x, y, z into `grid`) that a dense (paged = 0) or paged launch
// of these sizes takes on the current device; returns a cudaError_t.
// Lets a caller report the CTAs a call launches.
extern "C" int flash_attention_lse_grid(int paged, int B, int H, int KV,
                                        int n, int L, int hd, int bq,
                                        int int8, int* grid) {
  return paged ? grid_of<true>(B, H, KV, n, L, hd, bq, int8, grid)
               : grid_of<false>(B, H, KV, n, L, hd, bq, int8, grid);
}
