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
//   work, counters  the wrapper's scratch: chunk partials and one int per
//         (batch row, KV head, query tile), zero between calls
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
// What bounds it on an H100: bytes, and at the main path's sizes (B = 1,
// a few hundred cached keys, 8 KV heads of 128) launch latency and the
// serial chain of one CTA: a launch moves about 2 MB in fp32, under a
// microsecond at 3.35 TB/s.  The design shortens that chain:
//   * Rows of a CTA: all `rep` query heads of one KV head times up to
//     64 / rep queries (64 rows, four m16 row tiles, at the main case), so
//     a K/V tile is read once per GQA group and query tile.  Two warps
//     share a row tile, each taking half of every key tile with its own
//     running softmax; the halves merge, in order, when the chunk ends.
//     A single warp's chain of dependent MMAs and fragment splits, not
//     the bytes, is what a CTA waits on at these sizes.
//   * Split keys (flash-decoding): a CTA takes one chunk of chunk_keys()
//     logical key positions (64 for head_dim > 64, else 128: a function of
//     head_dim alone, the same for fp32, int8, dense and paged).  CTAs
//     whose chunk lies wholly past the tile's bound (kv_len, causal) or
//     before its window exit at once.  A row's result depends only on its
//     own batch row's keys and bounds: never on B or on other rows'
//     kv_len.
//   * Asynchronous copies: 32-key K/V tiles are double-buffered with
//     cp.async (16 bytes; the int8 rows and their scales raw, then
//     dequantized into the fp32 tile), so the next tile's copy (and, in
//     the paged mode, its block-table reads) runs during this tile's
//     arithmetic.
//   * Tensor cores: QK^T and PV are mma.sync m16n8k8 TF32 in the 3xTF32
//     form (big and small parts of both operands, three products, small
//     ones first), which keeps fp32-level accuracy.  q is pre-scaled once
//     in shared memory; q, K, V and P are split as fragments are read.  PV takes P straight from the QK accumulators: the k slots t
//     and t + 4 of a thread are its keys 2t and 2t + 1, and V's fragment
//     reads the same keys.  Rows of K and V are padded to head_dim + 4
//     floats, so the fragment reads hit 32 banks.
//   * One launch per call: a CTA whose tile has more than one chunk
//     writes its unnormalised (acc, m, l); the last CTA of the (batch
//     row, KV head, query tile) to finish (a counter bumped after a
//     __threadfence, reset by that CTA) merges the chunks in chunk order,
//     each thread keeping several chunks' loads in flight.  A tile with
//     one chunk writes (o, m, l) itself.
// A tile or chunk with no valid key for a row adds exactly nothing to
// that row (p = 0, alpha = 1), so skipped chunks change no bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;           // 8 warps: a row tile and key half each
constexpr int kMaxRows = 64;            // (query, head) rows per CTA
constexpr int kTile = 32;               // keys per shared-memory tile

__host__ __device__ constexpr int chunk_keys(int hd) {
  return hd > 64 ? 64 : 128;
}

// Shared-memory layout of a CTA: q, pre-scaled, [64][HD + 4]; the K and V
// fp32 tiles [32][HD + 4], two of each for fp32 K/V, one for int8, whose
// raw K and V tiles [32][HD] and scales [32] are the two buffers instead
// (they are dequantized into the fp32 tiles once landed).  At head_dim
// 128 a CTA takes 99 KB (fp32) or 83 KB (int8): two CTAs an SM; at 256
// (Gemma) 195 KB or 163 KB: one.  After the last tile, everything past q
// holds the key halves' hand-over (kHandover floats) and the chunk merge.
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
  // one warp's (acc, m, l) per m16 row tile, 32 lanes each
  static constexpr int kHandover = (kMaxRows / 16) * (HD / 2 + 4) * 32;
  static_assert((size_t)4 * (kQ + kHandover) <= kBytes,
                "the key halves' hand-over must fit past q");
  static_assert(kBytes <= 227 * 1024, "over the opt-in shared memory");
};

template <class Elem, bool kPaged, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_lse_kernel(
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
  extern __shared__ __align__(16) float smem[];
  float* qf = smem;                      // [64][S]
  float* kst = qf + SM::kQ;              // [kBufs][32][S]
  float* vst = kst + SM::kBufs * SM::kKV;
  float* kss = vst + SM::kBufs * SM::kKV;  // [2][32]
  float* vss = kss + 2 * SM::kSc;
  int8_t* kraw = reinterpret_cast<int8_t*>(vss + 2 * SM::kSc);  // [2][32][HD]
  int8_t* vraw = kraw + 2 * SM::kRaw;
  __shared__ int last;

  const int C = chunk_keys(HD);
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
  const int slot = blockIdx.x;
  if (slot >= nchunks) return;           // past the tile's bound
  const int cs = (c_lo + slot) * C;
  const int ce = min(cs + C, end);       // keys past ce are never read
  const int ntiles = ce > cs ? (ce - cs + kTile - 1) / kTile : 0;

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

  // zero the padding columns [hd, HD) of the fp32 tiles once (loads
  // never write them)
  if (hd < HD) {
    for (int i = tid; i < 2 * SM::kBufs * kTile * (HD - hd); i += kThreads) {
      const int r = i / (HD - hd);
      const int d = hd + (i - r * (HD - hd));
      kst[r * S + d] = 0.f;   // the tiles are contiguous
    }
  }
  // q rows (r < rows) land as fp32 in the first tile's copy group and are
  // scaled in place once landed.  Row r is query q0 + r / rep of head
  // g * rep + r % rep.  Rows past `rows` are never attended or stored, so
  // they are left as they are.
  const bool qvec = hd % 4 == 0 && qsb % 4 == 0 && qsh % 4 == 0 &&
                    qsn % 4 == 0 && (uintptr_t)q % 16 == 0;
  if (ntiles > 0) {
    const int per = qvec ? hd / 4 : hd;
    for (int i = tid; i < rows * per; i += kThreads) {
      const int r = i / per;
      const int d = (i - r * per) * (qvec ? 4 : 1);
      const float* src =
          q + b * qsb + (g * rep + r % rep) * qsh + (q0 + r / rep) * qsn + d;
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
    load_tile<HD>(k, v, k_scale, v_scale, keys, cs, ce, kTile, kThreads, hd,
                  vec != 0, kst, vst, kraw, vraw, kss, vss);
  }
  cp_async_commit();

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

  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int t0 = cs + it * kTile;
    if (it + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_tile<HD>(k, v, k_scale, v_scale, keys, t0 + kTile, ce, kTile,
                    kThreads, hd, vec != 0, kst + (kInt8 ? 0 : nb * SM::kKV),
                    vst + (kInt8 ? 0 : nb * SM::kKV),
                    kraw + nb * SM::kRaw, vraw + nb * SM::kRaw,
                    kss + nb * SM::kSc, vss + nb * SM::kSc);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                     // this tile (and q) has landed
    if (it == 0) {
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
    __syncthreads();                     // readers done before the refill
  }
  cp_async_wait<0>();

  // the two key halves of each row tile, in order: warp kh = 1 hands its
  // (acc, m, l) to warp kh = 0 through shared memory (the tiles are free
  // now), which merges them as the chunks are merged
  {
    float* cb = kst + mt * (kDT * 4 + 4) * 32 + lane;
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
    if (kh == 0 && active) {
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
  const bool owner = kh == 0 && active;  // holds its row tile's result

  // element (row i, column 8 dt + 2 tq + e) is acc[dt][2 i + e]
  const long long grp = (long long)bg * gridDim.y + qt;
  if (nchunks == 1) {
    if (!owner) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const int r = 16 * mt + gq + 8 * i;
      const int h = g * rep + r % rep;
      const long long orow = ((long long)b * H + h) * n + q0 + r / rep;
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
    return;
  }
  // chunk partials: slot s of group grp holds acc [64][hd], then m, l [64]
  const long long pstride = (long long)kMaxRows * (hd + 2);
  float* part = work + (grp * gridDim.x + slot) * pstride;
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
        part[kMaxRows * hd + r] = mrow[i];
        part[kMaxRows * hd + kMaxRows + r] = lrow[i];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + grp, 1) == nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA: per row the max M and l = sum_c l_c exp(m_c - M), then
  // o = sum_c acc_c exp(m_c - M) / max(l, 1e-30), chunks in order.  The
  // chunks' m and l, and the weights exp(m_c - M), go to shared memory
  // (the tiles are free now) when they fit; each thread starts a batch of
  // chunks' loads before it adds them in order, so the L2 latency is paid
  // once a batch.
  const float* base = work + grp * gridDim.x * pstride;
  float* lsum = qf;                                   // l, then M [64]
  const int nrc = rows * nchunks;
  float* mc = kst;                                    // [rows][nchunks]
  float* lc = mc + nrc;
  float* wts = lc + nrc;
  constexpr int kBatch = 4;
  if (3 * nrc <= 2 * SM::kBufs * SM::kKV) {
    for (int i = tid; i < nrc; i += kThreads) {
      const int r = i / nchunks;
      const float* pc = base + (i - r * nchunks) * pstride + kMaxRows * hd;
      mc[i] = __ldcg(pc + r);
      lc[i] = __ldcg(pc + kMaxRows + r);
    }
    __syncthreads();
    if (tid < rows) {
      float mx = kNegInf;
      for (int c = 0; c < nchunks; ++c) mx = fmaxf(mx, mc[tid * nchunks + c]);
      float l = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        const float w = exp2f((mc[tid * nchunks + c] - mx) * kLog2e);
        wts[tid * nchunks + c] = w;
        l += lc[tid * nchunks + c] * w;
      }
      lsum[tid] = l;
      lsum[kMaxRows + tid] = mx;
    }
  } else {
    // a cache too long for shared memory: the same sums from L2
    if (tid < rows) {
      float mx = kNegInf;
      for (int c = 0; c < nchunks; ++c) {
        mx = fmaxf(mx, __ldcg(base + c * pstride + kMaxRows * hd + tid));
      }
      float l = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        const float* pc = base + c * pstride + kMaxRows * hd;
        l += __ldcg(pc + kMaxRows + tid) *
             exp2f((__ldcg(pc + tid) - mx) * kLog2e);
      }
      lsum[tid] = l;
      lsum[kMaxRows + tid] = mx;
    }
    wts = nullptr;
  }
  __syncthreads();
  if (tid < rows) {
    const int h = g * rep + tid % rep;
    const long long orow = ((long long)b * H + h) * n + q0 + tid / rep;
    m_out[orow] = lsum[kMaxRows + tid];
    l_out[orow] = lsum[tid];
  }
  // pass 2: kU (row, 4 columns) items a thread, kBatch chunks at a time
  constexpr int kU = 4;
  const int w4 = hd % 4 == 0 ? 4 : 1;
  const int per = hd / w4;
  const int items = rows * per;
  for (int i0 = tid; i0 < items; i0 += kThreads * kU) {
    float a[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[u][e] = 0.f;
    for (int c0 = 0; c0 < nchunks; c0 += kBatch) {
      float4 v[kU][kBatch];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        const int r = i / per;
        const int d = (i - r * per) * w4;
#pragma unroll
        for (int bb = 0; bb < kBatch; ++bb) {
          if (i < items && c0 + bb < nchunks) {
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
        for (int bb = 0; bb < kBatch; ++bb) {
          const int c = c0 + bb;
          if (i < items && c < nchunks) {
            const float w =
                wts ? wts[r * nchunks + c]
                    : exp2f((__ldcg(base + c * pstride + kMaxRows * hd + r) -
                             lsum[kMaxRows + r]) * kLog2e);
            a[u][0] += v[u][bb].x * w;
            a[u][1] += v[u][bb].y * w;
            a[u][2] += v[u][bb].z * w;
            a[u][3] += v[u][bb].w * w;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= items) continue;
      const int r = i / per;
      const int d = (i - r * per) * w4;
      const int h = g * rep + r % rep;
      const long long orow = ((long long)b * H + h) * n + q0 + r / rep;
      const float den = fmaxf(lsum[r], kMinL);
      float* op = o + orow * hd + d;
      if (w4 == 4) {
        *reinterpret_cast<float4*>(op) = make_float4(
            a[u][0] / den, a[u][1] / den, a[u][2] / den, a[u][3] / den);
      } else {
        op[0] = a[u][0] / den;
      }
    }
  }
  if (tid == 0) counters[grp] = 0;       // ready for the next call
}

template <class Elem, bool kPaged, int HD>
cudaError_t launch_hd(dim3 grid, const float* q, long long qsb,
                      long long qsh, long long qsn, const void* k,
                      const void* v, long long ksb, long long ksh,
                      long long ksl, const float* ksc, const float* vsc,
                      long long ssb, long long ssh, long long ssl,
                      const int* table, int mb, int page, const int* kv_len,
                      const int* qpos, float* o, float* m, float* l,
                      float* work, int* counters, int KV, int H, int n,
                      int L, int hd, int rep, int bq, int causal, int window,
                      float scale, int vec, cudaStream_t s) {
  constexpr size_t smem = Smem<HD, sizeof(Elem) == 1>::kBytes;
  cudaError_t err =
      allow_smem<flash_attention_lse_kernel<Elem, kPaged, HD>>(smem);
  if (err != cudaSuccess) return err;
  flash_attention_lse_kernel<Elem, kPaged, HD><<<grid, kThreads, smem, s>>>(
      q, qsb, qsh, qsn, (const Elem*)k, (const Elem*)v, ksb, ksh, ksl, ksc,
      vsc, ssb, ssh, ssl, table, mb, page, kv_len, qpos, o, m, l, work,
      counters, KV, H, n, L, hd, rep, bq, causal, window, scale, vec);
  return cudaGetLastError();
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
  const int chunks = max(1, (L + chunk_keys(hd) - 1) / chunk_keys(hd));
  if (qtiles > 65535 ||
      (chunks > 1 && (work == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(chunks, qtiles, B * KV);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int8 = k_scale != nullptr;
  const int vec = (int)can_vec(k, v, ksb, ksh, ksl, hd, int8 ? 1 : 4) &&
                  (!int8 || hd % 16 == 0);
  // chunk_keys(hd) is the same for both head_dim templates of a head_dim
#define FLASH_ARGS                                                          \
  grid, (const float*)q, qsb, qsh, qsn, k, v, ksb, ksh, ksl,                \
      (const float*)k_scale, (const float*)v_scale, ssb, ssh, ssl,          \
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
// one chunk (chunk_keys), `work` holds B * KV * ceil(n / bq) *
// ceil(L / chunk) * 64 * (hd + 2) floats and `counters` B * KV *
// ceil(n / bq) zeroed ints (left zero).
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
