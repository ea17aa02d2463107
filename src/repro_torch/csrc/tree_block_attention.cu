// tree_block_attention: masked attention of a tree layer's queries over
// the whole fp32 or int8 tree KV buffer, returning the normalised output and
// its log-sum-exp stats (m, l), or, given the committed-prefix half, the two
// halves merged.
//
// Replaces the JAX package's Pallas kernels repro/kernels/tree_block.py
// (tree_block_attention, body _tree_kernel) and, in its paged mode,
// repro/kernels/paged.py (paged_tree_block_attention, body
// _paged_tree_kernel).
//
//   q       [B, H, n, hd] fp32, any strides with head_dim contiguous
//   k, v    [B, KV, T, hd] fp32 or int8 views of the [B, T, KV, hd] tree
//           caches, any strides with head_dim contiguous
//   k_scale, v_scale  [B, KV, T] fp32 per-row scales of int8 K/V (views of
//           the [B, T, KV] scale caches), one set of strides; null for
//           fp32 K/V
//   mask    [B, n, T] uint8 (a torch.bool buffer), nonzero = may attend:
//           each row's ancestor-or-self mask against the tree buffer
//   past_o, past_m, past_l  null, or the committed-prefix half
//           [B, H, n, hd], [B, H, n], [B, H, n] fp32, contiguous (what
//           flash_attention_lse wrote): the merge epilogue
//   o [B, H, n, hd] fp32, contiguous; m, l [B, H, n] fp32, contiguous
//           (standalone mode only)
//
// Paged mode (paged_tree_block_attention_launch): the tree K/V (and the
// int8 scales) live in a block pool viewed as [Nb, KV, page, hd] (scales
// [Nb, KV, page]), read through `table` [B, mb] int32: tree row t of batch
// row b is row t % page of physical block table[b, t / page], mb * page >=
// T.  Only a key's address changes (PagedRows against DenseRows, in
// attn_common.cuh): the plan, the masks and the summation order are the
// dense kernel's, so the paged kernel over a pool gives the same bits as
// the dense kernel over the gathered view.  Rows at or past T, the tail of
// the last block included, are zero-filled and never read.
//
// What bounds it on an H100: at the main path's sizes (B = 1, T = 105 at 8
// stages, 64 query rows of 8 KV heads) the serial chain of one CTA, not
// the bytes (about 1.4 MB in fp32, under half a microsecond at 3.35 TB/s).
// The design shortens that chain:
//   * Rows of a CTA: one m16 row tile of the (query, head) rows of one KV
//     head, so a K/V slice staged in shared memory serves every query head
//     of the group, and 8 warps (16 rows and 8 warps measured fastest of
//     16 | 32 rows x 4 | 8 warps, PERF.md).
//   * One asynchronous wave: every cp.async of the (batch row, KV head)
//     slice's K and V (16 bytes; int8 rows and their 4-byte scales raw,
//     dequantized in shared memory once landed) is issued before the first
//     MMA, so the CTA pays one memory round trip.  T is bounded by the tree
//     capacity (105 rows at 8 stages); a T past one wave (wave_keys in
//     kernels/tree_block.py) loops the same code over stages of
//     `stage_keys` keys, double-buffered.
//   * Keys split across warps: the warps each take a contiguous share of
//     every stage's 16-key blocks, with their own running softmax; their
//     (acc, m, l) merge through shared memory in warp order at the end,
//     each warp finishing a slice of the output columns.  No cross-CTA
//     partials: T is short.
//   * Tensor cores: QK^T and PV are mma.sync m16n8k8 TF32 in the 3xTF32
//     form of flash_attention_lse.cu (masked big part, three products,
//     small ones first); P goes straight from the QK accumulators to the PV
//     fragments, and K/V rows are padded to head_dim + 4 floats.  exp2 with
//     log2 e; m is reported in natural-log units.
//   * Mask as bits: each stage's mask rows of the CTA's queries are read
//     once and packed with __ballot_sync into 32-key words in shared
//     memory, tested per score.
//   * Merge epilogue: with past_*, each row's tree result (o_t, m_t, l_t),
//     the standalone mode's bits, is merged with the committed-prefix half
//     by ops.combine_lse's arithmetic in its order (m = max, w = l *
//     expf(m_i - m), num = w_p o_p + w_t o_t, den = w_p + w_t, o = num /
//     max(den, 1e-30); no FMA contraction, IEEE division), so a tree-verify
//     layer is two launches (flash and this kernel).
// A row's bits depend on its own batch row, T and the plan alone: never on
// B or on which rows share its CTA (each MMA output row is its own sums).
// kernels/tree_block.py tree_plan states the plan in Python; the card tests
// hold the kernel to it (rows of a B = 3 call equal B = 1 calls, paged
// equals dense).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kRows = 16;          // (query, head) rows of a CTA
constexpr int kWarps = 8;          // warps of a CTA, a share of keys each
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 16;         // keys per softmax step of a warp

// Shared-memory layout of a CTA (offsets in floats), the same on the host,
// which sizes the launch, and on the card:
//   q       [kRows][HD + 4], pre-scaled
//   K, V    fp32 tiles [bufs][skp][HD + 4] each (int8 K/V: one tile each)
//   scales  [bufs][skp] of K, then of V (int8)
//   raw     [bufs][skp][HD] int8 K, then V (int8)
// and, over the tiles once the last stage is done, the warps' partials in
// the MMA accumulator layout: acc [kWarps][HD / 2][32 lanes], m, l
// [kWarps][16]; then the mask words [bufs][kRows][ceil(skp / 32)] (uint32).
template <int HD, bool kInt8>
struct Layout {
  static constexpr int S = HD + 4;
  static constexpr int R = kRows;
  int k, v, ksc, vsc, raw, part, pm, pl, mask;
  size_t bytes;
  __host__ __device__ Layout(int skp, int bufs) {
    const int fb = kInt8 ? 1 : bufs;
    k = R * S;
    v = k + fb * skp * S;
    ksc = v + fb * skp * S;
    vsc = ksc + (kInt8 ? bufs * skp : 0);
    raw = vsc + (kInt8 ? bufs * skp : 0);
    const int kv_end = raw + (kInt8 ? bufs * skp * HD / 2 : 0);
    part = k;
    pm = part + kWarps * R * HD;
    pl = pm + kWarps * R;
    mask = kv_end > pl + kWarps * R ? kv_end : pl + kWarps * R;
    bytes = 4 * ((size_t)mask + (size_t)bufs * R * ((skp + 31) / 32));
  }
};

template <class Elem, bool kPaged, int HD>
__global__ void __launch_bounds__(kThreads) tree_block_attention_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const int* __restrict__ table, int mb, int page,
    const unsigned char* __restrict__ mask, const float* __restrict__ past_o,
    const float* __restrict__ past_m, const float* __restrict__ past_l,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int n, int T, int hd, int rep, int sk,
    float scale, int vec) {
  constexpr bool kInt8 = sizeof(Elem) == 1;
  constexpr int S = HD + 4;
  constexpr int kDT = HD / 8;            // 8-column tiles of head_dim
  extern __shared__ __align__(16) float smem[];
  const int skp = (sk + kBlock - 1) / kBlock * kBlock;
  const int nstages = (T + sk - 1) / sk;
  const int bufs = nstages > 1 ? 2 : 1;
  const Layout<HD, kInt8> lay(skp, bufs);
  const int words = (skp + 31) / 32;
  const int tile = skp * S;              // floats of one fp32 tile
  float* qf = smem;
  float* kst = smem + lay.k;
  float* vst = smem + lay.v;
  float* kss = smem + lay.ksc;
  float* vss = smem + lay.vsc;
  int8_t* kraw = reinterpret_cast<int8_t*>(smem + lay.raw);
  int8_t* vraw = kraw + bufs * skp * HD;
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + lay.mask);

  constexpr int R = kRows;
  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * R;         // first (query, head) row
  const int rows = min(R, n * rep - r0);
  const int qlo = r0 / rep;
  const int nq = (r0 + rows - 1) / rep - qlo + 1;
  const int tid = threadIdx.x;
  // a runtime stride on purpose: with kThreads here the compiler unrolls
  // the copy loops, and that code, as fast alone, ran about 4 us a call
  // slower after the other kernels of a timestep (PERF.md)
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;             // share of each stage's keys
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

  // zero the padding columns [hd, HD) of the fp32 tiles once (loads never
  // write them); the K and V tiles are contiguous
  if (hd < HD) {
    const int nrow = 2 * (kInt8 ? 1 : bufs) * skp;
    for (int i = tid; i < nrow * (HD - hd); i += nthreads) {
      const int r = i / (HD - hd);
      kst[r * S + hd + (i - r * (HD - hd))] = 0.f;
    }
  }
  // q rows (r < rows) land with the first stage's copies and are scaled in
  // place once landed.  Row r is (query, head) row r0 + r: query
  // (r0 + r) / rep of head g * rep + (r0 + r) % rep.  Rows past `rows` are
  // never attended or stored, so they are left as they are.
  const bool qvec = hd % 4 == 0 && qsb % 4 == 0 && qsh % 4 == 0 &&
                    qsn % 4 == 0 && (uintptr_t)q % 16 == 0;
  {
    const int per = qvec ? hd / 4 : hd;
    for (int i = tid; i < rows * per; i += nthreads) {
      const int r = i / per;
      const int d = (i - r * per) * (qvec ? 4 : 1);
      const int rg = r0 + r;
      const float* src =
          q + b * qsb + (g * rep + rg % rep) * qsh + (rg / rep) * qsn + d;
      if (qvec) {
        cp_async16(qf + r * S + d, src, true);
      } else {
        qf[r * S + d] = *src;
      }
    }
    for (int i = tid; i < rows * (HD - hd); i += nthreads) {
      const int r = i / (HD - hd);
      qf[r * S + hd + (i - r * (HD - hd))] = 0.f;
    }
  }

  // Start stage st's copies into buffer st % bufs, and pack its mask
  // words: bit j of word w of local query ql says whether query qlo + ql
  // may attend key st * sk + 32 w + j (0 past T).  Full rows (head_dim ==
  // HD) take the copy loop with HD a constant, so its index arithmetic
  // divides by no runtime value.
  const unsigned char* mrow0 = mask + ((long long)b * n + qlo) * T;
  auto issue = [&](int st) {
    const int buf = st & (bufs - 1);
    const int t0 = st * sk;
    const int tend = min(T, t0 + sk);
    float* kd = kst + (kInt8 ? 0 : buf * tile);
    float* vd = vst + (kInt8 ? 0 : buf * tile);
    int8_t* krd = kraw + buf * skp * HD;
    int8_t* vrd = vraw + buf * skp * HD;
    if (hd == HD) {
      load_tile<HD>(k, v, k_scale, v_scale, keys, t0, tend, skp, nthreads,
                    HD, vec != 0, kd, vd, krd, vrd, kss + buf * skp,
                    vss + buf * skp);
    } else {
      load_tile<HD>(k, v, k_scale, v_scale, keys, t0, tend, skp, nthreads,
                    hd, vec != 0, kd, vd, krd, vrd, kss + buf * skp,
                    vss + buf * skp);
    }
    uint32_t* mw = mbits + buf * R * words;
    for (int p = warp; p < nq * words; p += kWarps) {
      const int ql = p / words;
      const int w = p - ql * words;
      const int t = t0 + 32 * w + lane;
      const bool bit = t < tend && mrow0[(long long)ql * T + t] != 0;
      const unsigned word = __ballot_sync(kFull, bit);
      if (lane == 0) mw[ql * words + w] = word;
    }
  };
  issue(0);
  cp_async_commit();

  // this thread's two rows: gq and gq + 8
  bool live[2];
  int qloc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gq + 8 * i;
    live[i] = r < rows;
    qloc[i] = live[i] ? (r0 + r) / rep - qlo : 0;
  }

  float mrow[2] = {kNegInf, kNegInf};
  float lrow[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  for (int st = 0; st < nstages; ++st) {
    const int buf = st & (bufs - 1);
    if (st + 1 < nstages) issue(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                     // this stage (and q) has landed
    if (st == 0) {
      // q * scale, the Pallas kernels' order
      for (int i = tid; i < rows * HD; i += nthreads) {
        const int r = i / HD;
        qf[r * S + (i - r * HD)] *= scale;
      }
      if constexpr (!kInt8) __syncthreads();
    }
    float* ks = kst + (kInt8 ? 0 : buf * tile);
    float* vs = vst + (kInt8 ? 0 : buf * tile);
    if constexpr (kInt8) {
      if (hd == HD) {
        dequant_tile4<HD>(kraw + buf * skp * HD, vraw + buf * skp * HD,
                          kss + buf * skp, vss + buf * skp, skp, nthreads,
                          ks, vs);
      } else {
        dequant_tile<HD>(kraw + buf * skp * HD, vraw + buf * skp * HD,
                         kss + buf * skp, vss + buf * skp, skp, nthreads, hd,
                         ks, vs);
      }
      __syncthreads();
    }
    // this warp's share: 16-key blocks [blo, bhi) of the stage's nblk
    const int tl = min(sk, T - st * sk);
    const int nblk = (tl + kBlock - 1) / kBlock;
    const int per = (nblk + kWarps - 1) / kWarps;
    const int blo = warp * per;
    const int bhi = min(nblk, blo + per);
    const uint32_t* mw = mbits + buf * R * words;
    for (int blk = blo; blk < bhi; ++blk) {
      const int kb = blk * kBlock;
      // S = q K^T over the block's two 8-key tiles; the three products
      // accumulate apart (6 independent MMA chains), then add, small ones
      // first
      float s[2][4], sx[2][4], sy[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = sx[j][c] = sy[j][c] = 0.f;
      const float* qr = qf + gq * S + tq;
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
          const float* kp = ks + (kb + 8 * j + gq) * S + 8 * kk + tq;
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
      // online softmax over the block; element (row i, key kb + 8 j +
      // 2 tq + e) is s[j][2 i + e], valid when its mask bit is set
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t bits =
            live[i] ? mw[qloc[i] * words + (kb >> 5)] >> (kb & 31) : 0u;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = (bits >> (8 * j + 2 * tq + e)) & 1u;
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
      // O += P V: k slots tq and tq + 4 of 8-key tile j are its keys 2 tq
      // and 2 tq + 1, and V's fragment reads the same keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ab[4], as[4];
        split_tf32(s[j][0], ab[0], as[0]);
        split_tf32(s[j][2], ab[1], as[1]);
        split_tf32(s[j][1], ab[2], as[2]);
        split_tf32(s[j][3], ab[3], as[3]);
        pv_update<kDT, S>(acc, ab, as, vs + (kb + 8 * j + 2 * tq) * S + gq);
      }
    }
    __syncthreads();                     // readers done before the refill
  }
  cp_async_wait<0>();

  // The warps' partials, over the tiles, in the MMA accumulator layout:
  // warp s keeps acc[dt][c] of lane x at pacc[(s * kDT * 4 + 4 dt + c) *
  // 32 + x], and m, l of its rows at pm, pl[s * 16 + row].
  float* pacc = smem + lay.part;
  float* pm = smem + lay.pm;
  float* pl = smem + lay.pl;
  {
    float* cb = pacc + warp * kDT * 4 * 32 + lane;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[(4 * dt + c) * 32] = acc[dt][c];
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pm[warp * 16 + gq + 8 * i] = mrow[i];
        pl[warp * 16 + gq + 8 * i] = lrow[i];
      }
    }
  }
  __syncthreads();
  // Each warp merges its slice of the 8-column tiles.  Per row, the
  // shares in warp order: M = max m_s, w_s = exp(m_s - M), l = sum_s l_s
  // w_s, o = sum_s acc_s w_s / max(l, 1e-30) (a share with no valid key
  // adds exactly nothing); every lane of the row computes the same M, w
  // and l.
  float mx[2], lsum[2], w[2][kWarps];
  long long orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* pmi = pm + gq + 8 * i;
    const float* pli = pl + gq + 8 * i;
    mx[i] = kNegInf;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) mx[i] = fmaxf(mx[i], pmi[16 * s]);
    lsum[i] = 0.f;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) {
      w[i][s] = exp2f((pmi[16 * s] - mx[i]) * kLog2e);
      lsum[i] += pli[16 * s] * w[i][s];
    }
    const int rg = r0 + gq + 8 * i;
    orow[i] = ((long long)b * H + g * rep + rg % rep) * n + rg / rep;
  }
  if (past_o == nullptr && warp == 0 && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      m_out[orow[i]] = mx[i];
      l_out[orow[i]] = lsum[i];
    }
  }
  // with the committed-prefix half: ops.combine_lse([past, tree]) in its
  // order, rounding each step
  float wp[2], wt[2], den[2];
  if (past_o != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const float mp = past_m[orow[i]];
      const float mall = fmaxf(mp, mx[i]);
      wp[i] = __fmul_rn(past_l[orow[i]], expf(__fsub_rn(mp, mall)));
      wt[i] = __fmul_rn(lsum[i], expf(__fsub_rn(mx[i], mall)));
      den[i] = fmaxf(__fadd_rn(__fadd_rn(0.f, wp[i]), wt[i]), kMinL);
    }
  }
  constexpr int dper = (kDT + kWarps - 1) / kWarps;
  const int dlo = warp * dper;
  const int dhi = min(kDT, dlo + dper);
  const float* src = pacc + lane;
  for (int dt = dlo; dt < dhi; ++dt) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kWarps; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[c] += src[(s * kDT * 4 + 4 * dt + c) * 32] * w[c >> 1][s];
      }
    }
    const int d = 8 * dt + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const float dn = fmaxf(lsum[i], kMinL);
      float x0 = a[2 * i] / dn;
      float x1 = a[2 * i + 1] / dn;
      if (past_o != nullptr && d < hd) {
        const float* op = past_o + orow[i] * hd + d;
        x0 = __fadd_rn(__fadd_rn(0.f, __fmul_rn(wp[i], op[0])),
                       __fmul_rn(wt[i], x0)) / den[i];
        if (d + 1 < hd) {
          x1 = __fadd_rn(__fadd_rn(0.f, __fmul_rn(wp[i], op[1])),
                         __fmul_rn(wt[i], x1)) / den[i];
        }
      }
      store2(o + orow[i] * hd + d, x0, x1, hd - d);
    }
  }
}

template <class Elem, bool kPaged, int HD>
cudaError_t launch_hd(dim3 grid, const float* q, long long qsb,
                      long long qsh, long long qsn, const void* k,
                      const void* v, long long ksb, long long ksh,
                      long long ksl, const float* ksc, const float* vsc,
                      long long ssb, long long ssh, long long ssl,
                      const int* table, int mb, int page,
                      const unsigned char* mask, const float* past_o,
                      const float* past_m, const float* past_l, float* o,
                      float* m, float* l, int H, int n, int T, int hd,
                      int rep, int sk, float scale, int vec, cudaStream_t s) {
  const int skp = (sk + kBlock - 1) / kBlock * kBlock;
  const int bufs = T > sk ? 2 : 1;
  const size_t smem =
      Layout<HD, sizeof(Elem) == 1>(skp, bufs).bytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem<tree_block_attention_kernel<Elem, kPaged, HD>>(smem);
  if (err != cudaSuccess) return err;
  tree_block_attention_kernel<Elem, kPaged, HD><<<grid, kThreads, smem, s>>>(
      q, qsb, qsh, qsn, (const Elem*)k, (const Elem*)v, ksb, ksh, ksl, ksc,
      vsc, ssb, ssh, ssl, table, mb, page, mask, past_o, past_m, past_l, o, m,
      l, H, n, T, hd, rep, sk, scale, vec);
  return cudaGetLastError();
}

template <bool kPaged>
int launch(const void* q, long long qsb, long long qsh, long long qsn,
           const void* k, const void* v, long long ksb, long long ksh,
           long long ksl, const void* k_scale, const void* v_scale,
           long long ssb, long long ssh, long long ssl, const void* table,
           int mb, int page, const void* mask, const void* past_o,
           const void* past_m, const void* past_l, void* o, void* m, void* l,
           int B, int H, int KV, int n, int T, int hd, int sk, float scale,
           void* stream) {
  const bool merged = past_o != nullptr;
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || T < 1 || hd < 1 ||
      hd > 256 || B > 65535 || KV > 65535 || sk < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (past_m == nullptr) != !merged || (past_l == nullptr) != !merged ||
      (!merged && (m == nullptr || l == nullptr)) ||
      (kPaged && (table == nullptr || mb < 1 || page < 1 || T > mb * page))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rep = H / KV;
  const long long tiles = ((long long)n * rep + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, KV, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool int8 = k_scale != nullptr;
  const int vec = (int)can_vec(k, v, ksb, ksh, ksl, hd, int8 ? 1 : 4) &&
                  (!int8 || hd % 16 == 0);
#define TREE_ARGS                                                           \
  grid, (const float*)q, qsb, qsh, qsn, k, v, ksb, ksh, ksl,       \
      (const float*)k_scale, (const float*)v_scale, ssb, ssh, ssl,          \
      (const int*)table, mb, page, (const unsigned char*)mask,              \
      (const float*)past_o, (const float*)past_m, (const float*)past_l,     \
      (float*)o, (float*)m, (float*)l, H, n, T, hd, rep, sk, scale, vec, s
  cudaError_t err;
  if (int8) {
    err = hd <= 64    ? launch_hd<int8_t, kPaged, 64>(TREE_ARGS)
          : hd <= 128 ? launch_hd<int8_t, kPaged, 128>(TREE_ARGS)
                      : launch_hd<int8_t, kPaged, 256>(TREE_ARGS);
  } else {
    err = hd <= 64    ? launch_hd<float, kPaged, 64>(TREE_ARGS)
          : hd <= 128 ? launch_hd<float, kPaged, 128>(TREE_ARGS)
                      : launch_hd<float, kPaged, 256>(TREE_ARGS);
  }
#undef TREE_ARGS
  return (int)err;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).  The
// caller allocates every buffer; k and v share one set of strides (in
// elements), and so do k_scale and v_scale.  A null k_scale means fp32
// K/V; otherwise K/V are int8 and both scales are given.  The plan: 16
// (query, head) rows and 8 warps a CTA, stages of `sk` keys (sk >= T: one
// wave; kernels/tree_block.py stage_keys).  With past_o, past_m and past_l the
// kernel writes the merged output to o and leaves m and l (may be null)
// alone.
extern "C" int tree_block_attention_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* mask, const void* past_o, const void* past_m,
    const void* past_l, void* o, void* m, void* l, int B, int H, int KV,
    int n, int T, int hd, int sk, float scale, void* stream) {
  return launch<false>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                       ssb, ssh, ssl, nullptr, 0, 0, mask, past_o, past_m,
                       past_l, o, m, l, B, H, KV, n, T, hd, sk, scale, stream);
}

// The paged mode: k/v are pools [Nb, KV, page, hd] given by their block,
// head and row strides (ksb, ksh, ksl), the scales likewise (ssb, ssh,
// ssl), and `table` [B, mb] int32 is contiguous, with mb * page >= T.
// Every table entry must be a block of the pool.
extern "C" int paged_tree_block_attention_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* table, int mb, int page, const void* mask,
    const void* past_o, const void* past_m, const void* past_l, void* o,
    void* m, void* l, int B, int H, int KV, int n, int T, int hd, int sk,
    float scale, void* stream) {
  return launch<true>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                      ssb, ssh, ssl, table, mb, page, mask, past_o, past_m,
                      past_l, o, m, l, B, H, KV, n, T, hd, sk, scale, stream);
}
