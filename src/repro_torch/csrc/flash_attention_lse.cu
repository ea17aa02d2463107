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
//         fp32 K/V.  An int8 row is dequantized, float(q) * scale, as it
//         is staged (the Pallas kernel's int8 mode)
//   kv_len [B] int32 valid prefix per batch row
//   qpos  [B, n] int32 absolute query positions, or null (needed for
//         causal and window masks)
//   o [B, H, n, hd], m [B, H, n], l [B, H, n] fp32, contiguous
//
// Key kpos is valid for a query at qpos when kpos < kv_len[b], and, if
// causal, kpos <= qpos, and, if window > 0, kpos > qpos - window.
//
// Grid: (query tiles, KV heads, B); a CTA takes `bq` queries of all `rep`
// query heads of one KV head, so each K/V tile is read once per group and
// query tile.  Keys past the CTA's last valid key (kv_len, or the causal
// bound of its last query) are never read.
//
// Paged mode (paged_flash_attention_lse_launch): K/V (and the int8
// scales) live in a block pool read through a per-row block table:
//   k, v  pools viewed as [Nb, KV, page, hd], any strides with head_dim
//         contiguous (the port passes its flat [Nb*page, KV, hd] pools as
//         such views, with no copy); k_scale, v_scale [Nb, KV, page]
//   table [B, mb] int32: logical key t of row b is row t % page of
//         physical block table[b, t / page]; L = mb * page
// The tile loop, the tile size (kBK keys), the masks and the summation
// order are the dense kernel's; only the address of a key changes.  Each
// tile's physical blocks are read from the table once, into shared
// memory, before its loads.  So the paged kernel over a pool gives the
// same bits as the dense kernel over the gathered view.  Masking stays
// logical: a key is attended only by its logical position (kv_len,
// causal, window); unallocated logical blocks alias physical block 0 (the
// null block) and lie at or past kv_len, so they are never read.
//
// What bounds it on an H100: bytes.  At the main path's shapes (B = 1, a
// few hundred cached keys, 8 KV heads of 128) a launch moves about 2 MB in
// fp32 (a quarter of the K/V bytes in int8, plus 4 bytes of scale per row
// and KV head), which the card's 3.35 TB/s moves in under a microsecond,
// so launch latency and the few CTAs in flight dominate.  The design keeps every
// K/V byte read once per group from device memory and reads the cache in
// place (no transposed copy); it does not yet split long caches across
// CTAs (flash-decoding) or use the tensor cores.
#include <cuda_runtime.h>

#include "attn_common.cuh"

using namespace attn;

namespace {

// kPaged: k/v (and the scales) are pools read through `table` [B, mb],
// and ksb/ssb are their block strides; otherwise ksb/ssb are batch
// strides and `table` is unused.
template <class Elem, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_attention_lse_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const int* __restrict__ table, int mb, int page,
    const int* __restrict__ kv_len, const int* __restrict__ qpos,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int n, int L, int hd, int rep, int bq,
    int causal, int window, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int blk[kBK];
  const int nwarps = blockDim.x >> 5;
  const int rows_cap = nwarps * kRowsPerWarp;
  float* qs = smem;
  float* ks = qs + rows_cap * hd;
  float* vs = ks + kBK * (hd + 1);

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, n - q0);
  const int rows = nq * rep;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kRowsPerWarp;

  stage_q(q, qsb, qsh, qsn, b, g, q0, rows, rows_cap, rep, hd, scale, qs);

  const int* qp = qpos ? qpos + (long long)b * n : nullptr;
  const int kvl = kv_len[b];
  int end = min(L, kvl);
  if (causal && qp) {
    int last = -1;
    for (int i = 0; i < nq; ++i) last = max(last, qp[q0 + i]);
    end = min(end, last + 1);
  }
  int qpos_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    qpos_r[r] = (qp && row < rows) ? qp[q0 + row / rep] : 0;
  }
  __syncthreads();

  const long long kbase = (kPaged ? 0 : b * ksb) + g * ksh;
  const long long sbase = (kPaged ? 0 : b * ssb) + g * ssh;
  const Elem* kb = k + kbase;
  const Elem* vb = v + kbase;
  const float* ksc = k_scale ? k_scale + sbase : nullptr;
  const float* vsc = v_scale ? v_scale + sbase : nullptr;
  const int* trow = kPaged ? table + (long long)b * mb : nullptr;
  Rows st;
  st.init();
  for (int t0 = 0; t0 < end; t0 += kBK) {
    const int tl = min(kBK, end - t0);
    if constexpr (kPaged) {
      stage_blocks(trow, page, t0, tl, blk);
      __syncthreads();
      load_tile(kb, vb, ksc, vsc, PagedKeys{blk, t0, page, ksb, ksl, ssb, ssl},
                tl, hd, vec != 0, ks, vs);
    } else {
      load_tile(kb, vb, ksc, vsc, DenseKeys{t0, ksl, ssl}, tl, hd, vec != 0,
                ks, vs);
    }
    __syncthreads();
    update(st, qs + row0 * hd, ks, vs, hd, tl, [&](int r, int j) {
      const int kp = t0 + j;
      bool ok = kp < kvl;
      if (causal) ok = ok && kp <= qpos_r[r];
      if (window > 0) ok = ok && kp > qpos_r[r] - window;
      return ok;
    });
    __syncthreads();
  }
  store_rows(st, row0, rows, b, g, q0, rep, H, n, hd, o, m_out, l_out);
}

template <bool kPaged>
int launch(const void* q, long long qsb, long long qsh, long long qsn,
           const void* k, const void* v, long long ksb, long long ksh,
           long long ksl, const void* k_scale, const void* v_scale,
           long long ssb, long long ssh, long long ssl, const void* table,
           int mb, int page, const void* kv_len, const void* qpos, void* o,
           void* m, void* l, int B, int H, int KV, int n, int L, int hd,
           int bq, int causal, int window, float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || bq < 1 || hd < 1 ||
      hd > kMaxHeadDim || B > 65535 || KV > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (kPaged && (table == nullptr || mb < 1 || page < 1 || L > mb * page))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rep = H / KV;
  const int rows_cap = bq * rep;
  if (rows_cap > kMaxRows) return (int)cudaErrorInvalidValue;
  const int nwarps = (rows_cap + kRowsPerWarp - 1) / kRowsPerWarp;
  const size_t smem = smem_bytes(nwarps, hd);
  dim3 grid((n + bq - 1) / bq, KV, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k_scale == nullptr) {
    cudaError_t err =
        allow_smem<flash_attention_lse_kernel<float, kPaged>>(smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_lse_kernel<float, kPaged><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const float*)k, (const float*)v, ksb,
        ksh, ksl, nullptr, nullptr, 0, 0, 0, (const int*)table, mb, page,
        (const int*)kv_len, (const int*)qpos, (float*)o, (float*)m, (float*)l,
        H, n, L, hd, rep, bq, causal, window, scale,
        (int)can_vec(k, v, ksb, ksh, ksl, hd, 4));
  } else {
    cudaError_t err =
        allow_smem<flash_attention_lse_kernel<int8_t, kPaged>>(smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_lse_kernel<int8_t, kPaged><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const int8_t*)k, (const int8_t*)v,
        ksb, ksh, ksl, (const float*)k_scale, (const float*)v_scale, ssb, ssh,
        ssl, (const int*)table, mb, page, (const int*)kv_len,
        (const int*)qpos, (float*)o, (float*)m, (float*)l, H, n, L, hd, rep,
        bq, causal, window, scale, (int)can_vec(k, v, ksb, ksh, ksl, hd, 1));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).  The
// caller allocates every buffer; k and v share one set of strides (in
// elements), and so do k_scale and v_scale.  A null k_scale means fp32
// K/V; otherwise K/V are int8 and both scales are given.
extern "C" int flash_attention_lse_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* kv_len, const void* qpos, void* o, void* m,
    void* l, int B, int H, int KV, int n, int L, int hd, int bq, int causal,
    int window, float scale, void* stream) {
  return launch<false>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                       ssb, ssh, ssl, nullptr, 0, 0, kv_len, qpos, o, m, l, B,
                       H, KV, n, L, hd, bq, causal, window, scale, stream);
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
    const void* qpos, void* o, void* m, void* l, int B, int H, int KV, int n,
    int hd, int bq, int causal, int window, float scale, void* stream) {
  return launch<true>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                      ssb, ssh, ssl, table, mb, page, kv_len, qpos, o, m, l, B,
                      H, KV, n, mb * page, hd, bq, causal, window, scale,
                      stream);
}
