// tree_block_attention: masked attention of a tree layer's queries over
// the whole fp32 or int8 tree KV buffer, returning the normalised output and its
// log-sum-exp stats (m, l) for merging with the committed-prefix half.
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
//           fp32 K/V.  An int8 row is dequantized as it is staged
//   mask    [B, n, T] uint8 (a torch.bool buffer), nonzero = may attend:
//           each row's ancestor-or-self mask against the tree buffer
//   o [B, H, n, hd], m [B, H, n], l [B, H, n] fp32, contiguous
//
// Grid: (query tiles, KV heads, B), the same CTA shape as
// flash_attention_lse: a CTA takes `bq` queries of all `rep` heads of one
// KV head (at most 16 rows, 4 warps), so each tree K/V tile is read once
// per group and query tile.  The Pallas kernel holds the whole buffer in
// one VMEM tile; here the buffer streams through shared memory 32 keys at
// a time with the same running softmax, so T is not bounded by shared
// memory (T = 105 at 8 stages would need 107 KB to hold K and V whole).
// One CTA per (batch row, KV head) with all n * rep rows would need up to
// 1024 threads, which caps a thread at 64 registers; query tiles keep the
// CTA at 128 threads and give the card 4x more CTAs at the main path's
// shapes (n = 8, rep = 8).
//
// Paged mode (paged_tree_block_attention_launch): the tree K/V (and the
// int8 scales) live in a block pool, viewed as [Nb, KV, page, hd] (scales
// [Nb, KV, page]), read through `table` [B, mb] int32: tree row t of
// batch row b is row t % page of physical block table[b, t / page], with
// mb * page >= T.  The Pallas kernel takes one grid step per logical
// block; here the loop over 32-key tiles, the masks and the summation
// order stay the dense kernel's, and only a key's address changes (each
// tile's physical blocks are read from the table once, into shared
// memory, before its loads).  So the paged kernel over a pool gives the
// same bits as the dense kernel over the gathered view.  The mask is
// indexed by logical row, and rows at and past T (the tail of the last
// block) are neither read nor attended.
//
// What bounds it on an H100: bytes, and at these sizes launch latency.  A
// target launch at B = 1 moves about 1.4 MB in fp32 (the tree K/V of 105
// rows and 8 KV heads, q, the mask, o; int8 K/V a quarter of their fp32
// bytes plus 4 bytes of scale per row and KV head), under half a
// microsecond at 3.35 TB/s; with 32 CTAs in flight the kernel runs far
// from that bound.
#include <cuda_runtime.h>

#include "attn_common.cuh"

using namespace attn;

namespace {

// kPaged: k/v (and the scales) are pools read through `table` [B, mb],
// and ksb/ssb are their block strides; otherwise ksb/ssb are batch
// strides and `table` is unused.
template <class Elem, bool kPaged>
__global__ void __launch_bounds__(kThreads) tree_block_attention_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const int* __restrict__ table, int mb, int page,
    const unsigned char* __restrict__ mask, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int n, int T,
    int hd, int rep, int bq, float scale, int vec) {
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
  const int rows = min(bq, n - q0) * rep;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * kRowsPerWarp;

  stage_q(q, qsb, qsh, qsn, b, g, q0, rows, rows_cap, rep, hd, scale, qs);

  // this warp's rows' mask rows (null for idle rows: never valid)
  const unsigned char* mrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    mrow[r] = row < rows ? mask + ((long long)b * n + q0 + row / rep) * T
                          : nullptr;
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
  for (int t0 = 0; t0 < T; t0 += kBK) {
    const int tl = min(kBK, T - t0);
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
      return mrow[r] != nullptr && mrow[r][t0 + j] != 0;
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
           int mb, int page, const void* mask, void* o, void* m, void* l,
           int B, int H, int KV, int n, int T, int hd, int bq, float scale,
           void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || T < 1 || bq < 1 ||
      hd < 1 || hd > kMaxHeadDim || B > 65535 || KV > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (kPaged && (table == nullptr || mb < 1 || page < 1 || T > mb * page))) {
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
        allow_smem<tree_block_attention_kernel<float, kPaged>>(smem);
    if (err != cudaSuccess) return (int)err;
    tree_block_attention_kernel<float, kPaged><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const float*)k, (const float*)v, ksb,
        ksh, ksl, nullptr, nullptr, 0, 0, 0, (const int*)table, mb, page,
        (const unsigned char*)mask, (float*)o, (float*)m, (float*)l, H, n, T,
        hd, rep, bq, scale, (int)can_vec(k, v, ksb, ksh, ksl, hd, 4));
  } else {
    cudaError_t err =
        allow_smem<tree_block_attention_kernel<int8_t, kPaged>>(smem);
    if (err != cudaSuccess) return (int)err;
    tree_block_attention_kernel<int8_t, kPaged><<<grid, nwarps * 32, smem,
                                                  s>>>(
        (const float*)q, qsb, qsh, qsn, (const int8_t*)k, (const int8_t*)v,
        ksb, ksh, ksl, (const float*)k_scale, (const float*)v_scale, ssb, ssh,
        ssl, (const int*)table, mb, page, (const unsigned char*)mask,
        (float*)o, (float*)m, (float*)l, H, n, T, hd, rep, bq, scale,
        (int)can_vec(k, v, ksb, ksh, ksl, hd, 1));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).  The
// caller allocates every buffer; k and v share one set of strides (in
// elements), and so do k_scale and v_scale.  A null k_scale means fp32
// K/V; otherwise K/V are int8 and both scales are given.
extern "C" int tree_block_attention_launch(
    const void* q, long long qsb, long long qsh, long long qsn, const void* k,
    const void* v, long long ksb, long long ksh, long long ksl,
    const void* k_scale, const void* v_scale, long long ssb, long long ssh,
    long long ssl, const void* mask, void* o, void* m, void* l, int B, int H,
    int KV, int n, int T, int hd, int bq, float scale, void* stream) {
  return launch<false>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                       ssb, ssh, ssl, nullptr, 0, 0, mask, o, m, l, B, H, KV,
                       n, T, hd, bq, scale, stream);
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
    void* o, void* m, void* l, int B, int H, int KV, int n, int T, int hd,
    int bq, float scale, void* stream) {
  return launch<true>(q, qsb, qsh, qsn, k, v, ksb, ksh, ksl, k_scale, v_scale,
                      ssb, ssh, ssl, table, mb, page, mask, o, m, l, B, H, KV,
                      n, T, hd, bq, scale, stream);
}
