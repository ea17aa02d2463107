// tree_block_attention: masked attention of a tree layer's queries over
// the whole fp32 or int8 tree KV buffer, returning the normalised output and its
// log-sum-exp stats (m, l) for merging with the committed-prefix half.
//
// Replaces the JAX package's Pallas kernel repro/kernels/tree_block.py
// (tree_block_attention, body _tree_kernel).
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

template <class Elem>
__global__ void __launch_bounds__(kThreads) tree_block_attention_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const unsigned char* __restrict__ mask,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int n, int T, int hd, int rep, int bq,
    float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
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

  const Elem* kb = k + b * ksb + g * ksh;
  const Elem* vb = v + b * ksb + g * ksh;
  const float* ksc = k_scale ? k_scale + b * ssb + g * ssh : nullptr;
  const float* vsc = v_scale ? v_scale + b * ssb + g * ssh : nullptr;
  Rows st;
  st.init();
  for (int t0 = 0; t0 < T; t0 += kBK) {
    const int tl = min(kBK, T - t0);
    load_tile(kb, vb, ksc, vsc, ksl, ssl, t0, tl, hd, vec != 0, ks, vs);
    __syncthreads();
    update(st, qs + row0 * hd, ks, vs, hd, tl, [&](int r, int j) {
      return mrow[r] != nullptr && mrow[r][t0 + j] != 0;
    });
    __syncthreads();
  }
  store_rows(st, row0, rows, b, g, q0, rep, H, n, hd, o, m_out, l_out);
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
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || T < 1 || bq < 1 ||
      hd < 1 || hd > kMaxHeadDim || B > 65535 || KV > 65535 ||
      (k_scale == nullptr) != (v_scale == nullptr)) {
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
    cudaError_t err = allow_smem(tree_block_attention_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    tree_block_attention_kernel<float><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const float*)k, (const float*)v, ksb,
        ksh, ksl, nullptr, nullptr, 0, 0, 0, (const unsigned char*)mask,
        (float*)o, (float*)m, (float*)l, H, n, T, hd, rep, bq, scale,
        (int)can_vec(k, v, ksb, ksh, ksl, hd, 4));
  } else {
    cudaError_t err = allow_smem(tree_block_attention_kernel<int8_t>, smem);
    if (err != cudaSuccess) return (int)err;
    tree_block_attention_kernel<int8_t><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const int8_t*)k, (const int8_t*)v,
        ksb, ksh, ksl, (const float*)k_scale, (const float*)v_scale, ssb, ssh,
        ssl, (const unsigned char*)mask, (float*)o, (float*)m, (float*)l, H,
        n, T, hd, rep, bq, scale, (int)can_vec(k, v, ksb, ksh, ksl, hd, 1));
  }
  return (int)cudaGetLastError();
}
