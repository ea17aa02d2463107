// flash_attention_lse: GQA attention over a dense fp32 or int8 KV cache,
// returning the normalised output and its log-sum-exp stats (m, l).
//
// Replaces the JAX package's Pallas kernel repro/kernels/flash.py
// (flash_attention_lse, body _flash_kernel).  One kernel serves three call
// sites of the port: the committed-prefix half of tree verification,
// decode (n = 1) and causal prefill.
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

template <class Elem>
__global__ void __launch_bounds__(kThreads) flash_attention_lse_kernel(
    const float* __restrict__ q, long long qsb, long long qsh, long long qsn,
    const Elem* __restrict__ k, const Elem* __restrict__ v, long long ksb,
    long long ksh, long long ksl, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, long long ssb, long long ssh,
    long long ssl, const int* __restrict__ kv_len,
    const int* __restrict__ qpos, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int n, int L,
    int hd, int rep, int bq, int causal, int window, float scale,
    int vec) {
  extern __shared__ __align__(16) float smem[];
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

  const Elem* kb = k + b * ksb + g * ksh;
  const Elem* vb = v + b * ksb + g * ksh;
  const float* ksc = k_scale ? k_scale + b * ssb + g * ssh : nullptr;
  const float* vsc = v_scale ? v_scale + b * ssb + g * ssh : nullptr;
  Rows st;
  st.init();
  for (int t0 = 0; t0 < end; t0 += kBK) {
    const int tl = min(kBK, end - t0);
    load_tile(kb, vb, ksc, vsc, ksl, ssl, t0, tl, hd, vec != 0, ks, vs);
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
  if (B < 1 || KV < 1 || H % KV != 0 || n < 1 || bq < 1 || hd < 1 ||
      hd > kMaxHeadDim || B > 65535 || KV > 65535 ||
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
    cudaError_t err = allow_smem(flash_attention_lse_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_lse_kernel<float><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const float*)k, (const float*)v, ksb,
        ksh, ksl, nullptr, nullptr, 0, 0, 0, (const int*)kv_len,
        (const int*)qpos, (float*)o, (float*)m, (float*)l, H, n, L, hd, rep,
        bq, causal, window, scale, (int)can_vec(k, v, ksb, ksh, ksl, hd, 4));
  } else {
    cudaError_t err = allow_smem(flash_attention_lse_kernel<int8_t>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_lse_kernel<int8_t><<<grid, nwarps * 32, smem, s>>>(
        (const float*)q, qsb, qsh, qsn, (const int8_t*)k, (const int8_t*)v,
        ksb, ksh, ksl, (const float*)k_scale, (const float*)v_scale, ssb, ssh,
        ssl, (const int*)kv_len, (const int*)qpos, (float*)o, (float*)m,
        (float*)l, H, n, L, hd, rep, bq, causal, window, scale,
        (int)can_vec(k, v, ksb, ksh, ksl, hd, 1));
  }
  return (int)cudaGetLastError();
}
