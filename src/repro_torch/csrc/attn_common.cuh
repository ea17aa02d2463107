// Shared pieces of the port's two attention kernels
// (flash_attention_lse.cu, tree_block_attention.cu), in their dense and
// paged modes.
//
// Work split.  A CTA owns a set of "rows": (query, query-head) pairs that
// share one KV head (GQA), so every K/V tile it stages in shared memory is
// read from device memory once for the whole group.  Each warp owns
// kRowsPerWarp rows.  K/V stream through shared memory kBK keys at a time
// (a key functor, DenseKeys or PagedKeys, says where each key's row is);
// in a tile, lane j scores key j against the warp's rows, the warp reduces
// max and sum with shuffles, and the P.V product gives each lane
// kDimsPerLane output columns (head_dim <= 128).  Arithmetic is fp32 FMA
// on the CUDA cores: no TF32 and no tensor-core MMA, so the results follow
// the fp32 reference up to summation order.
//
// K and V are fp32, or int8 with one fp32 scale per (batch, kv-head, row)
// (the int8 serving layout).  An int8 row is dequantized as it is staged,
// float(q) * scale, into the same fp32 shared-memory tile, as the Pallas
// kernels dequantize a tile before QK^T and PV; everything after the
// staging is the same code for both.
//
// Masking follows the JAX package's Pallas kernels exactly: a masked score
// is -1e30 and its probability is zeroed, the running max starts at -1e30,
// and the final normaliser is floored at 1e-30, so a row with no valid key
// returns o = 0, m = -1e30, l = 0 (weight 0 when the two halves of tree
// attention are merged).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kBK = 32;           // keys per shared-memory tile, one per lane
constexpr int kRowsPerWarp = 4;   // (query, head) rows a warp owns
constexpr int kDimsPerLane = 4;   // output columns per lane
constexpr int kMaxHeadDim = 32 * kDimsPerLane;
constexpr int kMaxRows = 16;      // rows per CTA
constexpr int kThreads = 32 * kMaxRows / kRowsPerWarp;  // 4 warps at most
constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Running softmax state of one warp's rows.  m and l are replicated over
// the lanes; acc[r][c] is column lane + 32 * c of row r.
struct Rows {
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = 0.f;
    }
  }
};

// Shared-memory size of a CTA with `nwarps` warps: q rows, then the K tile
// (rows padded by one float so lane j reading key j hits its own bank),
// then the V tile.
__host__ __device__ inline size_t smem_bytes(int nwarps, int hd) {
  return sizeof(float) * ((size_t)nwarps * kRowsPerWarp * hd +
                          (size_t)kBK * (hd + 1) + (size_t)kBK * hd);
}

// Stage this CTA's rows of q, pre-multiplied by `scale` (the order the
// Pallas kernels use).  Row r is query q0 + r / rep of head g * rep + r % rep;
// rows past `rows` are zero so idle rows of the last warp stay finite.
__device__ __forceinline__ void stage_q(const float* __restrict__ q,
                                        long long qsb, long long qsh,
                                        long long qsn, int b, int g, int q0,
                                        int rows, int rows_cap, int rep,
                                        int hd, float scale, float* qs) {
  for (int i = threadIdx.x; i < rows_cap * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    float x = 0.f;
    if (r < rows) {
      const int qi = q0 + r / rep;
      const int h = g * rep + r % rep;
      x = q[b * qsb + h * qsh + qi * qsn + d] * scale;
    }
    qs[i] = x;
  }
}

// Loads a thread keeps in flight per tensor while staging a tile.
constexpr int kStage = 8;

// Where key j of the tile starting at logical key t0 lives, in elements
// from the (batch, kv-head) base pointers: `kv(j)` for K/V, `sc(j)` for
// the int8 scales.  A dense cache keeps key t at row t (`kl`/`sl`
// elements apart).
struct DenseKeys {
  int t0;
  long long kl, sl;
  __device__ __forceinline__ long long kv(int j) const {
    return (long long)(t0 + j) * kl;
  }
  __device__ __forceinline__ long long sc(int j) const {
    return (long long)(t0 + j) * sl;
  }
};

// A block-paged cache keeps logical key t in row t % page of physical
// block table[t / page] of a pool whose blocks are `kb` (K/V) and `sb`
// (scales) elements apart and whose rows are `kl` and `sl` apart.  `blk`
// holds the tile's physical block per key, read from the block table once
// per tile into shared memory (stage_blocks) before the tile's loads.
struct PagedKeys {
  const int* blk;
  int t0, page;
  long long kb, kl, sb, sl;
  __device__ __forceinline__ long long kv(int j) const {
    return (long long)blk[j] * kb + (long long)((t0 + j) % page) * kl;
  }
  __device__ __forceinline__ long long sc(int j) const {
    return (long long)blk[j] * sb + (long long)((t0 + j) % page) * sl;
  }
};

// Read the physical block of keys [t0, t0 + tl) of one batch row's block
// table `trow` into `blk` (tl <= kBK <= blockDim.x).  The caller
// synchronises before the tile's loads read it.
__device__ __forceinline__ void stage_blocks(const int* __restrict__ trow,
                                             int page, int t0, int tl,
                                             int* blk) {
  const int j = threadIdx.x;
  if (j < tl) blk[j] = trow[(t0 + j) / page];
}

// Copy the tile's `tl` keys of one (batch, kv-head) fp32 K and V into
// shared memory.  k/v point at the (batch, kv-head) base and `keys` says
// where each key's row starts; head_dim is contiguous, so consecutive
// threads read consecutive addresses.  With `vec` (16-byte aligned rows,
// head_dim a multiple of 4) each thread reads 16 bytes at a time, and
// issues up to kStage reads of K and of V before its first shared-memory
// store, so their latencies overlap.  The scale arguments are unused:
// fp32 rows carry none.
template <class Keys>
__device__ __forceinline__ void load_tile(const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float*, const float*,
                                          const Keys& keys, int tl, int hd,
                                          bool vec, float* ks, float* vs) {
  const int width = vec ? 4 : 1;
  const int per_row = hd / width;
  const int total = tl * per_row;
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    float4 kr[kStage], vr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int j = i / per_row;
        const int d = (i - j * per_row) * width;
        const long long gi = keys.kv(j) + d;
        if (vec) {
          kr[u] = *reinterpret_cast<const float4*>(k + gi);
          vr[u] = *reinterpret_cast<const float4*>(v + gi);
        } else {
          kr[u].x = k[gi];
          vr[u].x = v[gi];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int j = i / per_row;
        const int d = (i - j * per_row) * width;
        float* kd = ks + j * (hd + 1) + d;
        float* vd = vs + j * hd + d;
        kd[0] = kr[u].x;
        vd[0] = vr[u].x;
        if (vec) {
          kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
          vd[1] = vr[u].y; vd[2] = vr[u].z; vd[3] = vr[u].w;
        }
      }
    }
  }
}

// Four int8 bytes of `w` times `s`: byte b is made an exact float from the
// bits 0x4B000000 | (b ^ 0x80) (= 2^23 + b + 128) less 2^23 + 128, then
// multiplied once by the row's scale, as the plain version computes
// float(q) * scale.
__device__ __forceinline__ float4 dequant4(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;
  float4 f;
  f.x = (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f) * s;
  f.y = (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f) * s;
  f.z = (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f) * s;
  f.w = (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f) * s;
  return f;
}

// The int8 twin: the tile's keys of int8 K and V with their per-row
// scales (`ksc`/`vsc` point at the (batch, kv-head) base of the scales,
// `keys.sc` places each key's scale), dequantized into the same fp32
// tiles.  With `vec` (16-byte aligned rows, head_dim a multiple of 16)
// each thread reads 16 int8 values at a time; a target row (head_dim 128)
// is 8 such reads, a draft row (64) is 4.
template <class Keys>
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ k,
                                          const int8_t* __restrict__ v,
                                          const float* __restrict__ ksc,
                                          const float* __restrict__ vsc,
                                          const Keys& keys, int tl, int hd,
                                          bool vec, float* ks, float* vs) {
  if (!vec) {
    for (int i = threadIdx.x; i < tl * hd; i += blockDim.x) {
      const int j = i / hd;
      const int d = i - j * hd;
      const long long gi = keys.kv(j) + d;
      const long long si = keys.sc(j);
      ks[j * (hd + 1) + d] = (float)k[gi] * ksc[si];
      vs[j * hd + d] = (float)v[gi] * vsc[si];
    }
    return;
  }
  const int per_row = hd / 16;
  const int total = tl * per_row;
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    uint4 kr[kStage], vr[kStage];
    float kscale[kStage], vscale[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int j = i / per_row;
        const int d = (i - j * per_row) * 16;
        const long long gi = keys.kv(j) + d;
        const long long si = keys.sc(j);
        kr[u] = *reinterpret_cast<const uint4*>(k + gi);
        vr[u] = *reinterpret_cast<const uint4*>(v + gi);
        kscale[u] = ksc[si];
        vscale[u] = vsc[si];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) {
        const int j = i / per_row;
        const int d = (i - j * per_row) * 16;
        float* kd = ks + j * (hd + 1) + d;
        float4* vd = reinterpret_cast<float4*>(vs + j * hd + d);
        const uint32_t kw[4] = {kr[u].x, kr[u].y, kr[u].z, kr[u].w};
        const uint32_t vw[4] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 kf = dequant4(kw[c], kscale[u]);
          kd[4 * c] = kf.x; kd[4 * c + 1] = kf.y;
          kd[4 * c + 2] = kf.z; kd[4 * c + 3] = kf.w;
          vd[c] = dequant4(vw[c], vscale[u]);
        }
      }
    }
  }
}

// Whether K/V rows of one (batch, kv-head) can be read 16 bytes at a time:
// aligned base pointers, and head_dim and every stride (in elements of
// `elem_bytes`) a whole number of 16-byte vectors.
inline bool can_vec(const void* k, const void* v, long long ksb,
                    long long ksh, long long ksl, int hd, int elem_bytes) {
  const unsigned long long a =
      (unsigned long long)k | (unsigned long long)v;
  const int width = 16 / elem_bytes;
  return a % 16 == 0 && hd % width == 0 && ksb % width == 0 &&
         ksh % width == 0 && ksl % width == 0;
}

// Fold one staged tile of `tl` keys into a warp's running softmax.
// `valid(r, j)` says whether the warp's row r may attend key j of the tile.
template <class Valid>
__device__ __forceinline__ void update(Rows& st, const float* qs,
                                       const float* ks, const float* vs,
                                       int hd, int tl, Valid valid) {
  const int lane = threadIdx.x & 31;
  float s[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
  if (lane < tl && hd % 4 == 0) {
    // q rows are 16-byte aligned in shared memory: one broadcast float4
    // read per row and four dims (same summation order as the scalar loop)
    const float* kr = ks + lane * (hd + 1);
    for (int d = 0; d < hd; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * hd + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }
  } else if (lane < tl) {
    const float* kr = ks + lane * (hd + 1);
    for (int d = 0; d < hd; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qs[r * hd + d], kd, s[r]);
    }
  }
  float p[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const bool ok = lane < tl && valid(r, lane);
    const float sv = ok ? s[r] : kNegInf;
    const float mn = fmaxf(st.m[r], warp_max(sv));
    p[r] = ok ? expf(sv - mn) : 0.f;
    const float alpha = expf(st.m[r] - mn);
    st.l[r] = st.l[r] * alpha + warp_sum(p[r]);
    st.m[r] = mn;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) st.acc[r][c] *= alpha;
  }
  for (int j = 0; j < tl; ++j) {
    float pj[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
    const float* vr = vs + j * hd;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) {
        const float vd = vr[d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) st.acc[r][c] = fmaf(pj[r], vd, st.acc[r][c]);
      }
    }
  }
}

// Write a warp's finished rows: o = acc / max(l, 1e-30) into o [B,H,n,hd],
// and the softmax stats into m, l [B,H,n].
__device__ __forceinline__ void store_rows(const Rows& st, int row0, int rows,
                                           int b, int g, int q0, int rep,
                                           int H, int n, int hd,
                                           float* __restrict__ o,
                                           float* __restrict__ m,
                                           float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= rows) continue;
    const int qi = q0 + row / rep;
    const int h = g * rep + row % rep;
    const long long orow = ((long long)b * H + h) * n + qi;
    const float den = fmaxf(st.l[r], kMinL);
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[orow * hd + d] = st.acc[r][c] / den;
    }
    if (lane == 0) {
      m[orow] = st.m[r];
      l[orow] = st.l[r];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when a launch needs more
// than the default 48 KB (a launch over the limit is refused and never
// runs).  The limit only grows, so the attribute is set at the first launch
// of each larger size and not again (nor while a CUDA graph captures).
// The kernel is a template argument so that each kernel keeps its own
// record (two kernels of one signature would otherwise share it).
template <auto kernel>
inline cudaError_t allow_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace attn
