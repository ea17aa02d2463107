// Shared pieces of the port's two attention kernels
// (flash_attention_lse.cu, tree_block_attention.cu), in their dense and
// paged modes: the Hopper primitives both build on.
//
//   * 3xTF32 tensor-core products: split_tf32 cuts an fp32 value into a
//     big and a small TF32 part, and mma_tf32 is one mma.sync m16n8k8.
//     Three products per fp32 product (small * big, big * small, big *
//     big, small ones first) keep fp32-level accuracy.
//   * cp.async copies (16 bytes, and 4 for the int8 row scales) with
//     commit/wait groups.
//   * Key addresses: DenseRows and PagedRows say where logical key t of
//     the CTA's (batch row, KV head) lives; a paged kernel differs from its
//     dense twin by this functor only, so it gives the same bits over a
//     pool as the dense kernel over the gathered view.
//   * Staging: load_tile starts the copies of `nkeys` keys of K and V
//     (fp32 straight into the padded tiles; int8 rows and their scales
//     raw), and dequant_tile (dequant_tile4 for full rows) makes the
//     landed int8 rows fp32 tiles, float(q) * scale, as the plain versions
//     dequantize; store2 writes two adjacent output columns.
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

constexpr float kNegInf = -1e30f;
constexpr float kMinL = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

// x as big + small TF32 parts: big keeps the top 10 mantissa bits (a
// mask, where cvt.rna.tf32 costs a rounding sequence on this card), small
// is the exact remainder, whose low 13 bits the MMA ignores.  big * big
// plus the two cross products carry about 21 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// O += P V for one 8-key tile of P, in the 3xTF32 form: ab/as are the big
// and small parts of this thread's A fragment of P (k slots tq and tq + 4,
// its keys 2 tq and 2 tq + 1), and vp points at V row 2 tq of the tile at
// column gq (rows S floats apart).  Every acc[dt] takes its three products
// in the order small * big, big * small, big * big.  Up to head_dim 128
// each product runs over all kDT column tiles before the next (one group);
// wider heads go in groups of 8 tiles so that the V fragments of one group
// stay in registers beside the accumulators.  The grouping reorders only
// MMAs of different acc[dt], so every sum is the same.
template <int kDT, int S>
__device__ __forceinline__ void pv_update(float (*acc)[4], const uint32_t* ab,
                                          const uint32_t* as,
                                          const float* vp) {
  constexpr int kG = kDT > 16 ? 8 : kDT;
#pragma unroll
  for (int d0 = 0; d0 < kDT; d0 += kG) {
    uint32_t vb[kG][2], vsm[kG][2];
#pragma unroll
    for (int dt = 0; dt < kG; ++dt) {
      split_tf32(vp[8 * (d0 + dt)], vb[dt][0], vsm[dt][0]);
      split_tf32(vp[8 * (d0 + dt) + S], vb[dt][1], vsm[dt][1]);
    }
#pragma unroll
    for (int dt = 0; dt < kG; ++dt) {
      mma_tf32(acc[d0 + dt], as, vb[dt][0], vb[dt][1]);
    }
#pragma unroll
    for (int dt = 0; dt < kG; ++dt) {
      mma_tf32(acc[d0 + dt], ab, vsm[dt][0], vsm[dt][1]);
    }
#pragma unroll
    for (int dt = 0; dt < kG; ++dt) {
      mma_tf32(acc[d0 + dt], ab, vb[dt][0], vb[dt][1]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where logical key t of the CTA's (batch row, KV head) lives, in elements
// from the K/V (`kv`) and scale (`sc`) base pointers.  A dense cache keeps
// key t at row t of the (b, g) slice.
struct DenseRows {
  long long k0, kl, s0, sl;
  __device__ __forceinline__ long long kv(int t) const { return k0 + t * kl; }
  __device__ __forceinline__ long long sc(int t) const { return s0 + t * sl; }
};

// A block-paged cache keeps key t in row t % page of physical block
// table[b, t / page]; blocks are kb (K/V) and sb (scales) elements apart.
// The table is read as each copy starts.
struct PagedRows {
  const int* trow;
  int page;
  long long k0, kb, kl, s0, sb, sl;
  __device__ __forceinline__ long long kv(int t) const {
    return k0 + (long long)__ldg(trow + t / page) * kb +
           (long long)(t % page) * kl;
  }
  __device__ __forceinline__ long long sc(int t) const {
    return s0 + (long long)__ldg(trow + t / page) * sb +
           (long long)(t % page) * sl;
  }
};

// Start the copies of the `nkeys` keys [t0, t0 + nkeys) with `nthreads`
// threads: keys at or past `tend` are zero-filled, never read.  fp32:
// straight into the K/V tiles, rows padded to HD + 4 floats.
template <int HD, class Rows>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__, const float* __restrict__, const Rows& rows,
    int t0, int tend, int nkeys, int nthreads, int hd, bool vec, float* ks,
    float* vs, int8_t*, int8_t*, float*, float*) {
  constexpr int S = HD + 4;
  if (vec) {
    const int per = hd / 4;
    for (int i = threadIdx.x; i < nkeys * per; i += nthreads) {
      const int j = i / per;
      const int d = (i - j * per) * 4;
      const int t = t0 + j;
      const bool ok = t < tend;
      const long long a = ok ? rows.kv(t) + d : 0;
      cp_async16(ks + j * S + d, k + a, ok);
      cp_async16(vs + j * S + d, v + a, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nkeys * hd; i += nthreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int t = t0 + j;
      const bool ok = t < tend;
      const long long a = ok ? rows.kv(t) + d : 0;
      ks[j * S + d] = ok ? k[a] : 0.f;
      vs[j * S + d] = ok ? v[a] : 0.f;
    }
  }
}

// int8: the raw rows [nkeys][HD] and their scales [nkeys] (dequantized by
// dequant_tile once they have landed).
template <int HD, class Rows>
__device__ __forceinline__ void load_tile(
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    const Rows& rows, int t0, int tend, int nkeys, int nthreads, int hd,
    bool vec, float*, float*, int8_t* kr, int8_t* vr, float* kss,
    float* vss) {
  if (vec) {
    const int per = hd / 16;
    for (int i = threadIdx.x; i < nkeys * per; i += nthreads) {
      const int j = i / per;
      const int d = (i - j * per) * 16;
      const int t = t0 + j;
      const bool ok = t < tend;
      const long long a = ok ? rows.kv(t) + d : 0;
      cp_async16(kr + j * HD + d, k + a, ok);
      cp_async16(vr + j * HD + d, v + a, ok);
    }
    for (int j = threadIdx.x; j < nkeys; j += nthreads) {
      const int t = t0 + j;
      const bool ok = t < tend;
      const long long a = ok ? rows.sc(t) : 0;
      cp_async4(kss + j, ksc + a, ok);
      cp_async4(vss + j, vsc + a, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nkeys * hd; i += nthreads) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int t = t0 + j;
      const bool ok = t < tend;
      const long long a = ok ? rows.kv(t) + d : 0;
      kr[j * HD + d] = ok ? k[a] : (int8_t)0;
      vr[j * HD + d] = ok ? v[a] : (int8_t)0;
    }
    for (int j = threadIdx.x; j < nkeys; j += nthreads) {
      const int t = t0 + j;
      const bool ok = t < tend;
      kss[j] = ok ? ksc[rows.sc(t)] : 0.f;
      vss[j] = ok ? vsc[rows.sc(t)] : 0.f;
    }
  }
}

// float(q) * scale of `nkeys` landed int8 rows into the fp32 tiles, as the
// plain version dequantizes.
template <int HD>
__device__ __forceinline__ void dequant_tile(const int8_t* kr,
                                             const int8_t* vr,
                                             const float* kss,
                                             const float* vss, int nkeys,
                                             int nthreads, int hd, float* ks,
                                             float* vs) {
  constexpr int S = HD + 4;
  for (int i = threadIdx.x; i < nkeys * hd; i += nthreads) {
    const int j = i / hd;
    const int d = i - j * hd;
    ks[j * S + d] = (float)kr[j * HD + d] * kss[j];
    vs[j * S + d] = (float)vr[j * HD + d] * vss[j];
  }
}

// dequant_tile for full rows (head_dim == HD): four values a thread step,
// one 4-byte read of each int8 row and one 16-byte write of each fp32 row,
// with no division by a runtime head_dim.  The same float(q) * scale.
template <int HD>
__device__ __forceinline__ void dequant_tile4(const int8_t* kr,
                                              const int8_t* vr,
                                              const float* kss,
                                              const float* vss, int nkeys,
                                              int nthreads, float* ks,
                                              float* vs) {
  constexpr int S = HD + 4;
  constexpr int kPer = HD / 4;
  for (int i = threadIdx.x; i < nkeys * kPer; i += nthreads) {
    const int j = i / kPer;
    const int d = (i - j * kPer) * 4;
    const char4 kq = *reinterpret_cast<const char4*>(kr + j * HD + d);
    const char4 vq = *reinterpret_cast<const char4*>(vr + j * HD + d);
    const float kx = kss[j];
    const float vx = vss[j];
    *reinterpret_cast<float4*>(ks + j * S + d) =
        make_float4((float)kq.x * kx, (float)kq.y * kx, (float)kq.z * kx,
                    (float)kq.w * kx);
    *reinterpret_cast<float4*>(vs + j * S + d) =
        make_float4((float)vq.x * vx, (float)vq.y * vx, (float)vq.z * vx,
                    (float)vq.w * vx);
  }
}

// Columns d, d + 1 of a row: one 8-byte write when both lie in the row
// (`left` = head_dim - d) and it is aligned, so a warp's store covers whole
// 32-byte sectors (sectors written in pieces are slow to read back).
__device__ __forceinline__ void store2(float* p, float a, float b, int left) {
  if (left >= 2 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else if (left >= 1) {
    p[0] = a;
    if (left >= 2) p[1] = b;
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
