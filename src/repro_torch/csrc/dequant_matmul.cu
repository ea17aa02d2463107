// dequant_matmul: y[m, n] = scale[n] * sum_k x[m, k] * float(q8[k, n]),
// fp32 activations against int8 weights with one fp32 scale per output
// channel, applied once after the whole sum.
//
// Replaces the JAX package's Pallas kernel repro/kernels/quant.py
// (dequant_matmul_kernel, body _dq_matmul_kernel).  Every projection of a
// quantized model reaches it: seven per layer per forward call.
//
//   x        [M, K] fp32, contiguous
//   q8       [K, N] int8, contiguous (N fastest)
//   scale    [N] fp32
//   out      [M, N] fp32
//   work     [splits, M, N] fp32 partial sums (unused when splits == 1)
//   counters [ceil(M / 128) * ceil(N / 128)] int32, zero between calls
//
// What bounds it on an H100.  At the main path's M (8 rows for a tree
// verify, 1 for a decode) the int8 weight bytes: K*N bytes at 3.35 TB/s
// (70 us for w_gate, K 8192, N 28672).  At a prefill's M = 128 the
// products: three bf16 passes of 2*M*K*N at the tensor cores' 989
// TFLOP/s (0.18 ms for w_gate), above the weight bytes.
//
// Design.
//   * Tensor cores at fp32 accuracy.  An int8 weight is exact in bf16.
//     x is split exactly into bf16 terms, x = hi + mid + lo (hi the top 8
//     significant bits by truncation, so nothing overflows; each
//     remainder is exact in fp32 and the last holds the 8 bits left), and
//     each term meets the same weight fragment in an mma.sync m16n8k16
//     with fp32 accumulation (lo first, hi last).  Every product is exact;
//     only the fp32 accumulation rounds.  The CUDA cores do only the int8
//     -> bf16 conversion (byte permutes into exact fp32 integers, one
//     subtraction, then the upper halves packed in pairs) and the split.
//   * Swap AB: the output columns are the MMA's 16-row side and the rows
//     of x its 8-column side, so M <= 8 wastes nothing and one CTA holds
//     up to 128 rows of x (NT = 16 column tiles of the MMA): at M = 128
//     each weight byte is read once, not once per 8 rows.
//   * A CTA of 4 warps owns 128 output columns (32 a warp: lane (g, t)
//     reads the 4-byte word of columns 4g..4g+3 of the warp's 32 at four K
//     rows t, t+4, t+8, t+12 of each 16-row step; bytes 0-3 are rows g,
//     g+8 of the warp's two m16 tiles, and K rows t+4i fill the MMA's k
//     slots 2t, 2t+1, 2t+8, 2t+9.  The k slots may be any permutation of
//     the step's 16 rows, as long as x's fragments use the same one).
//   * Asynchronous copies: 64-row K steps of int8 weights (8 KB; 32 rows
//     at NT >= 8) and of x stream through a 3-stage shared-memory ring
//     with cp.async (16 bytes; the ragged edges zero-filled), so two steps
//     are in flight while one computes; at M <= 8 five CTAs fit an SM
//     (deeper rings, 256-column tiles and cp.async.ca measured no faster
//     on the card).  Weight rows are padded to 160 bytes, which puts the
//     32 lanes' words on 32 banks.  At each step the CTA splits its x tile
//     once into the bf16 terms, laid out as the MMA's B fragments (one
//     8-byte read per lane, fragment and term).
//   * Enough CTAs: the K range of a column tile is split across CTAs (the
//     host's plan, kernels/quant.py k_split).
//   * One launch per call: every CTA of a split column tile writes its
//     partial sums; the last to finish (a per-tile counter, bumped after a
//     __threadfence, and reset to 0 by that CTA) sums the partials in
//     split order and applies the scale.
//
// Sum order.  The K split depends on K and N only, every output element is
// its own dot product inside the MMA (it reads only its own row of x and
// column of weights), and an element's sequence of MMAs does not depend on
// NT or on the row's place in the tile, so a row of x gives the same bits
// at any M: decode (M = 1), tree verify (M = 8) and prefill (M = 128)
// agree.  No atomics touch the sums.
//
// Ragged shapes: rows of x past M, K rows past the split's end and columns
// past N are zero-filled in shared memory, and stores are masked.  When x
// rows or weight rows are not 16-byte aligned (K % 4 or N % 16), the copy
// falls back to element loads; nothing else changes.  An infinite x gives
// NaN (its split is inf - inf), where the plain version gives +-inf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;             // output columns per CTA
constexpr int kPlanK = 64;               // the host's splits are multiples
constexpr int kWRow = kBlockN + 32;      // padded weight row, bytes
constexpr int kMaxNT = 16;               // 128 rows of x per CTA
constexpr int kTerms = 3;                // bf16 terms of x, at most

// Ring of a CTA with NT MMA column tiles (8 NT rows of x): K rows per
// stage (32 from 64 rows of x on, so that two CTAs fit an SM), stages,
// and shared-memory bytes.  The stage depth changes no sum order: an
// element's 16-row k steps run in the same sequence.
template <int NT>
struct Plan {
  static constexpr int kRows = 8 * NT;
  static constexpr int kBlockK = NT >= 8 ? 32 : 64;
  static constexpr int kXRow = kBlockK + 4;       // padded x row, floats
  static constexpr int kSteps16 = kBlockK / 16;   // MMA k steps per stage
  static constexpr int kStages = 3;
  static constexpr int kWBytes = kStages * kBlockK * kWRow;
  static constexpr int kXBytes = kStages * kRows * kXRow * 4;
  static constexpr int kFBytes = NT * kSteps16 * kTerms * 32 * 8;
  static constexpr int kSmem = kWBytes + kXBytes + kFBytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte b of w as an exact fp32 integer: the bits 0x4B000000 | (b ^ 0x80)
// are 2^23 + b + 128, less 2^23 + 128.  Its low 16 bits are zero, so its
// upper half is the same value in bf16.
__device__ __forceinline__ uint32_t byte_f32(uint32_t u, uint32_t sel) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f);
}

// bf16x2 of two exact fp32 values: `lo` in the low half (the lower k slot).
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// The bf16 terms of x, x = t[0] + t[1] + t[2] exactly (up to bf16
// subnormals): each term the top 16 bits of the remainder.
__device__ __forceinline__ void split(float x, uint32_t* t) {
  float r = x;
#pragma unroll
  for (int p = 0; p < kTerms; ++p) {
    const uint32_t bits = __float_as_uint(r) & 0xFFFF0000u;
    t[p] = bits >> 16;
    r -= __uint_as_float(bits);
  }
}

// Start the copies of one ring stage: K rows [kt, kt + kBlockK) of the
// CTA's 128 weight columns and of its rows of x.
template <int NT>
__device__ __forceinline__ void load_stage(
    uint8_t* ws, float* xs, const float* __restrict__ x,
    const int8_t* __restrict__ q8, int kt, int k_end, int m0, int mrows,
    int n0, int K, int N, bool vecw, bool vecx) {
  using P = Plan<NT>;
  constexpr int kBlockK = P::kBlockK;
  constexpr int kXChunks = kBlockK / 4;   // 16-byte chunks of an x row
  const int tid = threadIdx.x;
  constexpr int kWChunks = kBlockN / 16;  // 16-byte chunks of a weight row
  for (int i = tid; i < kBlockK * kWChunks; i += kThreads) {
    const int r = i / kWChunks;
    const int c = (i % kWChunks) * 16;
    const int k = kt + r;
    const int n = n0 + c;
    uint8_t* dst = ws + r * kWRow + c;
    if (vecw) {
      const bool ok = k < k_end && n < N;
      cp_async16(dst, ok ? (const void*)(q8 + (long long)k * N + n)
                         : (const void*)q8, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (k < k_end && n + b < N) {
          w[b >> 2] |= (uint32_t)(uint8_t)q8[(long long)k * N + n + b]
                       << (8 * (b & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  for (int i = tid; i < 8 * NT * kXChunks; i += kThreads) {
    const int r = i / kXChunks;
    const int c = (i % kXChunks) * 4;
    const int k = kt + c;
    float* dst = xs + r * P::kXRow + c;
    const float* src = x + (long long)(m0 + r) * K + k;
    if (vecx) {
      const bool ok = r < mrows && k < k_end;
      cp_async16(dst, ok ? (const void*)src : (const void*)x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[e] = (r < mrows && k + e < k_end) ? src[e] : 0.f;
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) dequant_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q8,
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ work, int* __restrict__ counters, int M, int K,
    int N, int kchunk, int splits, int vecw, int vecx) {
  using P = Plan<NT>;
  constexpr int kBlockK = P::kBlockK;
  constexpr int kXRow = P::kXRow;
  constexpr int kSteps16 = P::kSteps16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;
  float* xs = reinterpret_cast<float*>(smem + P::kWBytes);
  uint2* fr = reinterpret_cast<uint2*>(smem + P::kWBytes + P::kXBytes);
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile = blockIdx.x;
  const int split_id = blockIdx.y;
  const int n0 = tile * kBlockN;
  const int m0 = blockIdx.z * P::kRows;
  const int mrows = min(P::kRows, M - m0);
  const int k_begin = split_id * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int nsteps = (k_end - k_begin + kBlockK - 1) / kBlockK;

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < nsteps) {
      load_stage<NT>(ws + s * kBlockK * kWRow, xs + s * P::kRows * kXRow, x,
                     q8, k_begin + s * kBlockK, k_end, m0, mrows, n0, K, N,
                     vecw != 0, vecx != 0);
    }
    cp_async_commit();
  }

  for (int step = 0; step < nsteps; ++step) {
    const int stage = step % P::kStages;
    cp_async_wait<P::kStages - 2>();
    __syncthreads();   // the stage has landed; the last step's readers are done
    // split this stage's x into the MMA's B fragments: item (j, s16, g, t)
    // holds x row 8j + g at K rows 16 s16 + t + 4i, i = 0..3
    const float* xst = xs + stage * P::kRows * kXRow;
    for (int i = tid; i < NT * 32 * kSteps16; i += kThreads) {
      const int it = i & 3, ig = (i >> 2) & 7;
      const int is = (i >> 5) % kSteps16, ij = (i >> 5) / kSteps16;
      const float* src = xst + (8 * ij + ig) * kXRow + 16 * is + it;
      uint32_t v[4][kTerms];
#pragma unroll
      for (int q = 0; q < 4; ++q) split(src[4 * q], v[q]);
      uint2* dst = fr + ((ij * kSteps16 + is) * kTerms) * 32 + (i & 31);
#pragma unroll
      for (int p = 0; p < kTerms; ++p) {
        dst[p * 32] = make_uint2(v[0][p] | (v[1][p] << 16),
                                 v[2][p] | (v[3][p] << 16));
      }
    }
    // refill the stage the last step used
    const int ahead = step + P::kStages - 1;
    if (ahead < nsteps) {
      const int as = ahead % P::kStages;
      load_stage<NT>(ws + as * kBlockK * kWRow, xs + as * P::kRows * kXRow,
                     x, q8, k_begin + ahead * kBlockK, k_end, m0, mrows, n0,
                     K, N, vecw != 0, vecx != 0);
    }
    cp_async_commit();
    __syncthreads();   // fragments ready
    const uint8_t* wst = ws + stage * kBlockK * kWRow + warp * 32 + 4 * g;
#pragma unroll
    for (int s16 = 0; s16 < kSteps16; ++s16) {
      uint32_t f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            wst + (16 * s16 + t + 4 * i) * kWRow);
        const uint32_t u = w ^ 0x80808080u;
        f[i][0] = byte_f32(u, 0x7440);
        f[i][1] = byte_f32(u, 0x7441);
        f[i][2] = byte_f32(u, 0x7442);
        f[i][3] = byte_f32(u, 0x7443);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = pack_hi(f[0][2 * mt], f[1][2 * mt]);
        a[mt][1] = pack_hi(f[0][2 * mt + 1], f[1][2 * mt + 1]);
        a[mt][2] = pack_hi(f[2][2 * mt], f[3][2 * mt]);
        a[mt][3] = pack_hi(f[2][2 * mt + 1], f[3][2 * mt + 1]);
      }
      // the terms from the last to the first; within a term the column
      // tiles' MMAs are independent, so they run back to back
#pragma unroll
      for (int p = kTerms - 1; p >= 0; --p) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = fr[((j * kSteps16 + s16) * kTerms + p) * 32 + lane];
          mma_bf16(acc[0][j], a[0], b.x, b.y);
          mma_bf16(acc[1][j], a[1], b.x, b.y);
        }
      }
    }
  }
  cp_async_wait<0>();

  // element (x row 8j + 2t + e, column 4g + 2mt + h of the warp's 32) is
  // acc[mt][j][2h + e]: a thread holds 4 adjacent columns of a row, stored
  // as one 16-byte write (whole sectors per warp store, which the last
  // CTA's reads of the partials need) when N allows
  const int col0 = n0 + warp * 32 + 4 * g;
  const bool v4 = N % 4 == 0;
  const long long plane = (long long)M * N;
  float* dst = splits == 1 ? out : work + split_id * plane;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 8 * j + 2 * t + e;
      if (row >= mrows || col0 >= N) continue;
      float r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = acc[c >> 1][j][2 * (c & 1) + e];
      if (splits == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) r[c] *= scale[min(col0 + c, N - 1)];
      }
      float* o = dst + (long long)(m0 + row) * N + col0;
      if (v4) {
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
        for (int c = 0; c < 4 && col0 + c < N; ++c) o[c] = r[c];
      }
    }
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.x + tile;
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA of the tile: the splits in order, then the scale.  A
  // thread takes 4 columns of a row and starts up to kBatch splits' loads
  // before it adds them, in order, so the L2 latency is paid once a batch.
  constexpr int kBatch = 16;
  for (int it = tid; it < mrows * (kBlockN / 4); it += kThreads) {
    const int row = it / (kBlockN / 4);
    const int n = n0 + (it % (kBlockN / 4)) * 4;
    if (n >= N) continue;
    const long long base = (long long)(m0 + row) * N + n;
    if (N % 4 == 0) {
      float4 s = __ldcg(reinterpret_cast<const float4*>(work + base));
      for (int z0 = 1; z0 < splits; z0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (z0 + u < splits) {
            v[u] = __ldcg(reinterpret_cast<const float4*>(
                work + (z0 + u) * plane + base));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (z0 + u < splits) {
            s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
          }
        }
      }
      const float4 sc = make_float4(scale[n], scale[n + 1], scale[n + 2],
                                    scale[n + 3]);
      *reinterpret_cast<float4*>(out + base) =
          make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
    } else {
      for (int c = 0; c < 4 && n + c < N; ++c) {
        float s = __ldcg(work + base + c);
        for (int z = 1; z < splits; ++z) s += __ldcg(work + z * plane + base + c);
        out[base + c] = s * scale[n + c];
      }
    }
  }
  if (tid == 0) *counter = 0;   // ready for the next call
}

// Raise a kernel's dynamic shared-memory limit once (one record per
// template instance).
template <int NT>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      dequant_matmul_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan<NT>::kSmem);
  done = err == cudaSuccess;
  return err;
}

template <int NT>
cudaError_t launch_nt(const float* x, const int8_t* q8, const float* scale,
                      float* out, float* work, int* counters, int M, int K,
                      int N, int splits, int kchunk, int vecw, int vecx,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBlockN - 1) / kBlockN, splits,
            (M + Plan<NT>::kRows - 1) / Plan<NT>::kRows);
  dequant_matmul_kernel<NT><<<grid, kThreads, Plan<NT>::kSmem, stream>>>(
      x, q8, scale, out, work, counters, M, K, N, kchunk, splits, vecw,
      vecx);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = success).  The
// caller allocates every buffer: `work` with splits * M * N floats when
// splits > 1, and `counters` with ceil(M / 128) * ceil(N / 128) ints that
// are zero (the kernel leaves them zero).  Splits cover K:
// (splits - 1) * kchunk < K <= splits * kchunk, kchunk a multiple of 64.
extern "C" int dequant_matmul_launch(const void* x, const void* q8,
                                     const void* scale, void* out, void* work,
                                     void* counters, int M, int K, int N,
                                     int splits, int kchunk, void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || kchunk < 1 ||
      (long long)splits * kchunk < K ||
      kchunk % kPlanK != 0 || (long long)(splits - 1) * kchunk >= K ||
      (splits > 1 && (work == nullptr || counters == nullptr)) ||
      splits > 65535 || (M + 8 * kMaxNT - 1) / (8 * kMaxNT) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int vecw = N % 16 == 0 && (uintptr_t)q8 % 16 == 0;
  const int vecx = K % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int rows = M < 8 * kMaxNT ? M : 8 * kMaxNT;
  const int nt = rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4
               : rows <= 64 ? 8 : 16;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const int8_t* w = (const int8_t*)q8;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  float* wk = (float*)work;
  int* ct = (int*)counters;
  cudaError_t err;
  switch (nt) {
    case 1: err = launch_nt<1>(xf, w, sc, o, wk, ct, M, K, N, splits, kchunk, vecw, vecx, s); break;
    case 2: err = launch_nt<2>(xf, w, sc, o, wk, ct, M, K, N, splits, kchunk, vecw, vecx, s); break;
    case 4: err = launch_nt<4>(xf, w, sc, o, wk, ct, M, K, N, splits, kchunk, vecw, vecx, s); break;
    case 8: err = launch_nt<8>(xf, w, sc, o, wk, ct, M, K, N, splits, kchunk, vecw, vecx, s); break;
    default: err = launch_nt<16>(xf, w, sc, o, wk, ct, M, K, N, splits, kchunk, vecw, vecx, s);
  }
  return (int)err;
}
