// dequant_matmul: y[m, n] = scale[n] * sum_k x[m, k] * float(q8[k, n]),
// fp32 activations against int8 weights with one fp32 scale per output
// channel, applied once after the whole sum.
//
// Replaces the JAX package's Pallas kernel repro/kernels/quant.py
// (dequant_matmul_kernel, body _dq_matmul_kernel).  Every projection of a
// quantized model reaches it: seven per layer per forward call.
//
//   x     [M, K] fp32, contiguous
//   q8    [K, N] int8, contiguous (N fastest)
//   scale [N] fp32
//   out   [M, N] fp32
//   work  [splits, M, N] fp32 partial sums, or null when splits == 1
//
// What bounds it on an H100: the int8 weight bytes.  At the main path's M
// (8 rows for a tree verify, 1 for a decode) a call moves K*N weight bytes
// plus 4*(M*K + M*N + N), and does 2*M*K*N fp32 operations; at M = 8,
// K = 8192, N = 28672 the bytes take 70 us at 3.35 TB/s and the operations
// 56 us at the CUDA cores' 67 TFLOP/s, so the design must waste neither
// bandwidth nor FMAs.
//
// Design.  A CTA of 256 threads owns 128 output columns, up to MT <= 8
// rows of x and one split of the K range.  Eight threads span the 128
// columns, each reading 16 int8 weights (one 16-byte load) of a K row, so
// a warp reads four whole 128-byte row segments; the other factor of 32
// splits K into slices (thread slice s takes rows s, s + 32, ...).  Each
// step stages 256 K rows of x in shared memory, transposed so that one
// thread's MT values of a row are two 16-byte reads.  A thread issues the
// next step's 8 weight loads and its x values into registers before it
// computes the current step, so both are in flight during its FMAs (at
// MT = 8 this takes about 250 registers, one CTA per SM; a variant with 8
// columns a thread and two CTAs per SM was slower at M = 1 and on
// w_down, and no faster elsewhere on the target).  Bytes become
// floats exactly with a byte permute and one add (no int-to-float
// conversion instruction), and every product is an explicit fmaf into
// fp32 registers.  The slices are then summed in a fixed order (warp
// shuffles over the four slices of a warp, then the eight warps in order
// through shared memory), and the K splits, if more than one, by a second
// kernel in split order, which also applies the scale.
//
// Sum order.  The split of K into CTAs depends on K and N only (chosen by
// the host, kernels/quant.py k_split), and a row's arithmetic does not
// depend on which other rows share its CTA or on MT, so a row of x gives
// the same bits at any M: decode (M = 1) and tree verify (M = 8) agree.
// No atomics.  Ragged M, K and N are masked here; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                      // columns per thread
constexpr int kThreadsN = 8;                   // threads across a tile
constexpr int kBlockN = kThreadsN * kCols;     // 128 columns per CTA
constexpr int kSlices = kThreads / kThreadsN;  // 32 K slices
constexpr int kBlockK = 256;                   // K rows staged per step
constexpr int kRowsPerStep = kBlockK / kSlices;  // 8 weight loads in flight
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMT = 8;
static_assert(kBlockK == kThreads, "a thread stages one K row of x a step");

// 16 int8 weights of one K row: one 16-byte load when the row segment is
// whole and aligned, else byte loads with the columns past N as zero.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p,
                                        int valid, bool vec) {
  if (vec && valid >= kCols) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < valid) {
      w[c >> 2] |= (uint32_t)(uint8_t)__ldg(p + c) << (8 * (c & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Four int8 bytes of `w` as exact floats: byte b becomes the float with
// the bits 0x4B000000 | (b ^ 0x80), which is 2^23 + b + 128, less
// 2^23 + 128.
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// What one thread loads for one step: its weights (rows ts + 32 * j of the
// step, 16 columns each) and its share of the x tile (K row kt + tid of
// each of the CTA's MT rows; kBlockK == kThreads).
template <int MT>
struct Step {
  uint4 w[kRowsPerStep];
  float x[MT];
};

template <int MT>
__device__ __forceinline__ void fetch(Step<MT>& st,
                                      const float* __restrict__ x,
                                      const int8_t* __restrict__ q8, int kt,
                                      int k_end, int ts, int M, int K, int N,
                                      int m0, int n0, int valid_n, bool vec) {
  const int kl = min(kBlockK, k_end - kt);
#pragma unroll
  for (int j = 0; j < kRowsPerStep; ++j) {
    const int kk = ts + kSlices * j;
    st.w[j] = make_uint4(0u, 0u, 0u, 0u);
    if (kk < kl && valid_n > 0) {
      st.w[j] = load16(q8 + (long long)(kt + kk) * N + n0, valid_n, vec);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    st.x[m] = (m0 + m < M && (int)threadIdx.x < kl)
                  ? x[(long long)(m0 + m) * K + kt + threadIdx.x]
                  : 0.f;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) dequant_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q8,
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ work, int M, int K, int N, int kchunk, int vec) {
  __shared__ __align__(16) float xs[kBlockK * MT];   // [k][m]
  __shared__ float red[kWarps][MT][kBlockN];

  const int tid = threadIdx.x;
  const int tn = tid % kThreadsN;
  const int ts = tid / kThreadsN;
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * kBlockN;
  const int n0 = col0 + tn * kCols;
  const int valid_n = N - n0;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  }

  Step<MT> cur, next;
  if (k_begin < k_end) {
    fetch(cur, x, q8, k_begin, k_end, ts, M, K, N, m0, n0, valid_n, vec != 0);
  }
  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    const int kl = min(kBlockK, k_end - kt);
    __syncthreads();   // the previous step's readers of xs are done
#pragma unroll
    for (int m = 0; m < MT; ++m) xs[tid * MT + m] = cur.x[m];
    __syncthreads();
    // the next step's loads are in flight while this step computes
    const bool more = kt + kBlockK < k_end;
    if (more) {
      fetch(next, x, q8, kt + kBlockK, k_end, ts, M, K, N, m0, n0, valid_n,
            vec != 0);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerStep; ++j) {
      const int kk = ts + kSlices * j;
      if (kk < kl) {
        float wf[kCols];
        unpack4(cur.w[j].x, wf);
        unpack4(cur.w[j].y, wf + 4);
        unpack4(cur.w[j].z, wf + 8);
        unpack4(cur.w[j].w, wf + 12);
        float xv[MT];
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MT; m += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xs + kk * MT + m);
            xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) xv[m] = xs[kk * MT + m];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(xv[m], wf[c], acc[m][c]);
        }
      }
    }
    if (more) cur = next;
  }

  // slices of one warp: lanes l, l ^ 8, l ^ 16, l ^ 24 share columns
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  }
  if (lane < kThreadsN) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][m][tn * kCols + c] = acc[m][c];
    }
  }
  __syncthreads();
  // the warps in order, then one store per output (the scale applied
  // here when K is not split)
  for (int i = tid; i < MT * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i - m * kBlockN;
    const int row = m0 + m;
    const int n = col0 + c;
    if (row >= M || n >= N) continue;
    float s = red[0][m][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][m][c];
    if (work) {
      work[((long long)blockIdx.z * M + row) * N + n] = s;
    } else {
      out[(long long)row * N + n] = s * scale[n];
    }
  }
}

// Sum the K splits' partials in split order and apply the scale.
__global__ void dequant_matmul_reduce(const float* __restrict__ work,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out, int M, int N,
                                      int splits) {
  const long long total = (long long)M * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = work[i];
  for (int z = 1; z < splits; ++z) s += work[z * total + i];
  out[i] = s * scale[i % N];
}

template <int MT>
cudaError_t launch_mt(const float* x, const int8_t* q8, const float* scale,
                      float* out, float* work, int M, int K, int N,
                      int splits, int kchunk, int vec, cudaStream_t stream) {
  dim3 grid((M + MT - 1) / MT, (N + kBlockN - 1) / kBlockN, splits);
  dequant_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      x, q8, scale, out, splits > 1 ? work : nullptr, M, K, N, kchunk, vec);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the first launch error (0 = success).  The
// caller allocates every buffer, `work` with splits * M * N floats when
// splits > 1.  Splits cover K: (splits - 1) * kchunk < K <= splits * kchunk.
extern "C" int dequant_matmul_launch(const void* x, const void* q8,
                                     const void* scale, void* out, void* work,
                                     int M, int K, int N, int splits,
                                     int kchunk, void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || kchunk < 1 ||
      (long long)splits * kchunk < K || (long long)(splits - 1) * kchunk >= K ||
      (splits > 1 && work == nullptr) || splits > 65535 ||
      (N + kBlockN - 1) / kBlockN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = (N % kCols == 0) && ((uintptr_t)q8 % 16 == 0);
  // rows per CTA: the smallest of 1, 2, 4, 8 that holds M, else 8
  const int mt = M >= 5 ? kMaxMT : M >= 3 ? 4 : M;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const int8_t* w = (const int8_t*)q8;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  float* wk = (float*)work;
  cudaError_t err;
  switch (mt) {
    case 1: err = launch_mt<1>(xf, w, sc, o, wk, M, K, N, splits, kchunk, vec, s); break;
    case 2: err = launch_mt<2>(xf, w, sc, o, wk, M, K, N, splits, kchunk, vec, s); break;
    case 4: err = launch_mt<4>(xf, w, sc, o, wk, M, K, N, splits, kchunk, vec, s); break;
    default: err = launch_mt<kMaxMT>(xf, w, sc, o, wk, M, K, N, splits, kchunk, vec, s);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  dequant_matmul_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      wk, sc, o, M, N, splits);
  return (int)cudaGetLastError();
}
