// The floor fit's prepare as one Hopper kernel: the dB quantization of
// the mask, the above/below classes, the bin -> segment moments and
// their weighted prefix sums, from the spectra to what the greedy fit
// (csrc/floor_fit.cu) reads.
//
// Replaces no Pallas kernel: it stands for the quantization, the
// classes and `_moments` that the JAX package runs as jitted XLA around
// its Pallas fit (vorbis_tpu/ops/floor_device.py:114-145 and :199-208,
// lib/floor1.c floor1_fit's accumulate_fit), which the port ran as about
// 70 small PyTorch launches a fit (ops/floor_device.py `prepare`,
// `_moments`: a float64 matmul and a float64 cumsum among them).
//
// What bounds it on an H100: the bytes.  A long finish batch of 4,096
// rows of n = 1,024 reads logmdct and logmask (33.6 MB) and writes
// quant, above and the (P, 6) prefix rows (23.9 MB); the arithmetic is
// a dozen integer operations a bin and a few float operations a
// segment.
//
// Design: one CTA a row.  Phase 1, a thread a bin: quant = the
// saturating truncation of fma(logmask, scale, offset) clamped to [0,
// 1023] (__fmaf_rn, __float2int_rz: torch's CUDA cast), above =
// logmdct + atten >= logmask (one add), both written out and kept in
// shared memory.  Phase 2, a warp a segment: 32 bins of the segment's
// inclusive window a step, each step's six features (x, q, x^2, q^2,
// x q, 1) of the used bins above and below summed over the warp by one
// redux.sync each and added to int64 sums, exact in any order (the
// first cut kept a lane's sums in int64 and reduced them by shuffle
// trees: 120 shuffles a segment whatever its width); lane 0 converts each sum once with __ll2float_rn
// (what the plain version's exact float64 matmul rounds to) and forms
// the weight (bn + an) tw / (an + 1) + 1 and the weighted
// moments Bv + A w in float32, one rounding an operation (__fmul_rn,
// __fdiv_rn, __fadd_rn; built with -fmad=false besides).  Phase 3, a
// thread a feature: the prefix over the segments in float64, one
// segment after another as the CPU's torch.cumsum adds them, each
// rounded once to float32; the row's prefix goes out from shared
// memory, and `used` is whether any segment has a bin above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// shared memory of a row: quant (n int32), the weighted moments (S x 6
// float32), the prefix (P x 6 float32), the above counts (S int32),
// above (n bytes)
__host__ __device__ inline int shared_bytes(int n, int P) {
  const int S = P - 1;
  return 4 * (n + 6 * S + 6 * P + S) + n;
}

__global__ void __launch_bounds__(kThreads)
    floor_prepare_kernel(const float* __restrict__ logmdct,
                         const float* __restrict__ logmask,
                         const int* __restrict__ seg, int n, int P,
                         float scale, float offset, float atten, float tw,
                         int* __restrict__ quant,
                         unsigned char* __restrict__ above,
                         float* __restrict__ prefix,
                         unsigned char* __restrict__ used) {
  extern __shared__ int smem[];
  const int S = P - 1;
  int* q_s = smem;
  float* wm_s = reinterpret_cast<float*>(q_s + n);
  float* pre_s = wm_s + 6 * S;
  int* an_s = reinterpret_cast<int*>(pre_s + 6 * P);
  unsigned char* ab_s = reinterpret_cast<unsigned char*>(an_s + S);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x;
  const float* md = logmdct + row * n;
  const float* mk = logmask + row * n;

  // phase 1: a thread a bin
  for (int i = t; i < n; i += kThreads) {
    const float m = __ldg(mk + i);
    const int q = min(max(__float2int_rz(__fmaf_rn(m, scale, offset)), 0),
                      1023);
    const unsigned char a = __fadd_rn(__ldg(md + i), atten) >= m;
    quant[row * n + i] = q;
    above[row * n + i] = a;
    q_s[i] = q;
    ab_s[i] = a;
  }
  __syncthreads();

  // phase 2: a warp a segment, 32 bins a step; each step's six features
  // above and below summed over the warp in 32 bits (a bin's feature is
  // below 2^26 for n <= 8,192, so 32 of them are below 2^31) and added
  // to int64 sums, exact in any order
  for (int s = warp; s < S; s += kWarps) {
    const int lo = __ldg(seg + s), hi = __ldg(seg + S + s);
    long long A[6] = {0, 0, 0, 0, 0, 0}, B[6] = {0, 0, 0, 0, 0, 0};
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const unsigned q = i < hi ? (unsigned)q_s[i] : 0u;
      const unsigned x = i;
      const unsigned f[6] = {x, q, x * x, q * q, x * q, 1u};
      const bool a = q != 0 && ab_s[i], b = q != 0 && !ab_s[i];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        A[k] += __reduce_add_sync(kFull, a ? f[k] : 0u);
        B[k] += __reduce_add_sync(kFull, b ? f[k] : 0u);
      }
    }
    if (lane == 0) {
      float a[6], b[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a[k] = __ll2float_rn(A[k]);
        b[k] = __ll2float_rn(B[k]);
      }
      // (bn + an) * tw / (an + 1) + 1, then Bv + A * w
      const float w = __fadd_rn(
          __fdiv_rn(__fmul_rn(__fadd_rn(b[5], a[5]), tw),
                    __fadd_rn(a[5], 1.0f)),
          1.0f);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        wm_s[6 * s + k] = __fadd_rn(b[k], __fmul_rn(a[k], w));
      an_s[s] = A[5] != 0;
    }
  }
  __syncthreads();

  // phase 3: a thread a feature, the prefix in float64 in segment order
  if (t < 6) {
    double acc = 0.0;
    pre_s[t] = 0.0f;
    for (int s = 0; s < S; ++s) {
      acc = __dadd_rn(acc, (double)wm_s[6 * s + t]);
      pre_s[6 * (s + 1) + t] = __double2float_rn(acc);
    }
  } else if (t == 6) {
    int any = 0;
    for (int s = 0; s < S; ++s) any |= an_s[s];
    used[row] = any != 0;
  }
  __syncthreads();
  float* prow = prefix + row * 6 * P;
  for (int i = t; i < 6 * P; i += kThreads) prow[i] = pre_s[i];
}

}  // namespace

// logmdct, logmask (B, n) float32 and seg (2, P - 1) int32 (each
// segment's first bin, then its end) -> quant (B, n) int32, above (B, n)
// bool, prefix (B, P, 6) float32, used (B,) bool, on `stream`.  Returns
// the launch's cudaError_t.
extern "C" int vtt_floor_prepare(const float* logmdct, const float* logmask,
                                 const int* seg, int B, int n, int P,
                                 float scale, float offset, float atten,
                                 float tw, int* quant, unsigned char* above,
                                 float* prefix, unsigned char* used,
                                 cudaStream_t stream) {
  // n <= 8,192 keeps a step's 32-bit warp sums exact (phase 2)
  if (B < 1 || n < 1 || n > 8192 || P < 2)
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(n, P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        floor_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  floor_prepare_kernel<<<B, kThreads, smem, stream>>>(
      logmdct, logmask, seg, n, P, scale, offset, atten, tw, quant, above,
      prefix, used);
  return (int)cudaGetLastError();
}

// for the report: the shared bytes a block of a row of n bins and P
// posts (through *smem) and the blocks of it an SM can hold, or -1
extern "C" int vtt_floor_prepare_blocks_per_sm(int n, int P, int* smem) {
  *smem = shared_bytes(n, P);
  if (*smem > 48 * 1024 &&
      cudaFuncSetAttribute(floor_prepare_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, floor_prepare_kernel, kThreads, *smem) != cudaSuccess)
    return -1;
  return blocks;
}
