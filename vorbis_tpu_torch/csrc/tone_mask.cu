// The tone mask for NVIDIA Hopper (sm_90a), hand-written CUDA: one block
// per row (a frame's channel), the row's working set in shared memory.
//
// Replaces no TPU kernel.  The JAX package runs this stage as jitted XLA:
// vorbis_tpu/ops/jaxdsp.py DeviceToneMask.__call__ (:477-558), lib/psy.c's
// _vp_tonemask / seed_loop / seed_chase / max_seeds in the fast path's
// device form, whose seed deposit is 56 static gathers and a running max
// over the (rows, lines) seed buffer in device memory (its own TODO at
// :508-510 asks for the buffer to stay on chip).  For each row of the log
// FFT spectrum logfft (n) and its global and local spectral maxima it
// computes:
//   1. the ATH floor flr = ath + max(local + ath_adjatt, ath_maxatt);
//   2. the max of each octave group (a contiguous span of bins), its curve
//      row band * p_levels + clamp(int(((gmax + (max_curve_dB - global)) -
//      30) * 0.1), 0, p_levels - 1), the row's [post0, post1) and whether
//      the group is audible (gmax + 6 > flr at its first bin);
//   3. the seed deposit: an audible group g that owns octave line b_g puts
//      gmax + curve[2 + k] on line b_g + (k - 16) * linesper - linesper / 2
//      for each k in [post0, post1), lines 1..T-1, the max of the deposits
//      a line (-9999 where none);
//   4. the chase: the max over the line and the linesper - 1 lines below;
//   5. the windowed min back in the linear domain: the min of the chased
//      lines (+inf where unseeded) over each bin's window [lo, hi], clamped
//      at tone_abs_limit where finite, -9999 where not; then the max with
//      flr -> tone (n) float32.
// The plain PyTorch version is vorbis_tpu_torch/ops/tone_mask_cuda.py
// tone_mask_plain (the JAX package's passes, op for op).
//
// The tables of one look come as one int32 blob with a header of offsets
// (ops/tone_mask_cuda.py pack_blob, which defines the layout): each bin's
// group and window, the ATH, each group's first bin, band and owned line,
// each window's [lo, hi], the 136 x 58 curve rows and four constants.  They
// stay in global memory and are read through the read-only path: every
// block reads the same few tens of KB, which L1 and L2 hold.
//
// What bounds it on this card.  Bytes: at 4d's long batch (4,096 rows of
// n = 1,024) it reads logfft (16.8 MB) and writes the tone (16.8 MB), about
// 33.6 MB, 10.0 us at 3.35 TB/s.  Its operations are a few a bin, a few a
// line and up to 56 deposits an audible group, a few thousand a row.
//
// How the design runs it, a block a row, the phases apart by barriers:
//  * the group max from the coalesced row: a warp takes 32 bins, a
//    segmented max by 5 shuffles (groups are contiguous, so a lane d below
//    in the same group means every lane between is), and the last lane of
//    each segment an atomicMax into the group's word;
//  * a thread a group: level, curve row, audibility, then its deposits, an
//    atomicMax a line;
//  * a thread a line: the chase over linesper words;
//  * a thread a window: the min over its lines, then the clamp;
//  * a thread a bin: the floor and the coalesced store.
// Shared memory holds G + T words of maxima, T of chased lines and W of
// window minima: 8,744 bytes at the 44.1 kHz long look (G = 316, T = 777,
// W = 316), 5,664 at its short one.
//
// Exactness: every output is bitwise the plain version's.  Its float
// operations are a handful of adds, one subtract and one multiply, each
// taken with an explicit round-to-nearest intrinsic in the plain version's
// order (and the build has -fmad=false), the level truncated toward zero
// as torch's int32 conversion does; the rest are max, min and selects,
// exact in any order.  The atomic maxima are integer: a float's bits,
// negatives with the magnitude bits flipped, order as the floats do, so
// the max of the words is the word of the max.  torch.maximum and minimum
// propagate NaN where fmaxf and fminf drop it: no NaN reaches this kernel,
// since logfft is todB's bit pattern scaled and shifted by constants,
// finite for every input, and the spectral maxima are its clamped max and
// that max's decay recurrence.  No -0.0 arises either: each sum has a
// nonzero or positive operand (the tables hold no -0.0, checked by
// tests/test_torch_tone_mask.py), so max and min see no signed zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the blob's header words (ops/tone_mask_cuda.py HEADER)
enum {
  H_N, H_T, H_G, H_W, H_LINESPER, H_PLEVELS, H_NCURVES, H_CURVEW,
  H_BIN_GROUP, H_BIN_WIN, H_ATH, H_GFIRST, H_GBAND, H_GBASE, H_WLO, H_WHI,
  H_CURVES, H_LIMIT, H_ADJATT, H_MAXATT, H_MAXCURVE, H_EHMER, H_EHOFF,
  H_WORDS, H_SIZE
};

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -9999.0f;  // ops/psy.py NEGINF
constexpr float kLevel0 = 30.0f;     // P_LEVEL_0
constexpr float kTenth = 0.1f;       // float32(0.1)

// a float's bits as an int whose order is the floats' (no NaN)
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int e) {
  return __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

__global__ void __launch_bounds__(kThreads)
tone_mask_kernel(const float* __restrict__ logfft,
                 const float* __restrict__ gspec,
                 const float* __restrict__ lspec,
                 const int* __restrict__ blob, float* __restrict__ out) {
  extern __shared__ int smem[];
  const int n = __ldg(blob + H_N), T = __ldg(blob + H_T);
  const int G = __ldg(blob + H_G), W = __ldg(blob + H_W);
  const int lp = __ldg(blob + H_LINESPER), plev = __ldg(blob + H_PLEVELS);
  const int cw = __ldg(blob + H_CURVEW);
  const int ehmer = __ldg(blob + H_EHMER), ehoff = __ldg(blob + H_EHOFF);
  const int* bin_group = blob + __ldg(blob + H_BIN_GROUP);
  const int* bin_win = blob + __ldg(blob + H_BIN_WIN);
  const float* ath =
      reinterpret_cast<const float*>(blob + __ldg(blob + H_ATH));
  const int* g_first = blob + __ldg(blob + H_GFIRST);
  const int* g_band = blob + __ldg(blob + H_GBAND);
  const int* g_base = blob + __ldg(blob + H_GBASE);
  const int* w_lo = blob + __ldg(blob + H_WLO);
  const int* w_hi = blob + __ldg(blob + H_WHI);
  const float* curves =
      reinterpret_cast<const float*>(blob + __ldg(blob + H_CURVES));
  const float limit = __int_as_float(__ldg(blob + H_LIMIT));
  const float adjatt = __int_as_float(__ldg(blob + H_ADJATT));
  const float maxatt = __int_as_float(__ldg(blob + H_MAXATT));
  const float maxcurve = __int_as_float(__ldg(blob + H_MAXCURVE));

  int* s_gmax = smem;                                   // G
  int* s_seed = s_gmax + G;                             // T
  float* s_run = reinterpret_cast<float*>(s_seed + T);  // T
  float* s_win = s_run + T;                             // W

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const float* x = logfft + (size_t)row * n;
  const float g_spec = __ldg(gspec + row), l_spec = __ldg(lspec + row);

  for (int g = tid; g < G; g += kThreads) s_gmax[g] = ordered(-INFINITY);
  for (int t = tid; t < T; t += kThreads) s_seed[t] = ordered(kNegInf);
  __syncthreads();

  // 1. the group max: a segmented max a warp of 32 bins
  for (int base = tid - lane; base < n; base += kThreads) {
    const int j = base + lane;
    const bool in = j < n;
    int v = in ? ordered(__ldg(x + j)) : INT32_MIN;
    const int gid = in ? __ldg(bin_group + j) : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ov = __shfl_up_sync(kFull, v, d);
      const int og = __shfl_up_sync(kFull, gid, d);
      if (lane >= d && og == gid) v = max(v, ov);
    }
    const int next = __shfl_down_sync(kFull, gid, 1);
    if (in && (lane == 31 || j == n - 1 || next != gid))
      atomicMax(s_gmax + gid, v);
  }
  __syncthreads();

  // 2-3. a thread a group: its curve row and its deposits
  const float att = fmaxf(__fadd_rn(l_spec, adjatt), maxatt);
  const float dboffset = __fsub_rn(maxcurve, g_spec);
  for (int g = tid; g < G; g += kThreads) {
    const int b = __ldg(g_base + g);
    const float gm = unordered(s_gmax[g]);
    const float flr = __fadd_rn(__ldg(ath + __ldg(g_first + g)), att);
    if (b < 0 || !(__fadd_rn(gm, 6.0f) > flr)) continue;
    int level = __float2int_rz(
        __fmul_rn(__fsub_rn(__fadd_rn(gm, dboffset), kLevel0), kTenth));
    level = min(max(level, 0), plev - 1);
    const float* c = curves + (size_t)(__ldg(g_band + g) * plev + level) * cw;
    const int k0 = max(__float2int_rz(__ldg(c)), 0);
    const int k1 = min(__float2int_rz(__ldg(c + 1)), ehmer);
    const int off = b - ehoff * lp - (lp >> 1);
    for (int k = k0; k < k1; ++k) {
      const int t = off + k * lp;
      if (t >= 1 && t < T)
        atomicMax(s_seed + t, ordered(__fadd_rn(gm, __ldg(c + 2 + k))));
    }
  }
  __syncthreads();

  // 4. the chase, and +inf where no seed reached
  for (int t = tid; t < T; t += kThreads) {
    int m = s_seed[t];
    for (int s = 1; s < lp && s <= t; ++s) m = max(m, s_seed[t - s]);
    const float e = unordered(m);
    s_run[t] = e > kNegInf ? e : INFINITY;
  }
  __syncthreads();

  // 5. the windowed min, clamped where a seed reached
  for (int w = tid; w < W; w += kThreads) {
    const int hi = min(__ldg(w_hi + w), T - 1);
    float m = INFINITY;
    for (int t = __ldg(w_lo + w); t <= hi; ++t) m = fminf(m, s_run[t]);
    s_win[w] = isfinite(m) ? fminf(m, limit) : kNegInf;
  }
  __syncthreads();

  float* o = out + (size_t)row * n;
  for (int j = tid; j < n; j += kThreads)
    o[j] = fmaxf(__fadd_rn(__ldg(ath + j), att), s_win[__ldg(bin_win + j)]);
}

size_t smem_bytes(int G, int T, int W) {
  return (size_t)(G + 2 * T + W) * sizeof(int);
}

}  // namespace

// tone (rows, n) of logfft (rows, n) float32 and the spectral maxima
// (rows,) under the look's blob (`words` int32 words, G groups, T lines,
// W windows): one block a row on `stream`.  Returns the launch's
// cudaError_t.
extern "C" int vtt_tone_mask(const void* logfft, const void* gspec,
                             const void* lspec, const void* blob, int words,
                             int G, int T, int W, void* out, int rows,
                             void* stream) {
  if (rows < 0 || words < H_SIZE || G < 1 || T < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, T, W);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  tone_mask_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logfft, (const float*)gspec, (const float*)lspec,
      (const int*)blob, (float*)out);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block takes (into *smem) and the blocks an SM
// holds at once (-1 on an error), for reports.
extern "C" int vtt_tone_mask_blocks_per_sm(int G, int T, int W, int* smem) {
  *smem = (int)smem_bytes(G, T, W);
  int b = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, tone_mask_kernel, kThreads, *smem) != cudaSuccess)
    return -1;
  return b;
}
