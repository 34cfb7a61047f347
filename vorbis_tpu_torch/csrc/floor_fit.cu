// floor1 greedy post fit for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Replaces: vorbis_tpu/ops/floor_pallas.py DeviceFloorFitPallas._build_kernel
// (the TPU Pallas kernel, launched by _call_for).  Computes what
// vorbis_tpu/ops/floor_device.py DeviceFloorFit.__call__ computes in its
// greedy loop and final walk (floor_device.py:210-346; reference
// lib/floor1.c floor1_fit): for each sort position 2..P-1, the closed-form
// least-squares fit_line from prefix moments, inspect_error (closed-form DDA
// render checked against the quantized mask with maxover/maxunder/maxerr),
// the fitA/fitB split, neighbour-run propagation, and the final walk that
// sets the 0x8000 interpolation flags.  The plain PyTorch version of the
// same function is vorbis_tpu_torch/ops/floor_device.py DeviceFloorFit.fit.
//
// What bounds it on this card: latency of the serial loop, not bytes.  A
// chunk of B = 2048 frames reads about 10 MB (quant 8 MB, above 2 MB,
// prefix 1.4 MB), a few microseconds of HBM time; each frame then runs
// 27 dependent steps, each a short scalar chain (two divisions, a rint,
// table lookups) around one reduction over a bin range of ~35 bins on
// average.
//
// What the design does about that: one block of 128 threads per frame, so
// the 2048 frames of a chunk fill all 132 SMs in a single wave and the
// per-frame serial chains of many blocks overlap each other.  The frame's
// quant row, above flags, prefix moments and all fit state live in shared
// memory for the whole loop, so the serial steps touch no global memory.
// inspect strides the block over [lx, hx) only (the TPU kernel masked the
// full row because its lanes are fixed-width) and reduces the integer mse
// and the any-over flag with warp shuffles; thread 0 runs the scalar steps.
//
// Exactness: the posts equal the plain version's bit for bit.  Build with
// -fmad=false (nvcc would otherwise contract a + b*x into an FMA and move
// rint ties in fit_line and the render), never with --use_fast_math; the
// divisions are IEEE (the default -prec-div=true), rintf rounds half to
// even like torch.round, values are clamped before the int cast, and mse is
// an int32 sum (<= 1023^2 * 1024 < 2^31) with C's truncating mse / cnt.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPosts = 65;   // floor1 allows at most 65 posts
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNeg = -200;

__device__ __forceinline__ int render_point(int x0, int x1, int y0, int y1,
                                            int x) {
  // floor1.c render_point closed form; the f32 divide + truncation is exact
  // here (err <= 1023*1024 and adx <= 1024 are exact in f32, and the quotient
  // sits >= 0.5/adx from every integer)
  y0 &= 0x7FFF;
  y1 &= 0x7FFF;
  const int dy = y1 - y0;
  const int adx = x1 - x0;
  const int err = abs(dy) * (x - x0);
  const int off = (int)(((float)err + 0.5f) / (float)max(adx, 1));
  return dy < 0 ? y0 - off : y0 + off;
}

struct FrameState {
  int fitA[kMaxPosts];
  int fitB[kMaxPosts];
  int lon[kMaxPosts];
  int hin[kMaxPosts];
  int memo[kMaxPosts];
  int out[kMaxPosts];
  int rev[kMaxPosts];
  int postlist[kMaxPosts];
  int sx[kMaxPosts];
  int lo_static[kMaxPosts];
  int hi_static[kMaxPosts];
  float prefix[kMaxPosts * 6];
  int red_mse[kWarps];
  int red_over[kWarps];
};

__device__ __forceinline__ int post_y(const FrameState& s, int idx) {
  const int a = s.fitA[idx];
  const int b = s.fitB[idx];
  return a < 0 ? b : (b < 0 ? a : (a + b) >> 1);
}

__device__ __forceinline__ int fit_point(float a, float b, float x) {
  float v = rintf(a + b * x);
  v = fminf(fmaxf(v, 0.0f), 1023.0f);
  return (int)v;
}

// weighted LS fit over segments [s0, s1) evaluated at x0 and x1; returns
// true (and y0 = y1 = 0) for a degenerate fit
__device__ bool fit_line(const FrameState& s, int s0, int s1, float x0,
                         float x1, int* y0, int* y1) {
  const float* lo = s.prefix + s0 * 6;
  const float* hi = s.prefix + s1 * 6;
  const float xb = hi[0] - lo[0];
  const float yb = hi[1] - lo[1];
  const float x2b = hi[2] - lo[2];
  const float xyb = hi[4] - lo[4];
  const float bn = hi[5] - lo[5];
  const float denom = bn * x2b - xb * xb;
  const bool bad = denom <= 0.0f;
  const float d = bad ? 1.0f : denom;
  const float a = (yb * x2b - xyb * xb) / d;
  const float b = (bn * xyb - xb * yb) / d;
  *y0 = bad ? 0 : fit_point(a, b, x0);
  *y1 = bad ? 0 : fit_point(a, b, x1);
  return bad;
}

__global__ void __launch_bounds__(kThreads)
floor_fit_kernel(const int* __restrict__ quant,
                 const uint8_t* __restrict__ above,
                 const float* __restrict__ prefix,
                 const int* __restrict__ tabs, int* __restrict__ out, int n,
                 int P, float maxover, float maxunder, float maxerr,
                 float maxover2, float maxunder2) {
  extern __shared__ int dyn[];
  int* s_quant = dyn;                                   // n ints
  uint8_t* s_above = reinterpret_cast<uint8_t*>(dyn + n);  // n bytes
  __shared__ FrameState s;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* q_row = quant + (size_t)row * n;
  const uint8_t* a_row = above + (size_t)row * n;
  for (int x = tid; x < n; x += kThreads) {
    s_quant[x] = q_row[x];
    s_above[x] = a_row[x];
  }
  const float* p_row = prefix + (size_t)row * P * 6;
  for (int k = tid; k < P * 6; k += kThreads) s.prefix[k] = p_row[k];
  for (int k = tid; k < P; k += kThreads) {
    s.rev[k] = tabs[k];
    s.postlist[k] = tabs[P + k];
    s.sx[k] = tabs[2 * P + k];
    s.lo_static[k] = tabs[3 * P + k];
    s.hi_static[k] = tabs[4 * P + k];
    s.fitA[k] = kNeg;
    s.fitB[k] = kNeg;
    s.lon[k] = 0;
    s.hin[k] = 1;
    s.memo[k] = -1;
  }
  __syncthreads();
  if (tid == 0) {
    int y0, y1;
    fit_line(s, 0, P - 1, (float)s.postlist[0], (float)s.sx[P - 1], &y0,
             &y1);
    s.fitA[0] = s.fitB[0] = y0;
    s.fitA[1] = s.fitB[1] = y1;
  }
  __syncthreads();

  for (int i = 2; i < P; i++) {
    // every thread reads the (stable) state it needs for inspect
    const int sortpos = s.rev[i];
    const int ln = s.lon[sortpos];
    const int hn = s.hin[sortpos];
    const int lx = s.postlist[ln];
    const int hx = s.postlist[hn];
    const int ly = post_y(s, ln);
    const int hy = post_y(s, hn);

    // inspect_error over [lx, hx), strided over the block
    int mse = 0;
    int over = 0;
    for (int x = lx + tid; x < hx; x += kThreads) {
      const int q = s_quant[x];
      const int y = render_point(lx, hx, ly, hy, x);
      const int diff = y - q;
      mse += diff * diff;
      if (s_above[x] && (x == lx || q != 0)) {
        const float yf = (float)y;
        const float qf = (float)q;
        if (yf + maxover < qf || yf - maxunder > qf) over = 1;
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      mse += __shfl_xor_sync(0xffffffffu, mse, o);
    over = __any_sync(0xffffffffu, over);
    if (lane == 0) {
      s.red_mse[warp] = mse;
      s.red_over[warp] = over;
    }
    __syncthreads();

    if (tid == 0) {
      int mse_t = 0;
      int hard = 0;
      for (int w = 0; w < kWarps; w++) {
        mse_t += s.red_mse[w];
        hard |= s.red_over[w];
      }
      const bool already = s.memo[ln] == hn;
      s.memo[ln] = hn;
      const int cnti = max(hx - lx, 1);
      const float cnt = (float)cnti;
      const bool rough_ok = (maxover2 / cnt > maxerr) ||
                            (maxunder2 / cnt > maxerr);
      const bool mse_bad = (float)(mse_t / cnti) > maxerr;
      const bool bad = hard || (!rough_ok && mse_bad);
      const bool act = bad && !already;

      const int lsort = s.rev[ln];
      const int hsort = s.rev[hn];
      const float sp_x = (float)s.sx[sortpos];
      int ly0, ly1, hy0, hy1;
      const bool ret0 = fit_line(s, lsort, sortpos, (float)lx, sp_x, &ly0,
                                 &ly1);
      const bool ret1 = fit_line(s, sortpos, hsort, sp_x, (float)hx, &hy0,
                                 &hy1);
      // degenerate handling (floor1.c:668-684), in the reference's order
      if (ret0) {
        ly0 = ly;
        ly1 = hy0;
      }
      if (ret1) {
        hy0 = ly1;
        hy1 = hy;
      }
      const bool both = ret0 && ret1;
      const bool upd = act && !both;
      if (upd) {
        s.fitB[ln] = ly0;
        if (ln == 0) s.fitA[0] = ly0;
        s.fitA[i] = ly1;
        s.fitB[i] = hy0;
        s.fitA[hn] = hy1;
        if (hn == 1) s.fitB[hn] = hy1;
        // neighbour propagation: the contiguous runs of matching
        // neighbours adjacent to sortpos take post i
        if (ly1 >= 0 || hy0 >= 0) {
          for (int j = sortpos - 1; j >= 0 && s.hin[j] == hn; j--)
            s.hin[j] = i;
          for (int j = sortpos + 1; j < P && s.lon[j] == ln; j++)
            s.lon[j] = i;
        }
      } else if (act) {
        s.fitA[i] = kNeg;
        s.fitB[i] = kNeg;
      }
    }
    __syncthreads();
  }

  // final output walk (floor1.c:735-750) with the static decode-side
  // neighbours
  if (tid == 0) {
    s.out[0] = post_y(s, 0);
    s.out[1] = post_y(s, 1);
    for (int i = 2; i < P; i++) {
      const int ln0 = s.lo_static[i - 2];
      const int hn0 = s.hi_static[i - 2];
      const int pred = render_point(s.postlist[ln0], s.postlist[hn0],
                                    s.out[ln0], s.out[hn0], s.postlist[i]);
      const int vx = post_y(s, i);
      s.out[i] = (vx >= 0 && pred != vx) ? vx : (pred | 0x8000);
    }
  }
  __syncthreads();
  for (int k = tid; k < P; k += kThreads) out[(size_t)row * P + k] = s.out[k];
}

}  // namespace

// C entry point, bound with ctypes.  All pointers are device pointers of
// C-contiguous tensors: quant (B, n) int32, above (B, n) bool, prefix
// (B, P, 6) float32, tabs (5, P) int32 [rev, postlist, sorted_x,
// lo_static, hi_static], out (B, P) int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronizes nor allocates.
extern "C" int vtt_floor_fit(const void* quant, const void* above,
                             const void* prefix, const void* tabs, void* out,
                             int B, int n, int P, float maxover,
                             float maxunder, float maxerr, float maxover2,
                             float maxunder2, void* stream) {
  if (P < 2 || P > kMaxPosts || n <= 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)n * sizeof(int) + (((size_t)n + 3) & ~(size_t)3);
  floor_fit_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(quant), static_cast<const uint8_t*>(above),
      static_cast<const float*>(prefix), static_cast<const int*>(tabs),
      static_cast<int*>(out), n, P, maxover, maxunder, maxerr, maxover2,
      maxunder2);
  return (int)cudaGetLastError();
}
