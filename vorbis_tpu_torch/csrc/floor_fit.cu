// floor1 greedy post fit for NVIDIA Hopper (sm_90a), hand-written CUDA:
// one warp per frame, several frames per block.
//
// Replaces: vorbis_tpu/ops/floor_pallas.py DeviceFloorFitPallas._build_kernel
// (the TPU Pallas kernel, launched by _call_for), and the earlier version of
// this file, which ran one 128-thread block per frame with the scalar steps
// on thread 0 between two block barriers per greedy step.  Computes what
// vorbis_tpu/ops/floor_device.py DeviceFloorFit.__call__ computes in its
// greedy loop and final walk (floor_device.py:210-346; reference
// lib/floor1.c floor1_fit): for each sort position 2..P-1, the closed-form
// least-squares fit_line from prefix moments, inspect_error (the DDA render
// checked against the quantized mask with maxover/maxunder/maxerr), the
// fitA/fitB split, neighbour-run propagation, and the final walk that sets
// the 0x8000 interpolation flags.  The plain PyTorch version of the same
// function is vorbis_tpu_torch/ops/floor_device.py DeviceFloorFit.fit.
//
// What bounds it on this card.  Bytes: a chunk of B = 2048 frames at
// n = 1024, P = 29 reads quant 8.39 MB, above 2.10 MB and prefix 1.43 MB and
// writes 0.24 MB, 12.15 MB in all, 3.6 us at 3.35 TB/s.  The operations are
// of the same order: the bins the data needs (the steps whose pair is new,
// each up to its first bin over the limits) at 20 integer operations a bin,
// and the steps' own work, at the card's int32 rate of 64 lanes a SM a
// clock (16.7e12 a second); chip_smoke.py counts both terms on real spectra
// and prints the larger as the bound.  The real
// floor is the dependent chain of each frame: 27 greedy steps, each a short
// scalar chain around one small reduction, then the final walk.  With every frame
// resident at once the kernel lasts as long as its slowest warp, so what
// counts is the instructions on one warp's path.
//
// How the design shortens that chain:
//  * One warp per frame (kWarps frames per block): the greedy loop has no
//    block barrier, only shuffles, ballots, warp reductions and
//    __syncwarp.  At B = 2048 that is 512 blocks, about 15.5 warps per SM,
//    all resident in one wave.
//  * The per-post state lives in registers across the lanes: lane k holds
//    the state of posts k, k+32 and k+64 (NS slots; floor1's limit is
//    P <= 65), packed so that a step reads another post's state with one
//    __shfl_sync: fitA, fitB and memo of a post in one word, lon and hin of
//    a sort position in another.
//  * The two fit_lines of a step depend only on ln, hn and sortpos, not on
//    inspect: lanes 0-15 fit the left segment run and lanes 16-31 the right
//    one, and lane bit 3 picks the numerator (a or b), so each lane runs
//    one IEEE division, ahead of the inspect loop.  A warp issues in
//    order, so the division's latency stays on the step's chain; the
//    split keeps that chain to one division.
//  * A step whose neighbour pair was inspected before (memo) changes
//    nothing and is skipped whole, as floor1.c skips it.
//  * inspect strides the warp over [lx, hx) with an exact integer DDA in
//    place of the per-bin division: each lane's first bin in closed form,
//    then a constant quotient-and-remainder step per stride of 32.  The
//    over test is one unsigned range check on q - y (the limits are
//    integral); the scan stops at the first 128 bins that hold a bin over
//    the limits (__any_sync), since the step is then bad whatever its
//    error; otherwise the int32 mse is summed with one warp reduction
//    (redux.sync).  The two per-step tests
//    that only depend on the bin count are thresholds computed once per
//    launch: the rough-error test (maxover^2 / cnt > maxerr ...) holds
//    exactly for cnt <= rough_max, and (float)(mse / cnt) > maxerr exactly
//    when mse >= mse_k * cnt.
//  * Neighbour propagation runs in parallel: ballots find the nearest
//    position below sortpos whose hin differs from hn and the nearest above
//    it whose lon differs from ln, and every lane updates its own posts in
//    between.
//  * The final walk only chains through posts that were never fitted: a
//    fitted post's low 15 bits are its own value whatever its predictor, so
//    the walk resolves the unfitted posts in passes over the lanes, as
//    many as the longest chain of unfitted neighbours, and then sets every
//    flag at once.
//  * The row load is asynchronous: cp.async brings the prefix (group 0) and
//    the quant and above rows (group 1) into the warp's shared memory; the
//    initial fit_line waits for the prefix only, so the rows land while it
//    runs.
//
// Exactness: the posts equal the plain version's bit for bit.  Build with
// -fmad=false (nvcc would otherwise contract a + b*x into an FMA and move
// rint ties in fit_line), never with --use_fast_math; the divisions of
// fit_line are IEEE (the default -prec-div=true), rintf rounds half to even
// like torch.round, values are clamped before the int cast, and mse is an
// int32 sum (at most 1023^2 * 2048 < 2^31).  The host computes rough_max
// with the same IEEE float divisions as the plain version, and the test
// falls as cnt grows (correctly rounded division is monotone), so it holds
// exactly on [1, rough_max].  (float)(mse / cnt) > maxerr with C's
// truncating division is exact in f32 (mse / cnt < 2^21) and, for an
// integer, means mse / cnt >= floor(maxerr) + 1 = mse_k, that is
// mse >= mse_k * cnt.  The over test yf + maxover < qf || yf - maxunder > qf
// is exact in f32 for integral limits below 2^20 and integers y, q, so it
// equals q - y > maxover || q - y < -maxunder; the entry point refuses
// other limits (every floor1 template uses 60 and 30).
//
// The render (inspect and the final walk) is integer: off = err / adx with
// err = |dy| * (x - x0), C's truncating division, as floor1.c render_point
// computes it.  The plain version computes trunc((err + 0.5f) / adx) in f32;
// the two agree for every n the templates use (12 for the 5.1 LFE, 128,
// 256, 512, 1024, and 2048 for the long floor of q = -0.1 at 44.1 kHz).
// Posts are at most 1023, so err <= 1023 * (n - 1) <= 1023 * 2047 < 2^21 and
// err + 0.5 and adx <= n are exact in f32.  Write err = m * adx + r with
// 0 <= r < adx: the exact quotient m + (r + 0.5) / adx lies at least
// 0.5 / adx >= 0.5 / 2048 = 2.4e-4 from every integer, and it is below
// 1024, so the f32 rounding moves it by at most 1024 * 2^-24 = 6.1e-5.
// Truncation therefore gives m on both sides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPosts = 65;   // floor1 allows at most 65 posts
constexpr int kWarps = 4;       // frames per block
constexpr int kThreads = 32 * kWarps;
constexpr int kNeg = -200;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadFit = 1 << 22;   // fit_line_lanes: degenerate fit, y = 0

struct Tabs {   // the look's static tables, shared by the block's frames
  int rev[kMaxPosts];   // sort position of post i
  int pr[kMaxPosts];    // postlist[i] | rev[i] << 16
  int sx[kMaxPosts];    // sorted x
  int lo[kMaxPosts];    // decode-side low neighbour of post i + 2
  int hi[kMaxPosts];    // decode-side high neighbour of post i + 2
};

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp copies `bytes` from global `src` into its 16-byte aligned shared
// `dst` with the widest cp.async that the source address and the size
// allow; a row with no 4-byte alignment is copied with plain loads.
__device__ __forceinline__ void warp_copy(void* dst, const void* src,
                                          int bytes, int lane) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes;
  if ((mis & 15) == 0) {
    for (int o = lane * 16; o < bytes; o += 32 * 16) cp_async16(d + o, s + o);
  } else if ((mis & 7) == 0) {
    for (int o = lane * 8; o < bytes; o += 32 * 8) cp_async8(d + o, s + o);
  } else if ((mis & 3) == 0) {
    for (int o = lane * 4; o < bytes; o += 32 * 4) cp_async4(d + o, s + o);
  } else {
    for (int o = lane; o < bytes; o += 32) d[o] = s[o];
  }
}

// Per-post state word: fitA + 256 in bits 0-10, fitB + 256 in bits 11-21,
// memo + 1 in bits 22-28 (fits lie in [-200, 1023], memo in [-1, 64]).
constexpr int kStateInit = (kNeg + 256) | ((kNeg + 256) << 11);

__device__ __forceinline__ int fit_a(int w) { return (w & 0x7FF) - 256; }
__device__ __forceinline__ int fit_b(int w) {
  return ((w >> 11) & 0x7FF) - 256;
}
__device__ __forceinline__ int memo_of(int w) { return (w >> 22) - 1; }
__device__ __forceinline__ int with_a(int w, int v) {
  return (w & ~0x7FF) | (v + 256);
}
__device__ __forceinline__ int with_b(int w, int v) {
  return (w & ~(0x7FF << 11)) | ((v + 256) << 11);
}
__device__ __forceinline__ int with_memo(int w, int v) {
  return (w & 0x3FFFFF) | ((v + 1) << 22);
}

__device__ __forceinline__ int post_y(int a, int b) {
  return a < 0 ? b : (b < 0 ? a : (a + b) >> 1);
}

// Post state spread over the lanes: slot s of lane k is post (or sort
// position) k + 32 s.  warp_get reads entry idx (warp-uniform) on every
// lane; warp_put lets the owner lane of entry idx replace it with f(old).
template <int NS>
__device__ __forceinline__ int warp_get(const int (&a)[NS], int idx) {
  int v = a[0];
#pragma unroll
  for (int s = 1; s < NS; s++)
    if ((idx >> 5) == s) v = a[s];
  return __shfl_sync(kFull, v, idx & 31);
}

template <int NS, class F>
__device__ __forceinline__ void warp_put(int (&a)[NS], int idx, int lane,
                                         F f) {
#pragma unroll
  for (int s = 0; s < NS; s++)
    if (lane + 32 * s == idx) a[s] = f(a[s]);
}

// floor1.c render_point: C's truncating integer division (see the
// exactness note above).
__device__ __forceinline__ int render_point(int x0, int x1, int y0, int y1,
                                            int x) {
  y0 &= 0x7FFF;
  y1 &= 0x7FFF;
  const int dy = y1 - y0;
  const int adx = max(x1 - x0, 1);
  const int off = (abs(dy) * (x - x0)) / adx;
  return dy < 0 ? y0 - off : y0 + off;
}

// Weighted LS fit over segments [s0, s1) (floor1.c fit_line), spread over
// the lanes of each half-warp: lane bit 3 picks the numerator (a or b) so
// that each lane runs one IEEE division, and the two quotients are swapped
// with a shuffle.  Returns y(xa) | y(xb) << 11, or kBadFit for a degenerate
// fit.  Every lane of the warp must call it.
__device__ __forceinline__ int fit_line_lanes(const float* pre, int s0,
                                              int s1, int xa, int xb,
                                              int lane) {
  const float* lo = pre + s0 * 6;
  const float* hi = pre + s1 * 6;
  const float xs = hi[0] - lo[0];
  const float ys = hi[1] - lo[1];
  const float x2s = hi[2] - lo[2];
  const float xys = hi[4] - lo[4];
  const float bn = hi[5] - lo[5];
  const float denom = bn * x2s - xs * xs;
  const bool bad = denom <= 0.0f;
  const float d = bad ? 1.0f : denom;
  const bool is_b = (lane & 8) != 0;
  const float num = is_b ? bn * xys - xs * ys : ys * x2s - xys * xs;
  const float q = num / d;
  const float other = __shfl_xor_sync(kFull, q, 8);
  const float a = is_b ? other : q;
  const float b = is_b ? q : other;
  const float v0 = fminf(fmaxf(rintf(a + b * (float)xa), 0.0f), 1023.0f);
  const float v1 = fminf(fmaxf(rintf(a + b * (float)xb), 0.0f), 1023.0f);
  return bad ? kBadFit : ((int)v0 | ((int)v1 << 11));
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
floor_fit_kernel(const int* __restrict__ quant,
                 const uint8_t* __restrict__ above,
                 const float* __restrict__ prefix,
                 const int* __restrict__ tabs, int* __restrict__ out, int B,
                 int n, int P, int maxover, int maxunder, int mse_k,
                 int rough_max) {
  __shared__ Tabs t;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < P; k += kThreads) {
    t.rev[k] = tabs[k];
    t.pr[k] = tabs[P + k] | (tabs[k] << 16);
    t.sx[k] = tabs[2 * P + k];
    t.lo[k] = tabs[3 * P + k];
    t.hi[k] = tabs[4 * P + k];
  }
  __syncthreads();   // the only block barrier: the static tables
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;

  // the warp's shared memory: quant row, above row, prefix, walk values
  const int qbytes = round16(4 * n);
  const int abytes = round16(n);
  const int pbytes = round16(24 * P);
  unsigned char* base =
      dyn + (size_t)warp * (qbytes + abytes + pbytes + round16(4 * P));
  const int* s_q = reinterpret_cast<const int*>(base);
  const uint8_t* s_a = base + qbytes;
  const float* s_p = reinterpret_cast<const float*>(base + qbytes + abytes);
  int* s_L = reinterpret_cast<int*>(base + qbytes + abytes + pbytes);

  warp_copy(base + qbytes + abytes, prefix + (size_t)row * P * 6, 24 * P,
            lane);
  cp_async_commit();
  warp_copy(base, quant + (size_t)row * n, 4 * n, lane);
  warp_copy(base + qbytes, above + (size_t)row * n, n, lane);
  cp_async_commit();

  int st[NS];     // per post: fitA, fitB, memo
  int links[NS];  // per sort position: lon | hin << 8
#pragma unroll
  for (int s = 0; s < NS; s++) {
    st[s] = kStateInit;
    links[s] = 1 << 8;
  }
  const unsigned span = (unsigned)(maxover + maxunder);

  // initial fit over all segments: needs the prefix only
  cp_async_wait<1>();
  __syncwarp();
  {
    const int r = __shfl_sync(
        kFull,
        fit_line_lanes(s_p, 0, P - 1, t.pr[0] & 0xFFFF, t.sx[P - 1], lane),
        0);
    // post 0 is slot 0 of lane 0, post 1 slot 0 of lane 1
    const int y = lane == 0 ? r & 0x7FF : (r >> 11) & 0x7FF;
    if (lane < 2) st[0] = with_b(with_a(st[0], y), y);
  }
  cp_async_wait<0>();
  __syncwarp();

  int sp_next = P > 2 ? t.rev[2] : 0;
  int spx_next = t.sx[sp_next];
  for (int i = 2; i < P; i++) {
    const int sortpos = sp_next;
    const int spx = spx_next;
    if (i + 1 < P) {   // the next step's static values, off the chain
      sp_next = t.rev[i + 1];
      spx_next = t.sx[sp_next];
    }
    const int lh = warp_get(links, sortpos);
    const int ln = lh & 0xFF;
    const int hn = lh >> 8;
    const int wl = warp_get(st, ln);
    const int wh = warp_get(st, hn);
    const int prl = t.pr[ln];
    const int prh = t.pr[hn];
    const int lx = prl & 0xFFFF;
    const int hx = prh & 0xFFFF;
    const int ly = post_y(fit_a(wl), fit_b(wl));
    const int hy = post_y(fit_a(wh), fit_b(wh));
    // floor1.c inspects a neighbour pair once: a pair seen before (memo)
    // changes nothing, as in the plain version where act is then false
    if (memo_of(wl) == hn) continue;
    warp_put(st, ln, lane, [hn](int w) { return with_memo(w, hn); });

    // the step's two fits, independent of inspect: lanes 0-15 fit
    // [rev[ln], sortpos), lanes 16-31 [sortpos, rev[hn])
    const bool right = (lane & 16) != 0;
    const int fr = fit_line_lanes(s_p, right ? sortpos : prl >> 16,
                                  right ? prh >> 16 : sortpos,
                                  right ? spx : lx, right ? hx : spx, lane);

    // inspect_error over [lx, hx): integer DDA, stride 32.  The lane's
    // first offset and the stride's quotient come from one correctly
    // rounded reciprocal of adx: the numerators are below 2^21, exact in
    // f32, so the product is within num / adx * 2^-23 <= 0.25 of the
    // quotient, truncation is off by at most one, and one correction step
    // gives the exact C division.
    const int y0 = ly & 0x7FFF;
    const int dy = (hy & 0x7FFF) - y0;
    const int ady = abs(dy);
    const int sg = dy < 0 ? -1 : 1;
    const int adx = max(hx - lx, 1);
    const float rcp = __frcp_rn((float)adx);
    int off0 = __float2int_rz((float)(ady * lane) * rcp);
    int rem = ady * lane - off0 * adx;
    if (rem < 0) {
      off0--;
      rem += adx;
    } else if (rem >= adx) {
      off0++;
      rem -= adx;
    }
    int q32 = __float2int_rz((float)(ady * 32) * rcp);
    int r32 = ady * 32 - q32 * adx;
    if (r32 < 0) {
      q32--;
      r32 += adx;
    } else if (r32 >= adx) {
      q32++;
      r32 -= adx;
    }
    const int dy32 = sg * q32;
    int y = y0 + sg * off0;
    int mse = 0;
    int over = 0;
    bool hard = false;
    // 128 bins (4 a lane) at a time; once a bin is over the limits the
    // step is bad whatever the mse, so the scan stops there
    for (int base = lx, x = lx + lane; base < hx; base += 128) {
#pragma unroll
      for (int k = 0; k < 4; k++, x += 32) {
        if (x < hx) {
          const int q = s_q[x];
          const int d = q - y;
          mse += d * d;
          over |= (s_a[x] != 0) & ((x == lx) | (q != 0)) &
                  ((unsigned)(d + maxunder) > span);
          y += dy32;
          rem += r32;
          if (rem >= adx) {
            rem -= adx;
            y += sg;
          }
        }
      }
      if (__any_sync(kFull, over)) {
        hard = true;
        break;
      }
    }

    // the pair is new, so the step acts exactly when inspect finds it bad
    const int cnti = max(hx - lx, 1);
    const bool rough_ok = cnti <= rough_max;
    const bool act =
        hard || (!rough_ok && (long long)__reduce_add_sync(kFull, mse) >=
                                  (long long)mse_k * cnti);

    const int l = __shfl_sync(kFull, fr, 0);
    const int h = __shfl_sync(kFull, fr, 16);
    const bool ret0 = l == kBadFit;
    const bool ret1 = h == kBadFit;
    int ly0 = l & 0x7FF;
    int ly1 = (l >> 11) & 0x7FF;
    int hy0 = h & 0x7FF;
    int hy1 = (h >> 11) & 0x7FF;
    // degenerate handling (floor1.c:668-684), in the reference's order
    if (ret0) {
      ly0 = ly;
      ly1 = hy0;
    }
    if (ret1) {
      hy0 = ly1;
      hy1 = hy;
    }
    const bool upd = act && !(ret0 && ret1);
    if (upd) {
      warp_put(st, ln, lane, [ln, ly0](int w) {
        w = with_b(w, ly0);
        return ln == 0 ? with_a(w, ly0) : w;
      });
      warp_put(st, i, lane,
               [ly1, hy0](int w) { return with_b(with_a(w, ly1), hy0); });
      warp_put(st, hn, lane, [hn, hy1](int w) {
        w = with_a(w, hy1);
        return hn == 1 ? with_b(w, hy1) : w;
      });
      if (ly1 >= 0 || hy0 >= 0) {
        // neighbour propagation: the contiguous runs of matching
        // neighbours adjacent to sortpos take post i
        int lastgap = -1;
        int firstgap = P;
#pragma unroll
        for (int s = 0; s < NS; s++) {
          const int j = lane + 32 * s;
          const unsigned bl =
              __ballot_sync(kFull, j < sortpos && (links[s] >> 8) != hn);
          if (bl) lastgap = 32 * s + 31 - __clz(bl);
          const unsigned bh = __ballot_sync(
              kFull, j > sortpos && j < P && (links[s] & 0xFF) != ln);
          if (bh && firstgap == P) firstgap = 32 * s + __ffs(bh) - 1;
        }
#pragma unroll
        for (int s = 0; s < NS; s++) {
          const int j = lane + 32 * s;
          if (j > lastgap && j < sortpos)
            links[s] = (links[s] & 0xFF) | (i << 8);
          if (j > sortpos && j < firstgap) links[s] = (links[s] & ~0xFF) | i;
        }
      }
    } else if (act) {
      warp_put(st, i, lane,
               [](int w) { return with_b(with_a(w, kNeg), kNeg); });
    }
  }

  // final output walk (floor1.c:735-750) with the static decode-side
  // neighbours.  The low 15 bits of out[j] are post_y(j) when it is fitted
  // (>= 0) and the neighbours' prediction when not; s_L holds them.
  int vx[NS], L[NS];
#pragma unroll
  for (int s = 0; s < NS; s++) {
    const int j = lane + 32 * s;
    vx[s] = post_y(fit_a(st[s]), fit_b(st[s]));
    L[s] = j < 2 ? vx[s] & 0x7FFF : (vx[s] >= 0 ? vx[s] : -1);
    if (j < P) s_L[j] = L[s];
  }
  __syncwarp();
  for (;;) {
    // one pass resolves every unfitted post whose neighbours are known;
    // neighbours are earlier posts, so the passes end
    bool unknown = false;
    int nl[NS];
#pragma unroll
    for (int s = 0; s < NS; s++) {
      const int j = lane + 32 * s;
      nl[s] = L[s];
      if (j >= 2 && j < P && L[s] < 0) {
        const int a = t.lo[j - 2];
        const int b = t.hi[j - 2];
        const int ya = s_L[a];
        const int yb = s_L[b];
        if (ya >= 0 && yb >= 0)
          nl[s] = render_point(t.pr[a] & 0xFFFF, t.pr[b] & 0xFFFF, ya, yb,
                               t.pr[j] & 0xFFFF);
        else
          unknown = true;
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; s++) {
      const int j = lane + 32 * s;
      if (j < P && nl[s] != L[s]) {
        L[s] = nl[s];
        s_L[j] = nl[s];
      }
    }
    __syncwarp();
    if (!__any_sync(kFull, unknown)) break;
  }
#pragma unroll
  for (int s = 0; s < NS; s++) {
    const int j = lane + 32 * s;
    if (j >= P) continue;
    int o = vx[s];
    if (j >= 2) {
      const int a = t.lo[j - 2];
      const int b = t.hi[j - 2];
      const int pred = render_point(t.pr[a] & 0xFFFF, t.pr[b] & 0xFFFF,
                                    s_L[a], s_L[b], t.pr[j] & 0xFFFF);
      o = (vx[s] >= 0 && pred != vx[s]) ? vx[s] : (pred | 0x8000);
    }
    out[(size_t)row * P + j] = o;
  }
}

// Largest cnt in [1, n] for which the plain version's rough-error test
// maxover2 / cnt > maxerr || maxunder2 / cnt > maxerr holds (IEEE float
// divisions, as on the card and in torch), 0 when it holds for none.  The
// test only falls as cnt grows, so a binary search finds the edge.
int rough_max_of(int n, float maxover2, float maxunder2, float maxerr) {
  auto rough = [&](int c) {
    const float cf = (float)c;
    return maxover2 / cf > maxerr || maxunder2 / cf > maxerr;
  };
  if (!rough(1)) return 0;
  int lo = 1, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (rough(mid))
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <int NS>
int launch(const void* quant, const void* above, const void* prefix,
           const void* tabs, void* out, int B, int n, int P, int maxover,
           int maxunder, int mse_k, int rough_max, size_t smem,
           cudaStream_t stream) {
  // above 48 KB of static + dynamic shared memory a block needs the
  // opt-in attribute, or the launch is refused
  if (smem + sizeof(Tabs) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        floor_fit_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kWarps - 1) / kWarps;
  floor_fit_kernel<NS><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(quant), static_cast<const uint8_t*>(above),
      static_cast<const float*>(prefix), static_cast<const int*>(tabs),
      static_cast<int*>(out), B, n, P, maxover, maxunder, mse_k, rough_max);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  All pointers are device pointers of
// C-contiguous tensors: quant (B, n) int32, above (B, n) bool, prefix
// (B, P, 6) float32, tabs (5, P) int32 [rev, postlist, sorted_x,
// lo_static, hi_static], out (B, P) int32.  maxover and maxunder must be
// integral in [0, 2^20); maxover2 and maxunder2 are their float32 squares.
// Launches on `stream` and returns the CUDA error code (0 on success); it
// neither synchronizes nor allocates.
extern "C" int vtt_floor_fit(const void* quant, const void* above,
                             const void* prefix, const void* tabs, void* out,
                             int B, int n, int P, float maxover,
                             float maxunder, float maxerr, float maxover2,
                             float maxunder2, void* stream) {
  const float kLimit = (float)(1 << 20);
  if (P < 2 || P > kMaxPosts || n <= 0 || B < 0 ||
      !(maxover >= 0.0f && maxover < kLimit && maxover == floorf(maxover)) ||
      !(maxunder >= 0.0f && maxunder < kLimit &&
        maxunder == floorf(maxunder)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // (float)(mse / cnt) > maxerr  <=>  mse / cnt >= floor(maxerr) + 1; mse /
  // cnt is below 1023^2 + 1 < 2^21, so clamping there changes nothing
  const double fe = floor((double)maxerr) + 1.0;
  const int mse_k =
      fe <= 0.0 ? 0 : (fe >= (double)(1 << 21) ? 1 << 21 : (int)fe);
  const int rough_max = rough_max_of(n, maxover2, maxunder2, maxerr);
  const size_t smem = (size_t)kWarps * (round16(4 * n) + round16(n) +
                                        round16(24 * P) + round16(4 * P));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mo = (int)maxover;
  const int mu = (int)maxunder;
  switch ((P + 31) / 32) {
    case 1:
      return launch<1>(quant, above, prefix, tabs, out, B, n, P, mo, mu,
                       mse_k, rough_max, smem, st);
    case 2:
      return launch<2>(quant, above, prefix, tabs, out, B, n, P, mo, mu,
                       mse_k, rough_max, smem, st);
    default:
      return launch<3>(quant, above, prefix, tabs, out, B, n, P, mo, mu,
                       mse_k, rough_max, smem, st);
  }
}
