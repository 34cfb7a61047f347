// The tone mask for NVIDIA Hopper (sm_90a), hand-written CUDA: one block
// per row (a frame's channel), the row's working set in shared memory, the
// row's uneven work spread evenly over the block's threads.
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
// (ops/tone_mask_cuda.py pack_blob, which defines the layout), each table
// at a multiple of 16 bytes: each bin's group and window, the ATH, four
// words a group (its ATH at its first bin, curve-row base and step 0's
// line; and at each of the 8 curve levels the steps [k0, k1) of its curve
// row whose line falls in 1..T-1, as 16-bit halves), the window pieces
// (each window's lines cut into pieces of at most kPiece lines, a word
// each with the window's id), the 136 x 58 curve rows and four constants.
// They stay in global memory and are read through the read-only path:
// every block reads the same few tens of KB, which L1 and L2 hold.  The
// header itself comes by value (Look, from the caller's host copy), so no
// table's address waits on a load.  The first design's other tables
// (group_first, group_band, group_base, win_lo, win_hi) stay in the blob
// for the tests.
//
// What bounds it on this card.  Bytes: at 4d's long batch (4,096 rows of
// n = 1,024) it reads logfft (16.8 MB) and writes the tone (16.8 MB), about
// 33.6 MB, 10.0 us at 3.35 TB/s; its arithmetic is a few operations a bin,
// a group and a line and two a deposit (about 3,300 deposits a long row),
// 2.1 us at the float32 rate.  The first design lost its time to the
// longest thread's chain a phase (a thread a group walked up to 104
// deposits, a thread a window up to 102 lines, the rest of the block
// waiting at the barrier).  With the work spread evenly, what bounds this
// design is the SM's instruction and shared-memory issue, not the bytes:
// reading the rows from L2 or not storing the tone leaves its time as it
// is, and 4 to 8 blocks an SM run at the same rate (chip_smoke.py 3k's
// phase stamps give where a block's time goes).  So each phase keeps its
// instructions few, and 8 blocks an SM (at most 32 registers, no stack)
// hide each other's latencies:
//  * the group max, a thread 4 bins: 16-byte loads of the row and of the
//    bins' groups, issued before the shared buffers are set (one loop of
//    16-byte stores); a run of one group in a quad carries its max back
//    to its first bin, which takes the atomicMax;
//  * two groups a thread: audibility, level, and the in-range steps at
//    that level from the group's posts words (no curve load), then one
//    block scan of the counts (a warp shuffle scan and the 8 warps'
//    totals) that lists the depositing groups: its maximum, curve index
//    and seed word less its first deposit's number (one 16-byte word),
//    the bit of its start in its 32-deposit chunk's word and, for each
//    chunk whose first deposit it holds, its number as that chunk's first
//    group;
//  * the deposits, load-balanced: warp w takes chunks w, w + 8, ..., two
//    at a time with both chunks' loads ahead of their atomics; a lane's
//    group is its chunk's first plus the starts at or below it (a popc),
//    and a deposit is a curve load and an atomicMax into the seed buffer,
//    which keeps the lines of each residue mod 8 in a column of their own,
//    so that a group's deposits 8 lines apart are consecutive words;
//  * the chase, 8 lines a thread: line 8a + s is the max of its block's
//    columns 0..s (a prefix max) and of the block below's columns s + 1..7
//    (a suffix max), 16 loads and two 16-byte stores (linesper is 8 in
//    every psy setup, and the kernel is built for it);
//  * the windowed min: a thread a piece (at most 8 lines, independent
//    loads), an atomicMin a piece into its window's word: 355 pieces at the
//    44.1 kHz long look, two rounds of the block;
//  * a thread 4 bins: the floor, the window's clamp and 16-byte stores.
// Shared memory holds the chased lines (T rounded up to 8), the seed
// columns (8 (ceil(T / 8) + 1)), 5 words a group (the list and the group
// maxima), two words a chunk, W window minima and 8 warp totals: 15,712
// bytes at the 44.1 kHz long look (G = 316, T = 777, W = 316, 224
// chunks), 8,208 at its short one.  Built with -DVTT_TONE_TIMING it also
// takes a stamps array and writes each warp's clock64 at the phases'
// starts and ends (kStamps a warp); the default build has no such code.
//
// Exactness: every output is bitwise the plain version's.  Its float
// operations are a handful of adds, one subtract and one multiply, each
// taken with an explicit round-to-nearest intrinsic in the plain version's
// order (and the build has -fmad=false), the level truncated toward zero
// as torch's int32 conversion does; the rest are max, min and selects,
// exact in any order.  Every merge (group maxima, deposits, chase, window
// minima) is on integer words: a float's bits, negatives with the
// magnitude bits flipped, order as the floats do, so the max or min of the
// words is the word of the max or min, whichever thread comes first.
// torch.maximum and minimum propagate NaN where fmaxf and fminf drop it: no
// NaN reaches this kernel, since logfft is todB's bit pattern scaled and
// shifted by constants, finite for every input, and the spectral maxima
// are its clamped max and that max's decay recurrence.  No -0.0 arises
// either: each sum has a nonzero or positive operand (the tables hold no
// -0.0, checked by tests/test_torch_tone_mask.py), so max and min see no
// signed zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the blob's header words (ops/tone_mask_cuda.py HEADER)
enum {
  H_N, H_T, H_G, H_W, H_LINESPER, H_PLEVELS, H_NCURVES, H_CURVEW,
  H_BIN_GROUP, H_BIN_WIN, H_ATH, H_GFIRST, H_GBAND, H_GBASE, H_WLO, H_WHI,
  H_CURVES, H_LIMIT, H_ADJATT, H_MAXATT, H_MAXCURVE, H_EHMER, H_EHOFF,
  H_WORDS, H_GSTATIC, H_GPOSTS, H_PIECE, H_PIECES, H_CHUNKS, H_SIZE
};

// the header as the kernel takes it, by value: sizes, constants and the
// tables' offsets in the blob
struct Look {
  int n, T, G, W, cw, pieces, chunks;
  float limit, adjatt, maxatt, maxcurve;
  int bin_group, bin_win, ath, gstatic, gposts, curves, piece;
};

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kGroupsPerThread = 2;  // G <= 512
constexpr int kDepUnroll = 2;        // deposit chunks a warp loads at once
constexpr int kLinesPer = 8;         // eighth_octave_lines
constexpr int kLevels = 8;           // P_LEVELS
constexpr int kPiece = 8;            // ops/tone_mask_cuda.py PIECE
constexpr float kNegInf = -9999.0f;  // ops/psy.py NEGINF
constexpr float kLevel0 = 30.0f;     // P_LEVEL_0
constexpr float kTenth = 0.1f;       // float32(0.1)
constexpr int kOrdInf = 0x7f800000;  // ordered(+inf)
constexpr int kOrdNegInf = -8388608 ^ 0x7fffffff;  // ordered(-inf)

#ifdef VTT_TONE_TIMING
constexpr int kStamps = 12;
#define TM_STAMPS_PARAM , long long* __restrict__ stamps
#define TM_STAMP(k)                                                       \
  do {                                                                    \
    if (lane == 0)                                                        \
      stamps[((size_t)blockIdx.x * kWarps + warp) * kStamps + (k)] =      \
          clock64();                                                      \
  } while (0)
#else
#define TM_STAMPS_PARAM
#define TM_STAMP(k) \
  do {              \
  } while (0)
#endif

// a float's bits as an int whose order is the floats' (no NaN)
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int e) {
  return __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

// the seed buffer's columns a residue of the line mod 8: column 0 is
// padding (the block below line 0), line t sits at (t & 7) * cols +
// (t >> 3) + 1
__host__ __device__ __forceinline__ int seed_cols(int T) {
  return ((T + kLinesPer - 1) >> 3) + 1;
}

// 4 consecutive bins' maxima into their groups' words: each run of one
// group carries its max back to its first bin, which takes the atomic
__device__ __forceinline__ void quad_max(float4 x, int4 g, int* s_gmax) {
  int v0 = ordered(x.x), v1 = ordered(x.y), v2 = ordered(x.z);
  const int v3 = ordered(x.w);
  const bool e01 = g.x == g.y, e12 = g.y == g.z, e23 = g.z == g.w;
  v2 = e23 ? max(v2, v3) : v2;
  v1 = e12 ? max(v1, v2) : v1;
  v0 = e01 ? max(v0, v1) : v0;
  atomicMax(s_gmax + g.x, v0);
  if (!e01) atomicMax(s_gmax + g.y, v1);
  if (!e12) atomicMax(s_gmax + g.z, v2);
  if (!e23) atomicMax(s_gmax + g.w, v3);
}

// a window's min word as the mask's value: clamped where a seed reached
__device__ __forceinline__ float window_value(int m, float limit) {
  return m == kOrdInf ? kNegInf : fminf(unordered(m), limit);
}

__global__ void __launch_bounds__(kThreads, 8)
tone_mask_kernel(const float* __restrict__ logfft,
                 const float* __restrict__ gspec,
                 const float* __restrict__ lspec,
                 const int* __restrict__ blob, const Look lk,
                 float* __restrict__ out TM_STAMPS_PARAM) {
  extern __shared__ int4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  TM_STAMP(0);
  const int nq = lk.n >> 2, T = lk.T, G = lk.G, cols = seed_cols(T);
  const int ord_neg = ordered(kNegInf);
  const float g_spec = __ldg(gspec + row), l_spec = __ldg(lspec + row);
  const int chunks = (lk.chunks + 1) & ~1, Gp = (G + 3) & ~3;
  int* s_run = reinterpret_cast<int*>(smem4);  // T rounded up to 8
  // a depositing group: its max (float bits), its curve word's index in
  // the blob and its seed word, each less its first deposit's number
  int4* s_grp = reinterpret_cast<int4*>(s_run + ((T + 7) & ~7));
  int4* s_wsum = s_grp + G;  // the warps' counts, kWarps = 8
  // what each row sets first, 16-byte pieces: the seeds (8 columns), a
  // 32-deposit chunk's group starts after its first deposit (bits) and the
  // group of its first deposit, the groups' maxima, the windows' minima
  int* s_seed = reinterpret_cast<int*>(s_wsum + 2);
  int2* s_chunk = reinterpret_cast<int2*>(s_seed + kLinesPer * cols);
  int* s_gmax = reinterpret_cast<int*>(s_chunk + chunks);  // G
  int* s_win = s_gmax + Gp;                                 // W

  // 1. the group max: a thread 4 bins, 16-byte loads issued before the
  // buffers are set
  {
    const float4* x = reinterpret_cast<const float4*>(logfft) +
                      (size_t)row * nq;
    const int4* bin_group = reinterpret_cast<const int4*>(blob + lk.bin_group);
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 gv = make_int4(0, 0, 0, 0);
    if (tid < nq) xv = __ldg(x + tid), gv = __ldg(bin_group + tid);
    const int e0 = 2 * cols, e1 = e0 + (chunks >> 1), e2 = e1 + (Gp >> 2);
    const int e3 = e2 + ((lk.W + 3) >> 2);
    for (int k = tid; k < e3; k += kThreads) {
      const int v = k < e0 ? ord_neg
                  : k < e1 ? 0
                  : k < e2 ? kOrdNegInf : kOrdInf;
      reinterpret_cast<int4*>(s_seed)[k] = make_int4(v, v, v, v);
    }
    __syncthreads();
    for (int q = tid; q < nq; q += kThreads) {
      if (q != tid) xv = __ldg(x + q), gv = __ldg(bin_group + q);
      quad_max(xv, gv, s_gmax);
    }
  }
  TM_STAMP(1);
  __syncthreads();
  TM_STAMP(2);

  // 2. two groups a thread: audibility, curve row, in-range deposits; a
  // block scan lists the depositing groups
  const float att = fmaxf(__fadd_rn(l_spec, lk.adjatt), lk.maxatt);
  int total;  // deposits | depositing groups << 16
  {
    const float dboffset = __fsub_rn(lk.maxcurve, g_spec);
    const int4* gstatic = reinterpret_cast<const int4*>(blob + lk.gstatic);
    const int4* gposts = reinterpret_cast<const int4*>(blob + lk.gposts);
    int cnt[kGroupsPerThread], word[kGroupsPerThread];
    float gmv[kGroupsPerThread];
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kGroupsPerThread; ++r) {
      const int g = tid * kGroupsPerThread + r;
      cnt[r] = 0;
      word[r] = 0;
      gmv[r] = 0.0f;
      if (g < G) {
        // {ATH at its first bin, curve-row base, step 0's line, 0} and
        // each level's in-range steps k0 | k1 << 8, two levels a word
        const int4 st = __ldg(gstatic + g), ps = __ldg(gposts + g);
        const float gm = unordered(s_gmax[g]);
        gmv[r] = gm;
        int level = __float2int_rz(__fmul_rn(
            __fsub_rn(__fadd_rn(gm, dboffset), kLevel0), kTenth));
        level = min(max(level, 0), kLevels - 1);
        const int pw = level < 4 ? (level < 2 ? ps.x : ps.y)
                                 : (level < 6 ? ps.z : ps.w);
        const int k01 = (pw >> ((level & 1) << 4)) & 0xffff;
        const int k0 = k01 & 0xff, k1 = k01 >> 8;
        if (__fadd_rn(gm, 6.0f) > __fadd_rn(__int_as_float(st.x), att) &&
            k1 > k0) {
          cnt[r] = k1 - k0;
          word[r] = (st.y + level * lk.cw + 2 + k0) |
                    ((st.z + k0 * kLinesPer) << 16);
          mine += cnt[r] + (1 << 16);
        }
      }
    }
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) reinterpret_cast<int*>(s_wsum)[warp] = inc;
    __syncthreads();
    const int4 w0 = s_wsum[0], w1 = s_wsum[1];  // kWarps = 8 totals
    const int ws[kWarps] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += ws[w];
      before += w < warp ? ws[w] : 0;
    }
    int at = before + inc - mine;
#pragma unroll
    for (int r = 0; r < kGroupsPerThread; ++r) {
      if (cnt[r]) {
        const int k = at >> 16, o = at & 0xffff, t = word[r] >> 16;
        // its deposits' lines t + 8 i are consecutive words of a column
        s_grp[k] = make_int4(__float_as_int(gmv[r]),
                             lk.curves + (word[r] & 0xffff) - o,
                             (t & 7) * cols + (t >> 3) + 1 - o, 0);
        if (o & 31)
          atomicOr(&s_chunk[o >> 5].x, (int)(1u << (o & 31)));
        // the chunks whose first deposit is its: at most 2 (cnt <= 56)
        const int c = (o + 31) >> 5;
        if (c << 5 < o + cnt[r]) s_chunk[c].y = k;
        if ((c + 1) << 5 < o + cnt[r]) s_chunk[c + 1].y = k;
        at += cnt[r] + (1 << 16);
      }
    }
  }
  TM_STAMP(3);
  __syncthreads();
  TM_STAMP(4);

  // 3. the deposits, load-balanced: 32 a chunk, a warp every eighth
  // chunk, kDepUnroll chunks' loads ahead of their atomics; a lane's group
  // is the chunk's first plus the starts at or below it.  A lane past the
  // last deposit takes its atomic on its own word of the chased lines,
  // which the chase writes later
  {
    const float* words = reinterpret_cast<const float*>(blob);
    const int N = total & 0xffff;
    const unsigned le = (2u << lane) - 1u;  // lanes at or below this one
    for (int c0 = warp; c0 < (N + 31) >> 5; c0 += kDepUnroll * kWarps) {
      float gm[kDepUnroll], cv[kDepUnroll];
      int* at[kDepUnroll];
#pragma unroll
      for (int u = 0; u < kDepUnroll; ++u) {
        const int c = c0 + u * kWarps, i = (c << 5) + lane;
        at[u] = s_run + lane;
        gm[u] = cv[u] = 0.0f;
        if (i < N) {
          const int2 ch = s_chunk[c];
          const int4 gr = s_grp[ch.y + __popc(ch.x & le)];
          gm[u] = __int_as_float(gr.x);
          cv[u] = __ldg(words + (unsigned)(gr.y + i));
          at[u] = s_seed + gr.z + i;
        }
      }
#pragma unroll
      for (int u = 0; u < kDepUnroll; ++u)
        atomicMax(at[u], ordered(__fadd_rn(gm[u], cv[u])));
    }
  }
  TM_STAMP(5);
  __syncthreads();
  TM_STAMP(6);

  // 4. the chase, 8 lines a thread: line 8a + s takes the max of block
  // a's columns 0..s and block a - 1's columns s + 1..7, a prefix and a
  // suffix max; +inf where no seed reached
  for (int a = tid; a < cols - 1; a += kThreads) {
    int p[kLinesPer], q[kLinesPer];
#pragma unroll
    for (int r = 0; r < kLinesPer; ++r) {
      p[r] = s_seed[r * cols + a + 1];
      q[r] = s_seed[r * cols + a];
    }
#pragma unroll
    for (int r = 1; r < kLinesPer; ++r) p[r] = max(p[r], p[r - 1]);
#pragma unroll
    for (int r = kLinesPer - 2; r >= 0; --r) q[r] = max(q[r], q[r + 1]);
#pragma unroll
    for (int r = 0; r < kLinesPer; ++r) {
      const int m = r + 1 < kLinesPer ? max(p[r], q[r + 1]) : p[r];
      p[r] = m > ord_neg ? m : kOrdInf;
    }
    reinterpret_cast<int4*>(s_run)[2 * a] = make_int4(p[0], p[1], p[2], p[3]);
    reinterpret_cast<int4*>(s_run)[2 * a + 1] =
        make_int4(p[4], p[5], p[6], p[7]);
  }
  TM_STAMP(7);
  __syncthreads();
  TM_STAMP(8);

  // 5. the windowed min: a thread a piece, an atomicMin a piece
  for (int k = tid; k < lk.pieces; k += kThreads) {
    const int pc = __ldg(blob + lk.piece + k);
    const int lo = pc & 0x7fff, len = (pc >> 15) & 7;
    int m = kOrdInf;
#pragma unroll
    for (int i = 0; i < kPiece; ++i)
      if (i <= len) m = min(m, s_run[lo + i]);
    atomicMin(s_win + (pc >> 18), m);
  }
  TM_STAMP(9);
  __syncthreads();
  TM_STAMP(10);

  // 6. the floor and the window's value, 4 bins a thread, 16-byte stores
  {
    const float4* ath = reinterpret_cast<const float4*>(blob + lk.ath);
    const int4* bin_win = reinterpret_cast<const int4*>(blob + lk.bin_win);
    float4* o = reinterpret_cast<float4*>(out) + (size_t)row * nq;
    for (int q = tid; q < nq; q += kThreads) {
      const float4 a = __ldg(ath + q);
      const int4 w = __ldg(bin_win + q);
      float4 r;
      r.x = fmaxf(__fadd_rn(a.x, att), window_value(s_win[w.x], lk.limit));
      r.y = fmaxf(__fadd_rn(a.y, att), window_value(s_win[w.y], lk.limit));
      r.z = fmaxf(__fadd_rn(a.z, att), window_value(s_win[w.z], lk.limit));
      r.w = fmaxf(__fadd_rn(a.w, att), window_value(s_win[w.w], lk.limit));
      o[q] = r;
    }
  }
  TM_STAMP(11);
}

size_t smem_bytes(const int* head) {
  const int T = head[H_T], G = head[H_G];
  return (size_t)(((T + 7) & ~7) + 4 * G + kWarps + kLinesPer * seed_cols(T) +
                  2 * ((head[H_CHUNKS] + 1) & ~1) + ((G + 3) & ~3) +
                  ((head[H_W] + 3) & ~3)) *
         sizeof(int);
}

}  // namespace

// tone (rows, n) of logfft (rows, n) float32 and the spectral maxima
// (rows,) under the look's blob on the device (`words` int32 words) whose
// header `head` (H_SIZE words) the caller also holds on the host: one
// block a row on `stream`.  logfft and out 16-byte aligned, n a multiple
// of 4, linesper 8.  Returns the launch's cudaError_t.  A timing build
// (-DVTT_TONE_TIMING) takes `stamps`, kStamps int64 a warp a row.
extern "C" int vtt_tone_mask(const void* logfft, const void* gspec,
                             const void* lspec, const void* blob,
                             const int* head, int words, void* out,
                             int rows, void* stream
#ifdef VTT_TONE_TIMING
                             , void* stamps
#endif
) {
  if (rows < 0 || words < H_SIZE || head[H_WORDS] != words ||
      ((uintptr_t)logfft | (uintptr_t)out) & 15)
    return (int)cudaErrorInvalidValue;
  Look lk;
  lk.n = head[H_N], lk.T = head[H_T], lk.G = head[H_G], lk.W = head[H_W];
  lk.cw = head[H_CURVEW];
  lk.pieces = head[H_PIECES], lk.chunks = head[H_CHUNKS];
  lk.limit = *reinterpret_cast<const float*>(head + H_LIMIT);
  lk.adjatt = *reinterpret_cast<const float*>(head + H_ADJATT);
  lk.maxatt = *reinterpret_cast<const float*>(head + H_MAXATT);
  lk.maxcurve = *reinterpret_cast<const float*>(head + H_MAXCURVE);
  lk.bin_group = head[H_BIN_GROUP], lk.bin_win = head[H_BIN_WIN];
  lk.ath = head[H_ATH], lk.gstatic = head[H_GSTATIC];
  lk.gposts = head[H_GPOSTS], lk.curves = head[H_CURVES];
  lk.piece = head[H_PIECE];
  if (lk.n < 4 || lk.n & 3 || lk.G < 1 || lk.T < 1 || lk.W < 1 ||
      lk.G > kThreads * kGroupsPerThread || lk.T >= (1 << 15) ||
      head[H_LINESPER] != kLinesPer || head[H_PLEVELS] != kLevels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(head);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  tone_mask_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logfft, (const float*)gspec, (const float*)lspec,
      (const int*)blob, lk, (float*)out
#ifdef VTT_TONE_TIMING
      , (long long*)stamps
#endif
  );
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block takes at the look of header `head`
// (into *smem) and the blocks an SM holds at once (-1 on an error), for
// reports.
extern "C" int vtt_tone_mask_blocks_per_sm(const int* head, int* smem) {
  *smem = (int)smem_bytes(head);
  int b = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, tone_mask_kernel, kThreads, *smem) != cudaSuccess)
    return -1;
  return b;
}
