// floor1 post coding for NVIDIA Hopper (sm_90a), hand-written CUDA: one
// warp per row (a frame's channel), kWarps rows a block at a time.
//
// Replaces no TPU kernel.  The JAX package runs these three stages as jitted
// XLA, fused into a few loops: vorbis_tpu/ops/encdevice.py _floor_wrap
// (:671-713) and _floor_fields (:715-765) and vorbis_tpu/ops/floor_device.py
// DeviceFloorFit.render (:396, the fromdB lookup exact_lookup_256 :54).  The
// port ran them as eager PyTorch, about 2,000 small launches a finish call
// (a Python walk over the posts, loops over partitions and sub-books); this
// kernel is one launch.  It computes, for each row of raw fit posts:
//   1. floor1_encode's quantization by the multiplier and the predictive
//      wrap coding over the static neighbours (lib/floor1.c:774-935): a
//      flagged or predicted post takes `predicted | 0x8000` and codes 0, a
//      coded post clears its two neighbours' flags -> codes, qposts (P);
//   2. the decoder-side curve (render_line + FLOOR1_fromdB_LOOKUP): for each
//      sorted post the previous used post and the next one, a DDA per bin,
//      clamped to [0, 255], then fromdB -> curve (n) float32;
//   3. the packet columns of the floor (the nonzero flag, the two first
//      posts at qb bits, then per partition the class codeword and per dim
//      the codeword of the first sub-book whose maxval exceeds the code)
//      -> vals (FC) int64, lens (FC) int32.
// The plain PyTorch version is vorbis_tpu_torch/ops/floor_encode_cuda.py
// floor_encode_plain (the three stages as the finish ran them).
//
// The tables of one floor config come as one packed int32 blob with a header
// of offsets (ops/floor_encode_cuda.py pack_blob, which defines the layout):
// the static neighbours and post x, the forward index and sorted x, the bin
// -> sorted interval table, the 256 fromdB bit patterns, one record a
// partition (its dim, class bits, first column and code, class book and
// sub-books with their maxval) and each codebook once, (codeword, length)
// pairs.  A block copies the blob into shared memory once and keeps it
// while its warps take rows.
//
// What bounds it on this card.  Bytes: at a long batch of 4,096 rows (P = 29,
// n = 1,024, FC = 37) it reads the posts (0.48 MB) and writes the curve
// (16.8 MB) and the columns (1.8 MB), about 19 MB, 5.7 us at 3.35 TB/s.  Its
// operations are a few hundred integer ones a row besides ~8 a bin.  The
// real limit of this first design is each row's dependent chain: the wrap is
// a chain over the posts (a flagged post's predicted value feeds later
// predictions, and the flags the wrap clears decide which posts the curve
// uses), walked by one lane.
//
// How the design runs it:
//  * one warp a row; lanes load and quantize the posts, lane 0 walks the
//    wrap in order in the warp's shared slice, then each lane takes sorted
//    posts (previous and next used post by a short scan), then the lanes
//    stride the bins for the curve (coalesced stores) and take the
//    partitions for the columns;
//  * the grid is capped at a few blocks a SM, each striding over row groups,
//    so a block copies the blob once.
//
// Exactness: every output is bitwise the plain version's.  All arithmetic
// is integer but the curve's DDA, which is the plain version's f32
// (err + 0.5) / adx truncated, written with __fadd_rn and __fdiv_rn (and
// built with -fmad=false); err < 2^24 and adx are exact in f32.  The wrap's
// err / adx and mult 3's / 12 divide non-negative values, so C's truncation
// is the floor the plain version takes.  Codewords are uint32 bit patterns
// widened without sign into the int64 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // rows in flight a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPosts = 65;            // floor1's limit
constexpr int kPostSlots = 68;           // kMaxPosts rounded up to 4
constexpr int kMaxSub = 8;               // 1 << 3 class sub-books
constexpr int kBlocksPerSM = 4;

// Header words of the blob (ops/floor_encode_cuda.py HEADER).
enum {
  H_P, H_N, H_MULT, H_QUANT_Q, H_QB, H_NPART, H_FC, H_LO, H_HI, H_POSTLIST,
  H_FWD, H_SX, H_IV, H_FROMDB, H_PARTS, H_WORDS, H_SIZE
};
// A partition record (ops/floor_encode_cuda.py PART): sub-book l's maxval,
// book offset (-1: none) and entries at R_SUBS + 3 * l.
enum { R_CDIM, R_CSUBBITS, R_CSUB, R_COL, R_CODE, R_CB, R_SUBS };
constexpr int kPartWords = R_SUBS + 3 * kMaxSub;

struct WarpSlice {
  int cols[kPostSlots];    // the posts as the wrap leaves them (qposts)
  int codes[kPostSlots];
  int4 seg[kPostSlots];    // per sorted post: lx, ly, hx (lx when no used
                           // post follows), hy
};

// floor1.c render_point as the plain version computes it (f32 divide,
// truncated); called only where x >= x0 and x1 > x0.
__device__ __forceinline__ int render_point(int x0, int x1, int y0, int y1,
                                            int x) {
  const int dy = y1 - y0;
  const int err = abs(dy) * (x - x0);
  const int off = __float2int_rz(__fdiv_rn(
      __fadd_rn(__int2float_rn(err), 0.5f), __int2float_rn(max(x1 - x0, 1))));
  return dy < 0 ? y0 - off : y0 + off;
}

// The first sub-book whose maxval exceeds the code, 0 when none does.
__device__ __forceinline__ int book_of(const int* rec, int csub, int code) {
  for (int l = 0; l < csub; ++l)
    if (code < rec[R_SUBS + 3 * l]) return l;
  return 0;
}

__global__ void __launch_bounds__(kThreads)
floor_encode_kernel(const int* __restrict__ posts,
                    const uint8_t* __restrict__ used,
                    const int* __restrict__ blob, int words,
                    int* __restrict__ curve, long long* __restrict__ vals,
                    int* __restrict__ lens, int B) {
  extern __shared__ int4 smem4[];
  WarpSlice* slices = reinterpret_cast<WarpSlice*>(smem4);
  int* tab = reinterpret_cast<int*>(slices + kWarps);
  for (int i = threadIdx.x; i < words; i += kThreads) tab[i] = blob[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  WarpSlice& w = slices[warp];
  const int P = tab[H_P], n = tab[H_N], mult = tab[H_MULT];
  const int qq = tab[H_QUANT_Q], qb = tab[H_QB];
  const int npart = tab[H_NPART], FC = tab[H_FC];
  const int* lo = tab + tab[H_LO];
  const int* hi = tab + tab[H_HI];
  const int* xl = tab + tab[H_POSTLIST];
  const int* fwd = tab + tab[H_FWD];
  const int* sx = tab + tab[H_SX];
  const int* iv = tab + tab[H_IV];
  const int* fromdB = tab + tab[H_FROMDB];
  const int* parts = tab + tab[H_PARTS];

  for (int row = blockIdx.x * kWarps + warp; row < B;
       row += gridDim.x * kWarps) {
    // 1a. quantization by the multiplier, flags kept
    for (int i = lane; i < P; i += 32) {
      const int p = posts[(size_t)row * P + i];
      int v = p & 0x7FFF;
      v = mult == 1 ? v >> 2 : mult == 2 ? v >> 3 : mult == 3 ? v / 12
                                                              : v >> 4;
      v |= p & 0x8000;
      w.cols[i] = v;
      if (i < 2) w.codes[i] = v & 0x7FFF;
    }
    __syncwarp();
    // 1b. the wrap, in post order on one lane: each step reads posts that
    // earlier steps may have re-flagged
    if (lane == 0) {
      for (int i = 2; i < P; ++i) {
        const int ln = lo[i - 2], hn = hi[i - 2];
        const int y0 = w.cols[ln] & 0x7FFF;
        const int dy = (w.cols[hn] & 0x7FFF) - y0;
        const int offp = abs(dy) * (xl[i] - xl[ln]) / (xl[hn] - xl[ln]);
        const int pred = dy < 0 ? y0 - offp : y0 + offp;
        const int c = w.cols[i];
        int code = 0;
        if ((c & 0x8000) != 0 || pred == c) {
          w.cols[i] = pred | 0x8000;
        } else {
          const int head = min(qq - pred, pred);
          const int v = c - pred;
          code = v < 0 ? (v < -head ? head - v - 1 : -1 - 2 * v)
                       : (v >= head ? v + head : 2 * v);
          w.cols[ln] &= 0x7FFF;
          w.cols[hn] &= 0x7FFF;
        }
        w.codes[i] = code;
      }
    }
    __syncwarp();
    // 2a. per sorted post: the used post at or before it (post 0 always
    // anchors) and the next used one after it
    for (int j = lane; j < P; j += 32) {
      int a = j;
      while (a > 0 && (w.cols[fwd[a]] & 0x8000)) --a;
      int b = j + 1;
      while (b < P && (w.cols[fwd[b]] & 0x8000)) ++b;
      const int lx = sx[a];
      const int ly = min(max((w.cols[fwd[a]] & 0x7FFF) * mult, 0), 255);
      int hx = lx, hy = 0;
      if (b < P) {
        hx = sx[b];
        hy = min(max((w.cols[fwd[b]] & 0x7FFF) * mult, 0), 255);
      }
      w.seg[j] = make_int4(lx, ly, hx, hy);
    }
    __syncwarp();
    // 2b. the curve: past the last used post, and at a post's own bin, the
    // segment's left value
    int* crow = curve + (size_t)row * n;
    for (int t = lane; t < n; t += 32) {
      const int4 s = w.seg[iv[t]];
      int y = s.y;
      if (s.z > s.x && t >= s.x) y = render_point(s.x, s.z, s.y, s.w, t);
      crow[t] = fromdB[min(max(y, 0), 255)];
    }
    // 3. the columns
    const bool u = used[row] != 0;
    long long* vrow = vals + (size_t)row * FC;
    int* lrow = lens + (size_t)row * FC;
    if (lane == 0) {
      vrow[0] = u ? 1 : 0;
      lrow[0] = 1;
      vrow[1] = w.codes[0];
      vrow[2] = w.codes[1];
      lrow[1] = lrow[2] = u ? qb : 0;
    }
    for (int p = lane; p < npart; p += 32) {
      const int* rec = parts + p * kPartWords;
      const int cdim = rec[R_CDIM], csubbits = rec[R_CSUBBITS];
      const int csub = rec[R_CSUB], j0 = rec[R_CODE];
      int col = rec[R_COL];
      if (csubbits) {
        int cval = 0;
        for (int k = 0; k < cdim; ++k)
          cval += book_of(rec, csub, w.codes[j0 + k]) << (k * csubbits);
        const int* cb = tab + rec[R_CB] + 2 * cval;
        vrow[col] = (long long)(unsigned)cb[0];
        lrow[col] = u ? cb[1] : 0;
        ++col;
      }
      for (int k = 0; k < cdim; ++k, ++col) {
        const int code = w.codes[j0 + k];
        const int* sub = rec + R_SUBS + 3 * book_of(rec, csub, code);
        long long v = 0;
        int len = 0;
        if (sub[1] >= 0 && code < sub[2]) {
          const int* e = tab + sub[1] + 2 * max(code, 0);
          v = (long long)(unsigned)e[0];
          len = e[1];
        }
        vrow[col] = v;
        lrow[col] = u ? len : 0;
      }
    }
    __syncwarp();   // the slice is rewritten by the next row
  }
}

}  // namespace

// C entry point, bound with ctypes.  All pointers are device pointers of
// C-contiguous tensors: posts (B, P) int32 (the floor fit's raw posts with
// the 0x8000 flag), used (B,) bool, blob (words,) int32 (one floor config's
// tables; P, n and FC are read from its header), curve (B, n) float32 (as
// int32 bit patterns), vals (B, FC) int64, lens (B, FC) int32.  Launches on
// `stream` and returns the CUDA error code (0 on success); it neither
// synchronizes nor allocates.
extern "C" int vtt_floor_encode(const void* posts, const void* used,
                                const void* blob, int words, void* curve,
                                void* vals, void* lens, int B, int P,
                                void* stream) {
  if (B < 0 || P < 2 || P > kMaxPosts || words < H_SIZE)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = kWarps * sizeof(WarpSlice) + (size_t)words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        floor_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (B + kWarps - 1) / kWarps;
  const int grid = groups < kBlocksPerSM * sms ? groups : kBlocksPerSM * sms;
  floor_encode_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(posts), static_cast<const uint8_t*>(used),
      static_cast<const int*>(blob), words, static_cast<int*>(curve),
      static_cast<long long*>(vals), static_cast<int*>(lens), B);
  return (int)cudaGetLastError();
}
