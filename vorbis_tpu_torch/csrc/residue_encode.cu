// The residue path of the encoder's finish step as one Hopper kernel:
// the partition classify, the multi-stage lattice VQ and the codeword
// columns in res01_forward's emission order.
//
// Replaces no Pallas kernel: it stands for the jitted XLA stages
// `_classify2` / `_classify`, `_vq_stages` and `_residue_fields` of
// vorbis_tpu/ops/encdevice.py:767-1000 (lib/res0.c _2class, _01class,
// _encodepart with the lattice fast path, res01_forward), which the port
// ran as about 600 small PyTorch launches a finish step.
//
// What bounds it on an H100: the bytes.  A long finish batch of 2,048
// stereo frames reads ~15 MB of residues and writes 2,048 x 2,813 columns
// of (int64 value, int32 length), 69 MB; the arithmetic is a few integer
// operations and one float32 divide-free quantization a value a stage.
//
// Design: a warp an item, items independent.  An item is `cpw` chunks of
// ppw partitions of one frame, every channel (ops/residue_encode_cuda.py
// `pack_blob`), so its columns are one contiguous run a stage of the
// frame's row.  A block of up to 8 warps (`geometry`) stages its tables
// (the (stage, class) records, each record's digit divisor, the
// thresholds) in shared memory, then each warp takes an item; the card
// hands the blocks out as SMs free up, so items of uneven cost balance
// (an item's VQ depends on its classes: a launch persistent over the SMs
// ended with its slowest warp's 3-4 items).  With no block barrier after
// the tables, an SM's warps are at every step at once: one loads its
// rows while another quantizes and a third writes its columns, so the
// reads, the arithmetic and the 69 MB of writes overlap across the card
// (the first design ran every block's classify and VQ, then every
// block's writes).
//  * A lane a unit of `unit` values of a partition (the least common
//    multiple of the config's lattice dims, and of the interleaved
//    channels for type 2; at most 8), `units` lanes a partition: each
//    unit holds
//    whole entries at every stage, so a lane's entry indices, remaps and
//    remainders need no other lane.  The unit's values come in 16-byte
//    loads where the rows allow and stay in registers through every
//    stage, the remainder carried from stage to stage.
//  * The class: each lane's partial statistics (type 2: channel 0's max
//    |x| and the other channels' max, torch's NaN-wins max; type 1: the
//    max |int(x)| and the int32 sum), combined over the partition's
//    lanes through shared memory; both are exact in any order.
//  * The lattice step's truncating divide is a multiply-high by the
//    record's magic number (exact for every 32-bit dividend); at INT_MIN
//    it gives the JAX package's quotient, +ceil(2^31 / delta) (JAX
//    negates before it divides, and -INT_MIN wraps).  A remapped book's
//    entry comes from its remap table and its remainder from the
//    remapped entry's digits, each a multiply-high by the record's digit
//    divisor (`rec2`), not a runtime divide.
//  * Each entry's (codeword, length) pair offset (or -1 for a dead
//    column: an unused channel, a pad partition, a class with no book at
//    the stage, a step past the class's) goes to the warp's shared
//    column array in the item's column order, the chunk's phrase word
//    from its partitions' classes; then the lanes write the item's
//    columns, a stage's run at a time, four columns a lane a round with
//    their pair loads (the books through the read-only path) in flight
//    together, so a warp stores 32 neighbouring int64 values and int32
//    lengths.
//
// Every float operation is the plain version's, in its order: t = (a -
// minval) + add with __fsub_rn / __fadd_rn, the remainder a - delta * zz
// with __fmul_rn / __fsub_rn; float -> int conversions truncate and
// saturate (__float2int_rz) as XLA's convert does; integer arithmetic
// wraps as int32 arithmetic does.  Built with -fmad=false.
// Built with -DVTT_RESIDUE_TIMING the entry point also takes a stamps
// array and writes, a warp, the clock64 cycles of its phases (PHASES in
// ops/residue_encode_cuda.py) summed over its items, its items and its
// total; the default build has no such code.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// ops/residue_encode_cuda.py HEADER
enum {
  H_TYPE, H_NCH, H_RES_CH, H_BEGIN, H_SPP, H_PARTVALS, H_PPW, H_NCK,
  H_PARTS_PAD, H_POSSIBLE, H_STAGES, H_RC, H_PHR_ENTRIES, H_SCALE, H_SUMENT,
  H_UNIT, H_PER_FRAME, H_UNITS, H_CM1, H_CM2, H_RECS, H_COLS, H_PHR, H_WORDS,
  H_MS, H_SOFF = H_MS + 8, H_REC2 = H_SOFF + 8, H_CPW, H_ITEM_COLS,
  kHeader
};
// ops/residue_encode_cuda.py REC
enum {
  R_DIM, R_QV, R_STEPS, R_MINVAL, R_ADD, R_DELTA, R_DELTAF, R_BOOK, R_REMAP,
  R_ENTRIES, R_MAGIC, R_SHIFT, kRec
};
// ops/residue_encode_cuda.py REC2: qv's divisor, a unit's entries
enum { R2_QMAGIC, R2_QSHIFT, R2_PER, kRec2 = 4 };
constexpr int kMaxStages = 8;
constexpr int kMaxUnit = 8;         // a lane's values, at most
constexpr int kWarps = 8;           // a block, at most
constexpr int kMaxShared = 227 * 1024;

#ifdef VTT_RESIDUE_TIMING
// tables, load, classify, VQ, columns
constexpr int kPhases = 5, kStamps = kPhases + 2;
#define RE_STAMPS_PARAM , long long* __restrict__ stamps
#define RE_PHASE(k)                   \
  do {                                \
    const long long now_ = clock64(); \
    ph[k] += now_ - t_prev;           \
    t_prev = now_;                    \
  } while (0)
#else
#define RE_STAMPS_PARAM
#define RE_PHASE(k) \
  do {              \
  } while (0)
#endif

struct Head {
  int w[kHeader];
};

// |a| / d for 0 <= a < 2^32 by the magic number (Granlund and
// Montgomery's round-up method); d = 1 divides by no number
__device__ __forceinline__ unsigned udiv(unsigned a, unsigned magic,
                                         int shift, bool one) {
  if (one) return a;
  const unsigned t = __umulhi(magic, a);
  return (t + ((a - t) >> 1)) >> shift;
}

// the JAX package's int32 division by delta >= 1: C's truncating
// division, except INT_MIN, whose negation wraps, so that it divides as
// +2^31 rounded up: +ceil(2^31 / delta) (INT_MIN itself at delta = 1)
__device__ __forceinline__ int vq_div(int v, int delta, unsigned magic,
                                      int shift) {
  const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
  const unsigned q = udiv(a, magic, shift, delta == 1);
  if (v == INT32_MIN) return (int)(q + (q * (unsigned)delta != a));
  return (int)(v < 0 ? 0u - q : q);
}

// torch's amax: a NaN wins
__device__ __forceinline__ float nanmax(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// a warp's shared words: its item's column array (H_ITEM_COLS), the
// lanes' partial statistics (2 a lane) and the partitions' classes
constexpr int kWarpExtra = 2 * 32 + 32;

__host__ __device__ inline int table_words(const Head& h) {
  const int sp = h.w[H_STAGES] * h.w[H_POSSIBLE];
  return (sp * (kRec + kRec2) + 2 * h.w[H_POSSIBLE] + 3) & ~3;
}

__host__ __device__ inline int warp_words(const Head& h) {
  return (h.w[H_ITEM_COLS] + kWarpExtra + 3) & ~3;
}

__global__ void __launch_bounds__(kWarps * 32)
    residue_encode_kernel(const float* __restrict__ res,
                          const uint8_t* __restrict__ used,
                          const int* __restrict__ blob, const Head h,
                          const int frames, const int rowlen,
                          const int wpb, const int vec4,
                          long long* __restrict__ vals,
                          int* __restrict__ lens RE_STAMPS_PARAM) {
  extern __shared__ __align__(16) int smem[];
  const int S = h.w[H_STAGES], P = h.w[H_POSSIBLE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#ifdef VTT_RESIDUE_TIMING
  long long ph[kPhases] = {0, 0, 0, 0, 0};
  const long long t_start = clock64();
  long long t_prev = t_start;
  int items = 0;
#endif
  // the block's tables: records, rec2, cm1, cm2
  const int sp = S * P;
  int* s_rec = smem;
  int* s_rec2 = s_rec + sp * kRec;
  int* s_cm = s_rec2 + sp * kRec2;
  for (int i = threadIdx.x; i < sp * kRec; i += blockDim.x)
    s_rec[i] = __ldg(blob + h.w[H_RECS] + i);
  for (int i = threadIdx.x; i < sp * kRec2; i += blockDim.x)
    s_rec2[i] = __ldg(blob + h.w[H_REC2] + i);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    s_cm[i] = __ldg(blob + h.w[H_CM1] + i);
    s_cm[P + i] = __ldg(blob + h.w[H_CM2] + i);
  }
  __syncthreads();
  int* s_col = smem + table_words(h) + warp * warp_words(h);
  int* s_red = s_col + h.w[H_ITEM_COLS];
  int* s_cls = s_red + 64;
  RE_PHASE(0);

  const int res_ch = h.w[H_RES_CH], ppw = h.w[H_PPW], nck = h.w[H_NCK];
  const int spp = h.w[H_SPP], L = h.w[H_UNIT], U = h.w[H_UNITS];
  const int cpw = h.w[H_CPW], partvals = h.w[H_PARTVALS];
  const int rcols = h.w[H_RC], type2 = h.w[H_TYPE] == 2;
  // this lane's unit: its partition slot ps of the item (chunk cl,
  // partition k of the chunk, channel c) and unit u of the partition
  const int ps = lane / U, u = lane - ps * U;
  const int cl = ps / (ppw * res_ch);
  const int k = ps / res_ch - cl * ppw, c = ps - (ps / res_ch) * res_ch;
  const int ipf = (nck + cpw - 1) / cpw;   // items a frame
  const int total = frames * ipf;
  const int G = gridDim.x * wpb;
  for (int it = blockIdx.x * wpb + warp; it < total; it += G) {
    const int f = it / ipf;
    const int c0a = (it - f * ipf) * cpw;
    const int nc = min(cpw, nck - c0a);
    const bool lane_on = cl < nc;
    const int p = (c0a + cl) * ppw + k;       // partition of the row
    const int row = f * res_ch + c;
    const bool use = lane_on && used[row] != 0;
    const bool live = use && p < partvals;

    // load: the unit's values
    float w[kMaxUnit];
    const int base = h.w[H_BEGIN] + p * spp + u * L;
    const float* x = res + (size_t)row * rowlen + base;
    if (live && vec4) {
#pragma unroll
      for (int i = 0; i < kMaxUnit; i += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < L && base + i < rowlen)
          v = __ldg(reinterpret_cast<const float4*>(x + i));
        w[i] = v.x;
        w[i + 1] = v.y;
        w[i + 2] = v.z;
        w[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kMaxUnit; ++i)
        w[i] = (live && i < L && base + i < rowlen) ? __ldg(x + i) : 0.f;
    }
    RE_PHASE(1);

    // classify: the lane's partial statistics, then its partition's
    if (type2) {
      const int nch = h.w[H_NCH];
      float mag = 0.f, ang = 0.f;
      int ch = 0;   // the unit starts on a channel-0 value
#pragma unroll
      for (int i = 0; i < kMaxUnit; ++i) {
        if (i < L) {
          const float a = fabsf(w[i]);
          if (ch == 0)
            mag = nanmax(mag, a);
          else
            ang = nanmax(ang, a);
          ch = ch + 1 == nch ? 0 : ch + 1;
        }
      }
      s_red[2 * lane] = __float_as_int(mag);
      s_red[2 * lane + 1] = __float_as_int(ang);
    } else {
      int mx = INT32_MIN;
      unsigned sum = 0u;
#pragma unroll
      for (int i = 0; i < kMaxUnit; ++i) {
        if (i < L) {
          const int v = __float2int_rz(w[i]);
          const int a = v < 0 ? (int)(0u - (unsigned)v) : v;
          mx = max(mx, a);
          sum += (unsigned)a;
        }
      }
      s_red[2 * lane] = mx;
      s_red[2 * lane + 1] = (int)sum;
    }
    __syncwarp();
    int cls = 0;   // a pad partition digit-packs as class 0
    if (live) {
      const int* r0 = s_red + 2 * ps * U;
      cls = P - 1;
      if (type2) {
        float mag = 0.f, ang = 0.f;
        for (int i = 0; i < U; ++i) {
          mag = nanmax(mag, __int_as_float(r0[2 * i]));
          ang = nanmax(ang, __int_as_float(r0[2 * i + 1]));
        }
        for (int q = P - 2; q >= 0; --q)
          if (mag <= __int2float_rn(s_cm[q]) &&
              ang <= __int2float_rn(s_cm[P + q]))
            cls = q;
      } else {
        int mx = INT32_MIN;
        unsigned sum = 0u;
        for (int i = 0; i < U; ++i) {
          mx = max(mx, r0[2 * i]);
          sum += (unsigned)r0[2 * i + 1];
        }
        const int ent = __float2int_rz(__fmul_rn(
            __int2float_rn((int)sum), __int_as_float(h.w[H_SCALE])));
        for (int q = P - 2; q >= 0; --q) {
          const int t2 = s_cm[P + q];
          if (mx <= s_cm[q] && (t2 < 0 || ent < t2)) cls = q;
        }
      }
    }
    if (u == 0 && lane_on) s_cls[ps] = cls;
    RE_PHASE(2);

    // every stage: the entries' pair offsets into the column array
    int ib = 0;   // the stage's first column of the item
    for (int s = 0; s < S; ++s) {
      const int ms = h.w[H_MS + s];
      const int cs = (s == 0 ? res_ch : 0) + ppw * res_ch * ms;
      int* at = s_col + ib + cl * cs + (s == 0 ? res_ch : 0) +
                (k * res_ch + c) * ms;
      ib += nc * cs;
      if (!lane_on) continue;
      const int* rc = s_rec + (s * P + cls) * kRec;
      const int dim = live ? rc[R_DIM] : 0;
      if (dim == 0) {   // no book (or a dead partition): values unchanged
        for (int st = u; st < ms; st += U) at[st] = -1;
        continue;
      }
      const int* r2 = s_rec2 + (s * P + cls) * kRec2;
      const int qv = rc[R_QV], delta = rc[R_DELTA], remap = rc[R_REMAP];
      const int book = rc[R_BOOK], shift = rc[R_SHIFT];
      const unsigned magic = (unsigned)rc[R_MAGIC];
      const float minval = __int_as_float(rc[R_MINVAL]);
      const float add = __int_as_float(rc[R_ADD]);
      const float deltaf = __int_as_float(rc[R_DELTAF]);
      const bool carry = s + 1 < S;
      const unsigned ze = (unsigned)(qv >> 1);
      const int e0 = u * r2[R2_PER];   // this unit's first entry
      // the entry index: digit o of a step has significance qv^o; an
      // identity book's remainder from each digit as it comes
      int o = 0, kk = e0, acc = 0, pw = 1;
#pragma unroll
      for (int i = 0; i < kMaxUnit; ++i) {
        if (i < L) {
          const float t = __fadd_rn(__fsub_rn(w[i], minval), add);
          const int v = vq_div(__float2int_rz(t), delta, magic, shift);
          const unsigned uv = (unsigned)v;
          int m = (int)(v < (int)ze ? ((ze - uv) << 1) - 1u
                                    : (uv - ze) << 1);
          m = min(max(m, 0), qv - 1);
          if (remap < 0 && carry) {
            const int zz = (m & 1) ? -((m + 1) >> 1) : (m >> 1);
            w[i] = __fsub_rn(w[i], __fmul_rn(deltaf, __int2float_rn(zz)));
          }
          acc += m * pw;
          if (++o == dim) {
            const int e = remap >= 0 ? __ldg(blob + remap + acc) : acc;
            at[kk] = book + 2 * e;
            ++kk;
            o = 0;
            acc = 0;
            pw = 1;
          } else {
            pw *= qv;
          }
        }
      }
      if (remap >= 0 && carry) {
        // a remapped book's remainder: the remapped entries' digits
        const unsigned qm = (unsigned)r2[R2_QMAGIC];
        const int qs = r2[R2_QSHIFT];
        o = 0;
        kk = e0;
        unsigned q = (unsigned)(at[kk] - book) >> 1;
#pragma unroll
        for (int i = 0; i < kMaxUnit; ++i) {
          if (i < L) {
            const unsigned nq = udiv(q, qm, qs, qv == 1);
            const int d = (int)(q - nq * (unsigned)qv);
            q = nq;
            const int zz = (d & 1) ? -((d + 1) >> 1) : (d >> 1);
            w[i] = __fsub_rn(w[i], __fmul_rn(deltaf, __int2float_rn(zz)));
            if (++o == dim) {
              o = 0;
              if (++kk < e0 + r2[R2_PER])
                q = (unsigned)(at[kk] - book) >> 1;
            }
          }
        }
      }
      for (int st = rc[R_STEPS] + u; st < ms; st += U) at[st] = -1;
    }
    __syncwarp();
    // the chunks' phrase words: ppw classes digit-packed, MSB first
    if (lane_on && u == 0 && k == 0) {
      int v = 0;
      for (int q = 0; q < ppw; ++q) v = v * P + s_cls[ps + q * res_ch];
      const int hs = res_ch + ppw * res_ch * h.w[H_MS];
      s_col[cl * hs + c] = use && v < h.w[H_PHR_ENTRIES]
                               ? h.w[H_PHR] + 2 * v
                               : -1;
    }
    __syncwarp();
    RE_PHASE(3);

    // the item's columns, a stage's run at a time
    long long* vrow = vals + (size_t)f * rcols;
    int* lrow = lens + (size_t)f * rcols;
    int gb = 0;   // the stage's first column of the frame
    ib = 0;
    for (int s = 0; s < S; ++s) {
      const int cs = (s == 0 ? res_ch : 0) + ppw * res_ch * h.w[H_MS + s];
      const int n = nc * cs, g0 = gb + c0a * cs;
      for (int j0 = lane; j0 < n; j0 += 4 * 32) {
        int a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = j0 + 32 * q < n ? s_col[ib + j0 + 32 * q] : -1;
        int2 pr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pr[q] = a[q] >= 0
                      ? __ldg(reinterpret_cast<const int2*>(blob + a[q]))
                      : make_int2(0, 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q;
          if (j < n) {
            vrow[g0 + j] = (long long)(unsigned)pr[q].x;
            lrow[g0 + j] = pr[q].y;
          }
        }
      }
      gb += nck * cs;
      ib += n;
    }
    __syncwarp();   // the column array is the next item's
    RE_PHASE(4);
#ifdef VTT_RESIDUE_TIMING
    ++items;
#endif
  }
#ifdef VTT_RESIDUE_TIMING
  if (lane == 0) {
    long long* st = stamps + ((long long)blockIdx.x * wpb + warp) * kStamps;
#pragma unroll
    for (int q = 0; q < kPhases; ++q) st[q] = ph[q];
    st[kPhases] = items;
    st[kPhases + 1] = clock64() - t_start;
  }
#endif
}

// The launch of `frames` frames (ops/residue_encode_cuda.py geometry):
// warps a block (at most kWarps, fewer where the items are few) and
// shared bytes a block
struct Geometry {
  int wpb, smem;
};

Geometry geometry(const Head& h, int frames, int sms) {
  const int cpw = h.w[H_CPW], nck = h.w[H_NCK];
  const long long items = (long long)frames * ((nck + cpw - 1) / cpw);
  long long wpb = (items + sms - 1) / sms;
  if (wpb > kWarps) wpb = kWarps;
  if (wpb < 1) wpb = 1;
  return Geometry{(int)wpb,
                  4 * (table_words(h) + (int)wpb * warp_words(h))};
}

int g_sms = 0;

// blocks of geometry g an SM holds, or -1; opts the kernel into g's
// shared memory first
int blocks_per_sm(const Geometry& g) {
  if (g.smem > 48 * 1024 &&
      cudaFuncSetAttribute(residue_encode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, residue_encode_kernel, g.wpb * 32, g.smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// res (frames * res_ch, rowlen) float32 rows, used (frames, res_ch) bool,
// the config's blob and its header (kHeader words, by value) -> vals
// (frames, RC) int64, lens (frames, RC) int32, on `stream`.  Returns the
// launch's cudaError_t.  A timing build (-DVTT_RESIDUE_TIMING) takes
// `stamps`, kStamps int64 a warp of the launch.
extern "C" int vtt_residue_encode(const float* res, const uint8_t* used,
                                  const int* blob, const int* head,
                                  int frames, int rowlen, long long* vals,
                                  int* lens, cudaStream_t stream
#ifdef VTT_RESIDUE_TIMING
                                  ,
                                  long long* stamps
#endif
) {
  Head h;
  memcpy(h.w, head, sizeof h.w);
  if (frames < 1 || h.w[H_UNIT] < 1 || h.w[H_UNIT] > kMaxUnit ||
      h.w[H_UNITS] < 1 || h.w[H_CPW] < 1 || h.w[H_STAGES] > kMaxStages ||
      h.w[H_UNITS] * h.w[H_PPW] * h.w[H_RES_CH] * h.w[H_CPW] > 32)
    return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const Geometry g = geometry(h, frames, g_sms);
  if (g.smem > kMaxShared) return (int)cudaErrorInvalidValue;
  const int occ = blocks_per_sm(g);
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // 16-byte row loads: an aligned base, rows, begin, spp and units in 4s
  const int vec4 = ((uintptr_t)res % 16 == 0 && rowlen % 4 == 0 &&
                    h.w[H_BEGIN] % 4 == 0 && h.w[H_SPP] % 4 == 0 &&
                    h.w[H_UNIT] % 4 == 0);
  const long long items =
      (long long)frames * ((h.w[H_NCK] + h.w[H_CPW] - 1) / h.w[H_CPW]);
  const long long blocks = (items + g.wpb - 1) / g.wpb;
  if (blocks >= 1ll << 31) return (int)cudaErrorInvalidValue;
  residue_encode_kernel<<<(unsigned)blocks, g.wpb * 32, g.smem, stream>>>(
      res, used, blob, h, frames, rowlen, g.wpb, vec4, vals, lens
#ifdef VTT_RESIDUE_TIMING
      ,
      stamps
#endif
  );
  return (int)cudaGetLastError();
}

// for the report: the launch of `frames` frames (warps a block, shared
// bytes a block and blocks through *wpb, *smem, *blocks) and the blocks
// of it an SM holds, or -1
extern "C" int vtt_residue_encode_blocks_per_sm(const int* head, int frames,
                                                int* wpb, int* smem,
                                                int* blocks) {
  Head h;
  memcpy(h.w, head, sizeof h.w);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const Geometry g = geometry(h, frames, sms);
  *wpb = g.wpb;
  *smem = g.smem;
  const int occ = blocks_per_sm(g);
  if (occ < 1) return -1;
  const long long items =
      (long long)frames * ((h.w[H_NCK] + h.w[H_CPW] - 1) / h.w[H_CPW]);
  *blocks = (int)((items + g.wpb - 1) / g.wpb);
  return occ;
}
