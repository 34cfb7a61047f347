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
// Design: a warp a row, several warps a block, no block barrier; the
// launch is persistent (ops/floor_cuda.py prepare_geometry): as many
// blocks as the SMs hold at once, each warp walking rows strided by the
// launch's warps.  A warp's next row (both spectra) comes into one of
// its two shared buffers by 16-byte cp.async while it works on this one.
//  * Quant and above, a lane a 4-bin chunk (chunks lane, lane + 32, ...):
//    quant = the saturating truncation of fma(logmask, scale, offset)
//    clamped to [0, 1023] (__fmaf_rn, __float2int_rz: torch's CUDA cast),
//    above = logmdct + atten >= logmask (one add); quant leaves in
//    16-byte stores, above through shared memory in 16-byte stores (4-byte
//    ones where the rows are not 16 bytes), and q | above << 16 is kept a
//    bin in shared memory, one pad word every 32 (a lane's run of bins
//    then starts in its own bank).
//  * The moments, balanced: lane l owns the bins [l bpl, (l + 1) bpl)
//    (bpl = bins_a_lane(n), n / 32 in 4s) and runs the six features (x,
//    q, x^2, q^2, x q, 1) of its used bins and of its used bins above
//    as twelve uint32 sums, in bin order; at each window edge it passes
//    (the look's sorted edges, `tab`, held as a bit mask of the lane's
//    bins in a register: no load on the walk) it records the sums so
//    far.  A warp
//    scan of the lanes' totals turns the records into prefix sums at the
//    edges, and a window's sums are its two edges' difference: every
//    window's true sums are below 2^32 for n <= 2,048, so the uint32
//    differences are exact, as the int64 sums they replace (the first
//    design handed whole windows to warps, whose widths differ 40-fold).
//  * A lane a segment converts each sum once (__uint2float_rn: what the
//    plain version's exact float64 matmul rounds to) and forms the weight
//    (bn + an) tw / (an + 1) + 1 and the weighted moments Bv + A w in
//    float32, one rounding an operation (__fmul_rn, __fdiv_rn, __fadd_rn;
//    built with -fmad=false besides); `used` is whether any segment has a
//    bin above.
//  * Six lanes run the prefix over the segments in float64, a feature
//    each, one segment after another as the CPU's torch.cumsum adds them,
//    each rounded once to float32; the row's prefix leaves from shared
//    memory in coalesced stores.
// Built with -DVTT_PREPARE_TIMING the entry point also takes a stamps
// array and writes, a warp, the clock64 cycles of its phases (PHASES
// below) summed over its rows, its rows and its total; the default build
// has no such code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;      // a block
constexpr int kMaxN = 2048;       // every window's sums below 2^32
constexpr int kMaxP = 65;         // floor1's posts: two segments a lane
constexpr int kMaxShared = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

#ifdef VTT_PREPARE_TIMING
// wait, quant and above, moments, windows, prefix, store
constexpr int kPhases = 6, kStamps = kPhases + 2;
#define FP_STAMPS_PARAM , long long* __restrict__ stamps
#define FP_PHASE(k)                   \
  do {                                \
    const long long now_ = clock64(); \
    ph[k] += now_ - t_prev;           \
    t_prev = now_;                    \
  } while (0)
#else
#define FP_STAMPS_PARAM
#define FP_PHASE(k) \
  do {              \
  } while (0)
#endif

// bins a lane owns in the moments: n / 32 rounded up to 4s, at least 4
__host__ __device__ inline int bins_a_lane(int n) {
  const int b = (n + 31) / 32;
  return b < 4 ? 4 : (b + 3) & ~3;
}

// a warp's shared words: two staged rows of both spectra, q | above << 16
// a bin (a pad word every 32), above's bytes, the edge records (12 sums
// an edge), the weighted moments (S x 6) and the prefix (P x 6); every
// part starts on 16 bytes
struct Layout {
  int qa, ab, edges, wm, pre, words;
};

__host__ __device__ inline Layout layout(int n, int P, int nE) {
  const int n4 = (n + 3) & ~3;
  Layout L;
  L.qa = 4 * n4;
  L.ab = L.qa + ((n + (n >> 5) + 4) & ~3);
  L.edges = L.ab + ((n4 / 4 + 3) & ~3);
  L.wm = L.edges + 12 * nE;
  L.pre = L.wm + 6 * (P - 1);
  L.words = (L.pre + 6 * P + 3) & ~3;
  return L;
}

struct Shape {
  int n, P, nE, bpl, wpb, vec, vab;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the newest complete
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a row's two spectra into a warp's buffer (logmdct, then logmask)
__device__ __forceinline__ void stage_row(float* buf, const float* md,
                                          const float* mk, int n, int n4,
                                          int vec, int lane) {
  if (vec) {
    for (int g = lane; g < n4 / 4; g += 32) {
      cp_async16(buf + 4 * g, md + 4 * g);
      cp_async16(buf + n4 + 4 * g, mk + 4 * g);
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      cp_async4(buf + i, md + i);
      cp_async4(buf + n4 + i, mk + i);
    }
  }
}

__device__ __forceinline__ int quantize(float m, float scale, float offset) {
  return min(max(__float2int_rz(__fmaf_rn(m, scale, offset)), 0), 1023);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    floor_prepare_kernel(const float* __restrict__ logmdct,
                         const float* __restrict__ logmask,
                         const int* __restrict__ tab, const Shape s,
                         const int B, const float scale,
                         const float offset, const float atten,
                         const float tw, int* __restrict__ quant,
                         unsigned char* __restrict__ above,
                         float* __restrict__ prefix,
                         unsigned char* __restrict__ used FP_STAMPS_PARAM) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = s.n, n4 = (n + 3) & ~3, P = s.P, S = P - 1, bpl = s.bpl;
  const Layout L = layout(n, P, s.nE);
  int* ws = smem + warp * L.words;
  float* stage = reinterpret_cast<float*>(ws);
  unsigned* qa = reinterpret_cast<unsigned*>(ws + L.qa);
  unsigned* ab = reinterpret_cast<unsigned*>(ws + L.ab);
  unsigned* ed = reinterpret_cast<unsigned*>(ws + L.edges);
  float* wm = reinterpret_cast<float*>(ws + L.wm);
  float* pre = reinterpret_cast<float*>(ws + L.pre);
  // tab: the sorted edges (nE), then each segment's lo and hi edge
  const int* E = tab;
  const int* lo_e = tab + s.nE;
  const int* hi_e = lo_e + S;
  // this lane's edges [e0, e1): those in its bins, and the last lane's
  // also the edge at the end of every lane's bins
  const int x0 = lane * bpl;
  // the same for every row, so held in registers: a bit j for an edge
  // at bin x0 + j (bpl <= 64), and whether the last lane also has the
  // edge past its bins; the two segments' edge indices a lane takes in
  // the windows (S <= 64)
  int e0 = 0, e1 = 0;
  unsigned long long emask = 0ull;
  for (int k = 0; k < s.nE; ++k) {
    const int e = __ldg(E + k);
    e0 += e < x0;
    e1 += lane == 31 || e < x0 + bpl;
    if (e >= x0 && e < x0 + bpl) emask |= 1ull << (e - x0);
  }
  const bool tail = e1 - e0 > __popcll(emask);
  const int lo0 = lane < S ? __ldg(lo_e + lane) : 0;
  const int hi0 = lane < S ? __ldg(hi_e + lane) : 0;
  const int lo1 = lane + 32 < S ? __ldg(lo_e + lane + 32) : 0;
  const int hi1 = lane + 32 < S ? __ldg(hi_e + lane + 32) : 0;
#ifdef VTT_PREPARE_TIMING
  long long ph[kPhases] = {0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
  long long t_prev = t_start;
  int rows = 0;
#endif

  const int G = gridDim.x * s.wpb;
  int row = blockIdx.x * s.wpb + warp;
  if (row < B)
    stage_row(stage, logmdct + (size_t)row * n, logmask + (size_t)row * n,
              n, n4, s.vec, lane);
  cp_async_commit();
  for (int it = 0; row < B; row += G, ++it) {
    const int nxt = row + G;
    if (nxt < B)
      stage_row(stage + ((it + 1) & 1) * 2 * n4,
                logmdct + (size_t)nxt * n, logmask + (size_t)nxt * n, n,
                n4, s.vec, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    FP_PHASE(0);
    const float* md = stage + (it & 1) * 2 * n4;
    const float* mk = md + n4;
    int* qrow = quant + (size_t)row * n;
    unsigned char* arow = above + (size_t)row * n;

    // quant and above, a lane a 4-bin chunk
    if (s.vec) {
      for (int g = lane; g < n4 / 4; g += 32) {
        const float4 m = reinterpret_cast<const float4*>(mk)[g];
        const float4 d = reinterpret_cast<const float4*>(md)[g];
        const int4 q = make_int4(quantize(m.x, scale, offset),
                                 quantize(m.y, scale, offset),
                                 quantize(m.z, scale, offset),
                                 quantize(m.w, scale, offset));
        const unsigned a0 = __fadd_rn(d.x, atten) >= m.x;
        const unsigned a1 = __fadd_rn(d.y, atten) >= m.y;
        const unsigned a2 = __fadd_rn(d.z, atten) >= m.z;
        const unsigned a3 = __fadd_rn(d.w, atten) >= m.w;
        reinterpret_cast<int4*>(qrow)[g] = q;
        const unsigned a = a0 | a1 << 8 | a2 << 16 | a3 << 24;
        if (s.vab)
          ab[g] = a;
        else
          reinterpret_cast<unsigned*>(arow)[g] = a;
        unsigned* p = qa + 4 * g + (g >> 3);   // bin 4g's padded word
        p[0] = (unsigned)q.x | a0 << 16;
        p[1] = (unsigned)q.y | a1 << 16;
        p[2] = (unsigned)q.z | a2 << 16;
        p[3] = (unsigned)q.w | a3 << 16;
      }
    } else {
      for (int i = lane; i < n; i += 32) {
        const int q = quantize(mk[i], scale, offset);
        const unsigned a = __fadd_rn(md[i], atten) >= mk[i];
        qrow[i] = q;
        arow[i] = (unsigned char)a;
        qa[i + (i >> 5)] = (unsigned)q | a << 16;
      }
    }
    __syncwarp();
    if (s.vab)
      for (int k = lane; k < n / 16; k += 32)
        reinterpret_cast<uint4*>(arow)[k] =
            reinterpret_cast<const uint4*>(ab)[k];
    FP_PHASE(1);

    // the moments: this lane's bins in order, the sums recorded at its
    // edges
    unsigned T[6] = {0u, 0u, 0u, 0u, 0u, 0u};   // used bins
    unsigned A[6] = {0u, 0u, 0u, 0u, 0u, 0u};   // used bins above
    int e = e0;
#pragma unroll 4
    for (int j = 0; j < bpl; ++j) {
      const int x = x0 + j;
      if ((emask >> j) & 1ull) {
        unsigned* r = ed + 12 * e;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          r[k] = T[k];
          r[6 + k] = A[k];
        }
        ++e;
      }
      const unsigned w = x < n ? qa[x + (x >> 5)] : 0u;
      const unsigned q = w & 0xffffu, ux = (unsigned)x;
      // 0 or 1: a used bin, a used bin above; the q features of an
      // unused bin are 0 already
      const unsigned u = q != 0u, a = u & (w >> 16);
      const unsigned f[6] = {ux, q, ux * ux, q * q, ux * q, 1u};
      T[0] += ux * u;
      T[1] += q;
      T[2] += f[2] * u;
      T[3] += f[3];
      T[4] += f[4];
      T[5] += u;
#pragma unroll
      for (int k = 0; k < 6; ++k) A[k] += f[k] * a;
    }
    if (tail) {   // the last lane: the edge past every lane's bins
      unsigned* r = ed + 12 * e;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        r[k] = T[k];
        r[6 + k] = A[k];
      }
    }
    // the lanes' totals scanned: each record becomes a prefix sum
    unsigned ex[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const unsigned own = k < 6 ? T[k] : A[k - 6];
      unsigned v = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += o;
      }
      ex[k] = v - own;
    }
    for (int k0 = e0; k0 < e1; ++k0) {
      unsigned* r = ed + 12 * k0;
#pragma unroll
      for (int k = 0; k < 12; ++k) r[k] += ex[k];
    }
    __syncwarp();
    FP_PHASE(2);

    // a lane a segment: its window's sums, the weight, the moments
    bool any = false;
    for (int sg = lane; sg < S; sg += 32) {
      const unsigned* hi = ed + 12 * (sg < 32 ? hi0 : hi1);
      const unsigned* lo = ed + 12 * (sg < 32 ? lo0 : lo1);
      float a[6], b[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const unsigned at = hi[6 + k] - lo[6 + k];
        a[k] = __uint2float_rn(at);
        b[k] = __uint2float_rn(hi[k] - lo[k] - at);
      }
      any = any || hi[11] != lo[11];
      // (bn + an) * tw / (an + 1) + 1, then Bv + A * w
      const float w = __fadd_rn(
          __fdiv_rn(__fmul_rn(__fadd_rn(b[5], a[5]), tw),
                    __fadd_rn(a[5], 1.0f)),
          1.0f);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        wm[6 * sg + k] = __fadd_rn(b[k], __fmul_rn(a[k], w));
    }
    any = __any_sync(kFull, any);
    __syncwarp();
    FP_PHASE(3);

    // six lanes: the prefix in float64 in segment order
    if (lane < 6) {
      double acc = 0.0;
      pre[lane] = 0.0f;
      for (int sg = 0; sg < S; ++sg) {
        acc = __dadd_rn(acc, (double)wm[6 * sg + lane]);
        pre[6 * (sg + 1) + lane] = __double2float_rn(acc);
      }
    }
    __syncwarp();
    FP_PHASE(4);
    float* prow = prefix + (size_t)row * 6 * P;
    for (int i = lane; i < 6 * P; i += 32) prow[i] = pre[i];
    if (lane == 0) used[row] = any;
    FP_PHASE(5);
#ifdef VTT_PREPARE_TIMING
    ++rows;
#endif
  }
#ifdef VTT_PREPARE_TIMING
  if (lane == 0) {
    long long* st =
        stamps + ((long long)blockIdx.x * s.wpb + warp) * kStamps;
#pragma unroll
    for (int k = 0; k < kPhases; ++k) st[k] = ph[k];
    st[kPhases] = rows;
    st[kPhases + 1] = clock64() - t_start;
  }
#endif
}

// the launch of B rows (ops/floor_cuda.py prepare_geometry): warps a
// block, shared bytes a block; 0 warps where a warp's rows do not fit
struct Geometry {
  int wpb, smem;
};

Geometry geometry(int n, int P, int nE, int B, int sms) {
  const int bytes = 4 * layout(n, P, nE).words;
  int wpb = kMaxShared / bytes;
  if (wpb > kMaxWarps) wpb = kMaxWarps;
  // small batches: spread the rows over the SMs
  const int spread = (B + sms - 1) / sms;
  if (wpb > spread) wpb = spread < 1 ? 1 : spread;
  return Geometry{wpb, wpb * bytes};
}

int g_sms = 0, g_smem_set = 48 * 1024, g_occ_smem = -1, g_occ_wpb = -1,
    g_occ = 0;

cudaError_t allow_shared(int smem) {
  if (smem <= g_smem_set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      floor_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) g_smem_set = smem;
  return e;
}

cudaError_t blocks_per_sm(const Geometry& g, int* out) {
  if (g.smem != g_occ_smem || g.wpb != g_occ_wpb) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_occ, floor_prepare_kernel, g.wpb * 32, g.smem);
    if (e != cudaSuccess) return e;
    g_occ_smem = g.smem;
    g_occ_wpb = g.wpb;
  }
  *out = g_occ;
  return cudaSuccess;
}

}  // namespace

// logmdct, logmask (B, n) float32 and the look's table tab (int32: the nE
// sorted window edges, then each of the P - 1 segments' lo edge and hi
// edge, as indices into them) -> quant (B, n) int32, above (B, n) bool,
// prefix (B, P, 6) float32, used (B,) bool, on `stream`.  Returns the
// launch's cudaError_t.  A timing build (-DVTT_PREPARE_TIMING) takes
// `stamps`, kStamps int64 a warp of the launch.
extern "C" int vtt_floor_prepare(const float* logmdct, const float* logmask,
                                 const int* tab, int nE, int B, int n,
                                 int P, float scale, float offset,
                                 float atten, float tw, int* quant,
                                 unsigned char* above, float* prefix,
                                 unsigned char* used, cudaStream_t stream
#ifdef VTT_PREPARE_TIMING
                                 ,
                                 long long* stamps
#endif
) {
  if (B < 1 || n < 1 || n > kMaxN || P < 2 || P > kMaxP || nE < 2 ||
      nE > 2 * (P - 1))
    return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const Geometry g = geometry(n, P, nE, B, g_sms);
  if (g.wpb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_shared(g.smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = blocks_per_sm(g, &occ);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies and quant stores: 16-byte rows and bases; above's
  // 16-byte stores: rows of a multiple of 16 bytes
  const int vec = n % 4 == 0 && (uintptr_t)logmdct % 16 == 0 &&
                  (uintptr_t)logmask % 16 == 0 && (uintptr_t)quant % 16 == 0 &&
                  (uintptr_t)above % 4 == 0;
  const int vab = vec && n % 16 == 0 && (uintptr_t)above % 16 == 0;
  const Shape s{n, P, nE, bins_a_lane(n), g.wpb, vec, vab};
  int blocks = (B + g.wpb - 1) / g.wpb;
  if (blocks > g_sms * occ) blocks = g_sms * occ;
  floor_prepare_kernel<<<blocks, g.wpb * 32, g.smem, stream>>>(
      logmdct, logmask, tab, s, B, scale, offset, atten, tw, quant, above,
      prefix, used
#ifdef VTT_PREPARE_TIMING
      ,
      stamps
#endif
  );
  return (int)cudaGetLastError();
}

// for the report: the launch of B rows of n bins and P posts with nE
// window edges: warps a block (*wpb), shared bytes a block (*smem),
// blocks (*blocks); returns the blocks an SM holds, or -1
extern "C" int vtt_floor_prepare_blocks_per_sm(int n, int P, int nE, int B,
                                               int* wpb, int* smem,
                                               int* blocks) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const Geometry g = geometry(n, P, nE, B, sms);
  *wpb = g.wpb;
  *smem = g.smem;
  int occ = 0;
  if (g.wpb < 1 || allow_shared(g.smem) != cudaSuccess ||
      blocks_per_sm(g, &occ) != cudaSuccess)
    return -1;
  const int want = (B + g.wpb - 1) / g.wpb;
  *blocks = want < sms * occ ? want : sms * occ;
  return occ;
}
