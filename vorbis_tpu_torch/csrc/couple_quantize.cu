// The stereo coupling of the encoder's finish step as one Hopper kernel:
// the per-row lowpass, the lossless flags with the M9 threshold lowering,
// the aoTuV M6 promotion, the integer mag/ang transform, the signed-energy
// point fold, the noise-normalize promotion, the zeroing of unused frames
// and the interleave of the pair into the rows the residue coder reads
// (reference _vp_couple_quantize_normalize, psy.c:4858-5142).
//
// Replaces no Pallas kernel: it stands for the jitted XLA stages
// `_couple_quantize`, `_m6_promote` and `_normalize_promote` of
// vorbis_tpu/ops/encdevice.py:1011-1174 and :1448, with the lowpass and
// the interleave of `finish_from_posts` (:1510), which the port ran as
// about 166 small PyTorch launches a finish call.  Its plain version is
// ops/couple_cuda.py `couple_quantize_plain`; this kernel is held to it
// bit for bit.
//
// What bounds it on an H100: the bytes.  A long finish batch of 2,048
// stereo frames at n2 = 1,024 reads md, curve and the M9 peaks (3 x 16.8
// MB) and writes the interleaved residues (16.8 MB); the arithmetic is a
// few dozen float operations a bin and, per partition, a 32-step rank.
//
// Design (the first):
//  * A frame takes `tpf` threads (whole warps, at most 256) and a block
//    `fpb` frames; a thread walks the frame's bins in steps of tpf, so a
//    warp always holds whole partitions: a 32-bin partition is a warp, an
//    8-bin one a quarter warp.  Bins past n2 (a row padded to whole
//    partitions) hold zeros and take part in no decision.
//  * Partition sums are shuffles in XLA:CPU's order (ops/xla_f32.py
//    partition_sum): `lanes` accumulators, lane l chaining l, l + lanes,
//    ..., then folds in halves; one accumulator is a left-to-right chain.
//    The counts are ballots.  Floats use __fdiv_rn, __fsqrt_rn and rintf,
//    and the library is built with -fmad=false, so every operation rounds
//    once, as PyTorch's elementwise kernels do.
//  * M6 is two passes over the frame: the first writes each partition's
//    mean imbalance, its M6 gate and its opposed-fraction test to shared
//    memory; after one barrier the second reads its partition's and the
//    previous one's (the EMA's carry is only the previous partition's
//    mean, so there is no chain) and recomputes the bin from global
//    memory (an L1/L2 hit) rather than holding it in registers.
//  * The normalize promotion ranks a candidate by counting, over its
//    partition, the keys above it and the equal keys before it (a stable
//    descending sort's position), so no sort is needed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch's arguments, passed by value; ops/couple_cuda.py CoupleArgs
// mirrors it field for field (outside the anonymous namespace, so the C
// entry point that takes it keeps external linkage).
struct CoupleArgs {
  const float* md;        // (2F, n2) the pair's spectra, frame-major
  const float* curve;     // (2F, n2) the floor curves
  const uint8_t* used;    // (2F,) bool
  const int* lowpass;     // (2F,) bins kept below, or null
  const float* epeak;     // (2F, n2) the M9 peaks, or null
  const float* npeak;     // (2F, ncols) the M8 store, or null
  const float* thr1;      // row f: thr1 + (f % thr1_rows) * thr1_rs
  const float* threv;
  const uint8_t* inlimit;  // null: the static region nm_inreg
  const float* thr2;       // (n2,) M6's point2 thresholds
  const uint8_t* nm_inreg;  // (n2,) bool
  const uint8_t* nm_start;  // (n2,) bool
  float* res;              // (F, 2 n2) interleaved residues
  uint8_t* any_used;       // (F,) bool
  long long thr1_rs, threv_rs, inl_rs;
  int thr1_rows, threv_rows, inl_rows;
  int F, n2, part, npt, ncols;
  int tfe;                 // M6 gates the partitions starting below
  int m6, normalize, lanes_m6, lanes_nm;
  int tpf, fpb;
  float prepoint, prae, thresh;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

// The partition's sum in XLA:CPU's order (every lane of the partition
// gets it); `part` lanes of consecutive slots hold the partition.
__device__ __forceinline__ float part_sum(float v, int part, int lanes) {
  if (lanes == 1) {
    float acc = __shfl_sync(FULL, v, 0, part);
    for (int k = 1; k < part; ++k)
      acc = __fadd_rn(acc, __shfl_sync(FULL, v, k, part));
    return acc;
  }
  float a = v;
  for (int k = lanes; k < part; k += lanes)
    a = __fadd_rn(a, __shfl_down_sync(FULL, v, k, part));
  for (int h = lanes >> 1; h >= 1; h >>= 1)
    a = __fadd_rn(a, __shfl_down_sync(FULL, a, h, part));
  return __shfl_sync(FULL, a, 0, part);
}

// the lanes of this slot's partition set in a warp ballot
__device__ __forceinline__ int part_count(bool x, int part) {
  const unsigned b = __ballot_sync(FULL, x);
  if (part == 32) return __popc(b);
  const int sh = (threadIdx.x & 31) & ~(part - 1);
  return __popc((b >> sh) & ((1u << part) - 1u));
}

__device__ __forceinline__ float sq_signed(float x) {
  const float s = __fmul_rn(x, x);
  return x < 0.f ? -s : s;
}

// One bin of a frame, as far as the M6 promotion.
struct Bin {
  float resM, resA, rawM, rawA, curM, curA, mdM, mdA;
  bool f1M, f1A, flagm1;
};

__device__ __forceinline__ void load_bin(const CoupleArgs& a, int f, int i,
                                         bool uM, bool uA, Bin& b) {
  const long long rM = (long long)(2 * f) * a.n2 + i;
  const long long rA = rM + a.n2;
  float mM = a.md[rM], mA = a.md[rA];
  if (a.lowpass) {
    if (i >= a.lowpass[2 * f]) mM = 0.f;
    if (i >= a.lowpass[2 * f + 1]) mA = 0.f;
  }
  b.mdM = mM;
  b.mdA = mA;
  b.curM = uM ? a.curve[rM] : 1e-10f;
  b.curA = uA ? a.curve[rA] : 1e-10f;
  b.resM = uM ? __fdiv_rn(mM, b.curM) : 0.f;
  b.resA = uA ? __fdiv_rn(mA, b.curA) : 0.f;
  const float t1 = a.thr1[(long long)(f % a.thr1_rows) * a.thr1_rs + i];
  float thM = t1, thA = t1;
  if (a.epeak) {
    thM = fmaxf(__fsub_rn(t1, a.epeak[rM]), a.prepoint);
    thA = fmaxf(__fsub_rn(t1, a.epeak[rA]), a.prepoint);
  }
  const float rm = fabsf(b.resM), ra = fabsf(b.resA);
  b.f1M = rm >= thM;
  b.f1A = ra >= thA;
  b.flagm1 = false;
  b.rawM = b.rawA = 0.f;
  if (a.m6) {
    const float t2 = a.thr2[i];
    b.flagm1 = ((!b.f1M) && rm >= t2) || ((!b.f1A) && ra >= t2);
    b.rawM = sq_signed(mM);
    b.rawA = sq_signed(mA);
  }
}

__device__ __forceinline__ bool opposed(const Bin& b) {
  return (b.rawM > 0.f && b.rawA < 0.f) || (b.rawA > 0.f && b.rawM < 0.f);
}

__global__ void __launch_bounds__(THREADS)
    couple_quantize_kernel(const CoupleArgs a) {
  extern __shared__ float smem[];
  const int fl = threadIdx.x / a.tpf;
  const int t = threadIdx.x - fl * a.tpf;
  const int f0 = blockIdx.x * a.fpb + fl;
  const bool live = f0 < a.F;
  const int f = live ? f0 : a.F - 1;
  // per frame in the block: npt partition means, then npt flag words
  float* tdef = smem + fl * 2 * a.npt;
  int* pflag = reinterpret_cast<int*>(tdef + a.npt);
  const bool uM = a.used[2 * f] != 0, uA = a.used[2 * f + 1] != 0;
  const bool any = uM || uA;
  const int np = a.npt * a.part;                // bins in whole partitions
  const int slots = (np + 31) & ~31;
  const int part = a.part;
  const int j = threadIdx.x & (part - 1);       // position in the partition

  if (a.m6) {
    for (int s = t; s < slots; s += a.tpf) {
      const bool real = s < a.n2;
      Bin b;
      if (real) {
        load_bin(a, f, s, uM, uA, b);
      } else {
        b.resM = b.resA = b.rawM = b.rawA = 0.f;
      }
      const bool act = real && (fabsf(b.resM) >= 0.5f ||
                                fabsf(b.resA) >= 0.5f);
      const float imb = act ? fabsf(__fsub_rn(fabsf(b.resM), fabsf(b.resA)))
                            : 0.f;
      const int ap = part_count(act, part);
      const int rp = part_count(act && opposed(b), part);
      const float rdsum = part_sum(imb, part, a.lanes_m6);
      const int p = s / part;
      if (j == 0 && p < a.npt) {
        const float apf = fmaxf((float)ap, 1.f);
        tdef[p] = __fdiv_rn(rdsum, apf);
        const bool nz = ap > 0 && p * part < a.tfe;
        const bool c2 = nz && __fdiv_rn((float)rp, apf) >= a.prae;
        pflag[p] = (nz ? 1 : 0) | (c2 ? 2 : 0);
      }
    }
    __syncthreads();
  }

  for (int s = t; s < slots; s += a.tpf) {
    const bool real = s < a.n2;
    const int p = s / part;
    Bin b;
    if (real) {
      load_bin(a, f, s, uM, uA, b);
    } else {
      b.resM = b.resA = b.rawM = b.rawA = b.mdM = b.mdA = 0.f;
      b.curM = b.curA = 1.f;
      b.f1M = b.f1A = b.flagm1 = false;
    }
    bool lossless = b.f1M || b.f1A;
    if (a.m6 && real && p < a.npt) {
      const int fg = pflag[p];
      const bool nz = fg & 1;
      const float td = tdef[p];
      const float carry = (p > 0 && (pflag[p - 1] & 1)) ? tdef[p - 1] : -1.f;
      float rdef =
          carry > 0.f
              ? __fadd_rn(__fmul_rn(td, 0.5f), __fmul_rn(carry, 0.5f))
              : td;
      rdef = nz ? rdef : 0.f;
      const bool c1 = nz && rdef > 1.f;
      const bool c2 = (fg & 2) != 0;
      const bool prom =
          b.flagm1 && !lossless && (c1 || (c2 && opposed(b)));
      lossless = lossless || prom;
    }
    // integer lossless mag/ang
    const float qiM = rintf(b.resM), qiA = rintf(b.resA);
    const bool c1 = fabsf(qiM) > fabsf(qiA);
    float mag = c1 ? qiM : qiA;
    float ang = c1 ? (qiM > 0.f ? __fsub_rn(qiM, qiA) : __fsub_rn(qiA, qiM))
                   : (qiA > 0.f ? __fsub_rn(qiM, qiA) : __fsub_rn(qiA, qiM));
    if (ang >= __fmul_rn(fabsf(mag), 2.f)) {
      mag = -mag;
      ang = -ang;
    }
    // the point fold on the signed energies
    const float mm = uM ? b.mdM : 0.f, ma = uA ? b.mdA : 0.f;
    const float rawM = sq_signed(mm), rawA = sq_signed(ma);
    const float thnor = 0.94f;
    const float a2 = fabsf(__fmul_rn(rawM, thnor));
    const float b2 = fabsf(__fmul_rn(rawA, thnor));
    const float tv =
        real ? a.threv[(long long)(f % a.threv_rows) * a.threv_rs + s] : 0.f;
    float hyp;
    if (rawM > 0.f) {
      if (rawA > 0.f)
        hyp = __fadd_rn(a2, b2);
      else if (mm > -ma)
        hyp = __fsub_rn(a2, __fmul_rn(b2, tv));
      else
        hyp = -__fsub_rn(b2, __fmul_rn(a2, tv));
    } else {
      if (rawA < 0.f)
        hyp = -__fadd_rn(a2, b2);
      else if (-mm > ma)
        hyp = -__fsub_rn(a2, __fmul_rn(b2, tv));
      else
        hyp = __fsub_rn(b2, __fmul_rn(a2, tv));
    }
    const float fsum =
        __fadd_rn(__fmul_rn(b.curM, b.curM), __fmul_rn(b.curA, b.curA));
    const float ve = __fdiv_rn(fabsf(hyp), fsum);
    float mpt = rintf(__fsqrt_rn(ve));
    if (hyp < 0.f) mpt = -mpt;
    float outM = lossless ? mag : mpt;
    const float outA = lossless ? ang : 0.f;
    if (a.normalize) {
      bool inreg = false;
      if (real) {
        inreg = a.inlimit
                    ? (a.nm_start[s] != 0 &&
                       a.inlimit[(long long)(f % a.inl_rows) * a.inl_rs + s] !=
                           0)
                    : a.nm_inreg[s] != 0;
      }
      bool cand = real && !lossless && ve < 0.25f && inreg && any;
      float npk = 0.f;
      if (a.npeak) {
        float pM = 0.f, pA = 0.f;
        if (p < a.ncols) {
          pM = a.npeak[(long long)(2 * f) * a.ncols + p];
          pA = a.npeak[(long long)(2 * f + 1) * a.ncols + p];
        }
        npk = (pM < -0.5f || pA < -0.5f) ? -1.f : fminf(pM, pA);
        cand = cand && npk > -0.5f;
      }
      float acc = part_sum(cand ? ve : 0.f, part, a.lanes_nm);
      if (a.npeak) acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(acc, npk), npk));
      int npro = acc >= a.thresh
                     ? __float2int_rz(floorf(__fsub_rn(acc, a.thresh))) + 1
                     : 0;
      npro = min(npro, __float2int_rz(acc) + 1);
      const float key = cand ? fabsf(hyp) : -INFINITY;
      int rank = 0;
      for (int k = 0; k < part; ++k) {
        const float kk = __shfl_sync(FULL, key, k, part);
        rank += (kk > key || (kk == key && k < j)) ? 1 : 0;
      }
      if (cand && rank < npro) outM = hyp < 0.f ? -1.f : 1.f;
    }
    if (live && real) {
      float2 o;
      o.x = any ? outM : 0.f;
      o.y = any ? outA : 0.f;
      reinterpret_cast<float2*>(a.res + (long long)f * 2 * a.n2)[s] = o;
    }
  }
  if (live && t == 0) a.any_used[f] = any ? 1 : 0;
}

int shared_bytes(const CoupleArgs& a) {
  return a.m6 ? a.fpb * a.npt * 8 : 0;
}

cudaError_t allow_shared(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(couple_quantize_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// One launch on `stream`; returns the launch's cudaError (0 on success).
extern "C" int vtt_couple_quantize(const CoupleArgs* args,
                                   cudaStream_t stream) {
  const CoupleArgs& a = *args;
  const int part = a.part;
  if (a.F < 1 || a.n2 < 1 || (part != 8 && part != 32) ||
      a.npt != (a.n2 + part - 1) / part || a.tpf < 32 || a.tpf % 32 ||
      a.fpb < 1 || a.tpf * a.fpb > THREADS || a.thr1_rows < 1 ||
      a.threv_rows < 1 || (a.inlimit && a.inl_rows < 1) ||
      ((uintptr_t)a.res & 7) || (a.npeak && a.ncols < 0))
    return (int)cudaErrorInvalidValue;
  for (int l : {a.lanes_m6, a.lanes_nm})
    if (l < 1 || l > part || part % l || (l & (l - 1)))
      return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(a);
  const cudaError_t e = allow_shared(smem);
  if (e != cudaSuccess) return (int)e;
  couple_quantize_kernel<<<(a.F + a.fpb - 1) / a.fpb, a.tpf * a.fpb, smem,
                           stream>>>(a);
  return (int)cudaGetLastError();
}

// for the report: the blocks of `threads` threads and `smem` dynamic
// shared bytes that an SM holds at once, or -1
extern "C" int vtt_couple_quantize_blocks_per_sm(int threads, int smem) {
  if (allow_shared(smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, couple_quantize_kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}
