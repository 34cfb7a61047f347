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
// Design:
//  * A block is one warp, and a warp owns consecutive bins of one frame:
//    4 partitions of 32 bins, thread l of a partition's 8 owning its
//    bins l, l + 8, l + 16 and l + 24; or 4 partitions of 8 bins, a bin
//    a thread (bins_a_thread).  Every input of a bin is read once, by
//    one thread, and held in registers from its load to its store: all
//    of a thread's loads (md, curve and the M9 peaks of both channels,
//    thr1, threv, M6's thr2, the normalize's region) are issued before
//    the first is used.  For a warp's request the lanes of a partition
//    read adjacent bins, whole 32-byte sectors.  Bins past n2 (a row
//    padded to whole partitions) hold zeros and take part in no
//    decision.  One-warp blocks keep the warps of an SM out of step, so
//    one warp's loads overlap another's arithmetic.
//  * Partition sums take XLA:CPU's order (ops/xla_f32.py partition_sum):
//    with L lanes, accumulator i chains bins i, i + L, ...; in this
//    mapping a thread holds whole chains (L >= the partition's threads),
//    so only the halving folds below that are shuffles; one accumulator
//    (8-bin M6 sums, padded rows) is a left-to-right chain of shuffles.
//    Counts are ballots.  Floats use __fdiv_rn, __fsqrt_rn and rintf,
//    and the library is built with -fmad=false, so every operation
//    rounds once, as PyTorch's elementwise kernels do.
//  * M6 needs, besides a partition's own mean imbalance, only the
//    previous partition's (the EMA's carry), so there is no barrier:
//    a partition takes it from the previous one in the warp by a
//    shuffle, the warp's first partition from a recount of the previous
//    warp's last one (its md and curve again, L2 hits).  M6 runs only in
//    warps that hold a partition starting below tonefix_end; a partition
//    at or above it takes no decision, and the recount runs only where
//    the previous partition gates.
//  * The point fold (and its divide and square root) runs only for bins
//    that are not lossless: a lossless bin takes the mag/ang pair, and
//    the normalize's candidates are never lossless.
//  * The normalize promotion ranks a candidate by counting, over its
//    partition, the keys above it and the equal keys before it (a stable
//    descending sort's position), a thread's keys against the
//    partition's shuffled ones; a warp none of whose partitions can
//    promote skips the rank.
//  * The flags a launch fixes are template arguments: the partition
//    width, M6 on or off, the normalize on or off and the two sums'
//    lanes, one instantiation each combination ops/couple_cuda.py
//    `INSTANCES` lists (the configs' and the padded rows'); the lowpass,
//    the M9 peaks, the M8 store and the per-row region are uniform
//    run-time branches.
// Built with -DVTT_COUPLE_TIMING the entry point also takes a stamps
// array and each warp writes the clock64 cycles of its six phases (the
// loads issued and used; M6's counts and sums; the carry's recount; the
// lossless and point fold; the normalize; the store) and its total; the
// default build has no such code.
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
  float prepoint, prae, thresh;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

// bins a thread at a partition width (ops/couple_cuda.py BPT): four of
// a 32-bin partition, so a warp holds 4 partitions, 128 bins; one of an
// 8-bin one, so a warp holds 4 partitions, 32 bins (the short batch's
// frames are 128 bins: four warps a frame, not one)
__host__ __device__ constexpr int bins_a_thread(int part) {
  return part == 32 ? 4 : 1;
}

#ifdef VTT_COUPLE_TIMING
constexpr int kPhases = 6, kStamps = kPhases + 1;
#define CQ_STAMPS_PARAM , long long* __restrict__ stamps
#define CQ_STAMPS_ARG , stamps
#define CQ_PHASE(k)                   \
  do {                                \
    const long long now_ = clock64(); \
    ph[k] += now_ - t_prev;           \
    t_prev = now_;                    \
  } while (0)
#else
#define CQ_STAMPS_PARAM
#define CQ_STAMPS_ARG
#define CQ_PHASE(k) \
  do {              \
  } while (0)
#endif

// The partition's sum in XLA:CPU's order with L accumulators (every
// thread of the partition gets it).  v[j] is bin l + TPP j of the
// partition for its thread l of TPP = PART / 4.
template <int PART, int BPT, int L>
__device__ __forceinline__ float psum(const float (&v)[BPT]) {
  constexpr int TPP = PART / BPT;
  static_assert(TPP >= 2 && TPP <= 32 && (TPP & (TPP - 1)) == 0,
                "threads a partition");
  if constexpr (L == 1) {
    float acc = __shfl_sync(FULL, v[0], 0, TPP);
#pragma unroll
    for (int b = 1; b < PART; ++b)
      acc = __fadd_rn(acc, __shfl_sync(FULL, v[b / TPP], b % TPP, TPP));
    return acc;
  } else {
    static_assert(L % TPP == 0 && L <= PART && (L & (L - 1)) == 0,
                  "a thread holds whole chains");
    constexpr int M = L / TPP;   // accumulators a thread: l + TPP m
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = v[m];
#pragma unroll
    for (int j = M; j < BPT; j += M)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = __fadd_rn(acc[m], v[j + m]);
#pragma unroll
    for (int h = M / 2; h >= 1; h /= 2)
#pragma unroll
      for (int m = 0; m < h; ++m) acc[m] = __fadd_rn(acc[m], acc[m + h]);
    float a = acc[0];
#pragma unroll
    for (int h = TPP / 2; h >= 1; h /= 2)
      a = __fadd_rn(a, __shfl_down_sync(FULL, a, h, TPP));
    return __shfl_sync(FULL, a, 0, TPP);
  }
}

// the partition's bins set (gmask: its threads' lanes)
template <int BPT>
__device__ __forceinline__ int pcount(const bool (&x)[BPT], unsigned gmask) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < BPT; ++j) n += __popc(__ballot_sync(FULL, x[j]) & gmask);
  return n;
}

__device__ __forceinline__ float sq_signed(float x) {
  const float s = __fmul_rn(x, x);
  return x < 0.f ? -s : s;
}

// A frame's rows and the flags every thread of its warp shares.
struct Frame {
  long long rM, rA;   // the pair's rows' offsets in md, curve and epeak
  bool uM, uA;
  int lpM, lpA;       // the lowpass: bins kept below
};

// md (lowpassed), curve and residue of one bin of both channels
__device__ __forceinline__ void load_res(const CoupleArgs& a, const Frame& fr,
                                         int i, bool real, float& mM,
                                         float& mA, float& cM, float& cA) {
  mM = real && i < fr.lpM ? a.md[fr.rM + i] : 0.f;
  mA = real && i < fr.lpA ? a.md[fr.rA + i] : 0.f;
  cM = fr.uM ? (real ? a.curve[fr.rM + i] : 1.f) : 1e-10f;
  cA = fr.uA ? (real ? a.curve[fr.rA + i] : 1.f) : 1e-10f;
}

// The mean imbalance of a partition where it gates M6, else -1, from
// its md and curve (loaded by load_res at bins l + TPP j): M6's first
// pass over the previous warp's last partition, the carry of the warp's
// first one.
template <int PART, int BPT, int LM>
__device__ __forceinline__ float prev_mean(const Frame& fr,
                                           const float (&mM)[BPT],
                                           const float (&mA)[BPT],
                                           const float (&cM)[BPT],
                                           const float (&cA)[BPT],
                                           const bool (&real)[BPT],
                                           unsigned gmask) {
  float imb[BPT];
  bool act[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const float rm = fabsf(fr.uM ? __fdiv_rn(mM[j], cM[j]) : 0.f);
    const float ra = fabsf(fr.uA ? __fdiv_rn(mA[j], cA[j]) : 0.f);
    act[j] = real[j] && (rm >= 0.5f || ra >= 0.5f);
    imb[j] = act[j] ? fabsf(__fsub_rn(rm, ra)) : 0.f;
  }
  const int ap = pcount(act, gmask);
  const float rdsum = psum<PART, BPT, LM>(imb);
  return ap > 0 ? __fdiv_rn(rdsum, fmaxf((float)ap, 1.f)) : -1.f;
}

template <int PART, bool M6, bool NM, int LM, int LN>
__global__ void __launch_bounds__(32)
    couple_quantize_kernel(const CoupleArgs a CQ_STAMPS_PARAM) {
  constexpr int BPT = bins_a_thread(PART);
  constexpr int TPP = PART / BPT;   // threads a partition
  constexpr int PPW = 32 / TPP;     // partitions a warp
  constexpr int BPW = 32 * BPT;     // bins a warp
  const int lane = threadIdx.x & 31;
  const int wpf = (a.npt + PPW - 1) / PPW;   // warps a frame
  const long long gw = blockIdx.x;          // a block is one warp
  if (gw >= (long long)a.F * wpf) return;
#ifdef VTT_COUPLE_TIMING
  long long ph[kPhases] = {};
  const long long t_start = clock64();
  long long t_prev = t_start;
#endif
  const int f = (int)(gw / wpf), w = (int)(gw - (long long)f * wpf);
  const int q = lane / TPP, l = lane - q * TPP;
  const int p = w * PPW + q;                 // the thread's partition
  const bool live = p < a.npt;
  const unsigned gmask = ((1u << TPP) - 1u) << (q * TPP);
  const int n2 = a.n2;
  Frame fr;
  fr.rM = (long long)(2 * f) * n2;
  fr.rA = fr.rM + n2;
  fr.uM = a.used[2 * f] != 0;
  fr.uA = a.used[2 * f + 1] != 0;
  fr.lpM = fr.lpA = n2;
  if (a.lowpass) {
    fr.lpM = a.lowpass[2 * f];
    fr.lpA = a.lowpass[2 * f + 1];
  }
  const bool any = fr.uM || fr.uA;
  // the warp holds a partition that M6 gates
  const bool m6w = M6 && w * BPW < a.tfe;
  const float* t1row = a.thr1 + (long long)(f % a.thr1_rows) * a.thr1_rs;
  const float* tvrow = a.threv + (long long)(f % a.threv_rows) * a.threv_rs;

  // every load of the thread's bins, issued together
  int bin[BPT];
  bool real[BPT];
  float mM[BPT], mA[BPT], cM[BPT], cA[BPT], t1[BPT], tv[BPT];
  float eM[BPT], eA[BPT], t2[BPT];
  bool inreg[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    bin[j] = p * PART + l + TPP * j;
    real[j] = live && bin[j] < n2;
    const int i = bin[j];
    load_res(a, fr, i, real[j], mM[j], mA[j], cM[j], cA[j]);
    t1[j] = real[j] ? t1row[i] : 0.f;
    tv[j] = real[j] ? tvrow[i] : 0.f;
    eM[j] = eA[j] = 0.f;
    if (a.epeak && real[j]) {
      eM[j] = a.epeak[fr.rM + i];
      eA[j] = a.epeak[fr.rA + i];
    }
    t2[j] = 0.f;
    if (m6w && real[j]) t2[j] = a.thr2[i];
    inreg[j] = false;
    if (NM && real[j])
      inreg[j] = a.inlimit
                     ? (a.nm_start[i] != 0 &&
                        a.inlimit[(long long)(f % a.inl_rows) * a.inl_rs + i] !=
                            0)
                     : a.nm_inreg[i] != 0;
  }
  float npk = 0.f;
  if (NM && a.npeak) {
    float pM = 0.f, pA = 0.f;
    if (p < a.ncols) {
      pM = a.npeak[(long long)(2 * f) * a.ncols + p];
      pA = a.npeak[(long long)(2 * f + 1) * a.ncols + p];
    }
    npk = (pM < -0.5f || pA < -0.5f) ? -1.f : fminf(pM, pA);
  }

  float rM[BPT], rA[BPT];
  bool f1M[BPT], f1A[BPT], lossless[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    rM[j] = fr.uM ? __fdiv_rn(mM[j], cM[j]) : 0.f;
    rA[j] = fr.uA ? __fdiv_rn(mA[j], cA[j]) : 0.f;
    float thM = t1[j], thA = t1[j];
    if (a.epeak) {
      thM = fmaxf(__fsub_rn(t1[j], eM[j]), a.prepoint);
      thA = fmaxf(__fsub_rn(t1[j], eA[j]), a.prepoint);
    }
    f1M[j] = real[j] && fabsf(rM[j]) >= thM;
    f1A[j] = real[j] && fabsf(rA[j]) >= thA;
    lossless[j] = f1M[j] || f1A[j];
  }
  CQ_PHASE(0);

  if constexpr (M6) {
   if (m6w) {
    bool act[BPT], ao[BPT], opp[BPT], fm1[BPT];
    float imb[BPT];
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const float rm = fabsf(rM[j]), ra = fabsf(rA[j]);
      fm1[j] = real[j] && ((!f1M[j] && rm >= t2[j]) || (!f1A[j] && ra >= t2[j]));
      const float xM = sq_signed(mM[j]), xA = sq_signed(mA[j]);
      opp[j] = (xM > 0.f && xA < 0.f) || (xA > 0.f && xM < 0.f);
      act[j] = real[j] && (rm >= 0.5f || ra >= 0.5f);
      ao[j] = act[j] && opp[j];
      imb[j] = act[j] ? fabsf(__fsub_rn(rm, ra)) : 0.f;
    }
    const int ap = pcount(act, gmask);
    const int rp = pcount(ao, gmask);
    const float rdsum = psum<PART, BPT, LM>(imb);
    const float apf = fmaxf((float)ap, 1.f);
    const float td = __fdiv_rn(rdsum, apf);
    const bool nz = live && ap > 0 && p * PART < a.tfe;
    const bool c2 = nz && __fdiv_rn((float)rp, apf) >= a.prae;
    // the previous partition's mean where it gates M6, else -1
    float carry = __shfl_up_sync(FULL, nz ? td : -1.f, TPP);
    CQ_PHASE(1);
    // the first partition's: the previous warp's last one, recounted
    // from its md and curve where it gates
    const int pp = w * PPW - 1;
    if (w > 0 && pp * PART < a.tfe) {
      float qM[BPT], qA[BPT], dM[BPT], dA[BPT];
      bool qreal[BPT];
#pragma unroll
      for (int j = 0; j < BPT; ++j) {
        const int i = pp * PART + l + TPP * j;
        qreal[j] = i < n2;
        load_res(a, fr, i, qreal[j], qM[j], qA[j], dM[j], dA[j]);
      }
      const float prev =
          prev_mean<PART, BPT, LM>(fr, qM, qA, dM, dA, qreal, gmask);
      if (q == 0) carry = prev;
    } else if (q == 0) {
      carry = -1.f;
    }
    CQ_PHASE(2);
    float rdef = carry > 0.f
                     ? __fadd_rn(__fmul_rn(td, 0.5f), __fmul_rn(carry, 0.5f))
                     : td;
    rdef = nz ? rdef : 0.f;
    const bool c1 = nz && rdef > 1.f;
#pragma unroll
    for (int j = 0; j < BPT; ++j)
      lossless[j] = lossless[j] ||
                    (fm1[j] && !lossless[j] && (c1 || (c2 && opp[j])));
   }
  }

  float outM[BPT], outA[BPT], ve[BPT], hyp[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    ve[j] = hyp[j] = 0.f;
    if (lossless[j]) {
      // integer lossless mag/ang
      const float qiM = rintf(rM[j]), qiA = rintf(rA[j]);
      const bool c1 = fabsf(qiM) > fabsf(qiA);
      float mag = c1 ? qiM : qiA;
      float ang = c1 ? (qiM > 0.f ? __fsub_rn(qiM, qiA) : __fsub_rn(qiA, qiM))
                     : (qiA > 0.f ? __fsub_rn(qiM, qiA) : __fsub_rn(qiA, qiM));
      if (ang >= __fmul_rn(fabsf(mag), 2.f)) {
        mag = -mag;
        ang = -ang;
      }
      outM[j] = mag;
      outA[j] = ang;
      continue;
    }
    // the point fold on the signed energies (ve and hyp feed only the
    // normalize, whose candidates are not lossless)
    const float mm = fr.uM ? mM[j] : 0.f, ma = fr.uA ? mA[j] : 0.f;
    const float rawM = sq_signed(mm), rawA = sq_signed(ma);
    const float thnor = 0.94f;
    const float a2 = fabsf(__fmul_rn(rawM, thnor));
    const float b2 = fabsf(__fmul_rn(rawA, thnor));
    float h;
    if (rawM > 0.f) {
      if (rawA > 0.f)
        h = __fadd_rn(a2, b2);
      else if (mm > -ma)
        h = __fsub_rn(a2, __fmul_rn(b2, tv[j]));
      else
        h = -__fsub_rn(b2, __fmul_rn(a2, tv[j]));
    } else {
      if (rawA < 0.f)
        h = -__fadd_rn(a2, b2);
      else if (-mm > ma)
        h = -__fsub_rn(a2, __fmul_rn(b2, tv[j]));
      else
        h = __fsub_rn(b2, __fmul_rn(a2, tv[j]));
    }
    hyp[j] = h;
    const float fsum =
        __fadd_rn(__fmul_rn(cM[j], cM[j]), __fmul_rn(cA[j], cA[j]));
    ve[j] = __fdiv_rn(fabsf(h), fsum);
    float mpt = rintf(__fsqrt_rn(ve[j]));
    if (h < 0.f) mpt = -mpt;
    outM[j] = mpt;
    outA[j] = 0.f;
  }
  CQ_PHASE(3);

  if constexpr (NM) {
    bool cand[BPT];
    float vs[BPT], key[BPT];
    bool some = false;
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      cand[j] = real[j] && !lossless[j] && ve[j] < 0.25f && inreg[j] && any;
      if (a.npeak) cand[j] = cand[j] && npk > -0.5f;
      vs[j] = cand[j] ? ve[j] : 0.f;
      key[j] = cand[j] ? fabsf(hyp[j]) : -INFINITY;
      some = some || cand[j];
    }
    float acc = psum<PART, BPT, LN>(vs);
    if (a.npeak) acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(acc, npk), npk));
    int npro = acc >= a.thresh
                   ? __float2int_rz(floorf(__fsub_rn(acc, a.thresh))) + 1
                   : 0;
    npro = min(npro, __float2int_rz(acc) + 1);
    if (__any_sync(FULL, some && npro > 0)) {
      int rank[BPT] = {};
#pragma unroll
      for (int s = 0; s < TPP; ++s)
#pragma unroll
        for (int k = 0; k < BPT; ++k) {
          const float kk = __shfl_sync(FULL, key[k], s, TPP);
          const int kb = s + TPP * k;
#pragma unroll
          for (int j = 0; j < BPT; ++j)
            rank[j] += (kk > key[j] || (kk == key[j] && kb < l + TPP * j))
                           ? 1 : 0;
        }
#pragma unroll
      for (int j = 0; j < BPT; ++j)
        if (cand[j] && rank[j] < npro) outM[j] = hyp[j] < 0.f ? -1.f : 1.f;
    }
  }
  CQ_PHASE(4);

  float2* row = reinterpret_cast<float2*>(a.res + (long long)f * 2 * n2);
#pragma unroll
  for (int j = 0; j < BPT; ++j)
    if (real[j]) {
      float2 o;
      o.x = any ? outM[j] : 0.f;
      o.y = any ? outA[j] : 0.f;
      row[bin[j]] = o;
    }
  if (w == 0 && lane == 0) a.any_used[f] = any ? 1 : 0;
  CQ_PHASE(5);
#ifdef VTT_COUPLE_TIMING
  if (lane == 0) {
    long long* st = stamps + gw * kStamps;
#pragma unroll
    for (int k = 0; k < kPhases; ++k) st[k] = ph[k];
    st[kPhases] = clock64() - t_start;
  }
#endif
}

using Kernel = void (*)(const CoupleArgs CQ_STAMPS_PARAM);

// One instantiation: (part, m6, normalize, M6's lanes, the normalize's
// lanes; 0 where the step is off).  ops/couple_cuda.py INSTANCES lists
// the same keys in the same order.
struct Instance {
  int part, m6, nm, lm, ln;
  Kernel k;
};

#define INSTANCE(P, M, N, LM, LN) \
  { P, M, N, LM, LN, couple_quantize_kernel<P, M != 0, N != 0, LM, LN> }

const Instance kInstances[] = {
    INSTANCE(32, 1, 0, 8, 0),   // 4d long: M6, no normalize
    INSTANCE(32, 1, 1, 8, 8),   // q <= 0.2 long with M6
    INSTANCE(32, 0, 0, 0, 0),   // the stateless long finish
    INSTANCE(32, 0, 1, 0, 16),  // q <= 0.2 long stateless
    INSTANCE(32, 1, 0, 1, 0),   // padded rows
    INSTANCE(32, 1, 1, 1, 1),
    INSTANCE(32, 0, 1, 0, 1),
    INSTANCE(8, 1, 0, 1, 0),    // 4d short
    INSTANCE(8, 1, 1, 1, 8),    // q <= 0.2 short with M6
    INSTANCE(8, 0, 0, 0, 0),    // the stateless short finish
    INSTANCE(8, 0, 1, 0, 1),    // q <= 0.2 short stateless; 8-22 kHz
    INSTANCE(8, 1, 1, 1, 1),    // padded rows
};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

// the instantiation this launch's flags pick, or -1
int pick(const CoupleArgs& a) {
  const int lm = a.m6 ? a.lanes_m6 : 0, ln = a.normalize ? a.lanes_nm : 0;
  for (int k = 0; k < kNumInstances; ++k) {
    const Instance& s = kInstances[k];
    if (s.part == a.part && s.m6 == (a.m6 != 0) && s.nm == (a.normalize != 0) &&
        s.lm == lm && s.ln == ln)
      return k;
  }
  return -1;
}

}  // namespace

// One launch on `stream`; returns the launch's cudaError (0 on success).
// A timing build (-DVTT_COUPLE_TIMING) takes `stamps`, kStamps int64 a
// warp (F * warps a frame warps).
extern "C" int vtt_couple_quantize(const CoupleArgs* args,
                                   cudaStream_t stream
#ifdef VTT_COUPLE_TIMING
                                   ,
                                   long long* stamps
#endif
) {
  const CoupleArgs& a = *args;
  const int part = a.part;
  if (a.F < 1 || a.n2 < 1 || (part != 8 && part != 32) ||
      a.npt != (a.n2 + part - 1) / part || a.thr1_rows < 1 ||
      a.threv_rows < 1 || (a.inlimit && a.inl_rows < 1) ||
      ((uintptr_t)a.res & 7) || (a.npeak && a.ncols < 0))
    return (int)cudaErrorInvalidValue;
  const int k = pick(a);
  if (k < 0) return (int)cudaErrorInvalidValue;
  const int ppw = 32 / (part / bins_a_thread(part));
  const long long warps = (long long)a.F * ((a.npt + ppw - 1) / ppw);
  if (warps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kInstances[k].k<<<(unsigned)warps, 32, 0, stream>>>(a CQ_STAMPS_ARG);
  return (int)cudaGetLastError();
}

// for the report: the number of instantiations, and of instantiation k
// its registers, static shared and local bytes a thread, and the blocks
// (of one warp) an SM holds at once; nonzero on a CUDA error
extern "C" int vtt_couple_quantize_instances(void) { return kNumInstances; }

extern "C" int vtt_couple_quantize_attrs(int k, int* out) {
  if (k < 0 || k >= kNumInstances) return (int)cudaErrorInvalidValue;
  const Instance& s = kInstances[k];
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, s.k);
  if (e != cudaSuccess) return (int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, s.k, 32, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = s.part;
  out[1] = s.m6;
  out[2] = s.nm;
  out[3] = s.lm;
  out[4] = s.ln;
  out[5] = at.numRegs;
  out[6] = (int)at.sharedSizeBytes;
  out[7] = (int)at.localSizeBytes;
  out[8] = n;
  return 0;
}
