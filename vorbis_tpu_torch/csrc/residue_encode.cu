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
// Design: a block takes whole frames, one thread a (row, partition) in
// phase 1; the launch picks the frames a block (at most the blob's fpb)
// so that a small batch still spreads over the SMs, and gives a block at
// least 64 threads for phase 2.  Phase 1: the thread loads its
// partition's <= 32 values into registers (16-byte loads where the rows
// allow; loops over a compile-time 32 with a runtime guard, so every
// index is static), classifies them and runs every stage's lattice
// quantization on them in registers, carrying the remainder from stage
// to stage: the truncating divide by the lattice step is a multiply-high
// by the record's magic number (exact for every 32-bit dividend), and
// an identity book's remainder comes from its digits in the same pass;
// each step's entry index goes to shared memory (a column a slot, so a
// warp's stores hit distinct banks).  Phase 2: the block's threads walk
// its frames' output columns in order, four columns a thread a round
// with their loads in flight together, so a warp stores 32 neighbouring
// int64 values and int32 lengths; a column's record (blob `cols`) names
// its stage, partition, channel and step (or the stage-0 phrase word),
// the entry comes from shared memory and the codeword and length from
// the book's (codeword, length) pairs in global memory through the
// read-only path.
//
// Every float operation is the plain version's, in its order: t = (a -
// minval) + add with __fsub_rn / __fadd_rn, the remainder a - delta * zz
// with __fmul_rn / __fsub_rn; float -> int conversions truncate and
// saturate (__float2int_rz) as torch's CUDA conversion does; integer
// arithmetic wraps as torch's int32 arithmetic does.  Built with
// -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// ops/residue_encode_cuda.py HEADER
enum {
  H_TYPE, H_NCH, H_RES_CH, H_BEGIN, H_SPP, H_PARTVALS, H_PPW, H_NCK,
  H_PARTS_PAD, H_POSSIBLE, H_STAGES, H_RC, H_PHR_ENTRIES, H_SCALE, H_SUMENT,
  H_FPB, H_PER_FRAME, H_SMEM, H_CM1, H_CM2, H_RECS, H_COLS, H_PHR, H_WORDS,
  H_MS, H_SOFF = H_MS + 8, kHeader = H_SOFF + 8
};
// ops/residue_encode_cuda.py REC
enum {
  R_DIM, R_QV, R_STEPS, R_MINVAL, R_ADD, R_DELTA, R_DELTAF, R_BOOK, R_REMAP,
  R_ENTRIES, R_MAGIC, R_SHIFT, kRec
};
// ops/residue_encode_cuda.py COL_*
constexpr int kColStage = 6, kColPart = 9, kColChan = 21;
constexpr int kMaxSpp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 64;   // phase 2's threads a block, at least
constexpr int kColsInFlight = 4;  // phase 2's columns a thread a round

struct Head {
  int w[kHeader];
};

// C's truncating int32 division by delta >= 1: |v| / delta by the
// magic number (Granlund and Montgomery's round-up method, exact for
// every 32-bit unsigned dividend), the sign put back; wraps as C does
__device__ __forceinline__ int trunc_div(int v, int delta, unsigned magic,
                                        int shift) {
  const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
  unsigned q = a;
  if (delta != 1) {
    const unsigned t = __umulhi(magic, a);
    q = (t + ((a - t) >> 1)) >> shift;
  }
  return (int)(v < 0 ? 0u - q : q);
}

// torch's amax: a NaN wins
__device__ __forceinline__ float nanmax(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ int classify(const float (&w)[kMaxSpp],
                                        const Head& h,
                                        const int* __restrict__ blob) {
  const int spp = h.w[H_SPP], P = h.w[H_POSSIBLE];
  const int* cm1 = blob + h.w[H_CM1];
  const int* cm2 = blob + h.w[H_CM2];
  int cls = P - 1;
  if (h.w[H_TYPE] == 2) {
    // _classify2: channel 0's max |x| and the other channels' max
    const int nch = h.w[H_NCH];
    float mag = 0.f, ang = 0.f;
    int c = 0;
#pragma unroll
    for (int i = 0; i < kMaxSpp; ++i) {
      if (i < spp) {
        const float a = fabsf(w[i]);
        if (c == 0)
          mag = nanmax(mag, a);
        else
          ang = nanmax(ang, a);
        c = (c + 1 == nch) ? 0 : c + 1;
      }
    }
    for (int k = P - 2; k >= 0; --k)
      if (mag <= __int2float_rn(__ldg(cm1 + k)) &&
          ang <= __int2float_rn(__ldg(cm2 + k)))
        cls = k;
  } else {
    // _classify: the max of |int(x)| and (int32 sum) * f32(100 / spp)
    int mx = INT32_MIN;
    unsigned sum = 0u;
#pragma unroll
    for (int i = 0; i < kMaxSpp; ++i) {
      if (i < spp) {
        const int v = __float2int_rz(w[i]);
        const int a = v < 0 ? (int)(0u - (unsigned)v) : v;
        mx = max(mx, a);
        sum += (unsigned)a;
      }
    }
    const int ent = __float2int_rz(
        __fmul_rn(__int2float_rn((int)sum), __int_as_float(h.w[H_SCALE])));
    for (int k = P - 2; k >= 0; --k) {
      const int t2 = __ldg(cm2 + k);
      if (mx <= __ldg(cm1 + k) && (t2 < 0 || ent < t2)) cls = k;
    }
  }
  return cls;
}

// The launch geometry for `frames` frames (ops/residue_encode_cuda.py
// geometry): frames a block, phase-1 threads, threads, shared bytes
struct Geometry {
  int fpb, p1, threads, smem;
};

__host__ __device__ inline Geometry geometry(const Head& h, int frames,
                                             int sms) {
  Geometry g;
  // at least two blocks an SM where the batch allows, at most fpb frames
  const int want = frames / (2 * sms);
  g.fpb = want < 1 ? 1 : (want < h.w[H_FPB] ? want : h.w[H_FPB]);
  g.p1 = g.fpb * h.w[H_PER_FRAME];
  const int t = (g.p1 + 31) / 32 * 32;
  g.threads = t < kMinThreads ? kMinThreads : t;
  const int bytes = h.w[H_STAGES] * h.w[H_POSSIBLE] * kRec * 4 +
                    2 * h.w[H_SUMENT] * g.p1 + g.p1 + g.fpb * h.w[H_RES_CH];
  g.smem = (bytes + 15) / 16 * 16;
  return g;
}

__global__ void __launch_bounds__(kMaxThreads)
residue_encode_kernel(const float* __restrict__ res,
                      const uint8_t* __restrict__ used,
                      const int* __restrict__ blob, const Head h,
                      const int frames, const int rowlen, const int fpb,
                      const int vec4, long long* __restrict__ vals,
                      int* __restrict__ lens) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = h.w[H_STAGES], P = h.w[H_POSSIBLE];
  const int T = blockDim.x, tid = threadIdx.x;
  const int res_ch = h.w[H_RES_CH], parts_pad = h.w[H_PARTS_PAD];
  const int p1 = fpb * h.w[H_PER_FRAME];   // phase-1 threads
  const int nrec = S * P * kRec;
  int* s_rec = reinterpret_cast<int*>(smem);
  uint16_t* s_ent = reinterpret_cast<uint16_t*>(s_rec + nrec);
  uint8_t* s_cls = reinterpret_cast<uint8_t*>(s_ent + h.w[H_SUMENT] * p1);
  uint8_t* s_used = s_cls + p1;

  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, frames - f0);
  const int nrows = nf * res_ch;
  for (int i = tid; i < nrec; i += T) s_rec[i] = __ldg(blob + h.w[H_RECS] + i);
  if (tid < nrows) s_used[tid] = used[(size_t)f0 * res_ch + tid];
  __syncthreads();

  // phase 1: this thread's (row, partition)
  const int row = tid / parts_pad, p = tid - row * parts_pad;
  const int spp = h.w[H_SPP];
  if (tid < p1) {
    int cls = 0;                // a pad partition digit-packs as class 0
    if (row < nrows && p < h.w[H_PARTVALS]) {
      const float* x = res + ((size_t)f0 * res_ch + row) * rowlen;
      const int base = h.w[H_BEGIN] + p * spp;
      float w[kMaxSpp];
      if (vec4) {
        // the row, begin and spp are multiples of 4 values: a 4-value
        // chunk lies wholly inside the row or wholly past it
#pragma unroll
        for (int i = 0; i < kMaxSpp; i += 4) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < spp && base + i < rowlen)
            v = __ldg(reinterpret_cast<const float4*>(x + base + i));
          w[i] = v.x;
          w[i + 1] = v.y;
          w[i + 2] = v.z;
          w[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kMaxSpp; ++i)
          w[i] = (i < spp && base + i < rowlen) ? __ldg(x + base + i) : 0.f;
      }
      cls = classify(w, h, blob);
      for (int s = 0; s < S; ++s) {
        const int* rc = s_rec + (s * P + cls) * kRec;
        const int dim = rc[R_DIM];
        if (dim == 0) continue;   // no book: the values pass unchanged
        const int qv = rc[R_QV], steps = rc[R_STEPS], delta = rc[R_DELTA];
        const int remap = rc[R_REMAP], shift = rc[R_SHIFT];
        const unsigned magic = (unsigned)rc[R_MAGIC];
        const float minval = __int_as_float(rc[R_MINVAL]);
        const float add = __int_as_float(rc[R_ADD]);
        const float deltaf = __int_as_float(rc[R_DELTAF]);
        const bool carry = s + 1 < S;
        const unsigned ze = (unsigned)(qv >> 1);
        uint16_t* ent = s_ent + h.w[H_SOFF + s] * p1 + tid;
        // the entry index: digit o of a step has significance qv^o; an
        // identity book's remainder from each digit as it comes
        int o = 0, k = 0, acc = 0, pw = 1;
#pragma unroll
        for (int i = 0; i < kMaxSpp; ++i) {
          if (i < spp) {
            const float t = __fadd_rn(__fsub_rn(w[i], minval), add);
            const int v = trunc_div(__float2int_rz(t), delta, magic, shift);
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
              if (remap >= 0) acc = __ldg(blob + remap + acc);
              ent[k * p1] = (uint16_t)acc;
              ++k;
              o = 0;
              acc = 0;
              pw = 1;
            } else {
              pw *= qv;
            }
          }
        }
        if (remap < 0 || !carry) continue;
        // a remapped book's remainder: the digits of the remapped entry
        o = 0;
        k = 0;
        int q = ent[0];
#pragma unroll
        for (int i = 0; i < kMaxSpp; ++i) {
          if (i < spp) {
            const int d = q % qv;
            q /= qv;
            const int zz = (d & 1) ? -((d + 1) >> 1) : (d >> 1);
            w[i] = __fsub_rn(w[i], __fmul_rn(deltaf, __int2float_rn(zz)));
            if (++o == dim) {
              o = 0;
              if (++k < steps) q = ent[k * p1];
            }
          }
        }
      }
    }
    s_cls[tid] = (uint8_t)cls;
  }
  __syncthreads();

  // phase 2: the block's frames' columns in order, kColsInFlight a thread
  // a round, each round's loads issued before its stores
  const int rcols = h.w[H_RC], ppw = h.w[H_PPW];
  const int partvals = h.w[H_PARTVALS], phr_entries = h.w[H_PHR_ENTRIES];
  const int* cols = blob + h.w[H_COLS];
  const int total = nf * rcols;
  long long* vout = vals + (size_t)f0 * rcols;
  int* lout = lens + (size_t)f0 * rcols;
  for (int j0 = tid; j0 < total; j0 += kColsInFlight * T) {
    int word[kColsInFlight], at[kColsInFlight];
#pragma unroll
    for (int u = 0; u < kColsInFlight; ++u) {
      const int j = j0 + u * T;
      word[u] = 0;
      at[u] = -1;
      if (j < total) {
        const int fr = j / rcols;
        word[u] = __ldg(cols + (j - fr * rcols));
        at[u] = fr * res_ch;
      }
    }
#pragma unroll
    for (int u = 0; u < kColsInFlight; ++u) {
      const int j = j0 + u * T;
      if (j >= total) break;
      const int chn = (word[u] >> kColChan) & 0x3FF;
      const int part = (word[u] >> kColPart) & 0xFFF;
      const int r = at[u] + chn;
      const int t = r * parts_pad + part;
      bool ok = s_used[r] != 0;
      int book, e;
      if (word[u] < 0) {
        // stage 0's phrase word: ppw classes digit-packed, MSB first
        int v = 0;
        for (int q = 0; q < ppw; ++q) v = v * P + s_cls[t + q];
        ok = ok && v < phr_entries;
        book = h.w[H_PHR];
        e = v;
      } else {
        const int s = (word[u] >> kColStage) & 7, st = word[u] & 63;
        const int* rc = s_rec + (s * P + s_cls[t]) * kRec;
        ok = ok && part < partvals && rc[R_DIM] != 0 && st < rc[R_STEPS];
        book = rc[R_BOOK];
        e = ok ? (int)s_ent[(h.w[H_SOFF + s] + st) * p1 + t] : 0;
      }
      at[u] = ok ? book + 2 * e : -1;
    }
    long long v[kColsInFlight];
    int l[kColsInFlight];
#pragma unroll
    for (int u = 0; u < kColsInFlight; ++u) {
      v[u] = 0;
      l[u] = 0;
      if (j0 + u * T < total && at[u] >= 0) {
        const int2 pair = __ldg(reinterpret_cast<const int2*>(blob + at[u]));
        v[u] = (long long)(unsigned)pair.x;
        l[u] = pair.y;
      }
    }
#pragma unroll
    for (int u = 0; u < kColsInFlight; ++u) {
      const int j = j0 + u * T;
      if (j < total) {
        vout[j] = v[u];
        lout[j] = l[u];
      }
    }
  }
}

int g_sms = 0;

}  // namespace

extern "C" int vtt_residue_encode(const float* res, const uint8_t* used,
                                  const int* blob, const int* head,
                                  int frames, int rowlen, long long* vals,
                                  int* lens, cudaStream_t stream) {
  Head h;
  memcpy(h.w, head, sizeof h.w);
  if (frames < 1 || h.w[H_FPB] < 1 || h.w[H_PER_FRAME] < 1)
    return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const Geometry g = geometry(h, frames, g_sms);
  if (g.threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        residue_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte row loads: an aligned base, rows, begin and spp in 4s
  const int vec4 = ((uintptr_t)res % 16 == 0 && rowlen % 4 == 0 &&
                    h.w[H_BEGIN] % 4 == 0 && h.w[H_SPP] % 4 == 0);
  const int blocks = (frames + g.fpb - 1) / g.fpb;
  residue_encode_kernel<<<blocks, g.threads, g.smem, stream>>>(
      res, used, blob, h, frames, rowlen, g.fpb, vec4, vals, lens);
  return (int)cudaGetLastError();
}

// for the report: the geometry of a launch of `frames` frames (its
// threads and shared bytes through *threads, *smem) and the blocks of it
// an SM can hold, or -1
extern "C" int vtt_residue_encode_blocks_per_sm(const int* head, int frames,
                                                int* threads, int* smem) {
  Head h;
  memcpy(h.w, head, sizeof h.w);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const Geometry g = geometry(h, frames, sms);
  *threads = g.threads;
  *smem = g.smem;
  if (g.smem > 48 * 1024 &&
      cudaFuncSetAttribute(residue_encode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, residue_encode_kernel, g.threads, g.smem) != cudaSuccess)
    return -1;
  return n;
}
