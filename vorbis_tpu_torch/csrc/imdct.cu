// Batched inverse MDCT (libvorbis mdct_backward) as a hand-written Hopper
// kernel: the device stage of the port's decode (models/fastdec.py
// _device_imdct_dispatch).
//
// Replaces: vorbis_tpu/ops/mdct.py:261 imdct(spec, n, xp=jnp), which the
// JAX package jits per blocksize in vorbis_tpu/models/fastdec.py:210
// (plain jax.numpy, not a Pallas kernel).
//
// Computes, for every (packet, channel) row of (R, n/2) float32 spectra,
// the n-sample block (R, n) in the SAME expression trees as the numpy
// transform and the host C (native/vorbisnative.c vn_imdct1): stage A's
// pre-rotation through the gather tables, log2(n) - 6 radix-2 stages,
// the 32/16/8-point butterfly tails, stage C's bitreverse and half-angle
// rotation, stage D's rotation and symmetric expansion.  Every product
// and sum is an explicit round-to-nearest intrinsic in the C's operand
// order, and the library is built with -fmad=false as well, so no FMA
// contraction can move a bit: the output equals vn_imdct_batch and the
// numpy imdct bitwise.
//
// Design: one thread block a row.  The row's n/2 working vector and the
// n/2 stage-C vector stay in shared memory (33 KB at n = 8192), each with
// one pad word every 32 floats so that the single-thread 32-point tails
// (thread b walks floats 32b..32b+31) hit 32 different banks.  Each stage
// is one strided pass of the block's threads, with __syncthreads()
// between stages; each tail runs in one thread in the C's statement
// order.  The trig and index tables of each blocksize live in device
// memory (ops/imdct_cuda.py caches them per n) and are read through L1.
//
// Bound on this card: bytes.  A row reads n/2 floats and writes n, 6
// bytes an output sample against ~15 float32 operations (at n = 2048;
// H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 counting an FMA as two, and none
// here), so the least time is the traffic's.  This first
// design is right, not fast: stages serialise on __syncthreads and the
// tails use one thread in 32; several rows a block, cp.async staging and
// a fused window multiply are for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ImdctTabs {
    const float *T, *sa, *sb;
    const int32_t *ia, *ib, *ta, *tb, *tc_all, *stage_off;
    const int32_t *e0, *e1, *tC, *tD;
    int n, nstages;
};

// shared-memory index of element i: one pad float every 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float fadd(float a, float b)
{
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b)
{
    return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b)
{
    return __fmul_rn(a, b);
}

__device__ const float cPI1_8 = 0.92387953f;
__device__ const float cPI2_8 = 0.70710678f;
__device__ const float cPI3_8 = 0.38268343f;

// vn_bf8 (vorbisnative.c:1225) on 8 contiguous floats
__device__ void bf8(float *x)
{
    float r0 = fadd(x[6], x[2]), r1 = fsub(x[6], x[2]);
    float r2 = fadd(x[4], x[0]), r3 = fsub(x[4], x[0]);
    float n6 = fadd(r0, r2), n4 = fsub(r0, r2);
    float s0 = fsub(x[5], x[1]), s2 = fsub(x[7], x[3]);
    float n0 = fadd(r1, s0), n2 = fsub(r1, s0);
    float u0 = fadd(x[5], x[1]), u1 = fadd(x[7], x[3]);
    float n3 = fadd(s2, r3), n1 = fsub(s2, r3);
    float n7 = fadd(u1, u0), n5 = fsub(u1, u0);
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
}

// vn_bf16 (vorbisnative.c:1239)
__device__ void bf16(float *x)
{
    float c2 = cPI2_8;
    float r0 = fsub(x[1], x[9]), r1 = fsub(x[0], x[8]);
    float n8 = fadd(x[8], x[0]), n9 = fadd(x[9], x[1]);
    float n0 = fmul(fadd(r0, r1), c2), n1 = fmul(fsub(r0, r1), c2);
    float r0b = fsub(x[3], x[11]), r1b = fsub(x[10], x[2]);
    float n10 = fadd(x[10], x[2]), n11 = fadd(x[11], x[3]);
    float n2 = r0b, n3 = r1b;
    float r0c = fsub(x[12], x[4]), r1c = fsub(x[13], x[5]);
    float n12 = fadd(x[12], x[4]), n13 = fadd(x[13], x[5]);
    float n4 = fmul(fsub(r0c, r1c), c2), n5 = fmul(fadd(r0c, r1c), c2);
    float r0d = fsub(x[14], x[6]), r1d = fsub(x[15], x[7]);
    float n14 = fadd(x[14], x[6]), n15 = fadd(x[15], x[7]);
    float n6 = r0d, n7 = r1d;
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
    x[8] = n8; x[9] = n9; x[10] = n10; x[11] = n11;
    x[12] = n12; x[13] = n13; x[14] = n14; x[15] = n15;
    bf8(x);
    bf8(x + 8);
}

// vn_bf32 (vorbisnative.c:1262)
__device__ void bf32(float *x)
{
    float c1 = cPI1_8, c2 = cPI2_8, c3 = cPI3_8;
    float r0 = fsub(x[30], x[14]), r1 = fsub(x[31], x[15]);
    float n30 = fadd(x[30], x[14]), n31 = fadd(x[31], x[15]);
    float n14 = r0, n15 = r1;
    float r0b = fsub(x[28], x[12]), r1b = fsub(x[29], x[13]);
    float n28 = fadd(x[28], x[12]), n29 = fadd(x[29], x[13]);
    float n12 = fsub(fmul(r0b, c1), fmul(r1b, c3));
    float n13 = fadd(fmul(r0b, c3), fmul(r1b, c1));
    float r0c = fsub(x[26], x[10]), r1c = fsub(x[27], x[11]);
    float n26 = fadd(x[26], x[10]), n27 = fadd(x[27], x[11]);
    float n10 = fmul(fsub(r0c, r1c), c2), n11 = fmul(fadd(r0c, r1c), c2);
    float r0d = fsub(x[24], x[8]), r1d = fsub(x[25], x[9]);
    float n24 = fadd(x[24], x[8]), n25 = fadd(x[25], x[9]);
    float n8 = fsub(fmul(r0d, c3), fmul(r1d, c1));
    float n9 = fadd(fmul(r1d, c3), fmul(r0d, c1));
    float r0e = fsub(x[22], x[6]), r1e = fsub(x[7], x[23]);
    float n22 = fadd(x[22], x[6]), n23 = fadd(x[23], x[7]);
    float n6 = r1e, n7 = r0e;
    float r0f = fsub(x[4], x[20]), r1f = fsub(x[5], x[21]);
    float n20 = fadd(x[20], x[4]), n21 = fadd(x[21], x[5]);
    float n4 = fadd(fmul(r1f, c1), fmul(r0f, c3));
    float n5 = fsub(fmul(r1f, c3), fmul(r0f, c1));
    float r0g = fsub(x[2], x[18]), r1g = fsub(x[3], x[19]);
    float n18 = fadd(x[18], x[2]), n19 = fadd(x[19], x[3]);
    float n2 = fmul(fadd(r1g, r0g), c2), n3 = fmul(fsub(r1g, r0g), c2);
    float r0h = fsub(x[0], x[16]), r1h = fsub(x[1], x[17]);
    float n16 = fadd(x[16], x[0]), n17 = fadd(x[17], x[1]);
    float n0 = fadd(fmul(r1h, c3), fmul(r0h, c1));
    float n1 = fsub(fmul(r1h, c1), fmul(r0h, c3));
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
    x[8] = n8; x[9] = n9; x[10] = n10; x[11] = n11;
    x[12] = n12; x[13] = n13; x[14] = n14; x[15] = n15;
    x[16] = n16; x[17] = n17; x[18] = n18; x[19] = n19;
    x[20] = n20; x[21] = n21; x[22] = n22; x[23] = n23;
    x[24] = n24; x[25] = n25; x[26] = n26; x[27] = n27;
    x[28] = n28; x[29] = n29; x[30] = n30; x[31] = n31;
    bf16(x);
    bf16(x + 16);
}

__global__ void imdct_rows(const float *__restrict__ spec,
                           float *__restrict__ out, ImdctTabs t)
{
    extern __shared__ float sm[];
    const int n = t.n, n2 = n >> 1, n4 = n >> 2, n8 = n >> 3;
    float *y = sm;                       // working vector, padded
    float *z = sm + pad(n2);             // input row, then stage C
    const float *x = spec + (long)blockIdx.x * n2;
    float *o = out + (long)blockIdx.x * n;
    const int tid = threadIdx.x, nt = blockDim.x;
    const float *T = t.T;

    for (int i = tid; i < n2; i += nt)
        z[pad(i)] = x[i];
    __syncthreads();

    // stage A: pre-rotation, y[i] = sa*x[ia]*T[ta] + sb*x[ib]*T[tb]
    for (int i = tid; i < n2; i += nt) {
        float a = fmul(fmul(t.sa[i], z[pad(t.ia[i])]), T[t.ta[i]]);
        float b = fmul(fmul(t.sb[i], z[pad(t.ib[i])]), T[t.tb[i]]);
        y[pad(i)] = fadd(a, b);
    }
    __syncthreads();

    // stage B: radix-2 cascade, P = n2 >> s; each butterfly owns its
    // four floats, so a stage runs in place
    for (int s = 0; s < t.nstages; s++) {
        const int P = n2 >> s, half = P >> 1, nc = P >> 2;
        const int32_t *tc = t.tc_all + t.stage_off[s];
        for (int k = tid; k < (n2 >> 2); k += nt) {
            int b = k / nc, m = k - b * nc;
            int lo = b * P + 2 * m, hi = lo + half;
            float h0 = y[pad(hi)], h1 = y[pad(hi + 1)];
            float l0 = y[pad(lo)], l1 = y[pad(lo + 1)];
            float r0 = fsub(h0, l0), r1 = fsub(h1, l1);
            float c = T[tc[m]], sn = T[tc[m] + 1];
            y[pad(hi)] = fadd(h0, l0);
            y[pad(hi + 1)] = fadd(h1, l1);
            y[pad(lo)] = fadd(fmul(r1, sn), fmul(r0, c));
            y[pad(lo + 1)] = fsub(fmul(r1, c), fmul(r0, sn));
        }
        __syncthreads();
    }
    // the 32-point tails: block b's floats sit contiguous at 33b
    for (int b = tid; b < (n2 >> 5); b += nt)
        bf32(y + 33 * b);
    __syncthreads();

    // stage C: bitreverse + half-angle rotation into z
    for (int m = tid; m < n8; m += nt) {
        int e0 = t.e0[m], e1 = t.e1[m];
        float a0 = y[pad(e0)], a1 = y[pad(e0 + 1)];
        float b0 = y[pad(e1)], b1 = y[pad(e1 + 1)];
        float c = T[t.tC[m]], sn = T[t.tC[m] + 1];
        float r0 = fsub(a1, b1), r1 = fadd(a0, b0);
        float r2 = fadd(fmul(r1, c), fmul(r0, sn));
        float r3 = fsub(fmul(r1, sn), fmul(r0, c));
        float r0h = fmul(0.5f, fadd(a1, b1));
        float r1h = fmul(0.5f, fsub(a0, b0));
        int up = n4 + 2 * (n8 - 1 - m);
        z[pad(2 * m)] = fadd(r0h, r2);
        z[pad(2 * m + 1)] = fadd(r1h, r3);
        z[pad(up)] = fsub(r0h, r2);
        z[pad(up + 1)] = fsub(r3, r1h);
    }
    __syncthreads();

    // stage D: final rotation + symmetric expansion (vorbisnative.c
    // :1373-1386: o reads a and b reversed in its first and third
    // quarters)
    for (int i = tid; i < n4; i += nt) {
        float z0 = z[pad(2 * i)], z1 = z[pad(2 * i + 1)];
        float c = T[t.tD[i]], sn = T[t.tD[i] + 1];
        float a = fsub(fmul(z0, sn), fmul(z1, c));
        float b = -fadd(fmul(z0, c), fmul(z1, sn));
        o[n4 - 1 - i] = a;
        o[n4 + i] = -a;
        o[n2 + n4 - 1 - i] = b;
        o[n2 + n4 + i] = b;
    }
}

}  // namespace

extern "C" int vtt_imdct(const float *spec, float *out, long rows, int n,
                         int nstages, const float *T, const float *sa,
                         const float *sb, const int32_t *ia,
                         const int32_t *ib, const int32_t *ta,
                         const int32_t *tb, const int32_t *tc_all,
                         const int32_t *stage_off, const int32_t *e0,
                         const int32_t *e1, const int32_t *tC,
                         const int32_t *tD, void *stream)
{
    if (n < 64 || n > 8192 || (n & (n - 1)) || rows < 0
        || rows > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    if (rows == 0)
        return 0;
    ImdctTabs t = {T, sa, sb, ia, ib, ta, tb, tc_all, stage_off,
                   e0, e1, tC, tD, n, nstages};
    int threads = n >> 2;
    if (threads < 32)
        threads = 32;
    if (threads > 256)
        threads = 256;
    size_t smem = 2 * (size_t)((n >> 1) + (n >> 6)) * sizeof(float);
    imdct_rows<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
        spec, out, t);
    return (int)cudaGetLastError();
}
