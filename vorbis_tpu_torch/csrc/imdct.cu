// Batched inverse MDCT (libvorbis mdct_backward) as a hand-written Hopper
// kernel: the device stage of the port's decode (models/fastdec.py
// _decode_jobs), one launch a blocksize for every stream of a batch.
//
// Replaces: vorbis_tpu/ops/mdct.py:261 imdct(spec, n, xp=jnp), which the
// JAX package jits per blocksize in vorbis_tpu/models/fastdec.py:210
// (plain jax.numpy, not a Pallas kernel).
//
// Computes, for every row r of a row table (the n/2 float32 spectrum at
// spec + rowoff[r]), the n-sample block out[r] in the SAME expression
// trees as the numpy transform and the host C (csrc/host_decode.c
// vn_imdct1): stage A's pre-rotation, log2(n) - 6 radix-2 stages, the
// 32/16/8-point butterfly tails, stage C's bitreverse and half-angle
// rotation, stage D's rotation and symmetric expansion.  Every product
// and sum is an explicit round-to-nearest intrinsic in the C's operand
// order, and the library is built with -fmad=false as well (never
// --use_fast_math or -ftz=true: subnormals survive), so the output equals
// vn_imdct_batch and the numpy imdct bit for bit.  Stage A's signs
// (sa, sb = +-1) are applied as negations of the spectrum value, which is
// exact: fmul(fmul(-1, x), T) == fmul(-x, T).
//
// Bound on this card: bytes.  A row reads n/2 floats and writes n: 6
// bytes an output sample against ~15 float32 operations (n = 2048; H100
// SXM 3.35 TB/s and 67 TFLOP/s fp32), so the least time is the traffic's.
// No tensor cores and no TF32: bitwise equality to the host C allows
// neither.  The design keeps the card busy on the traffic:
//
// - Persistent CTAs, warps that own whole rows.  A warp owns G = 2048/n
//   rows at n <= 2048 (one row above), so that G * n/64 = 32 tails give
//   every lane one 32-point tail (n = 4096 and 8192: two and four a
//   lane).  Stages are separated by __syncwarp only; the CTA's one
//   __syncthreads follows the table staging.  The grid is the SM count
//   times the CTAs resident a SM, each warp striding over row groups.
// - Tables staged once a CTA into shared memory: the trig table T
//   (n + n/4 floats) and stage B's twiddles laid out a stage after
//   another (tw, (c, s) pairs in the order a warp reads them: n/2 - 32
//   floats).  Every index (stage A's gathers, stage B's trig index,
//   stage C's bit reversal) is computed from the lane's item, not read.
//   At n = 8192 the tables take 57 KB beside two warps' 96 KB.
// - Double-buffered asynchronous staging: while a warp computes one row
//   group, cp.async 16-byte copies bring the next group's spectra into
//   the other buffer (rows must start 16-byte aligned: offsets that are
//   multiples of 4 floats).
// - Stage B runs two radix-2 stages a pass on four (c, s)-pairs held in
//   registers (one radix-2 pass when the count is odd), halving the
//   shared-memory round trips; stage C feeds stage D in registers and
//   stores the block with 16-byte coalesced writes (four m a lane).
// - The working vector is XOR-swizzled at 16-byte granularity within
//   each 32-float chunk (chunk k's word i at i ^ 4 (k & 7)), so that a
//   lane's tail loads, stage B's pair loads and stage A's quad stores
//   hit distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// vn_bf8 (host_decode.c) on 8 contiguous floats
__device__ __forceinline__ void bf8(float *x)
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

// vn_bf16
__device__ __forceinline__ void bf16(float *x)
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

// vn_bf32
__device__ __forceinline__ void bf32(float *x)
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

// the working vector's swizzle: word i of 32-float chunk k at i ^ 4(k & 7)
__device__ __forceinline__ int ys(int e)
{
    return e ^ (((e >> 5) & 7) << 2);
}

// the staged spectra's swizzle, in 16-byte chunks: q ^ ((q >> 3) & 1)
__device__ __forceinline__ int xs(int q)
{
    return q ^ ((q >> 3) & 1);
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem)
{
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(K));
}

// one radix-2 butterfly on (c, s)-pairs lo and hi with twiddle w
__device__ __forceinline__ void bfly(float2 &lo, float2 &hi, float2 w)
{
    float r0 = fsub(hi.x, lo.x), r1 = fsub(hi.y, lo.y);
    hi = make_float2(fadd(hi.x, lo.x), fadd(hi.y, lo.y));
    lo = make_float2(fadd(fmul(r1, w.y), fmul(r0, w.x)),
                     fsub(fmul(r1, w.x), fmul(r0, w.y)));
}

template <int LOGN>
struct Cfg {
    static constexpr int N = 1 << LOGN, N2 = N >> 1, N4 = N >> 2;
    static constexpr int N8 = N >> 3;
    static constexpr int G = N <= 2048 ? 2048 / N : 1;   // rows a warp
    static constexpr int WARPS = N <= 2048 ? 8 : (N == 4096 ? 4 : 2);
    static constexpr int NST = LOGN - 6;                  // radix-2 stages
    static constexpr int TLEN = N + N4;
    static constexpr int TWLEN = NST ? N2 - 32 : 0;
    static constexpr int RB = G * N2;                     // floats a buffer
    static constexpr int SMEM = (TLEN + TWLEN + WARPS * 3 * RB) * 4;
    static constexpr int THREADS = WARPS * 32;
};

// twiddle offset (in pairs) of stage s: stage s' holds (N2 >> s') / 4,
// so the stages before s hold N2/2 - N2/2^(s+1)
template <int N2>
__device__ __forceinline__ int tw_off(int s)
{
    return (N2 >> 1) - (N2 >> (s + 1));
}

// one radix-2 stage (P = N2 >> s) over a warp's rows
template <int LOGN>
__device__ __forceinline__ void pass2(float *y, const float2 *tw, int s,
                                      int lane)
{
    using C = Cfg<LOGN>;
    const int P = C::N2 >> s, nc = P >> 2;
    const float2 *t = tw + tw_off<C::N2>(s);
#pragma unroll 4
    for (int u = lane; u < C::G * (C::N2 >> 2); u += 32) {
        int r = u / (C::N2 >> 2), k = u % (C::N2 >> 2);
        int b = k / nc, m = k % nc;
        int lo = r * C::N2 + b * P + 2 * m, hi = lo + (P >> 1);
        float2 vl = *(float2 *)(y + ys(lo)), vh = *(float2 *)(y + ys(hi));
        bfly(vl, vh, t[m]);
        *(float2 *)(y + ys(lo)) = vl;
        *(float2 *)(y + ys(hi)) = vh;
    }
}

// two radix-2 stages s and s + 1 (P = N2 >> s) in one pass: an item
// holds pairs q0, q0 + P/4, q0 + P/2, q0 + 3P/4 of one block, which the
// two stages' butterflies touch and no other item does
template <int LOGN>
__device__ __forceinline__ void pass4(float *y, const float2 *tw, int s,
                                      int lane)
{
    using C = Cfg<LOGN>;
    const int P = C::N2 >> s, nm = P >> 3;
    const float2 *t0 = tw + tw_off<C::N2>(s);
    const float2 *t1 = tw + tw_off<C::N2>(s + 1);
#pragma unroll 2
    for (int u = lane; u < C::G * (C::N2 >> 3); u += 32) {
        int r = u / (C::N2 >> 3), k = u % (C::N2 >> 3);
        int b = k / nm, m = k % nm;
        int q0 = r * C::N2 + b * P + 2 * m;
        int q1 = q0 + (P >> 2), q2 = q0 + (P >> 1), q3 = q2 + (P >> 2);
        float2 v0 = *(float2 *)(y + ys(q0)), v1 = *(float2 *)(y + ys(q1));
        float2 v2 = *(float2 *)(y + ys(q2)), v3 = *(float2 *)(y + ys(q3));
        bfly(v0, v2, t0[m]);
        bfly(v1, v3, t0[m + nm]);
        float2 w = t1[m];
        bfly(v0, v1, w);
        bfly(v2, v3, w);
        *(float2 *)(y + ys(q0)) = v0;
        *(float2 *)(y + ys(q1)) = v1;
        *(float2 *)(y + ys(q2)) = v2;
        *(float2 *)(y + ys(q3)) = v3;
    }
}

template <int LOGN>
__global__ void __launch_bounds__(Cfg<LOGN>::THREADS)
imdct_rows(const float *__restrict__ spec,
           const long long *__restrict__ rowoff, float *__restrict__ out,
           long rows, const float *__restrict__ Tg,
           const float *__restrict__ twg)
{
    using C = Cfg<LOGN>;
    constexpr int N = C::N, N2 = C::N2, N4 = C::N4, N8 = C::N8, G = C::G;
    extern __shared__ float4 sm4[];
    float *sm = (float *)sm4;
    float *T = sm;                                   // TLEN
    float2 *tw = (float2 *)(sm + C::TLEN);           // TWLEN / 2 pairs
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    float *xb = sm + C::TLEN + C::TWLEN + wid * 3 * C::RB;  // 2 buffers
    float *y = xb + 2 * C::RB;

    for (int i = threadIdx.x; i < C::TLEN; i += C::THREADS)
        T[i] = Tg[i];
    for (int i = threadIdx.x; i < C::TWLEN; i += C::THREADS)
        ((float *)tw)[i] = twg[i];
    __syncthreads();

    const long ngroups = (rows + G - 1) / G;
    const long stride = (long)gridDim.x * C::WARPS;
    long grp = (long)blockIdx.x * C::WARPS + wid;

    // the row group's spectra into buffer dst, 16 bytes a copy
    auto stage = [&](long g, float *dst) {
#pragma unroll
        for (int q = lane; q < G * (N2 >> 2); q += 32) {
            int r = q / (N2 >> 2), j = q % (N2 >> 2);
            long row = g * G + r;
            if (row < rows)
                cp_async16(dst + 4 * xs(q), spec + rowoff[row] + 4 * j);
        }
        cp_async_commit();
    };

    if (grp < ngroups)
        stage(grp, xb);
    for (int buf = 0; grp < ngroups; grp += stride, buf ^= 1) {
        if (grp + stride < ngroups)
            stage(grp + stride, xb + (buf ^ 1) * C::RB);
        else
            cp_async_commit();                  // an empty group
        cp_async_wait<1>();
        __syncwarp();
        const float *x = xb + buf * C::RB;

        // stage A: item (r, t) reads the 8 floats at B = N2 - 8 - 8t and
        // writes y[N4 - 4(t+1) .. +3] (loop 1, odd inputs) and
        // y[N4 + 4t .. +3] (loop 2, even inputs)
#pragma unroll 4
        for (int u = lane; u < G * (N2 >> 3); u += 32) {
            int r = u / (N2 >> 3), t = u % (N2 >> 3);
            int q = r * (N2 >> 2) + (N2 >> 2) - 2 - 2 * t;
            float4 lo4 = *(const float4 *)(x + 4 * xs(q));
            float4 hi4 = *(const float4 *)(x + 4 * xs(q + 1));
            float x0 = lo4.x, x1 = lo4.y, x2 = lo4.z, x3 = lo4.w;
            float x4 = hi4.x, x5 = hi4.y, x6 = hi4.z, x7 = hi4.w;
            float4 t1 = *(const float4 *)(T + N4 + 4 * t);
            float4 t2 = *(const float4 *)(T + N4 - 4 * (t + 1));
            float4 o1, o2;
            o1.x = fadd(fmul(-x3, t1.w), fmul(-x1, t1.z));
            o1.y = fadd(fmul(x1, t1.w), fmul(-x3, t1.z));
            o1.z = fadd(fmul(-x7, t1.y), fmul(-x5, t1.x));
            o1.w = fadd(fmul(x5, t1.y), fmul(-x7, t1.x));
            o2.x = fadd(fmul(x4, t2.w), fmul(x6, t2.z));
            o2.y = fadd(fmul(x4, t2.z), fmul(-x6, t2.w));
            o2.z = fadd(fmul(x0, t2.y), fmul(x2, t2.x));
            o2.w = fadd(fmul(x0, t2.x), fmul(-x2, t2.y));
            *(float4 *)(y + ys(r * N2 + N4 - 4 * (t + 1))) = o1;
            *(float4 *)(y + ys(r * N2 + N4 + 4 * t)) = o2;
        }
        __syncwarp();

        // stage B: radix-2 stages P = N2 .. 64, two a pass
        int s = 0;
        for (; s + 1 < C::NST; s += 2) {
            pass4<LOGN>(y, tw, s, lane);
            __syncwarp();
        }
        if (s < C::NST) {
            pass2<LOGN>(y, tw, s, lane);
            __syncwarp();
        }

        // the 32-point tails: one 32-float chunk a lane, in registers
#pragma unroll 1
        for (int c = lane; c < G * (N2 >> 5); c += 32) {
            float v[32];
            float4 *p = (float4 *)(y + 32 * c);
#pragma unroll
            for (int k = 0; k < 8; k++) {
                float4 w = p[k ^ (c & 7)];
                v[4 * k] = w.x; v[4 * k + 1] = w.y;
                v[4 * k + 2] = w.z; v[4 * k + 3] = w.w;
            }
            bf32(v);
#pragma unroll
            for (int k = 0; k < 8; k++)
                p[k ^ (c & 7)] = make_float4(v[4 * k], v[4 * k + 1],
                                             v[4 * k + 2], v[4 * k + 3]);
        }
        __syncwarp();

        // stages C and D: item (r, v) takes m = 4v .. 4v+3; stage C's m
        // gives stage D's pairs m and N4-1-m, kept in registers
#pragma unroll 1
        for (int u = lane; u < G * (N8 >> 2); u += 32) {
            int r = u / (N8 >> 2), v = u % (N8 >> 2);
            long row = grp * G + r;
            float4 tc0 = *(const float4 *)(T + N + 8 * v);
            float4 tc1 = *(const float4 *)(T + N + 8 * v + 4);
            float4 td0 = *(const float4 *)(T + N2 + 8 * v);
            float4 td1 = *(const float4 *)(T + N2 + 8 * v + 4);
            float4 tr0 = *(const float4 *)(T + N - 8 - 8 * v);
            float4 tr1 = *(const float4 *)(T + N - 4 - 8 * v);
            float cC[4] = {tc0.x, tc0.z, tc1.x, tc1.z};
            float sC[4] = {tc0.y, tc0.w, tc1.y, tc1.w};
            float cD[4] = {td0.x, td0.z, td1.x, td1.z};
            float sD[4] = {td0.y, td0.w, td1.y, td1.w};
            float cR[4] = {tr1.z, tr1.x, tr0.z, tr0.x};  // pair N4-1-m
            float sR[4] = {tr1.w, tr1.y, tr0.w, tr0.y};
            float a[4], b[4], a2[4], b2[4];
#pragma unroll
            for (int j = 0; j < 4; j++) {
                int m = 4 * v + j;
                int e1 = (int)(__brev((unsigned)m) >> (33 - LOGN));
                int e0 = ((~e1) & (N2 - 1)) - 1;
                float2 A = *(const float2 *)(y + ys(r * N2 + e0));
                float2 B = *(const float2 *)(y + ys(r * N2 + e1));
                float a0 = A.x, a1 = A.y, b0 = B.x, b1 = B.y;
                float r0 = fsub(a1, b1), r1 = fadd(a0, b0);
                float r2 = fadd(fmul(r1, cC[j]), fmul(r0, sC[j]));
                float r3 = fsub(fmul(r1, sC[j]), fmul(r0, cC[j]));
                float r0h = fmul(0.5f, fadd(a1, b1));
                float r1h = fmul(0.5f, fsub(a0, b0));
                // pair m
                float z0 = fadd(r0h, r2), z1 = fadd(r1h, r3);
                a[j] = fsub(fmul(z0, sD[j]), fmul(z1, cD[j]));
                b[j] = -fadd(fmul(z0, cD[j]), fmul(z1, sD[j]));
                // pair N4-1-m
                z0 = fsub(r0h, r2);
                z1 = fsub(r3, r1h);
                a2[j] = fsub(fmul(z0, sR[j]), fmul(z1, cR[j]));
                b2[j] = -fadd(fmul(z0, cR[j]), fmul(z1, sR[j]));
            }
            if (row < rows) {
                float4 *o = (float4 *)(out + row * (long)N);
                int q = v;                       // float4 index of m = 4v
                // pair i = m: o[N4-1-m] = a, o[N4+m] = -a,
                // o[N2+N4-1-m] = b, o[N2+N4+m] = b
                o[N4 / 4 - 1 - q] = make_float4(a[3], a[2], a[1], a[0]);
                o[N4 / 4 + q] = make_float4(-a[0], -a[1], -a[2], -a[3]);
                o[(N2 + N4) / 4 - 1 - q] = make_float4(b[3], b[2], b[1],
                                                       b[0]);
                o[(N2 + N4) / 4 + q] = make_float4(b[0], b[1], b[2], b[3]);
                // pair i = N4-1-m: o[m] = a2, o[N2-1-m] = -a2,
                // o[N2+m] = b2, o[N-1-m] = b2
                o[q] = make_float4(a2[0], a2[1], a2[2], a2[3]);
                o[N2 / 4 - 1 - q] = make_float4(-a2[3], -a2[2], -a2[1],
                                                -a2[0]);
                o[N2 / 4 + q] = make_float4(b2[0], b2[1], b2[2], b2[3]);
                o[N / 4 - 1 - q] = make_float4(b2[3], b2[2], b2[1], b2[0]);
            }
        }
        __syncwarp();
    }
    cp_async_wait<0>();
}

struct Launch {
    int sms = 0, per_sm = 0;
};

template <int LOGN>
int launch(const float *spec, const long long *rowoff, float *out,
           long rows, const float *T, const float *tw, cudaStream_t st)
{
    using C = Cfg<LOGN>;
    static Launch cache[64];                  // by device ordinal
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return (int)e;
    if (dev < 0 || dev >= 64)
        return (int)cudaErrorInvalidDevice;
    Launch &L = cache[dev];
    if (L.per_sm == 0) {
        e = cudaFuncSetAttribute(imdct_rows<LOGN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::SMEM);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&L.sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &L.per_sm, imdct_rows<LOGN>, C::THREADS, C::SMEM);
        if (e != cudaSuccess)
            return (int)e;
        if (L.per_sm < 1)
            return (int)cudaErrorLaunchOutOfResources;
    }
    long groups = (rows + C::G - 1) / C::G;
    long want = (groups + C::WARPS - 1) / C::WARPS;
    long cap = (long)L.sms * L.per_sm;
    unsigned grid = (unsigned)(want < cap ? want : cap);
    imdct_rows<LOGN><<<grid, C::THREADS, C::SMEM, st>>>(spec, rowoff, out,
                                                        rows, T, tw);
    return (int)cudaGetLastError();
}

}  // namespace

// spec: the spectra; rowoff[r]: element offset of row r's n/2 floats in
// spec (a multiple of 4); out: (rows, n) blocks; T: the trig table (n +
// n/4 floats); tw: stage B's twiddle pairs (n/2 - 32 floats, none at
// n = 64).  Returns a cudaError_t.
extern "C" int vtt_imdct(const float *spec, const long long *rowoff,
                         float *out, long rows, int n, const float *T,
                         const float *tw, void *stream)
{
    if (rows < 0 || rows > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    if (rows == 0)
        return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (n) {
    case 64: return launch<6>(spec, rowoff, out, rows, T, tw, st);
    case 128: return launch<7>(spec, rowoff, out, rows, T, tw, st);
    case 256: return launch<8>(spec, rowoff, out, rows, T, tw, st);
    case 512: return launch<9>(spec, rowoff, out, rows, T, tw, st);
    case 1024: return launch<10>(spec, rowoff, out, rows, T, tw, st);
    case 2048: return launch<11>(spec, rowoff, out, rows, T, tw, st);
    case 4096: return launch<12>(spec, rowoff, out, rows, T, tw, st);
    case 8192: return launch<13>(spec, rowoff, out, rows, T, tw, st);
    }
    return (int)cudaErrorInvalidValue;
}
