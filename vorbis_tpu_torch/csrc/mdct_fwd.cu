// The encoder's forward MDCT and log spectrum as a hand-written Hopper
// kernel: the first stage of every DeviceAnalysis.spectra call of the
// port (vorbis_tpu_torch/ops/torchdsp.py), one launch a spectra call.
//
// Replaces: mdct_forward(w, n, xp=jnp) and log_spectrum inside the jitted
// DeviceAnalysis.spectra of vorbis_tpu/ops/jaxdsp.py:258-271 (plain
// jax.numpy, not a Pallas kernel; the transform of
// vorbis_tpu/ops/mdct.py:383).
//
// Computes, for row r of frames (R, n): the windowed frame x * win (win
// one window, or row wid[r] of four), its MDCT md[r] (n/2 floats) and
// logmdct[r] = todB(md) + .345, in the expression trees and the roundings
// of XLA:CPU's compile of the JAX code (ops/mdct_cuda.py says which and
// mdct_fwd_plain is the same in PyTorch):
//   - every operation is an explicit PTX instruction with .rn.ftz: XLA's
//     CPU code runs with flush-to-zero and denormals-are-zero;
//   - a fused multiply-add exactly where LLVM contracts one in XLA's
//     code, and nowhere else (the library is built with -fmad=false);
//   - the 32-point tail follows XLA's fusions, one an output position
//     (bf32_xla below).
//
// Bound on this card: bytes.  A row reads n floats (and the window, which
// stays in L1/L2) and writes n: 8 bytes a sample against ~40 float32
// operations at n = 2048 (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32), so the
// least time is the traffic's.  No tensor cores and no TF32: bitwise
// equality allows neither.  The design is csrc/imdct.cu's:
//
// - Persistent CTAs, warps that own whole rows.  A warp owns G rows, at
//   most 2048/n (one above 2048), so that every lane owns one 32-point
//   tail of a full group (two and four at n = 4096 and 8192); a small
//   batch takes fewer rows a warp (down to one) and more warps.  Stages
//   are separated by __syncwarp only; the CTA's __syncthreads follow the
//   table staging.
// - At n >= 1024 (STAGED) everything a row reads comes from shared
//   memory.  T (n + n/4 floats) and, gathered from it, the radix-2
//   stages' twiddles in the order a warp reads them (n/2 - 32 floats) are
//   staged once a CTA; cp.async 16-byte copies bring a row group's frames
//   and their windows (the one window, or the row's of four, which stay
//   in L1) into the warp's buffers, the first group's with T, the next
//   group's as soon as the fold has read the current one, so the copy
//   runs under the radix-2 stages, the tails and the final stage.  The
//   fold reads a lane's four samples as two 16-byte words of consecutive
//   chunks (a0 and a2 share one, a1 and a3 another), bank-free, and the
//   window's the same way; each loop takes a few items a lane at a time,
//   their shared loads issued before their stores.
// - Below 1024 a row is a few hundred cycles of work and the kernel's
//   time is latency: the fold reads frames and windows with the same
//   16-byte words straight from global memory, every stage reads T
//   through L1, and nothing is staged or waited for.
// - Two radix-2 stages a pass on four (c, s)-pairs held in registers (one
//   radix-2 pass when the count is odd), each pass's index arithmetic
//   from constants (the stages are template arguments); the working
//   vector XOR-swizzled at 16-byte granularity within each 32-float chunk
//   (chunk k's word i at i ^ 4 (k & 7)), so that the fold's pair stores,
//   the stages' pair loads and the tails' chunk loads hit distinct banks.
// - The bitreverse stage feeds the final rotation and todB in registers,
//   one m a lane at a time, and writes md and logmdct with coalesced
//   stores (neighbouring lanes, neighbouring words, up or down).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fadd(float a, float b)
{
    float r;
    asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float fsub(float a, float b)
{
    float r;
    asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float fmul(float a, float b)
{
    float r;
    asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
// a*b + c rounded once
__device__ __forceinline__ float ffma(float a, float b, float c)
{
    float r;
    asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
    return r;
}

constexpr float cPI1_8 = 0.92387953f;
constexpr float cPI2_8 = 0.70710678f;
constexpr float cPI3_8 = 0.38268343f;
// todB's scale, and -764.6161886f + .345f as XLA folds them (float32)
constexpr float TODB_SCALE = 0x1.815182p-21f;
constexpr float TODB_C345 = -0x1.7e22b8p+9f;

// The 8-point tail on x[0..7]; p[0], p[1], p[4], p[5] (when p) are the
// unrounded factors of x0, x1, x4, x5 = p * cos(pi/4), which the add or
// subtract they feed fuses.
__device__ __forceinline__ void bf8_xla(float *x, const float *p)
{
    const float c2 = cPI2_8;
    float r0 = fadd(x[6], x[2]), r1 = fsub(x[6], x[2]);
    float r2, r3, s0, u0;
    if (p) {
        r2 = ffma(p[4], c2, x[0]);
        r3 = ffma(p[4], c2, -x[0]);
        s0 = ffma(p[5], c2, -x[1]);
        u0 = ffma(p[5], c2, x[1]);
    } else {
        r2 = fadd(x[4], x[0]);
        r3 = fsub(x[4], x[0]);
        s0 = fsub(x[5], x[1]);
        u0 = fadd(x[5], x[1]);
    }
    float n6 = fadd(r0, r2), n4 = fsub(r0, r2);
    float s2 = fsub(x[7], x[3]);
    float n0 = fadd(r1, s0), n2 = fsub(r1, s0);
    float u1 = fadd(x[7], x[3]);
    float n3 = fadd(s2, r3), n1 = fsub(s2, r3);
    float n7 = fadd(u1, u0), n5 = fsub(u1, u0);
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
}

// The 16-point tail on g[0..15]; q (when given) holds the unrounded
// factors of g2, g3, g10, g11 (= q * cos(pi/4)).  Writes the 16 outputs
// to out (out may be g).
__device__ __forceinline__ void bf16_xla(const float *g, const float *q,
                                         float *out)
{
    const float c2 = cPI2_8;
    float r0 = fsub(g[1], g[9]), r1 = fsub(g[0], g[8]);
    float n8 = fadd(g[8], g[0]), n9 = fadd(g[9], g[1]);
    float p[8];
    p[0] = fadd(r0, r1);
    p[1] = fsub(r0, r1);
    float n2, n3, n10, n11;
    if (q) {
        n2 = ffma(q[3], c2, -g[11]);
        n3 = ffma(q[10], c2, -g[2]);
        n10 = ffma(q[10], c2, g[2]);
        n11 = ffma(q[11], c2, g[3]);
    } else {
        n2 = fsub(g[3], g[11]);
        n3 = fsub(g[10], g[2]);
        n10 = fadd(g[10], g[2]);
        n11 = fadd(g[11], g[3]);
    }
    float r0c = fsub(g[12], g[4]), r1c = fsub(g[13], g[5]);
    float n12 = fadd(g[12], g[4]), n13 = fadd(g[13], g[5]);
    p[4] = fsub(r0c, r1c);
    p[5] = fadd(r0c, r1c);
    float n6 = fsub(g[14], g[6]), n7 = fsub(g[15], g[7]);
    float n14 = fadd(g[14], g[6]), n15 = fadd(g[15], g[7]);
    float lo[8] = {fmul(p[0], c2), fmul(p[1], c2), n2, n3,
                   fmul(p[4], c2), fmul(p[5], c2), n6, n7};
    float hi[8] = {n8, n9, n10, n11, n12, n13, n14, n15};
    bf8_xla(lo, p);
    bf8_xla(hi, nullptr);
#pragma unroll
    for (int i = 0; i < 8; i++) {
        out[i] = lo[i];
        out[8 + i] = hi[i];
    }
}

// The 32-point tail (ops/mdct.py _bf32) on x[0..31] in place, in XLA's
// fusions: n9 = r1d*c3 + r0d*c1 fuses r0d*c1 in the fusions of output
// positions 0-7 and r1d*c3 in those of 8-31.
__device__ __forceinline__ void bf32_xla(float *x)
{
    const float c1 = cPI1_8, c2 = cPI2_8, c3 = cPI3_8;
    float y[32], q[16];
    y[30] = fadd(x[30], x[14]); y[31] = fadd(x[31], x[15]);
    y[14] = fsub(x[30], x[14]); y[15] = fsub(x[31], x[15]);
    float r0b = fsub(x[28], x[12]), r1b = fsub(x[29], x[13]);
    y[28] = fadd(x[28], x[12]); y[29] = fadd(x[29], x[13]);
    y[12] = ffma(r0b, c1, -fmul(r1b, c3));
    y[13] = ffma(r0b, c3, fmul(r1b, c1));
    float r0c = fsub(x[26], x[10]), r1c = fsub(x[27], x[11]);
    y[26] = fadd(x[26], x[10]); y[27] = fadd(x[27], x[11]);
    q[10] = fsub(r0c, r1c);
    q[11] = fadd(r0c, r1c);
    float r0d = fsub(x[24], x[8]), r1d = fsub(x[25], x[9]);
    y[24] = fadd(x[24], x[8]); y[25] = fadd(x[25], x[9]);
    y[8] = ffma(r0d, c3, -fmul(r1d, c1));
    y[9] = ffma(r1d, c3, fmul(r0d, c1));           // positions 8-31
    float y9lo = ffma(r0d, c1, fmul(r1d, c3));     // positions 0-7
    y[22] = fadd(x[22], x[6]); y[23] = fadd(x[23], x[7]);
    y[6] = fsub(x[7], x[23]); y[7] = fsub(x[22], x[6]);
    float r0f = fsub(x[4], x[20]), r1f = fsub(x[5], x[21]);
    y[20] = fadd(x[20], x[4]); y[21] = fadd(x[21], x[5]);
    y[4] = ffma(r1f, c1, fmul(r0f, c3));
    y[5] = ffma(r1f, c3, -fmul(r0f, c1));
    float r0g = fsub(x[2], x[18]), r1g = fsub(x[3], x[19]);
    y[18] = fadd(x[18], x[2]); y[19] = fadd(x[19], x[3]);
    q[2] = fadd(r1g, r0g);
    q[3] = fsub(r1g, r0g);
    float r0h = fsub(x[0], x[16]), r1h = fsub(x[1], x[17]);
    y[16] = fadd(x[16], x[0]); y[17] = fadd(x[17], x[1]);
    y[0] = ffma(r1h, c3, fmul(r0h, c1));
    y[1] = ffma(r1h, c1, -fmul(r0h, c3));
    y[2] = fmul(q[2], c2); y[3] = fmul(q[3], c2);
    y[10] = fmul(q[10], c2); y[11] = fmul(q[11], c2);
    float a[16];
    bf16_xla(y, q, a);                // positions 8-15 from here
    y[9] = y9lo;
    bf16_xla(y, q, x);                // positions 0-7 from here
#pragma unroll
    for (int i = 8; i < 16; i++)
        x[i] = a[i];
    bf16_xla(y + 16, nullptr, x + 16);
}

// the working vector's swizzle: word i of 32-float chunk k at i ^ 4(k & 7)
__device__ __forceinline__ int ys(int e)
{
    return e ^ (((e >> 5) & 7) << 2);
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem)
{
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}
// the same through L1: a table of windows is read row after row
__device__ __forceinline__ void cp_async16_ca(void *smem, const void *gmem)
{
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// one radix-2 butterfly on (c, s)-pairs lo and hi with twiddle w = (Tc,
// Ts): hi + lo, and the rotation of hi - lo as fma(r1, Ts, r0*Tc),
// fma(r1, Tc, -(r0*Ts))
__device__ __forceinline__ void bfly(float2 &lo, float2 &hi, float2 w)
{
    float r0 = fsub(hi.x, lo.x), r1 = fsub(hi.y, lo.y);
    hi = make_float2(fadd(hi.x, lo.x), fadd(hi.y, lo.y));
    lo = make_float2(ffma(r1, w.y, fmul(r0, w.x)),
                     ffma(r1, w.x, -fmul(r0, w.y)));
}

template <int LOGN>
struct Cfg {
    static constexpr int N = 1 << LOGN, N2 = N >> 1, N4 = N >> 2;
    static constexpr int N8 = N >> 3;
    static constexpr int GMAX = N <= 2048 ? 2048 / N : 1;   // rows a warp
    static constexpr int WARPS = N <= 2048 ? 8 : (N == 4096 ? 4 : 2);
    static constexpr int NST = LOGN - 6;                  // radix-2 stages
    static constexpr int TLEN = N + N4;
    static constexpr int TWLEN = NST ? N2 - 32 : 0;
    // n >= 1024: frames, windows and tables staged in shared memory and
    // several items a lane at a time; below, where a row is a few hundred
    // cycles of work and latency is all, the fold reads frames and
    // windows and every stage T straight from global memory (L1)
    static constexpr bool STAGED = N >= 1024;
    static constexpr int TSM = STAGED ? TLEN + TWLEN : 0;
    // a warp's frames, their windows and its working vectors
    static constexpr int WFL = GMAX * (STAGED ? 2 * N + N2 : N2);
    static constexpr int SMEM = (TSM + WARPS * WFL) * 4;
    // items a lane takes at a time (loads before stores) in the fold and
    // the two kinds of radix-2 pass
    static constexpr int FB = STAGED ? 4 : 1;
    static constexpr int B2 = STAGED ? 4 : 1;
    static constexpr int B4 = STAGED ? 2 : 1;
};

// twiddle offset (in pairs) of stage s: stage s' holds (N2 >> s') / 4,
// so the stages before s hold N2/2 - N2/2^(s+1)
template <int N2>
__device__ __forceinline__ int tw_off(int s)
{
    return (N2 >> 1) - (N2 >> (s + 1));
}

// twiddle m of stage s: tw's pair (t = tw at the stage's offset), or
// T's pair at stride 4 << s
template <int LOGN>
__device__ __forceinline__ float2 twid(const float2 *t, const float *T,
                                       int s, int m)
{
    if constexpr (Cfg<LOGN>::STAGED) {
        return t[m];
    } else {
        const int nc = (Cfg<LOGN>::N2 >> s) >> 2;
        return *(const float2 *)(T + (4 << s) * (nc - 1 - m));
    }
}

// one radix-2 stage (P = N2 >> S) over a warp's G rows
template <int LOGN, int S>
__device__ __forceinline__ void pass2(float *y, const float2 *tw,
                                      const float *T, int G, int lane)
{
    using C = Cfg<LOGN>;
    constexpr int s = S, P = C::N2 >> s, nc = P >> 2;
    const float2 *t = tw + tw_off<C::N2>(s);
    const int items = G * (C::N2 >> 2);
    // four items a lane at a time, loads before the stores
    for (int u0 = lane; u0 < items; u0 += 32 * C::B2) {
        float2 vl[C::B2], vh[C::B2];
        int lo[C::B2];
#pragma unroll
        for (int q = 0; q < C::B2; q++) {
            int u = u0 + 32 * q;
            if (u >= items)
                break;
            int r = u / (C::N2 >> 2), k = u % (C::N2 >> 2);
            int b = k / nc, m = k % nc;
            lo[q] = r * C::N2 + b * P + 2 * m;
            vl[q] = *(float2 *)(y + ys(lo[q]));
            vh[q] = *(float2 *)(y + ys(lo[q] + (P >> 1)));
            bfly(vl[q], vh[q], twid<LOGN>(t, T, s, m));
        }
#pragma unroll
        for (int q = 0; q < C::B2; q++) {
            if (u0 + 32 * q >= items)
                break;
            *(float2 *)(y + ys(lo[q])) = vl[q];
            *(float2 *)(y + ys(lo[q] + (P >> 1))) = vh[q];
        }
    }
}

// two radix-2 stages S and S + 1 (P = N2 >> S) in one pass: an item
// holds pairs q0, q0 + P/4, q0 + P/2, q0 + 3P/4 of one block, which the
// two stages' butterflies touch and no other item does
template <int LOGN, int S>
__device__ __forceinline__ void pass4(float *y, const float2 *tw,
                                      const float *T, int G, int lane)
{
    using C = Cfg<LOGN>;
    constexpr int s = S, P = C::N2 >> s, nm = P >> 3;
    const float2 *t0 = tw + tw_off<C::N2>(s);
    const float2 *t1 = tw + tw_off<C::N2>(s + 1);
    const int items = G * (C::N2 >> 3);
    // two items a lane at a time, loads before the stores
    for (int u0 = lane; u0 < items; u0 += 32 * C::B4) {
        float2 v[C::B4][4];
        int q0[C::B4];
#pragma unroll
        for (int q = 0; q < C::B4; q++) {
            int u = u0 + 32 * q;
            if (u >= items)
                break;
            int r = u / (C::N2 >> 3), k = u % (C::N2 >> 3);
            int b = k / nm, m = k % nm;
            q0[q] = r * C::N2 + b * P + 2 * m;
#pragma unroll
            for (int j = 0; j < 4; j++)
                v[q][j] = *(float2 *)(y + ys(q0[q] + j * (P >> 2)));
            bfly(v[q][0], v[q][2], twid<LOGN>(t0, T, s, m));
            bfly(v[q][1], v[q][3], twid<LOGN>(t0, T, s, m + nm));
            float2 w = twid<LOGN>(t1, T, s + 1, m);
            bfly(v[q][0], v[q][1], w);
            bfly(v[q][2], v[q][3], w);
        }
#pragma unroll
        for (int q = 0; q < C::B4; q++) {
            if (u0 + 32 * q >= items)
                break;
#pragma unroll
            for (int j = 0; j < 4; j++)
                *(float2 *)(y + ys(q0[q] + j * (P >> 2))) = v[q][j];
        }
    }
}

// the radix-2 stages S .. NST - 1, two a pass (the last alone when their
// count is odd), each pass's indices from constants
template <int LOGN, int S>
__device__ __forceinline__ void stages(float *y, const float2 *tw,
                                       const float *T, int G, int lane)
{
    if constexpr (S + 1 < Cfg<LOGN>::NST) {
        pass4<LOGN, S>(y, tw, T, G, lane);
        __syncwarp();
        stages<LOGN, S + 2>(y, tw, T, G, lane);
    } else if constexpr (S < Cfg<LOGN>::NST) {
        pass2<LOGN, S>(y, tw, T, G, lane);
        __syncwarp();
    }
}

__device__ __forceinline__ float logspec(float v)
{
    return ffma((float)(__float_as_int(v) & 0x7fffffff), TODB_SCALE,
                TODB_C345);
}

template <int LOGN>
__global__ void __launch_bounds__(Cfg<LOGN>::WARPS * 32)
mdct_fwd_rows(const float *__restrict__ frames,
              const float *__restrict__ win, const int *__restrict__ wid,
              float *__restrict__ md, float *__restrict__ logmdct,
              long rows, int G, const float *__restrict__ Tg)
{
    using C = Cfg<LOGN>;
    constexpr int N = C::N, N2 = C::N2, N4 = C::N4, N8 = C::N8;
    extern __shared__ float4 sm4[];
    float *sm = (float *)sm4;
    float *Ts = sm;                                  // TLEN
    float2 *tw = (float2 *)(sm + C::TLEN);           // TWLEN / 2 pairs
    const float *T = C::STAGED ? Ts : Tg;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    float *xb = sm + C::TSM + w * C::WFL;              // G frames
    float *wb = xb + C::GMAX * N;                      // their windows
    float *y = C::STAGED ? wb + C::GMAX * N : xb;      // G vectors

    const long ngroups = (rows + G - 1) / G;
    const long stride = (long)gridDim.x * warps;
    long grp = (long)blockIdx.x * warps + w;

    // the row group's frames and windows into the warp's buffers, 16
    // bytes a copy
    auto stage = [&](long g) {
        for (int q = lane; q < G * N4; q += 32) {
            int r = q / N4, j = q % N4;
            long row = g * G + r;
            if (row < rows) {
                cp_async16(xb + 4 * q, frames + row * (long)N + 4 * j);
                cp_async16_ca(wb + 4 * q, win + (wid ? (long)wid[row] * N
                                                     : 0L) + 4 * j);
            }
        }
        cp_async_commit();
    };

    // the first group's copy and T's run together; the twiddles are
    // gathered from the staged T
    if constexpr (C::STAGED) {
        if (grp < ngroups)
            stage(grp);
        for (int i = threadIdx.x; i < C::TLEN / 4; i += blockDim.x)
            cp_async16(Ts + 4 * i, Tg + 4 * i);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        // stage s, pair j: T at stride (nc - 1 - j), stride = 4 << s
        for (int s = 0; s < C::NST; s++) {
            const int nc = (N2 >> s) >> 2;
            for (int j = threadIdx.x; j < nc; j += blockDim.x) {
                int t = (4 << s) * (nc - 1 - j);
                tw[tw_off<N2>(s) + j] = make_float2(Ts[t], Ts[t + 1]);
            }
        }
        __syncthreads();
    }

    for (; grp < ngroups; grp += stride) {
        if constexpr (C::STAGED) {
            cp_async_wait_all();
            __syncwarp();
        }

        // the fold and the first rotation: item (r, k) reads a0, a2 from
        // one 16-byte chunk (offsets 2, 0) and a1, a3 from another (1, 3)
        // of row r's frame and window (staged, or from global memory);
        // FB items a lane at a time, the loads before the stores
        for (int u0 = lane; u0 < G * N4; u0 += 32 * C::FB) {
            float2 o[C::FB];
            int dst[C::FB];
#pragma unroll
            for (int q = 0; q < C::FB; q++) {
                int u = u0 + 32 * q;
                if (u >= G * N4)
                    break;
                int r = u / N4, k = u % N4;
                int cA, cB;
                bool neg0, neg1;
                if (k < N8 / 2) {
                    cA = (N2 + N4) / 4 - k - 1; cB = (N2 + N4) / 4 + k;
                    neg0 = false; neg1 = false;
                } else if (k < (N2 - N8) / 2) {
                    cA = (N2 + N4) / 4 - k - 1; cB = k - N8 / 2;
                    neg0 = false; neg1 = true;
                } else {
                    cA = N / 4 - (k - (N2 - N8) / 2) - 1; cB = k - N8 / 2;
                    neg0 = true; neg1 = true;
                }
                float4 fa, fb, wa, wc;
                if constexpr (C::STAGED) {
                    const float4 *f4 = (const float4 *)(xb + r * N);
                    const float4 *w4 = (const float4 *)(wb + r * N);
                    fa = f4[cA]; fb = f4[cB]; wa = w4[cA]; wc = w4[cB];
                } else {
                    // a row past the end reads the last (nothing of it
                    // is stored)
                    long row = grp * G + r < rows ? grp * G + r : rows - 1;
                    const float4 *f4 = (const float4 *)(frames + row * N);
                    const float4 *w4 = (const float4 *)(
                        win + (wid ? (long)__ldg(wid + row) * N : 0L));
                    fa = __ldg(f4 + cA); fb = __ldg(f4 + cB);
                    wa = __ldg(w4 + cA); wc = __ldg(w4 + cB);
                }
                float x0 = fmul(fa.z, wa.z), x2 = fmul(fa.x, wa.x);
                float x1 = fmul(fb.y, wc.y), x3 = fmul(fb.w, wc.w);
                float r0 = fadd(neg0 ? -x0 : x0, neg1 ? -x1 : x1);
                float r1 = fadd(neg0 ? -x2 : x2, neg1 ? -x3 : x3);
                float2 t = *(const float2 *)(T + N2 - 2 * (k + 1));
                o[q] = make_float2(ffma(r1, t.y, fmul(r0, t.x)),
                                   ffma(r1, t.x, -fmul(r0, t.y)));
                dst[q] = ys(r * N2 + 2 * k);
            }
#pragma unroll
            for (int q = 0; q < C::FB; q++) {
                if (u0 + 32 * q >= G * N4)
                    break;
                *(float2 *)(y + dst[q]) = o[q];
            }
        }
        __syncwarp();
        // the buffers are free: the next group's copy runs under the rest
        if constexpr (C::STAGED)
            if (grp + stride < ngroups)
                stage(grp + stride);

        // radix-2 stages P = N2 .. 64, two a pass
        stages<LOGN, 0>(y, tw, T, G, lane);

        // the 32-point tails: one 32-float chunk a lane, in registers
#pragma unroll 1
        for (int c = lane; c < G * (N2 >> 5); c += 32) {
            float v[32];
            float4 *p = (float4 *)(y + 32 * c);
#pragma unroll
            for (int k = 0; k < 8; k++) {
                float4 q = p[k ^ (c & 7)];
                v[4 * k] = q.x; v[4 * k + 1] = q.y;
                v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
            }
            bf32_xla(v);
#pragma unroll
            for (int k = 0; k < 8; k++)
                p[k ^ (c & 7)] = make_float4(v[4 * k], v[4 * k + 1],
                                             v[4 * k + 2], v[4 * k + 3]);
        }
        __syncwarp();

        // bitreverse + half-angle rotation and the final rotation: item
        // (r, m) gives the pairs m and N4-1-m, md and logmdct at m,
        // N2-1-m, N4-1-m and N4+m: neighbouring lanes store neighbouring
        // words
        const float scale = 4.0f / N;
        for (int u = lane; u < G * N8; u += 32) {
            int r = u / N8, m = u % N8;
            long row = grp * G + r;
            float2 tC = *(const float2 *)(T + N + 2 * m);
            float2 tD = *(const float2 *)(T + N2 + 2 * m);
            float2 tR = *(const float2 *)(T + N - 2 - 2 * m);  // N4-1-m
            int e1 = (int)(__brev((unsigned)m) >> (33 - LOGN));
            int e0 = ((~e1) & (N2 - 1)) - 1;
            float2 A = *(const float2 *)(y + ys(r * N2 + e0));
            float2 B = *(const float2 *)(y + ys(r * N2 + e1));
            float rr0 = fsub(A.y, B.y), rr1 = fadd(A.x, B.x);
            float rr2 = ffma(rr1, tC.x, fmul(rr0, tC.y));
            float rr3 = ffma(rr1, tC.y, -fmul(rr0, tC.x));
            float sm_ = fadd(A.y, B.y), d = fsub(A.x, B.x);
            // pair m
            float w0 = ffma(0.5f, sm_, rr2), w1 = ffma(0.5f, d, rr3);
            float f = fmul(ffma(w0, tD.x, fmul(w1, tD.y)), scale);
            float bk = fmul(ffma(w0, tD.y, -fmul(w1, tD.x)), scale);
            // pair N4-1-m
            w0 = ffma(0.5f, sm_, -rr2);
            w1 = ffma(-0.5f, d, rr3);
            float f2 = fmul(ffma(w0, tR.x, fmul(w1, tR.y)), scale);
            float bk2 = fmul(ffma(w0, tR.y, -fmul(w1, tR.x)), scale);
            if (row < rows) {
                // pair i: md[i] = f, md[N2-1-i] = bk
                float *o = md + row * (long)N2;
                float *lg = logmdct + row * (long)N2;
                o[m] = f;
                o[N2 - 1 - m] = bk;
                o[N4 - 1 - m] = f2;
                o[N4 + m] = bk2;
                lg[m] = logspec(f);
                lg[N2 - 1 - m] = logspec(bk);
                lg[N4 - 1 - m] = logspec(f2);
                lg[N4 + m] = logspec(bk2);
            }
        }
        __syncwarp();
    }
    cp_async_wait_all();
}

template <int LOGN>
int launch(const float *frames, const float *win, const int *wid,
           float *md, float *logmdct, long rows, const float *T,
           cudaStream_t st)
{
    using C = Cfg<LOGN>;
    static int sms[64];                     // by device ordinal
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return (int)e;
    if (dev < 0 || dev >= 64)
        return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        e = cudaFuncSetAttribute(mdct_fwd_rows<LOGN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::SMEM);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms[dev],
                                       cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess)
            return (int)e;
    }
    const long S = sms[dev];
    // rows a warp: GMAX (every lane a tail) when the batch gives each of
    // eight warps a SM a group, else fewer (a power of two), down to one
    int G = C::GMAX;
    while (G > 1 && rows < 8 * S * G)
        G >>= 1;
    const long ngroups = (rows + G - 1) / G;
    long warps = (ngroups + S - 1) / S;
    if (warps > C::WARPS)
        warps = C::WARPS;
    const size_t smem = (size_t)(C::TSM + warps * C::WFL) * 4;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mdct_fwd_rows<LOGN>, (int)warps * 32, smem);
    if (e != cudaSuccess)
        return (int)e;
    if (per_sm < 1)
        return (int)cudaErrorLaunchOutOfResources;
    long want = (ngroups + warps - 1) / warps, cap = S * per_sm;
    unsigned grid = (unsigned)(want < cap ? want : cap);
    mdct_fwd_rows<LOGN><<<grid, (unsigned)warps * 32, smem, st>>>(
        frames, win, wid, md, logmdct, rows, G, T);
    return (int)cudaGetLastError();
}

}  // namespace

// frames: (rows, n) float32; win: the window (n floats) or, with wid
// (rows int32 ids), a table of windows (id * n + i); md, logmdct: (rows,
// n/2) outputs; T: ops/mdct.py's trig table (n + n/4 floats).  frames
// and win 16-byte aligned.  Returns a cudaError_t.
extern "C" int vtt_mdct_fwd(const float *frames, const float *win,
                            const int *wid, float *md, float *logmdct,
                            long rows, int n, const float *T, void *stream)
{
    if (rows < 0 || rows > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    if (rows == 0)
        return 0;
    if (((uintptr_t)frames | (uintptr_t)win) & 15)
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t st = (cudaStream_t)stream;
    switch (n) {
    case 64: return launch<6>(frames, win, wid, md, logmdct, rows, T, st);
    case 128: return launch<7>(frames, win, wid, md, logmdct, rows, T, st);
    case 256: return launch<8>(frames, win, wid, md, logmdct, rows, T, st);
    case 512: return launch<9>(frames, win, wid, md, logmdct, rows, T, st);
    case 1024: return launch<10>(frames, win, wid, md, logmdct, rows, T, st);
    case 2048: return launch<11>(frames, win, wid, md, logmdct, rows, T, st);
    case 4096: return launch<12>(frames, win, wid, md, logmdct, rows, T, st);
    case 8192: return launch<13>(frames, win, wid, md, logmdct, rows, T, st);
    }
    return (int)cudaErrorInvalidValue;
}
