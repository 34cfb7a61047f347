// Both passes of the encoder's bark noise fit as a hand-written Hopper
// kernel: the second stage of every DeviceAnalysis.spectra call of the
// port (vorbis_tpu_torch/ops/torchdsp.py), one launch a spectra call.
//
// Replaces: the two bark_fit calls (vorbis_tpu/ops/jaxdsp.py:93) and the
// compand index inside the jitted DeviceAnalysis.spectra,
// vorbis_tpu/ops/jaxdsp.py:272-284 (plain jax.numpy, not a Pallas
// kernel; reference lib/psy.c bark_noise_hybridmp, _vp_noisemask).
//
// Computes, for row r of md (rows, n2) (the MDCT of csrc/mdct_fwd.cu):
// pass 1, the least-squares fit of the bark-windowed log spectrum at
// offset 140; work = logmdct - mask; pass 2, the fit of max(work, 1) with
// the fixed-window minimum; fit1[r] = logmdct - work and dB[r] =
// clip(int(mask2 + .5), 0, 39).  Rounded as XLA:CPU compiles the JAX
// spectra (ops/bark_cuda.py says how; bark_fit_plain is the same in
// PyTorch): every operation an explicit PTX .rn.ftz instruction, a fused
// multiply-add exactly where LLVM contracts one, the five prefix sums in
// jnp.cumsum's CPU order (blocks of 16 summed in turn, the totals
// scanned the same way, each block's exclusive prefix added last).
//
// Bound on this card: bytes.  A row reads n2 floats and writes 2 n2
// words, against ~150 float32 operations a bin (two passes: products,
// five prefix sums, ten gathered differences, the terms, a division):
// 12 bytes against ~150 flops a bin is 12.5 flops a byte, below the
// card's 20 (67 TFLOP/s fp32 over 3.35 TB/s), so the traffic's time is
// the bound.  What costs is latency: the sums are serial chains of 16 and
// the fit gathers a window's two edges a bin.  The design:
//
// - Teams own rows.  A team of TT threads (one warp, or two when a row
//   has 64 blocks of 16 or the batch is small) owns G rows of NB = n2/16
//   blocks (G = TT/NB at short rows of a large batch, else 1); the
//   phases of a row are separated by __syncwarp or the team's named
//   barrier only, and the grid is persistent: the SMs times the CTAs
//   resident a SM, each team striding over row groups.
// - Block sums in registers.  Thread t owns blocks t, t + TT, ... of the
//   team's rows; it reads a block's 16 values with four 16-byte shared
//   loads, computes y and the five summands once a bin and sums each
//   array's 16 in turn (five independent chains).  A first sweep keeps
//   only the block totals (t1); a second, after the totals' chains, sums
//   again and adds each block's exclusive prefix, so no block sum is
//   stored twice.
// - Totals in the same order.  One thread a (array, row, 16 blocks)
//   chain sums the level-1 totals in turn, in place in t1; one thread an
//   (array, row) chain sums the level-2 totals (the last of each level-1
//   chain) into t2.  A block's exclusive prefix is its predecessor's
//   level-1 value, plus that value's level-2 exclusive prefix in a single
//   add: the adds of xla_f32.block_cumsum, no tree-shaped scan.
// - The five prefix arrays in the team's shared slice, written once a
//   pass: a bin's N, X, XX and Y as one 16-byte word, so that the fit
//   gathers a window edge with one 16-byte and one 4-byte load, and XY
//   alone; both XOR-swizzled (16-byte word e of each aligned 16 at
//   e ^ ((e >> 4) & 7); XY's word e of each aligned 32 at
//   e ^ 4 ((e >> 5) & 3)) so that the blocks' stores and the fit's
//   gathers of neighbouring bins hit distinct banks.
// - The fit runs bin t + TT j on thread t, FU bins at a time with their
//   gathers issued before any store, so its gathers are of neighbouring
//   words and fit1 and dB are written with coalesced stores.  Pass 1
//   writes fit1 (logmdct - work needs nothing of pass 2); work crosses
//   to pass 2 in W, the slice's n2-float vector that held logmdct, in the
//   thread that computed it; md is read once, coalesced, LU loads a
//   thread in flight.
// - The bark windows are staged once a CTA, lo and hi packed as two
//   16-bit halves of one word; the fixed window is computed.
// - The rounding rules are those of the one-CTA-a-row design this one
//   replaced: D fuses its square in a reflected region of at most
//   SQUARE_FUSED_MAX bins, bins from k2 take bin k2 - 1's terms, XLA's
//   NaN-propagating max and min, the saturating float -> int conversion.

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
__device__ __forceinline__ float ffma(float a, float b, float c)
{
    float r;
    asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
    return r;
}
__device__ __forceinline__ float fdiv(float a, float b)
{
    float r;
    asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
// XLA's max and min: a NaN operand gives NaN
__device__ __forceinline__ float xmax(float a, float b)
{
    return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float xmin(float a, float b)
{
    return (a != a || a < b) ? a : b;
}

constexpr int MAX_N2 = 4096;
constexpr int MAX_THREADS = 256;
constexpr int FU = 4;                         // bins a thread a fit step
constexpr int LU = 8;                         // md loads a thread in flight
constexpr int SMEM_MAX = 232448;              // 227 KB, a CTA's most
// todB's scale, and -764.6161886f + .345f (+ 140) as XLA folds them
constexpr float TODB_SCALE = 0x1.815182p-21f;
constexpr float TODB_C345 = -0x1.7e22b8p+9f;
constexpr float TODB_C140 = -0x1.3822b8p+9f;
// a reflected low region of at most this many bins fuses D's square
// (ops/bark_cuda.py SQUARE_FUSED_MAX)
constexpr int SQUARE_FUSED_MAX = 8;

__device__ __forceinline__ float todb_u(float m)
{
    return (float)(__float_as_int(m) & 0x7fffffff);
}

// the bin arrays' swizzle: word e of each aligned 32 at e ^ 4((e >> 5) & 3)
__device__ __forceinline__ int sw(int e)
{
    return e ^ (((e >> 5) & 3) << 2);
}

// the four arrays' swizzle in 16-byte words: word e of each aligned 16
// at e ^ ((e >> 4) & 7)
__device__ __forceinline__ int qs(int e)
{
    return e ^ ((e >> 4) & 7);
}

// t1's padding, one word a 16, so the level-1 chains hit distinct banks
__device__ __forceinline__ int t1p(int q)
{
    return q + (q >> 4);
}

// A warp's slice for rows of n2 bins, G rows a warp (floats): the prefix
// arrays N, X, XX, Y as one 16-byte word a bin (Q, 4 R floats; R = G n2p,
// rows n2p = 16 NB apart) and XY (R), W (R), the level-1 totals t1
// ((array, row, block) padded) and the level-2 prefixes t2 ((array, row,
// chain)).
struct Layout {
    int n2, NB, n2p, G, R, nc, t1w, wfl;
};

__host__ __device__ inline Layout layout(int n2, int G)
{
    Layout L;
    L.n2 = n2;
    L.NB = (n2 + 15) >> 4;
    L.n2p = 16 * L.NB;
    L.G = G;
    L.R = G * L.n2p;
    L.nc = (L.NB + 15) >> 4;
    int t1n = 5 * G * L.NB;
    L.t1w = t1n + (t1n >> 4) + 1;
    L.wfl = (6 * L.R + L.t1w + 5 * G * L.nc + 3) & ~3;
    return L;
}

// the five summands of bin i whose value is y (bin 0: the half weight)
__device__ __forceinline__ void summands(float y, int i, float *e)
{
    float w = fmul(y, y);
    if (i == 0) {
        float h = fmul(w, 0.5f);
        e[0] = h;
        e[1] = h;
        e[2] = 0.0f;
        e[3] = fmul(h, y);
        e[4] = 0.0f;
    } else {
        float x = (float)i;
        float wx = fmul(w, x);
        e[0] = w;
        e[1] = wx;
        e[2] = fmul(wx, x);
        e[3] = fmul(w, y);
        e[4] = fmul(wx, y);
    }
}

// Block b of row r: its 16 values (pass 1: y, from XY's slots; pass 2:
// work, from W), the summands and their sums in turn.  FINAL false: the
// five totals to t1.  FINAL true: each sum plus the block's exclusive
// prefix (none for block 0) into the prefix arrays, a bin's N, X, XX, Y
// one 16-byte store, XY four bins a store.  The padding bins of
// a row whose n2 is no multiple of 16 sum zeros, as block_cumsum pads.
template <bool FINAL>
__device__ __forceinline__ void sweep(float *P, const float *src,
                                      float *t1, const float *t2,
                                      const Layout &L, int r, int b,
                                      bool pass2)
{
    const int base = r * L.n2p + 16 * b;
    float y[16];
#pragma unroll
    for (int q = 0; q < 4; q++) {
        float4 v = *(const float4 *)(src + sw(base + 4 * q));
        y[4 * q] = v.x;
        y[4 * q + 1] = v.y;
        y[4 * q + 2] = v.z;
        y[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < 16; k++) {
        if (pass2)
            y[k] = xmax(y[k], 1.0f);
        if (16 * b + k >= L.n2)
            y[k] = 0.0f;
    }
    float excl[5];
    if (FINAL && b > 0) {
        const int c = (b - 1) >> 4;
#pragma unroll
        for (int a = 0; a < 5; a++) {
            const int ar = a * L.G + r;
            float e = t1[t1p(ar * L.NB + b - 1)];
            excl[a] = c ? fadd(e, t2[ar * L.nc + c - 1]) : e;
        }
    }
    float s[5], o[5], xy[4];
#pragma unroll
    for (int k = 0; k < 16; k++) {
        float e[5];
        summands(y[k], 16 * b + k, e);
#pragma unroll
        for (int a = 0; a < 5; a++) {
            s[a] = k ? fadd(s[a], e[a]) : e[a];
            if (FINAL)
                o[a] = b ? fadd(s[a], excl[a]) : s[a];
        }
        if (FINAL) {
            ((float4 *)P)[qs(base + k)] = make_float4(o[0], o[1], o[2],
                                                      o[3]);
            xy[k & 3] = o[4];
            if ((k & 3) == 3)
                *(float4 *)(P + 4 * L.R + sw(base + k - 3)) =
                    make_float4(xy[0], xy[1], xy[2], xy[3]);
        }
    }
    if (!FINAL) {
#pragma unroll
        for (int a = 0; a < 5; a++)
            t1[t1p((a * L.G + r) * L.NB + b)] = s[a];
    }
}

// the team's threads: TT of them, 32 (one warp, __syncwarp) or more (a
// named barrier of the team's warps, barrier 0 being __syncthreads')
__device__ __forceinline__ void team_sync(int team, int TT)
{
    if (TT == 32)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" :: "r"(team + 1), "r"(TT)
                     : "memory");
}

// every block of the team's rows through sweep<FINAL>, thread tt taking
// blocks tt, tt + TT, ...
template <bool FINAL>
__device__ __forceinline__ void sweeps(float *P, const float *src,
                                       float *t1, const float *t2,
                                       const Layout &L, int tt, int TT,
                                       bool pass2)
{
    for (int s = tt; s < L.G * L.NB; s += TT) {
        int r = L.G == 1 ? 0 : s / L.NB;
        int b = s - r * L.NB;
        sweep<FINAL>(P, src, t1, t2, L, r, b, pass2);
    }
}

// The level-1 chains: the totals of each (array, row) in blocks of 16,
// each block summed in turn in place, one thread a block.  Then the
// level-2 chains: each (array, row)'s level-1 chains' last values summed
// in turn into t2 (the inclusive prefix of every chain but the last).
__device__ __forceinline__ void chains(float *t1, float *t2, const Layout &L,
                                       int tt, int TT, int team)
{
    for (int it = tt; it < 5 * L.G * L.nc; it += TT) {
        const int ar = it / L.nc, c = it - ar * L.nc;
        const int q0 = ar * L.NB + 16 * c;
        const int len = min(16, L.NB - 16 * c);
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; k++)
            if (k < len)
                v[k] = t1[t1p(q0 + k)];
        float s = v[0];
#pragma unroll
        for (int k = 1; k < 16; k++)
            if (k < len) {
                s = fadd(s, v[k]);
                t1[t1p(q0 + k)] = s;
            }
    }
    if (L.nc < 2)
        return;
    team_sync(team, TT);
    for (int ar = tt; ar < 5 * L.G; ar += TT) {
        float s = 0.0f;
        for (int c = 0; c + 1 < L.nc; c++) {
            float v = t1[t1p(ar * L.NB + 16 * c + 15)];
            s = c ? fadd(s, v) : v;
            t2[ar * L.nc + c] = s;
        }
    }
}

// R of bin i of row rb / n2p for the regions [0, k1) reflected, [k1, k2)
// plain, the fit of bin k2 - 1 extrapolated over [k2, n2) (A = B = 0,
// D = 1 if k2 = 0); tab: the packed bark windows, or none for the fixed
// window of `fixed` bins
__device__ __forceinline__ float fit(const float *P, const Layout &L,
                                     int rb, int i, const int *tab,
                                     int fixed, int k1, int k2)
{
    int k = i;
    if (k >= k2) {
        if (k2 == 0)
            return fdiv(ffma((float)i, 0.0f, 0.0f), 1.0f);
        k = k2 - 1;
    }
    int l, h;
    if (tab) {
        int t = tab[k];
        l = (int)(short)(t & 0xffff);
        h = t >> 16;
    } else {
        h = k + fixed / 2 < L.n2 - 1 ? k + fixed / 2 : L.n2 - 1;
        l = k + fixed / 2 - fixed;
    }
    // (jaxdsp._ls_terms; the extrapolated bins share bin k2 - 1's A, B,
    // D, not its x)
    const bool neg = k < k1;
    const int eh = rb + h, el = rb + (neg ? -l : l);
    const float4 qh = ((const float4 *)P)[qs(eh)];
    const float4 ql = ((const float4 *)P)[qs(el)];
    const float *XY = P + 4 * L.R;
    const float xyh = XY[sw(eh)], xyl = XY[sw(el)];
    float tN, tX, tXX, tY, tXY, D;
    if (neg) {
        tN = fadd(qh.x, ql.x);
        tX = fsub(qh.y, ql.y);
        tXX = fadd(qh.z, ql.z);
        tY = fadd(qh.w, ql.w);
        tXY = fsub(xyh, xyl);
    } else {
        tN = fsub(qh.x, ql.x);
        tX = fsub(qh.y, ql.y);
        tXX = fsub(qh.z, ql.z);
        tY = fsub(qh.w, ql.w);
        tXY = fsub(xyh, xyl);
    }
    if (neg && k1 <= SQUARE_FUSED_MAX)
        D = ffma(-tX, tX, fmul(tN, tXX));
    else
        D = ffma(tN, tXX, -fmul(tX, tX));
    float A = ffma(tY, tXX, -fmul(tX, tXY));
    float B = ffma(tN, tXY, -fmul(tX, tY));
    return fdiv(ffma((float)i, B, A), D);
}

__global__ void __launch_bounds__(MAX_THREADS)
bark_fit_rows(const float *__restrict__ md, const int *__restrict__ blo,
              const int *__restrict__ bhi, float *__restrict__ fit1,
              int *__restrict__ dB, long rows, int n2, int G, int TT,
              int i1, int i2, int j1, int j2, int fixed)
{
    extern __shared__ float4 sm4[];
    const Layout L = layout(n2, G);
    // a team of TT threads (one or more warps) owns each row group
    const int tt = threadIdx.x % TT, team = threadIdx.x / TT;
    const int teams = blockDim.x / TT;
    int *tab = (int *)sm4;
    float *P = (float *)sm4 + ((n2 + 3) & ~3) + team * L.wfl;
    float *XY = P + 4 * L.R, *W = P + 5 * L.R, *t1 = P + 6 * L.R;
    float *t2 = t1 + L.t1w;
#pragma unroll 4
    for (int k = threadIdx.x; k < n2; k += blockDim.x)
        tab[k] = (__ldg(blo + k) & 0xffff) | (__ldg(bhi + k) << 16);
    __syncthreads();

    const long ngroups = (rows + G - 1) / G;
    for (long grp = (long)blockIdx.x * teams + team; grp < ngroups;
         grp += (long)gridDim.x * teams) {
        const long row0 = grp * G;
        const int nr = rows - row0 < G ? (int)(rows - row0) : G;
        // md once, in the fit's order: logmdct into W, pass 1's y into
        // XY's slots
        for (int r = 0; r < nr; r++) {
            const float *m = md + (row0 + r) * (long)n2;
            const int rb = r * L.n2p;
            // LU loads a thread in flight before their stores
            for (int i0 = tt; i0 < n2; i0 += TT * LU) {
                float v[LU];
#pragma unroll
                for (int u = 0; u < LU; u++)
                    if (i0 + TT * u < n2)
                        v[u] = __ldg(m + i0 + TT * u);
#pragma unroll
                for (int u = 0; u < LU; u++) {
                    const int i = i0 + TT * u;
                    if (i >= n2)
                        break;
                    float x = todb_u(v[u]);
                    W[sw(rb + i)] = ffma(x, TODB_SCALE, TODB_C345);
                    XY[sw(rb + i)] = xmax(ffma(x, TODB_SCALE, TODB_C140),
                                          1.0f);
                }
            }
        }
        team_sync(team, TT);
#pragma unroll 1
        for (int pass = 1; pass <= 2; pass++) {
            const float *src = pass == 1 ? XY : W;
            sweeps<false>(P, src, t1, t2, L, tt, TT, pass == 2);
            team_sync(team, TT);
            chains(t1, t2, L, tt, TT, team);
            team_sync(team, TT);
            sweeps<true>(P, src, t1, t2, L, tt, TT, pass == 2);
            team_sync(team, TT);
            for (int r = 0; r < nr; r++) {
                const long o = (row0 + r) * (long)n2;
                const int rb = r * L.n2p;
                // FU bins a thread at a time, their gathers all issued
                // before the stores (which might alias them)
                for (int i0 = tt; i0 < n2; i0 += TT * FU) {
                    float R[FU], S[FU];
#pragma unroll
                    for (int u = 0; u < FU; u++) {
                        const int i = i0 + TT * u;
                        if (i >= n2)
                            break;
                        R[u] = fit(P, L, rb, i, tab, 0, i1, i2);
                        // pass 1: logmdct; pass 2: the fixed window's fit
                        if (pass == 1)
                            S[u] = W[sw(rb + i)];
                        else if (fixed > 0)
                            S[u] = fit(P, L, rb, i, nullptr, fixed, j1, j2);
                    }
#pragma unroll
                    for (int u = 0; u < FU; u++) {
                        const int i = i0 + TT * u;
                        if (i >= n2)
                            break;
                        if (pass == 1) {
                            // pass 1: bark window, offset 140
                            float mask = fadd(xmax(R[u], 0.0f), -140.0f);
                            float work = fsub(S[u], mask);
                            fit1[o + i] = fsub(S[u], work);
                            W[sw(rb + i)] = work;
                        } else {
                            // pass 2: the residual at offset 0, with the
                            // fixed-window minimum
                            float mask2 = xmax(R[u], 0.0f);
                            if (fixed > 0)
                                mask2 = xmin(mask2, xmax(S[u], 0.0f));
                            // float -> int32 truncates, saturates and
                            // takes NaN to 0
                            int v = __float2int_rz(fadd(mask2, 0.5f));
                            dB[o + i] = v < 0 ? 0 : (v > 39 ? 39 : v);
                        }
                    }
                }
            }
            team_sync(team, TT);
        }
    }
}

}  // namespace

// md: (rows, n2) float32 MDCT rows; blo, bhi: the bark windows (n2 int32
// each); fit1 (rows, n2) float32 and dB (rows, n2) int32 outputs; i1, i2,
// j1, j2: the region bounds of the bark and the fixed window; fixed: the
// fixed window's width (<= 0: none).  n2 <= 4096.  Returns a cudaError_t.
extern "C" int vtt_bark_fit(const float *md, const int *blo, const int *bhi,
                            float *fit1, int *dB, long rows, int n2, int i1,
                            int i2, int j1, int j2, int fixed, void *stream)
{
    if (rows < 0 || rows > 0x7fffffffL || n2 < 1 || n2 > MAX_N2)
        return (int)cudaErrorInvalidValue;
    if (rows == 0)
        return 0;
    static int sms[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return (int)e;
    if (dev < 0 || dev >= 64)
        return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        e = cudaFuncSetAttribute(bark_fit_rows,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms[dev],
                                       cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess)
            return (int)e;
    }
    const long S = sms[dev];
    const int NB = (n2 + 15) >> 4;
    // a team of tw warps a row group: two when a row has 64 blocks or
    // more or when the batch is small (latency, not throughput, counts),
    // else one
    const int tw = NB >= 64 || rows < 16 * S ? 2 : 1;
    const int TT = 32 * tw;
    // rows a team: enough for every thread a block when the batch gives
    // each of four teams a SM a group, else one
    const int gmax = NB >= TT ? 1 : TT / NB;
    long g = rows / (4 * S);
    const int G = g < 1 ? 1 : (g < gmax ? (int)g : gmax);
    const Layout L = layout(n2, G);
    const long tabw = (n2 + 3) & ~3;
    const long ngroups = (rows + G - 1) / G;
    long teams = (SMEM_MAX / 4 - tabw) / L.wfl;
    long spread = (ngroups + S - 1) / S;
    if (teams > MAX_THREADS / TT)
        teams = MAX_THREADS / TT;
    if (teams > spread)
        teams = spread;
    if (teams < 1)
        return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)(tabw + teams * L.wfl) * sizeof(float);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bark_fit_rows, (int)(teams * TT), smem);
    if (e != cudaSuccess)
        return (int)e;
    if (per_sm < 1)
        return (int)cudaErrorLaunchOutOfResources;
    long want = (ngroups + teams - 1) / teams, cap = S * per_sm;
    unsigned grid = (unsigned)(want < cap ? want : cap);
    bark_fit_rows<<<grid, (unsigned)(teams * TT), smem,
                    (cudaStream_t)stream>>>(md, blo, bhi, fit1, dB, rows, n2,
                                            G, TT, i1, i2, j1, j2, fixed);
    return (int)cudaGetLastError();
}
