// M3 tempmdct scan: aoTuV M3's echo buffer carried across a batch of
// short frames in stream order (reference: psy.c set_m3p's tempmdct
// maintenance and the main loop's write-back).
//
// Replaces the `lax.scan` of vorbis_tpu/ops/psydevice.py:498
// m3_tempmdct_scan.  Its plain PyTorch version is
// vorbis_tpu_torch/ops/psydevice.py m3_tempmdct_scan; this kernel is
// bitwise equal to it (ops/m3_cuda.py binds it, chip_smoke.py checks it).
//
// Per frame f and (channel c, bin t), with the carry starting at zero:
//   tm   = (reset[f] ? last[t] : carry[t]) - base
//   acc  = tm, then for j = 1..min(maxnb-1, t) in order:
//          acc += (j < bfn[t-j] and tm < lm[t-j] - cell[t-j] * j)
//                 ? incr[t] : 0      (conditions on the pre-update tm)
//   tm   = acc
//   tm   = lm[t]  if sw[f] and val > tval and val > last[t]
//                 and lm[t] > tm + noise_center[f]
//   carry[t] = sw[f] ? tm : carry[t];   out[f, c, t] = carry[t]
//
// Two facts shorten the chain that the recurrence seems to have.
// 1. Segments.  A frame with sw and reset computes its buffer from
//    lastmdct alone, and a frame without sw passes the carry through,
//    so the batch splits into segments that do not depend on each
//    other: one starts at frame 0 (carry zero, as every call of the
//    JAX scan starts) and one at every frame with sw and reset, each
//    running up to the next.  The grid is (F, ch) blocks of n threads;
//    the block of a frame that starts no segment exits at once, every
//    other finds its segment's end (one coalesced read of the flags a
//    window of n frames, while its first frames are staged) and walks
//    the segment's frames for its channel, one thread a bin.  Inside a
//    segment only the first frame can have reset, so a frame needs only
//    its sw flag and noise_center.  The chain is the longest segment,
//    not the batch.
// 2. Compare, count, then add.  Every add of the spread lands the same
//    incr[t] on the column, and every condition compares against the
//    pre-update tm, so the compares are independent: count the true
//    ones (k), then add incr k times with __fadd_rn, in the order
//    XLA:CPU lands them.  The omitted adds are +0.0, which change no
//    bit of a buffer that is never -0.0: tm = x - base with base 5 or
//    10 is never -0.0 in round-to-nearest, nor is tm + incr (incr > 0).
//    `lm[t-j] - cell[t-j] * j` needs no carry: each thread keeps its
//    column's products (rounded once, the plain version's m3_cellj) in
//    registers, +inf where the shift does not apply (j > t or
//    j >= bfn[t-j]: lm - inf compares below every buffer), and forms
//    the next frame's differences before this frame's chain.
//
// What bounds it on the H100: the longest segment's walk, one frame
// after another, on one block of n / 32 warps.  The bytes the function
// needs (4 input rows a frame with sw, 1 output row every frame: well
// under 1 us for a 256-frame batch at 3.35 TB/s, PERF.md) and the
// operations are far below it, and the ~37 segments of a
// click-train batch run side by side on the 132 SMs; they are short (7
// or 8 frames), so the launch and the prologue are a large part of such
// a batch's time.  Per frame the carry's own chain is short (the base
// subtraction, the compares, k adds, the trigger's add, compare and
// select), but with one warp on each of an SM's four schedulers nothing
// hides the latency of the frame's other work (the stage, the barrier,
// the shared loads of the neighbours, the store), and a warp issues in
// order, so a frame costs several times its chain: chip_smoke.py 3b
// times a 256-frame segment without sw (the pipeline alone) beside the
// one-chain worst case (PERF.md).  What the design does about it: the
// loads stay off the chain -- a ring of DEPTH frames is staged in
// shared memory by cp.async, 16 bytes a copy (the log row for the
// neighbours the spread reads, the columns' own values; the aligned
// 4-byte word of the caller's bool row that holds the frame's sw, and
// its noise_center), and the next frame is read into registers, its
// differences formed, before this frame's chain starts; one barrier a
// frame makes
// the next log row visible and frees the slot that is staged next; the
// k adds run one trip count a warp with predicated adds, so the chain
// has no divergent branch.  Built with -fmad=false, and every product
// and sum is an explicit round-to-nearest intrinsic, as the plain
// version rounds.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define DEPTH 8                     // frames in flight in the ring

template <int J>
struct Frame {
    float fq[J];                    // lm[t-j] - cell[t-j] * j, j = 1..J
    float lmt, last, v, tv, nc;
    bool sw;
};

template <int N, int J>
__global__ void __launch_bounds__(N)
m3_scan_kernel(const float *__restrict__ logmdct,   // (F, ch, N)
               const float *__restrict__ lastmdct,  // (F, ch, ldl)
               const float *__restrict__ val,       // (F, ch, N)
               const float *__restrict__ tval,      // (F, ch, N)
               const unsigned char *__restrict__ sw,     // (F,) bool
               const unsigned char *__restrict__ reset,  // (F,) bool
               const float *__restrict__ ncen,      // (F,) noise_center
               const float *__restrict__ tabs,      // (J + 1, N)
               float *__restrict__ out,             // (F, ch, N)
               int F, int ch, int ldl, float base)
{
    constexpr int PAD = (J + 3) & ~3;   // slots left of bin 0
    __shared__ __align__(16) float s_lm[DEPTH][PAD + N];
    __shared__ __align__(16) float s_own[DEPTH][3][N];  // lastmdct, val, tval
    __shared__ unsigned s_sw[DEPTH];       // the words holding sw
    __shared__ float s_nc[DEPTH];
    __shared__ int s_end;                  // the segment's end

    const int f0 = blockIdx.x;
    const int c = blockIdx.y;
    const int t = threadIdx.x;
    if (f0 > 0 && !(sw[f0] && reset[f0]))
        return;                     // f0 starts no segment

    float thr[J];                   // tabs rows 0..J-1: cell[t-j] * j or inf
#pragma unroll
    for (int j = 0; j < J; ++j)
        thr[j] = tabs[j * N + t];
    const float incr = tabs[J * N + t];
    for (int q = t; q < DEPTH * PAD; q += N)
        s_lm[q / PAD][q % PAD] = 0.0f;

    // stage frame f into its ring slot, 16 bytes a copy: thread t copies
    // 4 bins of one of the 4 rows (the wrapper checks the alignment)
    constexpr int Q = N / 4;
    const int srow = t / Q, scol = (t % Q) * 4;
    const float *gsrc = srow == 0 ? logmdct : srow == 1 ? lastmdct
                      : srow == 2 ? val : tval;
    const size_t gld = srow == 1 ? (size_t)ldl : (size_t)N;
    auto stage = [&](int f) {
        const int s = (f - f0) & (DEPTH - 1);
        const size_t r = (size_t)f * ch + c;
        float *dst = srow == 0 ? &s_lm[s][PAD + scol]
                               : &s_own[s][srow - 1][scol];
        __pipeline_memcpy_async(dst, gsrc + r * gld + scol, 16);
        // the aligned 4-byte word that holds frame f's sw (the wrapper
        // passes 4-byte-aligned rows) and its noise_center, from lanes
        // of two warps
        if (t == 0)
            __pipeline_memcpy_async(&s_sw[s], sw + (f & ~3), 4);
        if (t == 32)
            __pipeline_memcpy_async(&s_nc[s], ncen + f, 4);
    };
    // read frame f's slot into registers; the differences need no carry
    auto read = [&](int f, Frame<J> &fr) {
        const int s = (f - f0) & (DEPTH - 1);
        const float *lm = &s_lm[s][PAD + t];
#pragma unroll
        for (int j = 1; j <= J; ++j)
            fr.fq[j - 1] = __fsub_rn(lm[-j], thr[j - 1]);
        fr.lmt = lm[0];
        fr.last = s_own[s][0][t];
        fr.v = s_own[s][1][t];
        fr.tv = s_own[s][2][t];
        fr.sw = (s_sw[s] >> (8 * (f & 3))) & 0xffu;
        fr.nc = s_nc[s];
    };

    float carry = 0.0f;
    int end = F;                    // the segment's end, found below
    bool rs0 = false;               // reset[f0]: no later frame of the
                                    // segment with sw has reset
    // frame f of the segment, read into `cur` one step before; reads
    // frame f + 1 into `nxt`
    auto step = [&](int f, const Frame<J> &cur, Frame<J> &nxt) {
        __pipeline_wait_prior(DEPTH - 3);   // frame f + 1 has landed
        __syncthreads();            // ... for all; frame f - 1's slot is free
        if (f + DEPTH - 1 < end)
            stage(f + DEPTH - 1);
        __pipeline_commit();
        if (f + 1 < end)
            read(f + 1, nxt);
        if (cur.sw) {
            float tm = __fsub_rn(f == f0 && rs0 ? cur.last : carry, base);
            int k0 = 0, k1 = 0, k2 = 0, k3 = 0;
#pragma unroll
            for (int j = 0; j < J; j += 4) {
                k0 += tm < cur.fq[j];
                if (j + 1 < J) k1 += tm < cur.fq[j + 1];
                if (j + 2 < J) k2 += tm < cur.fq[j + 2];
                if (j + 3 < J) k3 += tm < cur.fq[j + 3];
            }
            const int k = (k0 + k1) + (k2 + k3);
            // one trip count for the warp (its largest k), each lane's
            // adds predicated: no divergent branches in the chain
            const int kmax = __reduce_max_sync(0xffffffffu, k);
            for (int q = 0; q < kmax; ++q)
                if (q < k)
                    tm = __fadd_rn(tm, incr);
            if (cur.v > cur.tv && cur.v > cur.last
                && cur.lmt > __fadd_rn(tm, cur.nc))
                tm = cur.lmt;
            carry = tm;
        }
        out[((size_t)f * ch + c) * N + t] = carry;
    };

    for (int q = 0; q < DEPTH - 1; ++q) {
        if (f0 + q < F)
            stage(f0 + q);
        __pipeline_commit();
    }
    // the segment's end, while the first frames land: the first frame
    // after f0 with sw and reset, or F
    rs0 = reset[f0];
    if (t == 0)
        s_end = F;
    __syncthreads();
    for (int w = f0 + 1; w < F; w += N) {
        const int f = w + t;
        const bool st = f < F && (sw[f] & reset[f]);
        if (st)
            atomicMin(&s_end, f);
        if (__syncthreads_or(st))
            break;
    }
    end = s_end;
    __pipeline_wait_prior(DEPTH - 2);   // frame f0 has landed
    __syncthreads();
    Frame<J> a, b;                  // two frames in registers, in turns
    read(f0, a);
    for (int f = f0; f < end; f += 2) {
        step(f, a, b);
        if (f + 1 >= end)
            break;
        step(f + 1, b, a);
    }
    __pipeline_wait_prior(0);       // no copy outlives the block
}

extern "C" int vtt_m3_scan(const float *logmdct, const float *lastmdct,
                           const float *val, const float *tval,
                           const unsigned char *sw,
                           const unsigned char *reset, const float *ncen,
                           const float *tabs, float *out, int F, int ch,
                           int n, int ldl, int maxnb, float base,
                           void *stream)
{
    // the 16-byte copies need 16-byte rows, the flag words 4-byte ones
    const size_t mis = (((size_t)logmdct | (size_t)lastmdct | (size_t)val
                         | (size_t)tval) & 15)
                       | (((size_t)sw | (size_t)reset | (size_t)ncen) & 3);
    if (F <= 0 || ch <= 0 || ch > 65535 || ldl < n || ldl % 4 || mis)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(F, ch);
    cudaStream_t s = (cudaStream_t)stream;
    // maxnb is freq_bfn128's / freq_bfn256's largest entry
    if (n == 128 && maxnb == 25)
        m3_scan_kernel<128, 24><<<grid, 128, 0, s>>>(
            logmdct, lastmdct, val, tval, sw, reset, ncen, tabs, out, F, ch,
            ldl, base);
    else if (n == 256 && maxnb == 51)
        m3_scan_kernel<256, 50><<<grid, 256, 0, s>>>(
            logmdct, lastmdct, val, tval, sw, reset, ncen, tabs, out, F, ch,
            ldl, base);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
