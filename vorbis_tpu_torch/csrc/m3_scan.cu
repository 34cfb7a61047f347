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
// The spread compares against the pre-update carry of the target bin
// only, so no carry crosses columns: one thread per column loops over
// the frames, one block per channel.
//
// The adds land on the buffer one by one, as XLA:CPU compiles the JAX
// module's `temp + add` (its adds fold onto temp).
//
// What bounds it: the frame chain.  Each frame is ~maxnb dependent
// conditional adds of one column (a few hundred cycles), F frames in a
// row, on ch SMs; the bytes (4 input rows and 1 output row a frame) are
// far below that.  So the design keeps the chain free of memory
// latency: tiles of frames of all four inputs are staged in shared
// memory with cp.async, double-buffered, so the next tile loads while
// the current one is scanned, and the spread reads the frame's log row
// from shared memory.  Built with -fmad=false, and every product and
// sum is an explicit round-to-nearest intrinsic, so `lm - cell * j`
// rounds the product and the difference apart, as the plain version
// does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define TILE_ELEMS 1024            // floats of one staged input a buffer
#define MAX_N 256                  // bins of a column set (threads)
#define MIN_N 128
#define MAX_T (TILE_ELEMS / MIN_N) // frames a tile at the smallest n

__global__ void __launch_bounds__(MAX_N)
m3_scan_kernel(const float *__restrict__ logmdct,   // (F, ch, n)
               const float *__restrict__ lastmdct,  // (F, ch, ldl)
               const float *__restrict__ val,       // (F, ch, n)
               const float *__restrict__ tval,      // (F, ch, n)
               const float *__restrict__ prm,       // (3, F): sw, reset, ncen
               const float *__restrict__ tabs,      // (3, n): bfn, cell, incr
               float *__restrict__ out,             // (F, ch, n)
               int F, int ch, int n, int ldl, int maxnb, float base)
{
    __shared__ float s_cell[MAX_N];
    __shared__ int s_bfn[MAX_N];
    __shared__ float s_lm[2][TILE_ELEMS];
    __shared__ float s_last[2][TILE_ELEMS];
    __shared__ float s_v[2][TILE_ELEMS];
    __shared__ float s_tv[2][TILE_ELEMS];
    __shared__ float s_prm[2][3][MAX_T];

    const int c = blockIdx.x;
    const int t = threadIdx.x;          // the bin; blockDim.x == n
    const int T = TILE_ELEMS / n;       // frames a tile
    s_bfn[t] = (int)tabs[t];
    s_cell[t] = tabs[n + t];
    const float incr = tabs[2 * n + t];

    // stage frames [f0, f0 + T) of this channel into buffer `buf`: each
    // thread copies its own bin of every row (coalesced across the block)
    auto stage = [&](int buf, int f0) {
        const int nt = min(T, F - f0);
        for (int fr = 0; fr < nt; ++fr) {
            const size_t r = (size_t)(f0 + fr) * ch + c;
            const int k = fr * n + t;
            __pipeline_memcpy_async(&s_lm[buf][k], logmdct + r * n + t, 4);
            __pipeline_memcpy_async(&s_last[buf][k], lastmdct + r * ldl + t,
                                    4);
            __pipeline_memcpy_async(&s_v[buf][k], val + r * n + t, 4);
            __pipeline_memcpy_async(&s_tv[buf][k], tval + r * n + t, 4);
        }
        if (t < nt) {
            for (int q = 0; q < 3; ++q)
                __pipeline_memcpy_async(&s_prm[buf][q][t],
                                        prm + (size_t)q * F + f0 + t, 4);
        }
        __pipeline_commit();
    };

    float carry = 0.0f;
    const int ntiles = (F + T - 1) / T;
    stage(0, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < ntiles)
            stage(buf ^ 1, (tile + 1) * T);
        else
            __pipeline_commit();        // keep one group in flight
        __pipeline_wait_prior(1);       // this tile's group has landed
        __syncthreads();
        const int f0 = tile * T;
        const int nt = min(T, F - f0);
        const int jmax = min(maxnb - 1, t);
        for (int fr = 0; fr < nt; ++fr) {
            const float *lm = s_lm[buf] + fr * n;
            const int k = fr * n + t;
            const float last = s_last[buf][k];
            float tm = __fsub_rn(s_prm[buf][1][fr] > 0.5f ? last : carry,
                                 base);
            float acc = tm;
            for (int j = 1; j <= jmax; ++j) {
                const int i = t - j;
                const float freq = __fsub_rn(
                    lm[i], __fmul_rn(s_cell[i], (float)j));
                acc = __fadd_rn(acc, (j < s_bfn[i] && tm < freq) ? incr
                                                                 : 0.0f);
            }
            tm = acc;
            const float lmt = lm[t];
            const float v = s_v[buf][k];
            const bool sw = s_prm[buf][0][fr] > 0.5f;
            if (sw && v > s_tv[buf][k] && v > last
                && lmt > __fadd_rn(tm, s_prm[buf][2][fr]))
                tm = lmt;
            if (sw)
                carry = tm;
            out[((size_t)(f0 + fr) * ch + c) * n + t] = carry;
        }
        __syncthreads();                // buf is restaged next tile
    }
}

extern "C" int vtt_m3_scan(const float *logmdct, const float *lastmdct,
                           const float *val, const float *tval,
                           const float *prm, const float *tabs, float *out,
                           int F, int ch, int n, int ldl, int maxnb,
                           float base, void *stream)
{
    if (n < MIN_N || n > MAX_N || TILE_ELEMS % n != 0 || ldl < n
        || maxnb < 1 || maxnb > n || F <= 0 || ch <= 0)
        return (int)cudaErrorInvalidValue;
    m3_scan_kernel<<<ch, n, 0, (cudaStream_t)stream>>>(
        logmdct, lastmdct, val, tval, prm, tabs, out, F, ch, n, ldl, maxnb,
        base);
    return (int)cudaGetLastError();
}
