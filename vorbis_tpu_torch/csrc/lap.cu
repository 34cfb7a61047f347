// Windowed lapped overlap-add with the granulepos trim as a hand-written
// Hopper kernel: the decode's second device stage (models/fastdec.py
// _decode_jobs), one launch for every stream of a batch, after the IMDCT
// (csrc/imdct.cu) and before the copy of the PCM to the host.
//
// Replaces: the lap of the decode's host side, csrc/host_decode.c
// vn_lap_add (the JAX package's vorbis_tpu/models/fastdec.py
// FastDecoder._native_lap, host C, not a Pallas kernel) followed by the
// cut to [lo, hi) of FastDecoder._trim_range.
//
// Computes, for every stream of the batch, its trimmed (ch, hi - lo) PCM
// into one output buffer at the stream's offset: each raw block times its
// hybrid window (ops/window.py, the 8 (lW, W, nW) ids of _win_table),
// added at its offset into a zeroed buffer, then cut to [lo, hi).  The
// host C adds every block's products in packet order into a buffer that
// starts at +0.  Let c_p be packet p's center: in [c_{p-1}, c_p) only
// blocks p-1 and p have a nonzero window (the hybrid window's leftbegin
// and rightend put a long block's zeros exactly where a short neighbour's
// slope starts), and a finite block times a zero window is +-0, which
// leaves a nonzero sum as it is and a +0 sum at +0.  So one CTA owns one
// span [c_{p-1}, c_p) n [lo, hi) of a stream (all its channels) and
// writes each sample once as fadd(fadd(+0, a), b), a = block p-1's
// product and b = block p's (a block that does not reach the sample
// adds nothing): the host C's value bit for bit, a lone -0.0 product
// giving +0.0 as `d[i] += s * w` does.  (A non-finite sample under a
// zero window, inf * 0, would make the host C's sum NaN; such blocks are
// not compared bit for bit on the card anyway, its NaN pattern differs.)
// No float atomics: atom.add.f32 and red.add.f32 flush subnormal inputs
// and results to zero, which the host C does not.  Every op is an
// explicit round-to-nearest intrinsic and the library is built with
// -fmad=false and without --use_fast_math.
//
// Bound on this card: bytes.  A sample reads two block values (and two
// window values, which stay in L1: 4 bs0 + 4 bs1 floats a blocksize
// pair) and writes one, against four float32 operations.  Each thread
// takes consecutive samples of a channel, so loads and stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pk: per packet (the batch's streams one after another) block element
// offset of channel 0 (channel c at + c * n), block start in the stream's
// lapped coordinates, window element offset, (stream << 16) | n.
// st: per stream lo, hi, channels, output element offset.
__global__ void __launch_bounds__(128)
lap_spans(const float *__restrict__ blocks, const float *__restrict__ wins,
          const long long *__restrict__ pk, const long long *__restrict__ st,
          float *__restrict__ out, long npk)
{
    for (long p = blockIdx.x + 1L; p < npk; p += gridDim.x) {
        const long long *A = pk + 4 * (p - 1), *B = pk + 4 * p;
        long long sid = B[3] >> 16;
        if ((A[3] >> 16) != sid)
            continue;                       // p opens its stream
        const long long nA = A[3] & 0xffff, nB = B[3] & 0xffff;
        const long long posA = A[1], posB = B[1];
        const long long lo = st[4 * sid], hi = st[4 * sid + 1];
        const long long a = max(posA + nA / 2, lo);
        const long long b = min(posB + nB / 2, hi);
        if (a >= b)
            continue;
        const int ch = (int)st[4 * sid + 2];
        const long long N = hi - lo, len = b - a;
        float *o = out + st[4 * sid + 3] + (a - lo);
        // sample i of the span is block A's a - posA + i and block B's
        // a - posB + i (negative before B starts)
        const long long ia = a - posA, ib = a - posB;
        const float *wA = wins + A[2], *wB = wins + B[2];
        for (int c = 0; c < ch; c++) {
            const float *bA = blocks + A[0] + c * nA;
            const float *bB = blocks + B[0] + c * nB;
            for (long long i = threadIdx.x; i < len; i += blockDim.x) {
                long long ja = ia + i, jb = ib + i;
                float va = ja < nA ? __fmul_rn(bA[ja], wA[ja]) : 0.0f;
                float vb = jb >= 0 ? __fmul_rn(bB[jb], wB[jb]) : 0.0f;
                o[c * N + i] = __fadd_rn(__fadd_rn(0.0f, va), vb);
            }
        }
    }
}

}  // namespace

// blocks: every IMDCT block of the batch; wins: the window tables; pk
// (npk, 4) and st (streams, 4) as above; out: the trimmed PCM of every
// stream.  Returns a cudaError_t.
extern "C" int vtt_lap(const float *blocks, const float *wins,
                       const long long *pk, const long long *st, float *out,
                       long npk, void *stream)
{
    if (npk < 0)
        return (int)cudaErrorInvalidValue;
    if (npk < 2)
        return 0;
    long grid = npk - 1;
    if (grid > 0x7fffffffL)
        grid = 0x7fffffffL;
    lap_spans<<<(unsigned)grid, 128, 0, (cudaStream_t)stream>>>(
        blocks, wins, pk, st, out, npk);
    return (int)cudaGetLastError();
}
