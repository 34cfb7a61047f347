// Windowed lapped overlap-add with the granulepos trim as a hand-written
// Hopper kernel: the decode's second device stage, one launch for every
// stream of a batch (models/fastdec.py _decode_jobs) or for one chunk of
// the chunked decode (FastStreamDecoder._synth_device), after the IMDCT
// (csrc/imdct.cu) and before the copy of the PCM to the host.
//
// Replaces: the lap of the decode's host side, csrc/host_decode.c
// vn_lap_add (the JAX package's vorbis_tpu/models/fastdec.py
// FastDecoder._native_lap, host C, not a Pallas kernel) followed by the
// cut to [lo, hi) of FastDecoder._trim_range; and the chunked decode's
// sum into the previous chunk's lap tail (FastStreamDecoder._process,
// vn_decode_stream into a buffer that starts with that tail).
//
// Computes, for every stream of the batch, its trimmed (ch, hi - lo) PCM
// into one output buffer at the stream's offset: each raw block times its
// hybrid window (ops/window.py, the 8 (lW, W, nW) ids of _win_table),
// added at its offset into a buffer that holds the stream's initial
// values (its tail: t_len samples from t_pos, a chunk's carried lap tail)
// and +0 elsewhere, then cut to [lo, hi).  The host C adds every block's
// products in packet order.  Let c_p be packet p's center: in
// [c_{p-1}, c_p) only blocks p-1 and p have a nonzero window (the hybrid
// window's leftbegin and rightend put a long block's zeros exactly where
// a short neighbour's slope starts), before c_0 only block 0, after the
// last center only the last block; and a finite block times a zero
// window is +-0, which leaves a nonzero sum as it is and a +0 sum at +0
// (a sum that starts from +0 is never -0).  So one CTA owns one span of
// a stream, [c_{p-1}, c_p), or [lo, c_0) before its first packet, or
// [c_last, hi) after its last, cut to [lo, hi), and writes each sample
// once as t, then t + a, then + b: t its initial value, a = block p-1's
// product and b = block p's, each added where that block covers the
// sample.  That is the host C's value bit for bit, whatever the other
// blocks' windows (a carried block's window may reach past c_0: its
// products are in t).  (A non-finite sample under a zero window, inf * 0,
// would make the host C's sum NaN; such blocks are not compared bit for
// bit on the card anyway, its NaN pattern differs.)  No float atomics:
// atom.add.f32 and red.add.f32 flush subnormal inputs and results to
// zero, which the host C does not.  Every op is an explicit
// round-to-nearest intrinsic and the library is built with -fmad=false
// and without --use_fast_math.
//
// Bound on this card: bytes.  A sample reads two block values (and two
// window values, which stay in L1: 4 bs0 + 4 bs1 floats a blocksize
// pair), its initial value where it has one, and writes one, against
// four float32 operations.  Each thread takes consecutive samples of a
// channel, so loads and stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One span of stream S: samples [max(c_A, lo), min(c_B, hi)) with c_A
// block A's center (lo without A) and c_B block B's (hi without B).
// A, B: a packet's row of pk, or null; S: the stream's row of st.
__device__ __forceinline__ void
lap_span(const float *__restrict__ blocks, const float *__restrict__ wins,
         const float *__restrict__ tails, const long long *A,
         const long long *B, const long long *S, float *__restrict__ out)
{
    const long long lo = S[0], hi = S[1];
    const long long nA = A ? (A[3] & 0xffff) : 0;
    const long long nB = B ? (B[3] & 0xffff) : 0;
    const long long a = A ? max(A[1] + nA / 2, lo) : lo;
    const long long b = B ? min(B[1] + nB / 2, hi) : hi;
    if (a >= b)
        return;
    const int ch = (int)S[2];
    const long long N = hi - lo, len = b - a;
    float *o = out + S[3] + (a - lo);
    // sample i of the span is block A's a - posA + i, block B's
    // a - posB + i (negative before B starts) and the tail's a - t_pos + i
    const long long ia = A ? a - A[1] : 0, ib = B ? a - B[1] : 0;
    const long long it = a - S[6], tn = S[7];
    const float *wA = A ? wins + A[2] : nullptr;
    const float *wB = B ? wins + B[2] : nullptr;
    for (int c = 0; c < ch; c++) {
        const float *bA = A ? blocks + A[0] + c * nA : nullptr;
        const float *bB = B ? blocks + B[0] + c * nB : nullptr;
        const float *tc = tn > 0 ? tails + S[4] + c * S[5] : nullptr;
        for (long long i = threadIdx.x; i < len; i += blockDim.x) {
            const long long ja = ia + i, jb = ib + i, jt = it + i;
            float v = (tc && jt >= 0 && jt < tn) ? tc[jt] : 0.0f;
            if (A && ja < nA)
                v = __fadd_rn(v, __fmul_rn(bA[ja], wA[ja]));
            if (B && jb >= 0)
                v = __fadd_rn(v, __fmul_rn(bB[jb], wB[jb]));
            o[c * N + i] = v;
        }
    }
}

// pk: per packet (the batch's streams one after another) block element
// offset of channel 0 (channel c at + c * n), block start in the stream's
// lapped coordinates, window element offset, (stream << 16) | n.
// st: per stream lo, hi, channels, output element offset, and its tail:
// element offset in `tails` (channel c at + c * stride), stride, start in
// the stream's lapped coordinates, length (0: none).
// Span s in [0, npk] lies between packets s - 1 and s.
__global__ void __launch_bounds__(128)
lap_spans(const float *__restrict__ blocks, const float *__restrict__ wins,
          const float *__restrict__ tails, const long long *__restrict__ pk,
          const long long *__restrict__ st, float *__restrict__ out,
          long npk)
{
    for (long s = blockIdx.x; s <= npk; s += gridDim.x) {
        const long long *A = s > 0 ? pk + 4 * (s - 1) : nullptr;
        const long long *B = s < npk ? pk + 4 * s : nullptr;
        if (A && B && (A[3] >> 16) == (B[3] >> 16)) {
            lap_span(blocks, wins, tails, A, B, st + 8 * (B[3] >> 16), out);
            continue;
        }
        if (A)                              // after A's stream's last center
            lap_span(blocks, wins, tails, A, nullptr, st + 8 * (A[3] >> 16),
                     out);
        if (B)                              // before B's stream's first
            lap_span(blocks, wins, tails, nullptr, B, st + 8 * (B[3] >> 16),
                     out);
    }
}

}  // namespace

// blocks: every IMDCT block of the batch; wins: the window tables; tails:
// the streams' initial values (null when no stream has any); pk (npk, 4)
// and st (streams, 8) as above; out: the trimmed PCM of every stream.
// Returns a cudaError_t.
extern "C" int vtt_lap(const float *blocks, const float *wins,
                       const float *tails, const long long *pk,
                       const long long *st, float *out, long npk,
                       void *stream)
{
    if (npk < 0)
        return (int)cudaErrorInvalidValue;
    if (npk < 1)
        return 0;
    long grid = npk + 1;
    if (grid > 0x7fffffffL)
        grid = 0x7fffffffL;
    lap_spans<<<(unsigned)grid, 128, 0, (cudaStream_t)stream>>>(
        blocks, wins, tails, pk, st, out, npk);
    return (int)cudaGetLastError();
}
