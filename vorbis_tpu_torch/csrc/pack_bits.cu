// The packet packer of the encoder's finish step as one Hopper kernel:
// the static plan's bit-field column merge and the LSB-first packing of
// each packet's fields into its bytes (libogg oggpack_write).
//
// Replaces no Pallas kernel: it stands for the jitted XLA stages
// `merge_columns`, `_merge_limb_pairs` and `pack_bits_device` of
// vorbis_tpu/ops/encdevice.py:241-360 (a byte-plane one-hot matmul on the
// TPU's matrix unit), which the port ran as about 80 small PyTorch
// launches a finish call: a static gather and an OR a group slot, a
// cumsum of the lengths and five byte-plane scatter-adds.
//
// What bounds it on an H100: the bytes.  A long finish batch of 2,048
// stereo packets reads 2,048 x 2,891 columns of (int64 value, int32
// length), 71 MB, and writes 2,048 rows of 768 bytes; the arithmetic is
// a few integer operations a column.
//
// Design: one CTA a packet row.  The block's threads walk the plan's
// groups in rounds of one group a thread: a thread merges its group's
// columns in 64-bit registers as the plain version does (a zero-length
// column contributes nothing, even with a stale value; a column is ORed
// unmasked, shifted by the group's length so far clamped at 31; the
// merged value kept to 32 bits), masks the merged field to its width, and
// a block-wide exclusive scan of the merged lengths (warp shuffles, then
// the warps' totals) gives each field its bit offset after the previous
// rounds' bits.  Each field, at most 63 bits once shifted into place, is
// ORed with atomicOr into at most two 32-bit words of a shared buffer of
// wb bytes: fields occupy disjoint bits, so the ORs are exact in any
// order and equal the plain version's byte-plane sums.  Words at byte wb
// and beyond are dropped, bytes past wb inside the last word are never
// written out, the row goes out byte by byte, and thread 0 writes the
// packet's bit count.  The plan comes as the groups' column lists
// (`groups`: C1 + 1 offsets, then the columns; a plan's pads dropped, as
// they merge a zero-length column).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    pack_packets_kernel(const long long* __restrict__ vals,
                        const int* __restrict__ lens,
                        const int* __restrict__ groups, int C, int C1, int wb,
                        unsigned char* __restrict__ out,
                        int* __restrict__ nbits) {
  extern __shared__ unsigned int words[];  // (wb + 3) / 4
  __shared__ long long warp_total[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long f = blockIdx.x;
  const int nwords = (wb + 3) >> 2;
  for (int i = t; i < nwords; i += kThreads) words[i] = 0u;
  const long long* vrow = vals + f * C;
  const int* lrow = lens + f * C;
  const int* cols = groups + C1 + 1;
  long long base = 0;  // the bits of the rounds before this one
  __syncthreads();
  for (int g0 = 0; g0 < C1; g0 += kThreads) {
    const int g = g0 + t;
    unsigned long long acc = 0ull;
    int acc_l = 0;
    if (g < C1) {
      const int b = __ldg(groups + g), e = __ldg(groups + g + 1);
      for (int i = b; i < e; ++i) {
        const int c = __ldg(cols + i);
        const int l = __ldg(lrow + c);
        if (l > 0)
          acc |= (unsigned long long)__ldg(vrow + c) << min(acc_l, 31);
        acc_l += l;
      }
    }
    // the merged field kept to 32 bits, then masked to its width
    unsigned long long v = acc & 0xffffffffull;
    if (acc_l <= 0)
      v = 0ull;
    else if (acc_l < 32)
      v &= (1ull << acc_l) - 1ull;
    // block-wide exclusive scan of the merged lengths
    long long x = acc_l;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    long long before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const long long s = warp_total[w];
      before += w < warp ? s : 0;
      total += s;
    }
    const long long off = base + before + x - acc_l;
    if (v != 0ull) {
      const long long w = off >> 5;
      const unsigned long long sh = v << (off & 31);
      const unsigned lo = (unsigned)sh, hi = (unsigned)(sh >> 32);
      if (w < nwords && lo) atomicOr(&words[w], lo);
      if (w + 1 < nwords && hi) atomicOr(&words[w + 1], hi);
    }
    base += total;
    __syncthreads();  // the ORs done and warp_total read before reuse
  }
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(words);
  unsigned char* orow = out + f * wb;
  for (int i = t; i < wb; i += kThreads) orow[i] = bytes[i];
  if (t == 0) nbits[f] = (int)base;
}

int shared_bytes(int wb) { return ((wb + 3) / 4) * 4; }

}  // namespace

// vals (F, C) int64, lens (F, C) int32, groups (C1 + 1 + columns) int32
// -> out (F, wb) uint8, nbits (F,) int32, on `stream`.  Returns the
// launch's cudaError_t.
extern "C" int vtt_pack_packets(const long long* vals, const int* lens,
                                const int* groups, int F, int C, int C1,
                                int wb, unsigned char* out, int* nbits,
                                cudaStream_t stream) {
  if (F < 1 || C < 1 || C1 < 1 || wb < 1) return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(wb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_packets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_packets_kernel<<<F, kThreads, smem, stream>>>(vals, lens, groups, C,
                                                     C1, wb, out, nbits);
  return (int)cudaGetLastError();
}

// for the report: the shared bytes a block of a launch at budget wb
// (through *smem) and the blocks of it an SM can hold, or -1
extern "C" int vtt_pack_packets_blocks_per_sm(int wb, int* smem) {
  *smem = shared_bytes(wb) + (int)sizeof(long long) * kWarps;
  const int dyn = shared_bytes(wb);
  if (dyn > 48 * 1024 &&
      cudaFuncSetAttribute(pack_packets_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pack_packets_kernel, kThreads, dyn) != cudaSuccess)
    return -1;
  return n;
}
