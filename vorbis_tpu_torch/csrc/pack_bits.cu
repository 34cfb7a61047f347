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
// stereo packets reads 2,048 x 2,891 int32 lengths (23.7 MB), of the
// int64 values only the 32-byte sectors of columns with bits (about 10 MB:
// a zero-length column's value is never read), and writes 2,048 rows of
// 768 bytes; the arithmetic is a few integer operations a column.
//
// Design (the second; the first, a block a packet walking the groups in
// rounds of a group a thread with a block scan a round, is commit
// 4c76a5d's):
//  * The plan is its groups' column offsets alone (`offs`, C1 + 1 int32):
//    every group is a run of consecutive columns (ops/pack_cuda.py
//    PackTables refuses a plan otherwise).
//  * A block holds `ppb` packets of `tpp` threads (whole warps), sized to
//    the batch by ops/pack_cuda.py `PackTables.geometry`.  A packet's
//    groups go in tiles of tpp x run groups, a thread a run of `run`
//    consecutive groups; a tile carries the running bit base of those
//    before it, so any row length works (4d's long plan, 1,919 groups, is
//    one tile of 256 threads x 8 groups).
//  * A tile's lengths are staged into shared memory by asynchronous
//    copies, all issued before any is used: cp.async.cg 16-byte copies
//    of the aligned interior and cp.async.ca 4-byte copies of the head
//    and tail.  A row of C int32 starts on any 4-byte boundary (C is odd
//    at 4d's plans), so the tile lands at the shared word offset that
//    puts its interior on 16-byte shared addresses.  A bulk (TMA) copy
//    wants a 16-byte aligned source and a multiple of 16 bytes, which a
//    row's tile does not have, so the copies are cp.async's.
//  * The tile's values are staged the same way once its lengths are in:
//    a 4-byte cp.async of a value's low word a column whose length is
//    positive (a merged field keeps only its low 32 bits, and a shift of
//    at most 31 brings no higher bit down), consecutive threads on
//    consecutive columns, so a warp reads the same 32-byte sectors the
//    whole values would take; a zero-length column's value is never read
//    from global memory, and its slot's stale word never used.  A
//    thread reads the lengths of its copies before issuing them (a copy
//    writes shared memory, so no later load would be hoisted above it).
//    The copies fly while every thread sums its run's lengths and one
//    block-wide exclusive scan of the runs' sums (warp shuffles, then
//    the packet's warp totals) gives every run its bit offset.  (A first
//    cut loaded each thread's own run's values into registers:
//    neighbouring threads then read about 90 bytes apart, and the
//    uncoalesced loads made it slower than the first design.)
//  * The thread then merges its groups, a group at a time (each group's
//    end from `offs`, its columns from shared memory), exactly as the
//    plain version does, in 32 bits (a zero-length column contributes
//    nothing, even with a stale value; a column is ORed unmasked, shifted
//    by the group's length so far clamped at 31; the merged field kept to
//    32 bits, then masked to its width) and ORs each field, at most 63
//    bits once shifted into place, into at most two 32-bit words of the
//    packet's shared buffer (atomicOr: fields occupy disjoint bits, so
//    the ORs are exact in any order and equal the plain version's
//    byte-plane sums).  Words past the budget are dropped.  A thread's
//    merge is its own serial chain of groups, and it is the longest
//    phase of a block (the timing build below).
//  * The row leaves in 16-byte stores when its base is 16-byte aligned
//    (wb a multiple of 16: 768 at 4d's plans), in bytes otherwise and at
//    the edge; nbits is written once.
// Built with -DVTT_PACK_TIMING it also takes a stamps array and writes,
// a warp, the clock64 cycles of its six phases (stage the lengths; issue
// the value copies; the sum and the scan; the values' wait; the merge and
// the ORs; the store) summed over the tiles, and its total; the default
// build has no such code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a block (ops/pack_cuda.py THREADS)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRun = 8;        // groups a thread a tile (MAX_RUN)
constexpr int kCopies = 4;        // value copies a thread issues together
constexpr unsigned kFull = 0xffffffffu;

// the launch's shape (ops/pack_cuda.py PackTables.geometry)
struct Shape {
  int C, C1, wb;
  int tpp;  // threads a packet, whole warps
  int ppb;  // packets a block
  int run;  // groups a thread a tile, at most kMaxRun
  int lw;   // staged columns a packet (lengths, and as many values' low
            // words), a multiple of 4
  int nw;   // packet words a packet, a multiple of 4, >= (wb + 3) / 4
};

#ifdef VTT_PACK_TIMING
constexpr int kPhases = 6, kStamps = kPhases + 1;
#define PK_STAMPS_PARAM , long long* __restrict__ stamps
#define PK_PHASE(k)                   \
  do {                                \
    const long long now_ = clock64(); \
    ph[k] += now_ - t_prev;           \
    t_prev = now_;                    \
  } while (0)
#else
#define PK_STAMPS_PARAM
#define PK_PHASE(k) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one merged group's field, kept to 32 bits and masked to its width,
// ORed into the packet's words at bit `off`; words past the budget dropped
__device__ __forceinline__ void put_field(unsigned acc, int acc_l,
                                          long long off, unsigned* words,
                                          int nwords) {
  unsigned v = acc;
  if (acc_l <= 0)
    v = 0u;
  else if (acc_l < 32)
    v &= (1u << acc_l) - 1u;
  if (v == 0u || off < 0) return;
  const long long w = off >> 5;
  const unsigned long long sh = (unsigned long long)v << (off & 31);
  const unsigned lo = (unsigned)sh, hi = (unsigned)(sh >> 32);
  if (w < nwords && lo) atomicOr(&words[w], lo);
  if (w + 1 < nwords && hi) atomicOr(&words[w + 1], hi);
}

__global__ void __launch_bounds__(kMaxThreads)
    pack_packets_kernel(const long long* __restrict__ vals,
                        const int* __restrict__ lens,
                        const int* __restrict__ offs, Shape s, int F,
                        unsigned char* __restrict__ out,
                        int* __restrict__ nbits PK_STAMPS_PARAM) {
  extern __shared__ __align__(16) int smem[];
  __shared__ long long warp_total[kMaxWarps];
  const int slot = threadIdx.x / s.tpp, t = threadIdx.x - slot * s.tpp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = slot * (s.tpp >> 5), nwp = s.tpp >> 5;  // packet's warps
  const long long f = (long long)blockIdx.x * s.ppb + slot;
  const bool live = f < F;
  // a packet's shared memory: lw staged lengths, lw values' low words,
  // the packet's words
  int* stage = smem + slot * (2 * s.lw + s.nw);
  int* vstage = stage + s.lw;
  unsigned* words = reinterpret_cast<unsigned*>(vstage + s.lw);
  const int nwords = (s.wb + 3) >> 2;
#ifdef VTT_PACK_TIMING
  long long ph[kPhases] = {0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
  long long t_prev = t_start;
#endif
  for (int i = t; i < s.nw; i += s.tpp) words[i] = 0u;
  const long long* vrow = vals + (live ? f : 0) * s.C;
  const int* lrow = lens + (live ? f : 0) * s.C;
  const int tile = s.tpp * s.run;
  long long base = 0;  // the bits of the tiles before this one
  for (int g0 = 0; g0 < s.C1; g0 += tile) {
    const int g1 = min(g0 + tile, s.C1);
    // this thread's run of groups [ga, gb), columns [cb, ce)
    const int ga = min(g0 + t * s.run, g1), gb = min(ga + s.run, g1);
    const int cb = __ldg(offs + ga), ce = __ldg(offs + gb);
    // the row's ends need no load: a one-tile row stages at once
    const int c0 = g0 ? __ldg(offs + g0) : 0;
    const int c1 = g1 < s.C1 ? __ldg(offs + g1) : s.C;
    // the tile's lengths, columns [c0, c1), at shared word mis + (c - c0)
    const int mis = (int)((reinterpret_cast<uintptr_t>(lrow + c0) >> 2) & 3);
    if (live) {
      const int n = c1 - c0;
      const int head = min((4 - mis) & 3, n);
      const int nvec = (n - head) >> 2;
      const int tail = head + (nvec << 2);
      for (int j = t; j < head; j += s.tpp)
        cp_async4(stage + mis + j, lrow + c0 + j);
      for (int k = t; k < nvec; k += s.tpp)
        cp_async16(stage + mis + head + 4 * k, lrow + c0 + head + 4 * k);
      for (int j = tail + t; j < n; j += s.tpp)
        cp_async4(stage + mis + j, lrow + c0 + j);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    PK_PHASE(0);
    const int* ls = stage + mis - c0;  // ls[c]: column c's length
    const unsigned* vs =               // vs[c]: its value's low word
        reinterpret_cast<const unsigned*>(vstage) - c0;
    // the tile's values' low words where their lengths are positive, in
    // flight through the sum and the scan
    // (the lengths read ahead of the copies: a copy writes shared memory,
    // so no later length load would be hoisted above it)
    if (live)
      for (int c = c0 + t; c < c1; c += kCopies * s.tpp) {
        int l[kCopies];
#pragma unroll
        for (int k = 0; k < kCopies; ++k)
          l[k] = c + k * s.tpp < c1 ? ls[c + k * s.tpp] : 0;
#pragma unroll
        for (int k = 0; k < kCopies; ++k)
          if (l[k] > 0)
            cp_async4(vstage + (c + k * s.tpp - c0),
                      reinterpret_cast<const int*>(vrow + c + k * s.tpp));
      }
    cp_async_commit();
    PK_PHASE(1);
    const int ng = live ? gb - ga : 0;
    long long mine = 0;
    if (ng) {
#pragma unroll 4
      for (int c = cb; c < ce; ++c) mine += ls[c];
    }
    // one block-wide exclusive scan of the runs' bits, packet by packet
    long long x = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    long long before = 0, total = 0;
    for (int w = 0; w < nwp; ++w) {
      const long long tw = warp_total[w0 + w];
      before += w0 + w < warp ? tw : 0;
      total += tw;
    }
    PK_PHASE(2);
    cp_async_wait_all();
    __syncthreads();  // the tile's values staged
    PK_PHASE(3);
    long long off = base + before + x - mine;
    int ca = cb;  // the next group's first column
    for (int j = 0; j < ng; ++j) {
      const int cz = __ldg(offs + ga + j + 1);
      unsigned acc = 0u;
      int acc_l = 0;
      for (int c = ca; c < cz; ++c) {
        const int l = ls[c];
        const unsigned v = vs[c];  // a stale slot where l is not positive
        acc |= l > 0 ? v << min(acc_l, 31) : 0u;
        acc_l += l;
      }
      put_field(acc, acc_l, off, words, nwords);
      off += acc_l;
      ca = cz;
    }
    base += total;
    __syncthreads();  // the ORs done; the stages and totals free for reuse
    PK_PHASE(4);
  }
  if (live) {
    unsigned char* orow = out + f * s.wb;
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(words);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(orow) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(words);
      uint4* dst = reinterpret_cast<uint4*>(orow);
      done = s.wb >> 4;
      for (int i = t; i < done; i += s.tpp) dst[i] = src[i];
      done <<= 4;
    }
    for (int i = done + t; i < s.wb; i += s.tpp) orow[i] = bytes[i];
    if (t == 0) nbits[f] = (int)base;
  }
  PK_PHASE(5);
#ifdef VTT_PACK_TIMING
  if (lane == 0) {
    long long* st =
        stamps + ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kStamps;
#pragma unroll
    for (int k = 0; k < kPhases; ++k) st[k] = ph[k];
    st[kPhases] = clock64() - t_start;
  }
#endif
}

int shared_bytes(const Shape& s) { return s.ppb * (2 * s.lw + s.nw) * 4; }

bool valid(const Shape& s) {
  return s.C >= 1 && s.C1 >= 1 && s.wb >= 1 && s.tpp >= 32 &&
         s.tpp % 32 == 0 && s.ppb >= 1 && s.tpp * s.ppb <= kMaxThreads &&
         s.run >= 1 && s.run <= kMaxRun && s.lw >= 4 && s.lw % 4 == 0 &&
         s.nw % 4 == 0 && s.nw >= (s.wb + 3) / 4;
}

cudaError_t allow_shared(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pack_packets_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// vals (F, C) int64, lens (F, C) int32 (4-byte aligned rows), offs (C1 + 1)
// int32 -> out (F, wb) uint8, nbits (F,) int32, on `stream`, in blocks of
// ppb packets of tpp threads, tiles of tpp x run groups whose columns fit
// lw staged columns, nw words a packet's buffer.  Returns the launch's
// cudaError_t.  A timing build (-DVTT_PACK_TIMING) takes `stamps`, kStamps
// int64 a warp.
extern "C" int vtt_pack_packets(const long long* vals, const int* lens,
                                const int* offs, int F, int C, int C1,
                                int wb, int tpp, int ppb, int run, int lw,
                                int nw, unsigned char* out, int* nbits,
                                cudaStream_t stream
#ifdef VTT_PACK_TIMING
                                ,
                                long long* stamps
#endif
) {
  const Shape s{C, C1, wb, tpp, ppb, run, lw, nw};
  if (F < 1 || !valid(s) || ((uintptr_t)lens & 3) || ((uintptr_t)vals & 7))
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(s);
  const cudaError_t e = allow_shared(smem);
  if (e != cudaSuccess) return (int)e;
  pack_packets_kernel<<<(F + ppb - 1) / ppb, tpp * ppb, smem, stream>>>(
      vals, lens, offs, s, F, out, nbits
#ifdef VTT_PACK_TIMING
      ,
      stamps
#endif
  );
  return (int)cudaGetLastError();
}

// for the report: the blocks of `threads` threads and `smem` dynamic
// shared bytes that an SM holds at once, or -1
extern "C" int vtt_pack_packets_blocks_per_sm(int threads, int smem) {
  if (allow_shared(smem) != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pack_packets_kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}
