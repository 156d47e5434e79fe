// K-way splitter classifier on Hopper: bucket id of every (key, tie) pair
// and the histogram of the buckets, in one launch.
//
// Replaces the TPU kernel kway_classify (_kway_kernel / _classify_block) in
// src/repro/kernels/kway/kway.py.  On the TPU the grid walks 64x128 blocks in
// order and adds each block's one-hot histogram into one output; here blocks
// run in any order, so each block keeps a histogram in shared memory and adds
// it into the global one with one atomicAdd per bucket at its end.  The
// wrapper on the TPU pads C up to a block multiple and subtracts the pads
// from the histogram afterwards; this kernel masks its ragged edge, so the
// histogram is exact with no correction.
//
// bucket[i] = #splitters j with (s_key[j], s_tie[j]) <= (key[i], tie[i]),
// compared as the u64 word (key ^ 0x80000000) << 32 | tie: keys are the
// port's sign-flipped int32 words and ties uint32 bits, so the word's order
// is the reference's (unsigned key, unsigned tie) order.  The splitters need
// not be sorted (the count does not depend on their order).  hist[b] counts
// the elements with bucket b < nb.
//
// What bounds it on the card: bytes for the splitter counts of the external
// lane (nb <= 16 or so: 12 bytes per element against nb - 1 compares), the
// compares above a few hundred splitters.  Design, simple first: splitters
// are staged in shared memory as u64 words, SCHUNK at a time (so any count
// works); each thread holds ITEMS elements in registers and counts every
// splitter of the chunk against each (a broadcast read of shared memory);
// blocks stride over tiles of THREADS * ITEMS elements, so a single chunk is
// staged once per block.  The block histogram lives in shared memory when nb
// fits (warp-aggregated atomics: lanes of one bucket add once), else the
// adds go to the global histogram directly.  A search tree over sorted
// splitters would cut the compares to log2(nb); that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 4
#define SCHUNK 1024              // splitters staged per round (8 KB)
#define SMEM_HIST_MAX 8192       // buckets kept in shared memory (32 KB)
#define BLOCKS_PER_SM 8

__device__ __forceinline__ uint64_t word(int32_t key, int32_t tie) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)tie;
}

__global__ void __launch_bounds__(THREADS)
kway_classify_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ ties,
                     const int32_t* __restrict__ s_keys,
                     const int32_t* __restrict__ s_ties,
                     int32_t* __restrict__ bucket, int32_t* __restrict__ hist,
                     int64_t C, int64_t S, int nb, int smem_hist) {
  __shared__ uint64_t spl[SCHUNK];
  extern __shared__ int32_t block_hist[];
  const int lane = threadIdx.x & 31;
  if (smem_hist)
    for (int j = threadIdx.x; j < nb; j += THREADS) block_hist[j] = 0;
  __syncthreads();
  const int64_t nchunks = (S + SCHUNK - 1) / SCHUNK;
  const int64_t tile = (int64_t)THREADS * ITEMS;
  bool staged = false;                  // the one chunk, when S <= SCHUNK
  for (int64_t base = (int64_t)blockIdx.x * tile; base < C;
       base += (int64_t)gridDim.x * tile) {
    uint64_t e[ITEMS];
    int cnt[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t x = base + (int64_t)i * THREADS + threadIdx.x;
      e[i] = x < C ? word(__ldg(keys + x), __ldg(ties + x)) : 0;
      cnt[i] = 0;
    }
    for (int64_t c = 0; c < nchunks; ++c) {
      const int64_t lo = c * SCHUNK;
      const int len = (int)min((int64_t)SCHUNK, S - lo);
      if (nchunks > 1 || !staged) {     // uniform across the block
        __syncthreads();                // the last chunk is read by all
        for (int j = threadIdx.x; j < len; j += THREADS)
          spl[j] = word(__ldg(s_keys + lo + j), __ldg(s_ties + lo + j));
        __syncthreads();
        staged = true;
      }
      for (int j = 0; j < len; ++j) {
        const uint64_t s = spl[j];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) cnt[i] += s <= e[i];
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t x = base + (int64_t)i * THREADS + threadIdx.x;
      const int b = x < C ? cnt[i] : -1;
      if (x < C) bucket[x] = b;
      // every lane of the warp takes part in the match: the loop is uniform
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
      if (b >= 0 && b < nb && lane == __ffs(peers) - 1) {
        if (smem_hist) atomicAdd(&block_hist[b], __popc(peers));
        else atomicAdd(&hist[b], __popc(peers));
      }
    }
  }
  if (smem_hist) {
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += THREADS)
      if (block_hist[j]) atomicAdd(&hist[j], block_hist[j]);
  }
}

extern "C" {

int kway_classify(const int32_t* keys, const int32_t* ties,
                  const int32_t* s_keys, const int32_t* s_ties,
                  int32_t* bucket, int32_t* hist, int64_t C, int64_t S, int nb,
                  void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(hist, 0, (size_t)nb * sizeof(int32_t), st);
  const int64_t tiles = (C + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  int64_t blocks = (int64_t)sms * BLOCKS_PER_SM;
  if (tiles < blocks) blocks = tiles;
  if (blocks < 1) blocks = 1;
  const int smem_hist = nb <= SMEM_HIST_MAX;
  const size_t smem = smem_hist ? (size_t)nb * sizeof(int32_t) : 0;
  kway_classify_kernel<<<(unsigned)blocks, THREADS, smem, st>>>(
      keys, ties, s_keys, s_ties, bucket, hist, C, S, nb, smem_hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
