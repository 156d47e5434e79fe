// Fused partition-into-buckets on Hopper: splitter classify, histogram and
// stable in-bucket rank over PE-batched shards, in two launches.
//
// Replaces the TPU kernel partition_tile (_partition_kernel) in
// src/repro/kernels/partition/partition.py.  On the TPU one grid walks the
// tiles in order and threads the running histogram from tile to tile; here
// blocks run in any order, so
//   partition_classify  classifies every element and writes one histogram
//                       per tile (rows, tiles, nb+1);
//   (the wrapper turns those into per-tile offsets with one torch.cumsum
//    over the tile axis, the counterpart of the host-side chaining in
//    repro/kernels/partition/ops.py)
//   partition_rank      gives each element its stable rank: tile offset of
//                       its bucket plus its rank inside the tile.
//
// Element composites are never built: (int32 key, uint32 tie) compare
// lexicographically, the key signed (the port's sign-flipped word) and the
// tie unsigned, which equals the reference's u64 (key << 32 | tie) order.
// Flat index >= count goes to the trash bucket nb.  sum(hist) == count.
// Both grids are one-dimensional, block b taking row b / blocks_per_row, so
// the row count is bounded by gridDim.x (2^31 - 1 blocks), not by
// gridDim.y's 65 535 (RQuick runs p = 2^18 rows); the division is 32-bit
// (split()), since a 64-bit one costs each thread more than its compares.
//
// What bounds them on the card: bytes.  Classify reads key and tie (8 bytes)
// and writes the bucket (4); rank reads the bucket and writes the position
// (8); the binary search over at most 511 splitters runs out of shared
// memory.  Design: splitters and the tile histogram live in shared memory
// (atomics on the histogram); the rank walks its tile with one warp, 32
// elements a step, using __match_any_sync to find the lanes of the same
// bucket and __popc for the rank among them, with a running count per bucket
// in shared memory — in-order, so the rank is stable.

#include <cuda_runtime.h>
#include <stdint.h>

#define PTILE 1024
#define CLASSIFY_THREADS 256
#define RANK_WARPS 4

// This block's (row, index within the row) for blocks_per_row blocks a row.
__device__ __forceinline__ void split(int64_t blocks_per_row, int64_t& row,
                                      int64_t& index) {
  const unsigned per = (unsigned)blocks_per_row;
  const unsigned r = blockIdx.x / per;
  row = r;
  index = blockIdx.x - r * per;
}

__global__ void __launch_bounds__(CLASSIFY_THREADS)
partition_classify_kernel(const int32_t* __restrict__ keys,
                          const int32_t* __restrict__ ties,
                          const int32_t* __restrict__ s_keys,
                          const int32_t* __restrict__ s_ties,
                          const int64_t* __restrict__ count,
                          int32_t* __restrict__ bucket,
                          int32_t* __restrict__ tile_hist, int64_t C, int nb,
                          int inclusive, int64_t ntiles) {
  extern __shared__ int32_t sh[];
  const int S = nb - 1;
  int32_t* sk = sh;
  uint32_t* st = (uint32_t*)(sh + S);
  int32_t* hist = sh + 2 * S;
  int64_t row, tile;
  split(ntiles, row, tile);
  for (int j = threadIdx.x; j < S; j += CLASSIFY_THREADS) {
    sk[j] = s_keys[row * S + j];
    st[j] = (uint32_t)s_ties[row * S + j];
  }
  for (int j = threadIdx.x; j <= nb; j += CLASSIFY_THREADS) hist[j] = 0;
  __syncthreads();
  const int64_t cnt = count[row];
  const int64_t beg = tile * PTILE;
  const int64_t end = min(beg + PTILE, C);
  for (int64_t x = beg + threadIdx.x; x < end; x += CLASSIFY_THREADS) {
    int b = nb;
    if (x < cnt) {
      const int32_t key = __ldg(keys + row * C + x);
      const uint32_t tie = (uint32_t)__ldg(ties + row * C + x);
      int lo = 0, hi = S;                   // #splitters s with s <= e
      while (lo < hi) {                     // (s < e when !inclusive)
        const int mid = (lo + hi) >> 1;
        const bool le = sk[mid] < key ||
                        (sk[mid] == key &&
                         (inclusive ? st[mid] <= tie : st[mid] < tie));
        if (le) lo = mid + 1; else hi = mid;
      }
      b = lo;
    }
    bucket[row * C + x] = b;
    atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  int32_t* out = tile_hist + (row * ntiles + tile) * (nb + 1);
  for (int j = threadIdx.x; j <= nb; j += CLASSIFY_THREADS) out[j] = hist[j];
}

__global__ void __launch_bounds__(RANK_WARPS * 32)
partition_rank_kernel(const int32_t* __restrict__ bucket,
                      const int32_t* __restrict__ tile_off,
                      int32_t* __restrict__ pos, int64_t C, int nb,
                      int64_t ntiles, int64_t row_blocks) {
  extern __shared__ int32_t counts[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int64_t row, block;
  split(row_blocks, row, block);
  const int64_t tile = block * RANK_WARPS + warp;
  int32_t* c = counts + warp * (nb + 1);
  for (int j = lane; j <= nb; j += 32) c[j] = 0;
  __syncwarp();
  if (tile >= ntiles) return;
  const int32_t* off = tile_off + (row * ntiles + tile) * (nb + 1);
  const int64_t beg = tile * PTILE;
  const int64_t end = min(beg + PTILE, C);
  const unsigned below = (1u << lane) - 1u;
  for (int64_t x0 = beg; x0 < end; x0 += 32) {
    const int64_t x = x0 + lane;
    const bool active = x < end;
    const unsigned act = __ballot_sync(0xFFFFFFFFu, active);
    if (active) {
      const int b = __ldg(bucket + row * C + x);
      const unsigned peers = __match_any_sync(act, b);
      const int before = c[b];
      pos[row * C + x] = __ldg(off + b) + before + __popc(peers & below);
      __syncwarp(act);                      // every lane read c[b]
      if (lane == 31 - __clz(peers)) c[b] = before + __popc(peers);
    }
    __syncwarp();
  }
}

extern "C" {

int partition_classify(const int32_t* keys, const int32_t* ties,
                       const int32_t* s_keys, const int32_t* s_ties,
                       const int64_t* count, int32_t* bucket,
                       int32_t* tile_hist, int64_t rows, int64_t C, int nb,
                       int inclusive, void* stream) {
  if (rows == 0 || C == 0) return 0;
  const int64_t ntiles = (C + PTILE - 1) / PTILE;
  const size_t smem = (size_t)(2 * (nb - 1) + nb + 1) * sizeof(int32_t);
  if (ntiles * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  partition_classify_kernel<<<(unsigned)(ntiles * rows), CLASSIFY_THREADS,
                              smem, (cudaStream_t)stream>>>(
      keys, ties, s_keys, s_ties, count, bucket, tile_hist, C, nb, inclusive,
      ntiles);
  return (int)cudaGetLastError();
}

int partition_rank(const int32_t* bucket, const int32_t* tile_off,
                   int32_t* pos, int64_t rows, int64_t C, int nb,
                   void* stream) {
  if (rows == 0 || C == 0) return 0;
  const int64_t ntiles = (C + PTILE - 1) / PTILE;
  const size_t smem = (size_t)RANK_WARPS * (nb + 1) * sizeof(int32_t);
  const int64_t row_blocks = (ntiles + RANK_WARPS - 1) / RANK_WARPS;
  if (row_blocks * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  partition_rank_kernel<<<(unsigned)(row_blocks * rows), RANK_WARPS * 32,
                          smem, (cudaStream_t)stream>>>(bucket, tile_off, pos,
                                                        C, nb, ntiles,
                                                        row_blocks);
  return (int)cudaGetLastError();
}

int partition_tile_size() { return PTILE; }

}  // extern "C"
