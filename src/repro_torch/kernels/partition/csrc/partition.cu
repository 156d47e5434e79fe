// Fused partition-into-buckets on Hopper: splitter classify, histogram and
// stable in-bucket rank over PE-batched shards.
//
// Replaces the TPU kernel partition_tile (_partition_kernel) in
// src/repro/kernels/partition/partition.py.  On the TPU one grid walks the
// tiles in order and threads the running histogram from tile to tile; here
// blocks run in any order, so
//   partition_classify  gives every element its bucket and, as its caller
//                       asks, a histogram per PTILE tile (rows, tiles, nb+1)
//                       for the rank, a histogram per row (rows, nb), both,
//                       or neither: one launch variant for each caller
//                       (RAMS: buckets + tile histograms, then the rank;
//                       SSort: buckets only; RQuick: the row histogram
//                       only), so no caller pays for an output it drops;
//   (the wrapper turns the tile histograms into per-tile offsets with one
//    torch.cumsum over the tile axis, the counterpart of the host-side
//    chaining in repro/kernels/partition/ops.py)
//   partition_rank      gives each element its stable rank: tile offset of
//                       its bucket plus its rank inside the tile.
//
// An element (int32 key, uint32 tie) and a splitter compare as the u64
// word (key ^ 0x80000000) << 32 | tie: keys are the port's sign-flipped
// words and ties uint32 bits, so the word's order is the reference's
// (unsigned key, unsigned tie) order.  bucket = #splitters <= element
// (< when !inclusive); flat index >= count goes to the trash bucket nb.
// Both grids are one-dimensional, block b taking row b / blocks_per_row
// (a 32-bit division, split()), so the row count is bounded by gridDim.x,
// not by gridDim.y's 65 535 (RQuick runs p = 2^18 rows).
//
// What bounds the classify on the card: bytes.  It reads key and tie (8
// bytes) of each valid element only, writes a bucket (4) per slot where the
// caller wants buckets, and the histograms; the rank reads the bucket and
// writes the position (8).  What the design does about it:
//   * splitters in shared memory, staged once per block: a block walks
//     every blocks_per_row-th tile of its row (strided, so blocks of a row
//     share its valid prefix and its pad tail evenly), not one tile;
//   * each splitter is one packed u64 word, laid out as an implicit search
//     tree (Eytzinger order) padded with +inf words to 2^L - 1 nodes,
//     L = ceil(log2 nb): every element takes exactly L branch-free steps
//     i = 2i + (t[i] <= e) (t[i] < e for the strict pass), one compare
//     each, the elements of a thread walking the tree interleaved.  The
//     rows are locally sorted, so a thread first walks the two ends of
//     each of its groups of 4: a nondecreasing group whose ends land on
//     one node needs no more search (on an H100 this took the
//     histogram-only launch at nb = 256, whose search outweighs its
//     bytes, from 0.30-0.35 to 0.25-0.29 ms at (256, 2^20));
//   * 16-byte accesses: a thread loads keys and ties and stores buckets 4
//     at a time, two groups of 4 per tile, so 8 elements a thread are in
//     flight; a tile wholly past the row's count gets trash-bucket stores
//     only (no key reads, no search) and its tile histogram arithmetically;
//   * histograms without contention: locally sorted rows put a warp's 128
//     elements of a group in one bucket nearly always, so one shared add of
//     128 covers the warp (__all_sync); otherwise lanes of one bucket find
//     each other with __match_any_sync and add once, as kway.cu does.  The
//     row histogram goes to device memory with one atomicAdd per bucket per
//     block; the tile histogram with one store per bucket per tile, and
//     only in the variant that ranks.
// The rank walks its tile with one warp, 32 elements a step, using
// __match_any_sync to find the lanes of the same bucket and __popc for the
// rank among them, with a running count per bucket in shared memory —
// in-order, so the rank is stable.

#include <cuda_runtime.h>
#include <stdint.h>

#define PTILE 1024
#define CLASSIFY_THREADS 128          // 4 warps x 8 elements = one tile
#define GROUP 4                       // elements per 16-byte access
#define TARGET_BLOCKS 4224            // two waves of 16 blocks on 132 SMs
#define RANK_WARPS 4
#define FULL 0xFFFFFFFFu

// the classify variants: which outputs a launch writes
#define HIST_NONE 0
#define HIST_ROW 1                    // (rows, nb), trash not counted
#define HIST_TILE 2                   // (rows, tiles, nb + 1)

// This block's (row, index within the row) for blocks_per_row blocks a row.
__device__ __forceinline__ void split(int64_t blocks_per_row, int64_t& row,
                                      int64_t& index) {
  const unsigned per = (unsigned)blocks_per_row;
  const unsigned r = blockIdx.x / per;
  row = r;
  index = blockIdx.x - r * per;
}

__device__ __forceinline__ uint64_t word(int32_t key, int32_t tie) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)tie;
}

// v[0..3] = p[x..x+3] below lim (0 past it); one 16-byte load when whole.
__device__ __forceinline__ void load4(const int32_t* __restrict__ p,
                                      int64_t x, int64_t lim, bool vec,
                                      int32_t v[GROUP]) {
  if (vec && x + GROUP <= lim) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + x));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) v[j] = x + j < lim ? __ldg(p + x + j) : 0;
  }
}

// p[x..x+3] = v below lim; one 16-byte store when whole.
__device__ __forceinline__ void store4(int32_t* __restrict__ p, int64_t x,
                                       int64_t lim, bool vec,
                                       const int32_t v[GROUP]) {
  if (vec && x + GROUP <= lim) {
    *reinterpret_cast<int4*>(p + x) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (x + j < lim) p[x + j] = v[j];
  }
}

// Walk N elements down the search tree together, L = levels steps each:
// node i goes to 2i + (t[i] <= e) (t[i] < e for the strict pass), and
// after the last step i - 2^L counts the tree's words <= e (< e).
template <bool INCL, int N>
__device__ __forceinline__ void descend(const uint64_t* tree, int levels,
                                        const uint64_t e[N], int i[N]) {
  for (int d = 0; d < levels; ++d) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = tree[i[j]];
      i[j] = 2 * i[j] + (INCL ? s <= e[j] : s < e[j]);
    }
  }
}

__device__ __forceinline__ bool ascending(const uint64_t e[GROUP]) {
  return e[0] <= e[1] && e[1] <= e[2] && e[2] <= e[3];
}

// Add the warp's 4 x 32 buckets of one group (-1: no element) into hist.
__device__ __forceinline__ void warp_count(int32_t* hist, const int b[GROUP],
                                           int lane) {
  const int u = __shfl_sync(FULL, b[0], 0);
  const bool same = b[0] == u && b[1] == u && b[2] == u && b[3] == u;
  if (__all_sync(FULL, same)) {
    if (lane == 0 && u >= 0) atomicAdd(&hist[u], 32 * GROUP);
    return;
  }
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const unsigned peers = __match_any_sync(FULL, b[j]);
    if (b[j] >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[b[j]], __popc(peers));
  }
}

template <bool INCL, bool BUCKETS, int HIST>
__global__ void __launch_bounds__(CLASSIFY_THREADS)
partition_classify_kernel(const int32_t* __restrict__ keys,
                          const int32_t* __restrict__ ties,
                          const int32_t* __restrict__ s_keys,
                          const int32_t* __restrict__ s_ties,
                          const int64_t* __restrict__ count,
                          int32_t* __restrict__ bucket,
                          int32_t* __restrict__ hist, int64_t C, int nb,
                          int levels, int64_t ntiles, int64_t blocks_per_row,
                          int vec) {
  extern __shared__ uint64_t smem[];
  const int T = 1 << levels;                  // tree nodes 1 .. T - 1
  uint64_t* tree = smem;
  int32_t* sh_hist = reinterpret_cast<int32_t*>(smem + T);
  const int S = nb - 1;
  int64_t row, part;
  split(blocks_per_row, row, part);
  const int32_t* rk = keys + row * C;
  const int32_t* rt = ties + row * C;
  int32_t* rb = BUCKETS ? bucket + row * C : nullptr;
  for (int k = threadIdx.x + 1; k < T; k += CLASSIFY_THREADS) {
    const int d = 31 - __clz(k);              // depth of node k
    const int idx = ((2 * (k - (1 << d)) + 1) << (levels - 1 - d)) - 1;
    tree[k] = idx < S ? word(__ldg(s_keys + row * S + idx),
                             __ldg(s_ties + row * S + idx))
                      : ~0ull;                // +inf pads the tree
  }
  if (HIST != HIST_NONE)
    for (int j = threadIdx.x; j <= nb; j += CLASSIFY_THREADS) sh_hist[j] = 0;
  __syncthreads();
  const bool v4 = vec != 0;
  const int64_t cnt = min(count[row], C);
  const int lane = threadIdx.x & 31;
  const int64_t off = (int64_t)(threadIdx.x >> 5) * (64 * GROUP) + GROUP * lane;
  for (int64_t tile = part; tile < ntiles; tile += blocks_per_row) {
    const int64_t beg = tile * PTILE;
    const int64_t end = min(beg + PTILE, C);
    if (beg >= cnt) {                         // wholly past the count
      if (BUCKETS) {
        const int32_t trash[GROUP] = {nb, nb, nb, nb};
        for (int64_t x = beg + GROUP * threadIdx.x; x < end;
             x += GROUP * CLASSIFY_THREADS)
          store4(rb, x, end, v4, trash);
      }
      if (HIST == HIST_TILE) {
        int32_t* out = hist + (row * ntiles + tile) * (nb + 1);
        for (int j = threadIdx.x; j <= nb; j += CLASSIFY_THREADS)
          out[j] = j == nb ? (int32_t)(end - beg) : 0;
      }
      continue;
    }
    const int64_t lim = min(cnt, end);        // keys read below it only
    int32_t k[2][GROUP], t[2][GROUP];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int64_t x = beg + off + g * 32 * GROUP;
      load4(rk, x, lim, v4, k[g]);
      load4(rt, x, lim, v4, t[g]);
    }
    uint64_t e[2][GROUP];
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < GROUP; ++j) e[g][j] = word(k[g][j], t[g][j]);
    // the ends of both groups first; a nondecreasing group whose ends
    // share a node lies in it whole, so only other groups (rare in the
    // locally sorted rows of every caller) search their middle two
    const uint64_t ends[4] = {e[0][0], e[0][3], e[1][0], e[1][3]};
    const uint64_t mids[4] = {e[0][1], e[0][2], e[1][1], e[1][2]};
    int ie[4] = {1, 1, 1, 1}, im[4];
    descend<INCL, 4>(tree, levels, ends, ie);
    if (ascending(e[0]) && ie[0] == ie[1] && ascending(e[1])
        && ie[2] == ie[3]) {
      im[0] = im[1] = ie[0];
      im[2] = im[3] = ie[2];
    } else {
      im[0] = im[1] = im[2] = im[3] = 1;
      descend<INCL, 4>(tree, levels, mids, im);
    }
    const int i[2][GROUP] = {{ie[0], im[0], im[1], ie[1]},
                             {ie[2], im[2], im[3], ie[3]}};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int64_t x = beg + off + g * 32 * GROUP;
      int b[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        b[j] = x + j < cnt ? min(i[g][j] - T, S)   // +inf pads never count
             : x + j < end ? nb : -1;
      if (BUCKETS) store4(rb, x, end, v4, b);
      if (HIST != HIST_NONE) warp_count(sh_hist, b, lane);
    }
    if (HIST == HIST_TILE) {
      __syncthreads();
      int32_t* out = hist + (row * ntiles + tile) * (nb + 1);
      for (int j = threadIdx.x; j <= nb; j += CLASSIFY_THREADS) {
        out[j] = sh_hist[j];
        sh_hist[j] = 0;
      }
      __syncthreads();
    }
  }
  if (HIST == HIST_ROW) {
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += CLASSIFY_THREADS) {
      const int32_t v = sh_hist[j];
      if (v) atomicAdd(hist + row * nb + j, v);
    }
  }
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
    const unsigned act = __ballot_sync(FULL, active);
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

template <bool INCL, bool BUCKETS, int HIST>
static void launch_classify(unsigned blocks, size_t smem, cudaStream_t st,
                            const int32_t* keys, const int32_t* ties,
                            const int32_t* s_keys, const int32_t* s_ties,
                            const int64_t* count, int32_t* bucket,
                            int32_t* hist, int64_t C, int nb, int levels,
                            int64_t ntiles, int64_t bpr, int vec) {
  partition_classify_kernel<INCL, BUCKETS, HIST>
      <<<blocks, CLASSIFY_THREADS, smem, st>>>(keys, ties, s_keys, s_ties,
                                               count, bucket, hist, C, nb,
                                               levels, ntiles, bpr, vec);
}

extern "C" {

// mode 0: buckets + tile histograms (the rank's input); 1: buckets + row
// histogram; 2: buckets only; 3: row histogram only.  hist must be zero
// for the row-histogram modes.
int partition_classify(const int32_t* keys, const int32_t* ties,
                       const int32_t* s_keys, const int32_t* s_ties,
                       const int64_t* count, int32_t* bucket, int32_t* hist,
                       int64_t rows, int64_t C, int nb, int inclusive,
                       int mode, void* stream) {
  if (rows == 0 || C == 0) return 0;
  if (nb < 1 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = (C + PTILE - 1) / PTILE;
  int64_t bpr = (TARGET_BLOCKS + rows - 1) / rows;
  bpr = bpr < ntiles ? bpr : ntiles;
  if (bpr * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((1 << levels) < nb) ++levels;        // ceil(log2 nb)
  const size_t smem = ((size_t)1 << levels) * sizeof(uint64_t)
                      + (size_t)(nb + 1) * sizeof(int32_t);
  const int vec = C % GROUP == 0 && ((uintptr_t)keys | (uintptr_t)ties
                                     | (uintptr_t)bucket) % 16 == 0;
  const unsigned blocks = (unsigned)(bpr * rows);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(I, B, H)                                                      \
  launch_classify<I, B, H>(blocks, smem, st, keys, ties, s_keys, s_ties,   \
                           count, bucket, hist, C, nb, levels, ntiles, bpr, \
                           vec)
#define MODES(I)                                                             \
  switch (mode) {                                                            \
    case 0: LAUNCH(I, true, HIST_TILE); break;                               \
    case 1: LAUNCH(I, true, HIST_ROW); break;                                \
    case 2: LAUNCH(I, true, HIST_NONE); break;                               \
    default: LAUNCH(I, false, HIST_ROW); break;                              \
  }
  if (inclusive) { MODES(true) } else { MODES(false) }
#undef MODES
#undef LAUNCH
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
