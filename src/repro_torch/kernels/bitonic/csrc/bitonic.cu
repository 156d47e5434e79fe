// Stable local sort of PE-batched shards on Hopper: a tile sort and a run
// merge, the two halves of local_sort_fast (kernels/bitonic/ops.py).
//
// Replaces the TPU kernels in src/repro/kernels/bitonic/bitonic.py:
//   tile_sort  <- sort_tile   (_sort_kernel / _sort_network)
//   run_merge  <- merge_tiles (_merge_kernel / _merge_network)
//
// Keys are the port's sign-flipped int32 words (signed order == the
// reference's unsigned order); the optional payload is one int32 plane.
// Rows are PEs: arrays are (rows, C), row-major, contiguous.  Both grids
// are one-dimensional, block b taking row b / blocks_per_row, so the row
// count is bounded by gridDim.x (2^31 - 1 blocks), not by gridDim.y's 65 535
// (RQuick runs p = 2^18 rows); the division is 32-bit (split()), since a
// 64-bit one costs each thread more than a partition tile's compares.  An
// optional
// (rows,) int64 count limits the sort to each row's prefix [0, count[r]);
// the rest of the row passes through unchanged.  Ties keep their input
// order.
//
// What bounds them on the card: device-memory bytes.  Every pass reads and
// writes each key and payload word once, 16 bytes per element, so the sort
// of C keys costs 16 * C * (1 + merge passes) bytes at best; the compares
// are a few per byte moved.  What the design does about it:
//
// * tile_sort is a block merge sort of TILE = 8192 keys, 512 threads x 16
//   items.  Keys and payload are read once, coalesced, into shared memory.
//   Each thread sorts its 16 items in registers as 64-bit (key, in-tile
//   index) words through a 60-comparator network (distinct words, so the
//   order is stable), then 9
//   rounds of merge-path merges in shared memory double the runs from 16 to
//   8192: each thread finds its diagonal by binary search and merges 16
//   outputs serially, left ties first.  Only the in-tile index travels with
//   a key; the payload is gathered from shared memory once at the end, and
//   everything leaves through shared memory as coalesced stores.  A larger
//   tile leaves fewer merge passes over device memory.
// * run_merge is a merge-path merge: each block of 256 threads x 16 items
//   makes 4096 contiguous outputs of one run pair.  Two warps find the
//   co-ranks of the block's two end diagonals in device memory, each by a
//   32-way search (about 5 dependent loads instead of 21); the block stages
//   the two input slices (keys and payload) in shared memory with coalesced
//   loads, each thread searches its own diagonal there and merges 16 items,
//   and the outputs leave through shared memory as coalesced stores.  Each
//   element is read once and written once per pass.
// * Only the valid prefix is sorted.  Positions at or past count[r] are
//   copied once, by the tile-sort launch, into the buffer the last merge
//   pass ends in; merge blocks wholly past the count exit at once.
//
// Shared memory is indexed with one pad word every 32 (pad()), so a
// thread's 16 consecutive words (blocked order) fall into distinct banks
// across a warp.  The merge-path device functions (merge_path,
// serial_merge) are shared by both kernels.
//
// Occupancy, from ptxas -v for sm_90a: tile_sort uses 64 registers (the
// launch bound's cap for 2 blocks of 512), no spills, and 100 864 bytes of
// dynamic shared memory with a payload, so 2 blocks run per SM; run_merge
// uses 60 registers, no spills, and 34 320 bytes of static shared memory,
// so registers allow 4 blocks of 256 per SM.  Either way 1024 of the SM's
// 2048 threads.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 8192                                  // keys per tile sort
#define SORT_THREADS 512
#define SORT_ITEMS (TILE / SORT_THREADS)           // 16
static_assert(SORT_ITEMS == 16, "the register sort is sort16");
#define MERGE_THREADS 256
#define MERGE_ITEMS 16
#define MERGE_SPAN (MERGE_THREADS * MERGE_ITEMS)   // outputs per merge block
// words of a padded shared array of n entries, with room for the serial
// merge's reads past the end of its runs
#define PADDED(n) ((n) + ((n) >> 5) + 64)

__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

// This block's (row, index within the row) for blocks_per_row blocks a row.
__device__ __forceinline__ void split(int64_t blocks_per_row, int64_t& row,
                                      int64_t& index) {
  const unsigned per = (unsigned)blocks_per_row;
  const unsigned r = blockIdx.x / per;
  row = r;
  index = blockIdx.x - r * per;
}

// (key, in-tile index) as one unsigned word whose order is the stable
// order of the keys: the sign-flipped key above, the index below.
__device__ __forceinline__ uint64_t order_word(int32_t key, int index) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)index;
}

__device__ __forceinline__ void cmp_swap(uint64_t& a, uint64_t& b) {
  const bool s = b < a;
  const uint64_t lo = s ? b : a;
  b = s ? a : b;
  a = lo;
}

// Sorts 16 words ascending: a 60-comparator network in 10 layers, one line
// per layer (tests/test_torch_local_sort.py runs it on every 0-1 input).
// The words are distinct (key, index) pairs, so the result is the stable
// order of the keys.
__device__ __forceinline__ void sort16(uint64_t (&u)[16]) {
#define CS(a, b) cmp_swap(u[a], u[b])
  CS(0, 13); CS(1, 12); CS(2, 15); CS(3, 14); CS(4, 8); CS(5, 6); CS(7, 11);
  CS(9, 10);
  CS(0, 5); CS(1, 7); CS(2, 9); CS(3, 4); CS(6, 13); CS(8, 14); CS(10, 15);
  CS(11, 12);
  CS(0, 1); CS(2, 3); CS(4, 5); CS(6, 8); CS(7, 9); CS(10, 11); CS(12, 13);
  CS(14, 15);
  CS(0, 2); CS(1, 3); CS(4, 10); CS(5, 11); CS(6, 7); CS(8, 9); CS(12, 14);
  CS(13, 15);
  CS(1, 2); CS(3, 12); CS(4, 6); CS(5, 7); CS(8, 10); CS(9, 11); CS(13, 14);
  CS(1, 4); CS(2, 6); CS(5, 8); CS(7, 10); CS(9, 13); CS(11, 14);
  CS(2, 4); CS(3, 6); CS(9, 12); CS(11, 13);
  CS(3, 5); CS(6, 8); CS(7, 9); CS(10, 12);
  CS(3, 4); CS(5, 6); CS(7, 8); CS(9, 10); CS(11, 12);
  CS(6, 7); CS(8, 9);
#undef CS
}

// Merge path in shared memory: runs a = s[a0, a0 + la) and b = s[b0, b0 +
// lb), each sorted.  Returns how many of a's keys are among the first diag
// outputs of their merge with a's ties first (a[i] goes before b[j] iff
// a[i] <= b[j]).
__device__ __forceinline__ int merge_path(const int32_t* s, int a0, int la,
                                          int b0, int lb, int diag) {
  int lo = max(0, diag - lb), hi = min(diag, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[pad(a0 + mid)] <= s[pad(b0 + diag - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ITEMS outputs of the merge of s[ai, a_end) and s[bi, b_end), a's ties
// first: key[j] is each output's key and src[j] its shared-memory position,
// through which the caller gathers what travels with the key.  Reads may go
// up to ITEMS words past either end (the arrays are PADDED).
template <int ITEMS>
__device__ __forceinline__ void serial_merge(const int32_t* s, int ai,
                                             int a_end, int bi, int b_end,
                                             int32_t (&key)[ITEMS],
                                             int (&src)[ITEMS]) {
  int32_t ka = s[pad(ai)], kb = s[pad(bi)];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool take_b = bi < b_end && (ai >= a_end || kb < ka);
    key[j] = take_b ? kb : ka;
    src[j] = take_b ? bi : ai;
    if (take_b) kb = s[pad(++bi)];
    else ka = s[pad(++ai)];
  }
}

// The co-rank of diagonal d for runs a[0, la) and b[0, lb) in device memory
// (how many of a's keys are among the first d merged outputs), found by one
// whole warp: each step tests 32 points of the open interval at once and
// keeps the gap where the test turns false, 33 times narrower.
__device__ int64_t corank_warp(const int32_t* __restrict__ a, int64_t la,
                               const int32_t* __restrict__ b, int64_t lb,
                               int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d - lb > 0 ? d - lb : 0;
  int64_t hi = d < la ? d : la;                    // the co-rank is in [lo, hi]
  while (hi > lo) {
    const int64_t len = hi - lo;
    const bool small = len <= 32;
    const int64_t m = small ? lo + lane : lo + len * (lane + 1) / 33;
    // a[m] is among the first d outputs: true below the co-rank, false from it
    const bool below = m < hi && __ldg(a + m) <= __ldg(b + (d - 1 - m));
    const int t = __popc(__ballot_sync(0xffffffffu, below));
    if (small) return lo + t;
    const int64_t hi_next = t == 32 ? hi : lo + len * (t + 1) / 33;
    if (t > 0) lo = lo + len * t / 33 + 1;
    hi = hi_next;
  }
  return lo;
}

// Tile sort: block b = y * tiles + x sorts keys [x * TILE, (x + 1) * TILE)
// of row y, clipped at count[y], into out; the part of the tile at or past
// count[y] goes unchanged into tail (which may be out).
__global__ void __launch_bounds__(SORT_THREADS, 2)
tile_sort_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 int32_t* __restrict__ out_keys,
                 int32_t* __restrict__ out_vals,
                 int32_t* __restrict__ tail_keys,
                 int32_t* __restrict__ tail_vals,
                 const int64_t* __restrict__ count, int64_t C,
                 int64_t tiles) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;                     // keys (padded)
  int32_t* si = sk + PADDED(TILE);        // in-tile index, then payload out
  int32_t* sv = si + PADDED(TILE);        // payload in (unpadded)
  const int tid = threadIdx.x;
  int64_t row, tile;
  split(tiles, row, tile);
  const int64_t first = tile * TILE;
  const int64_t off = row * C + first;
  const int64_t left = C - first;
  const int64_t valid = (count == nullptr ? C : count[row]) - first;
  const int m = (int)(left < TILE ? left : TILE);       // words in the tile
  const int n = (int)(valid <= 0 ? 0 : valid < m ? valid : m);  // to sort
  for (int i = n + tid; i < m; i += SORT_THREADS) {
    tail_keys[off + i] = keys[off + i];
    if (vals != nullptr) tail_vals[off + i] = vals[off + i];
  }
  if (n == 0) return;
  // past n the largest key: the stable sort keeps it behind every real key
  // equal to it, so the first n outputs are the sorted valid keys
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int i = j * SORT_THREADS + tid;
    sk[pad(i)] = i < n ? __ldg(keys + off + i) : INT32_MAX;
    if (vals != nullptr && i < n) sv[i] = __ldg(vals + off + i);
  }
  __syncthreads();
  const int x0 = tid * SORT_ITEMS;
  int32_t k[SORT_ITEMS];
  int ix[SORT_ITEMS];
  {
    uint64_t u[SORT_ITEMS];
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j)
      u[j] = order_word(sk[pad(x0 + j)], x0 + j);
    sort16(u);
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j) {
      k[j] = (int32_t)((uint32_t)(u[j] >> 32) ^ 0x80000000u);
      ix[j] = (int)(uint32_t)u[j];
    }
  }
  for (int L = SORT_ITEMS; L < TILE; L <<= 1) {   // runs of L -> runs of 2L
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j) {
      sk[pad(x0 + j)] = k[j];
      si[pad(x0 + j)] = ix[j];
    }
    __syncthreads();
    const int p0 = x0 & ~(2 * L - 1);
    const int d = x0 - p0;
    const int i = merge_path(sk, p0, L, p0 + L, L, d);
    int src[SORT_ITEMS];
    serial_merge<SORT_ITEMS>(sk, p0 + i, p0 + L, p0 + L + d - i, p0 + 2 * L,
                             k, src);
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j) ix[j] = si[pad(src[j])];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    sk[pad(x0 + j)] = k[j];
    si[pad(x0 + j)] = vals != nullptr ? sv[ix[j]] : 0;
  }
  __syncthreads();
  for (int i = tid; i < n; i += SORT_THREADS) {
    out_keys[off + i] = sk[pad(i)];
    if (vals != nullptr) out_vals[off + i] = si[pad(i)];
  }
}

// Run merge: the runs [2m·w, (2m+1)·w) and [(2m+1)·w, (2m+2)·w) of every
// row, clipped at count, merge into one run of 2w, a's ties first.  Block
// b = y * span_blocks + x writes outputs [x, x + 1) * MERGE_SPAN of row y
// (2w is a multiple of MERGE_SPAN, so they belong to one pair); an unpaired
// run is copied.
__global__ void __launch_bounds__(MERGE_THREADS)
run_merge_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 int32_t* __restrict__ out_keys,
                 int32_t* __restrict__ out_vals,
                 const int64_t* __restrict__ count, int64_t C, int64_t w,
                 int64_t span_blocks) {
  __shared__ int32_t sk[PADDED(MERGE_SPAN)];
  __shared__ int32_t sv[PADDED(MERGE_SPAN)];
  __shared__ int64_t cut[2];
  const int tid = threadIdx.x;
  int64_t y, span;
  split(span_blocks, y, span);
  const int64_t row = y * C;
  const int64_t cnt = count == nullptr ? C : count[y];
  const int64_t o0 = span * MERGE_SPAN;
  if (o0 >= cnt) return;
  const int n = (int)(cnt - o0 < MERGE_SPAN ? cnt - o0 : MERGE_SPAN);
  const int64_t p0 = o0 - o0 % (2 * w);                 // the pair's start
  const int64_t la = cnt - p0 < w ? cnt - p0 : w;
  const int64_t lb = cnt - p0 - la < w ? cnt - p0 - la : w;
  if (lb == 0) {                                         // unpaired run
    for (int x = tid; x < n; x += MERGE_THREADS) {
      out_keys[row + o0 + x] = __ldg(keys + row + o0 + x);
      if (vals != nullptr) out_vals[row + o0 + x] = __ldg(vals + row + o0 + x);
    }
    return;
  }
  const int32_t* a = keys + row + p0;
  const int64_t d0 = o0 - p0;
  if (tid < 64) {
    const int64_t i = corank_warp(a, la, a + la, lb, tid < 32 ? d0 : d0 + n);
    if ((tid & 31) == 0) cut[tid >> 5] = i;
  }
  __syncthreads();
  const int64_t i0 = cut[0];
  const int na = (int)(cut[1] - i0);                    // a[i0, i0 + na)
  const int64_t j0 = la + d0 - i0;                       // b from a + j0
  // stage a's slice, then b's, at [0, na) and [na, n): all loads first
  int32_t rk[MERGE_ITEMS], rv[MERGE_ITEMS];
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    const int x = j * MERGE_THREADS + tid;
    const int64_t at = x < na ? i0 + x : j0 + (x - na);
    if (x < n) {
      rk[j] = __ldg(a + at);
      if (vals != nullptr) rv[j] = __ldg(vals + row + p0 + at);
    }
  }
#pragma unroll
  for (int j = 0; j < MERGE_ITEMS; ++j) {
    const int x = j * MERGE_THREADS + tid;
    if (x < n) {
      sk[pad(x)] = rk[j];
      if (vals != nullptr) sv[pad(x)] = rv[j];
    }
  }
  __syncthreads();
  const int x0 = tid * MERGE_ITEMS;
  int32_t k[MERGE_ITEMS];
  int src[MERGE_ITEMS];
  if (x0 < n) {
    const int i = merge_path(sk, 0, na, na, n - na, x0);
    serial_merge<MERGE_ITEMS>(sk, i, na, na + x0 - i, n, k, src);
    if (vals != nullptr) {
#pragma unroll
      for (int j = 0; j < MERGE_ITEMS; ++j) rv[j] = sv[pad(src[j])];
    }
  }
  __syncthreads();
  if (x0 < n) {
#pragma unroll
    for (int j = 0; j < MERGE_ITEMS; ++j) {
      if (x0 + j < n) {
        sk[pad(x0 + j)] = k[j];
        if (vals != nullptr) sv[pad(x0 + j)] = rv[j];
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < n; x += MERGE_THREADS) {
    out_keys[row + o0 + x] = sk[pad(x)];
    if (vals != nullptr) out_vals[row + o0 + x] = sv[pad(x)];
  }
}

extern "C" {

// tail_keys/tail_vals receive each row's [count, C); count may be null
// (every row full).
int tile_sort(const int32_t* keys, const int32_t* vals, int32_t* out_keys,
              int32_t* out_vals, int32_t* tail_keys, int32_t* tail_vals,
              const int64_t* count, int64_t rows, int64_t C, void* stream) {
  if (rows == 0 || C == 0) return 0;
  const int smem =
      (2 * PADDED(TILE) + (vals != nullptr ? TILE : 0)) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (C + TILE - 1) / TILE;
  if (tiles * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  tile_sort_kernel<<<(unsigned)(tiles * rows), SORT_THREADS, smem,
                     (cudaStream_t)stream>>>(keys, vals, out_keys, out_vals,
                                             tail_keys, tail_vals, count, C,
                                             tiles);
  return (int)cudaGetLastError();
}

// Merges within [0, count[r]) of every row and writes nothing past it;
// cmax = max(count) (C when count is null) sizes the grid.  width must be a
// multiple of MERGE_SPAN / 2.
int run_merge(const int32_t* keys, const int32_t* vals, int32_t* out_keys,
              int32_t* out_vals, const int64_t* count, int64_t rows,
              int64_t C, int64_t cmax, int64_t width, void* stream) {
  if (rows == 0 || cmax == 0) return 0;
  if (width <= 0 || (2 * width) % MERGE_SPAN != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t span_blocks = (cmax + MERGE_SPAN - 1) / MERGE_SPAN;
  if (span_blocks * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  run_merge_kernel<<<(unsigned)(span_blocks * rows), MERGE_THREADS, 0,
                     (cudaStream_t)stream>>>(keys, vals, out_keys, out_vals,
                                             count, C, width, span_blocks);
  return (int)cudaGetLastError();
}

int tile_size() { return TILE; }

}  // extern "C"
