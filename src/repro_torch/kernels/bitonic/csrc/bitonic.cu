// Stable local sort of PE-batched shards on Hopper: a tile sort and a run
// merge, the two halves of local_sort_fast (kernels/bitonic/ops.py).
//
// Replaces the TPU kernels in src/repro/kernels/bitonic/bitonic.py:
//   tile_sort  <- sort_tile   (_sort_kernel / _sort_network)
//   run_merge  <- merge_tiles (_merge_kernel / _merge_network)
//
// Keys are the port's sign-flipped int32 words (signed order == the
// reference's unsigned order); the optional payload is one int32 plane.
// Rows are PEs: arrays are (rows, C), row-major, contiguous.
//
// What bounds them on the card: the sort moves 16 bytes per element (key and
// payload in and out) per pass, so device-memory bandwidth is the floor; the
// tile sort adds log2(T)(log2(T)+1)/2 shared-memory compare-exchange steps
// per element, and each merge pass a binary search per element.  Design:
// the tile sort keeps its whole tile in shared memory as 64-bit words
// (key ^ 0x80000000) << 32 | in-tile index, so the network touches device
// memory once per element and the unique words make any network stable;
// the payload is gathered once at the end through the index.  A merge pass
// reads each key and payload once and writes them once; the partner-run
// searches of neighbouring threads hit neighbouring addresses, so they are
// served mostly from L1/L2.  Simple first: the merge does not use merge-path
// partitioning or shared-memory staging yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 4096
#define SORT_THREADS 512
#define MERGE_THREADS 256

__device__ __forceinline__ uint64_t pack(int32_t key, uint32_t idx) {
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | idx;
}

__global__ void __launch_bounds__(SORT_THREADS)
tile_sort_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 int32_t* __restrict__ out_keys,
                 int32_t* __restrict__ out_vals, int64_t C) {
  __shared__ uint64_t s[TILE];
  const int64_t row_off = (int64_t)blockIdx.y * C;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int n = (int)min((int64_t)TILE, C - base);
  const int32_t* k = keys + row_off + base;
  // ragged last tile: the all-ones word sorts after every real word
  for (int i = threadIdx.x; i < TILE; i += SORT_THREADS)
    s[i] = i < n ? pack(__ldg(k + i), (uint32_t)i) : ~0ull;
  __syncthreads();
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < TILE / 2; t += SORT_THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const uint64_t a = s[lo], b = s[hi];
        if ((a > b) == asc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  int32_t* ok = out_keys + row_off + base;
  for (int i = threadIdx.x; i < n; i += SORT_THREADS) {
    const uint64_t w = s[i];
    ok[i] = (int32_t)((uint32_t)(w >> 32) ^ 0x80000000u);
    if (vals != nullptr)
      out_vals[row_off + base + i] =
          __ldg(vals + row_off + base + (uint32_t)(w & 0xFFFFFFFFu));
  }
}

// Merge adjacent sorted runs [2m·w, (2m+1)·w) and [(2m+1)·w, (2m+2)·w) of
// every row into one run of 2w (clipped at C).  a[i] lands at i + #{b < a[i]}
// and b[j] at j + #{a <= b[j]}: a's ties first, so the merge is stable.
__global__ void __launch_bounds__(MERGE_THREADS)
run_merge_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 int32_t* __restrict__ out_keys,
                 int32_t* __restrict__ out_vals, int64_t C, int64_t w) {
  const int64_t x = (int64_t)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (x >= C) return;
  const int64_t row_off = (int64_t)blockIdx.y * C;
  const int32_t* k = keys + row_off;
  const int64_t run = x / w;
  const int64_t a_beg = (run >> 1) * 2 * w;
  const int64_t a_end = min(a_beg + w, C);
  const int64_t b_end = min(a_beg + 2 * w, C);
  const int32_t key = __ldg(k + x);
  int64_t pos;
  if ((run & 1) == 0) {
    int64_t lo = a_end, hi = b_end;          // lower bound in b
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(k + mid) < key) lo = mid + 1; else hi = mid;
    }
    pos = x + (lo - a_end);
  } else {
    int64_t lo = a_beg, hi = a_end;          // upper bound in a
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(k + mid) <= key) lo = mid + 1; else hi = mid;
    }
    pos = a_beg + (x - a_end) + (lo - a_beg);
  }
  out_keys[row_off + pos] = key;
  if (vals != nullptr) out_vals[row_off + pos] = __ldg(vals + row_off + x);
}

extern "C" {

int tile_sort(const int32_t* keys, const int32_t* vals, int32_t* out_keys,
              int32_t* out_vals, int64_t rows, int64_t C, void* stream) {
  if (rows == 0 || C == 0) return 0;
  dim3 grid((unsigned)((C + TILE - 1) / TILE), (unsigned)rows);
  tile_sort_kernel<<<grid, SORT_THREADS, 0, (cudaStream_t)stream>>>(
      keys, vals, out_keys, out_vals, C);
  return (int)cudaGetLastError();
}

int run_merge(const int32_t* keys, const int32_t* vals, int32_t* out_keys,
              int32_t* out_vals, int64_t rows, int64_t C, int64_t width,
              void* stream) {
  if (rows == 0 || C == 0) return 0;
  dim3 grid((unsigned)((C + MERGE_THREADS - 1) / MERGE_THREADS),
            (unsigned)rows);
  run_merge_kernel<<<grid, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      keys, vals, out_keys, out_vals, C, width);
  return (int)cudaGetLastError();
}

int tile_size() { return TILE; }

}  // extern "C"
