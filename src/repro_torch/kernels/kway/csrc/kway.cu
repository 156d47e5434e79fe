// K-way splitter classifier on Hopper: bucket id of every (key, tie) pair
// and the histogram of the buckets, in one launch.
//
// Replaces the TPU kernel kway_classify (_kway_kernel / _classify_block) in
// src/repro/kernels/kway/kway.py.  On the TPU the grid walks 64x128 blocks in
// order, compares every element with every splitter (a broadcast compare on
// the VPU) and adds each block's one-hot histogram into one output; the
// wrapper pads C up to a block multiple and subtracts the pads afterwards.
// Here blocks run in any order and the ragged edge is masked, so the
// histogram is exact with no correction.
//
// bucket[i] = #splitters j with (s_key[j], s_tie[j]) <= (key[i], tie[i]),
// compared as the u64 word (key ^ 0x80000000) << 32 | tie: keys are the
// port's sign-flipped int32 words and ties uint32 bits, so the word's order
// is the reference's (unsigned key, unsigned tie) order.  The splitters need
// not be sorted (the count does not depend on their order) and may number
// anything; hist[b] counts the elements with bucket b < nb.
//
// What bounds it on the card: bytes.  It reads key and tie (8 bytes) and
// writes a bucket (4) per element; a search needs ceil(log2(S + 1))
// compares, far below the bytes at every splitter count of the external
// lane (pass C: nb = p, pass D: nb = ceil(total / budget)).  What the design
// does about it:
//   * the splitters are packed into u64 words and sorted inside the launch:
//     each block stages them in shared memory, pads them with +inf words to
//     a power of two T and, unless they are in order already (the lane's
//     always are: one pass and one barrier tell), sorts them with a bitonic
//     network (S = 7: six barrier steps; S = 2047: 66, 32 KB of
//     shared-memory traffic a step in every block: 0.218 ms against 0.165
//     at C = 2^25 on an H100).  Every element then takes log2 T
//     branch-free steps of a uniform binary search, pos += s when
//     a[pos + s - 1] <= e, one compare each, and min(pos, S) discards the
//     padding (a real splitter may equal the +inf word).  A linear count
//     made C * S compares: at nb = 2048 it ran 3.9x slower than a library
//     search;
//   * more than TREE_MAX - 1 splitters are taken in chunks of that many:
//     each chunk is sorted and searched in turn and the buckets summed in
//     place (the block rereads the buckets it wrote), so any S works; the
//     lane never needs it;
//   * 16-byte accesses: a thread loads keys and ties and stores buckets 4 at
//     a time, two groups of 4 per tile, so 8 elements a thread are in
//     flight.  Views at an offset that breaks 16-byte alignment take
//     4-byte accesses;
//   * searches only where the bucket can change: the lane's inputs are
//     sorted runs, so a nondecreasing run of elements whose ends share a
//     bucket lies in it whole.  A warp whose two groups of 128 are
//     nondecreasing searches their 4 ends (one search per lane, 4 lanes);
//     otherwise each thread searches the ends of its groups of 4, and the
//     middles only where those differ;
//   * each block walks one contiguous range of tiles, so a block of a
//     sorted run sees few buckets; the histogram counts the runs of equal
//     buckets in a thread's 8 elements (nondecreasing for sorted runs) and
//     adds each run once to a shared-memory histogram, or 256 at once when
//     a whole warp's elements share a bucket (no per-element
//     __match_any_sync);
//   * no memset: the blocks add their histograms into an accumulator that
//     is zero between launches (one per stream, kept by the wrapper), and
//     the last block to finish (a ticket in the accumulator) moves it into
//     hist and zeroes it again, so a call is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define GROUP 4                          // elements per 16-byte access
#define GROUPS 2                         // groups of GROUP per thread a tile
#define TILE (THREADS * GROUP * GROUPS)  // 2048 elements
#define TREE_MAX 4096                    // splitter words sorted in a block
#define HIST_MAX 2048                    // buckets counted in shared memory
#define BLOCKS_PER_SM 4
#define FULL 0xFFFFFFFFu

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

// load4 of a buffer this launch writes (no read-only cache).
__device__ __forceinline__ void reload4(const int32_t* p, int64_t x,
                                        int64_t lim, bool vec,
                                        int32_t v[GROUP]) {
  if (vec && x + GROUP <= lim) {
    const int4 q = *reinterpret_cast<const int4*>(p + x);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) v[j] = x + j < lim ? p[x + j] : 0;
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

// Ascending bitonic sort of a[0..T), T a power of two; ends on a barrier.
__device__ void block_sort(uint64_t* a, int T) {
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (T >> 1); q += THREADS) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));   // bit j clear
        const uint64_t x = a[i], y = a[i | j];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[i | j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// N elements searched together in the sorted a[0..T): pos[j] becomes the
// number of words of a <= e[j] (at most T - 1).
template <int N>
__device__ __forceinline__ void search(const uint64_t* a, int T,
                                       const uint64_t e[N], int pos[N]) {
  for (int s = T >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) pos[j] += a[pos[j] + s - 1] <= e[j] ? s : 0;
  }
}

__device__ __forceinline__ bool ascending(const uint64_t e[GROUP]) {
  return e[0] <= e[1] && e[1] <= e[2] && e[2] <= e[3];
}

// Add a thread's 8 buckets (in element order; -1: not counted) into h: the
// whole warp at once when its 256 share one bucket, else each run of equal
// buckets once.
__device__ __forceinline__ void count_runs(int32_t* h,
                                           const int b[GROUPS * GROUP],
                                           int lane) {
  const int u = __shfl_sync(FULL, b[0], 0);
  bool same = true;
#pragma unroll
  for (int j = 0; j < GROUPS * GROUP; ++j) same &= b[j] == u;
  if (__all_sync(FULL, same)) {
    if (lane == 0 && u >= 0) atomicAdd(&h[u], 32 * GROUPS * GROUP);
    return;
  }
  int run = b[0], n = 1;
#pragma unroll
  for (int j = 1; j < GROUPS * GROUP; ++j) {
    if (b[j] == run) {
      ++n;
    } else {
      if (run >= 0) atomicAdd(&h[run], n);
      run = b[j];
      n = 1;
    }
  }
  if (run >= 0) atomicAdd(&h[run], n);
}

// acc[0] is the ticket, acc[1 .. nb] the bins; zero on entry and on exit.
__global__ void __launch_bounds__(THREADS)
kway_classify_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ ties,
                     const int32_t* __restrict__ s_keys,
                     const int32_t* __restrict__ s_ties,
                     int32_t* bucket, int32_t* __restrict__ hist,
                     int32_t* __restrict__ acc, int64_t C, int64_t S, int nb,
                     int T, int64_t chunk, int vec, int smem_hist) {
  extern __shared__ uint64_t smem[];
  __shared__ bool last_block;
  uint64_t* spl = smem;                                // T sorted words
  int32_t* h = smem_hist ? reinterpret_cast<int32_t*>(smem + T) : acc + 1;
  const int lane = threadIdx.x & 31;
  const bool v4 = vec != 0;
  const int64_t tiles = (C + TILE - 1) / TILE;
  const int64_t per = (tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * per;
  const int64_t t1 = min(tiles, t0 + per);
  const int64_t nchunks = S > 0 ? (S + chunk - 1) / chunk : 1;
  if (smem_hist)
    for (int j = threadIdx.x; j < nb; j += THREADS) h[j] = 0;

  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * chunk;
    const int len = (int)min(chunk, S - lo);          // 0 when S == 0
    __syncthreads();                                  // the last chunk's reads
    for (int j = threadIdx.x; j < T; j += THREADS)
      spl[j] = j < len ? word(__ldg(s_keys + lo + j), __ldg(s_ties + lo + j))
                       : ~0ull;                       // +inf pads
    __syncthreads();
    bool ordered = true;                              // the lane's are
    for (int j = threadIdx.x; j + 1 < T; j += THREADS)
      ordered &= spl[j] <= spl[j + 1];
    if (!__syncthreads_and(ordered)) block_sort(spl, T);
    const bool first = c == 0, last = c == nchunks - 1;
    for (int64_t tile = t0; tile < t1; ++tile) {
      const int64_t beg = tile * TILE + GROUP * threadIdx.x;
      uint64_t e[GROUPS][GROUP];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        int32_t k[GROUP], t[GROUP];
        const int64_t x = beg + g * (THREADS * GROUP);
        load4(keys, x, C, v4, k);
        load4(ties, x, C, v4, t);
#pragma unroll
        for (int j = 0; j < GROUP; ++j) e[g][j] = word(k[j], t[j]);
      }
      // A warp's group g is 128 consecutive elements.  Where both are
      // nondecreasing (the lane's inputs are sorted runs), lanes 0-3
      // search their four ends, one each: a group whose ends share a
      // position lies in it whole.  Otherwise each thread searches the two
      // ends of its groups of 4, then, where those differ or a group
      // descends, the middle two.
      bool asc = true;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const uint64_t prev = __shfl_up_sync(FULL, e[g][GROUP - 1], 1);
        asc &= ascending(e[g]) && (lane == 0 || prev <= e[g][0]);
      }
      int pe[4], pm[4];
      bool whole = false;
      if (__all_sync(FULL, asc)) {
        const uint64_t f0 = __shfl_sync(FULL, e[0][0], 0);
        const uint64_t l0 = __shfl_sync(FULL, e[0][GROUP - 1], 31);
        const uint64_t f1 = __shfl_sync(FULL, e[1][0], 0);
        const uint64_t l1 = __shfl_sync(FULL, e[1][GROUP - 1], 31);
        const int q = lane & 3;
        const uint64_t v[1] = {q == 0 ? f0 : q == 1 ? l0 : q == 2 ? f1 : l1};
        int w[1] = {0};
        search<1>(spl, T, v, w);
#pragma unroll
        for (int j = 0; j < 4; ++j) pe[j] = __shfl_sync(FULL, w[0], j);
        whole = pe[0] == pe[1] && pe[2] == pe[3];        // warp-uniform
        pm[0] = pm[1] = pe[0];
        pm[2] = pm[3] = pe[2];
      }
      if (!whole) {
        const uint64_t ends[4] = {e[0][0], e[0][3], e[1][0], e[1][3]};
        const uint64_t mids[4] = {e[0][1], e[0][2], e[1][1], e[1][2]};
        pe[0] = pe[1] = pe[2] = pe[3] = 0;
        search<4>(spl, T, ends, pe);
        if (ascending(e[0]) && pe[0] == pe[1] && ascending(e[1])
            && pe[2] == pe[3]) {
          pm[0] = pm[1] = pe[0];
          pm[2] = pm[3] = pe[2];
        } else {
          pm[0] = pm[1] = pm[2] = pm[3] = 0;
          search<4>(spl, T, mids, pm);
        }
      }
      const int pos[GROUPS][GROUP] = {{pe[0], pm[0], pm[1], pe[1]},
                                      {pe[2], pm[2], pm[3], pe[3]}};
      int hb[GROUPS * GROUP];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int64_t x = beg + g * (THREADS * GROUP);
        int32_t b[GROUP];
        if (!first) reload4(bucket, x, C, v4, b);
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          b[j] = (first ? 0 : b[j]) + min(pos[g][j], len);
          hb[g * GROUP + j] = x + j < C && b[j] < nb ? b[j] : -1;
        }
        store4(bucket, x, C, v4, b);
      }
      if (last) count_runs(h, hb, lane);
    }
  }

  // this block's histogram into the accumulator; the last block moves the
  // accumulator into hist and leaves it zero for the next launch
  __syncthreads();
  if (smem_hist)
    for (int j = threadIdx.x; j < nb; j += THREADS)
      if (h[j]) atomicAdd(acc + 1 + j, h[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(reinterpret_cast<unsigned*>(acc), 1u)
                 == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    for (int j = threadIdx.x; j < nb; j += THREADS)
      hist[j] = atomicExch(acc + 1 + j, 0);
    if (threadIdx.x == 0) atomicExch(acc, 0);
  }
}

extern "C" {

// acc: (>= nb + 1,) int32, zero (the wrapper's accumulator of this stream).
int kway_classify(const int32_t* keys, const int32_t* ties,
                  const int32_t* s_keys, const int32_t* s_ties,
                  int32_t* bucket, int32_t* hist, int32_t* acc, int64_t C,
                  int64_t S, int nb, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  if (nb < 1 || C < 0 || S < 0) return (int)cudaErrorInvalidValue;
  const int64_t chunk = S < 1 ? 1 : (S < TREE_MAX ? S : TREE_MAX - 1);
  int T = 2;
  while (T < chunk + 1) T <<= 1;                     // pow2 >= chunk + 1
  const int64_t tiles = (C + TILE - 1) / TILE;
  int64_t blocks = (int64_t)sms * BLOCKS_PER_SM;
  if (tiles < blocks) blocks = tiles;
  if (blocks < 1) blocks = 1;
  const int smem_hist = nb <= HIST_MAX;
  const size_t smem = (size_t)T * sizeof(uint64_t)
                      + (smem_hist ? (size_t)nb * sizeof(int32_t) : 0);
  const int vec = ((uintptr_t)keys | (uintptr_t)ties | (uintptr_t)bucket)
                  % 16 == 0;
  kway_classify_kernel<<<(unsigned)blocks, THREADS, smem,
                         (cudaStream_t)stream>>>(
      keys, ties, s_keys, s_ties, bucket, hist, acc, C, S, nb, T, chunk, vec,
      smem_hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
