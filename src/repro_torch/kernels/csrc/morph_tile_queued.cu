// Queued morphological-reconstruction tile drain for Hopper (sm_90a).
//
// Replaces the Pallas kernels morph_tile_solve_queued (B3) and
// morph_tile_solve_queued_batched (B4) of the JAX package
// (repro/kernels/morph_tile.py, _make_queued_kernel, and the drain loop
// queued_fixed_point of repro/kernels/queue.py).  One launch drains K halo
// blocks, grid = (K,); K = 1 is the single-block form.  One CTA owns one
// block of n = (T+2)^ndim cells and keeps, in shared memory, the block (J
// double-buffered, I, valid) and a queue of the cells whose values its
// neighbours have not seen yet.
//
// The loop, per block (J and iters equal the dense drain's, morph_tile.cu):
//   * round 1 is dense (J' = min(I, max(J, max_o J(p+o))) on valid cells)
//     and its improved cells become the queue; a resident seed (indices,
//     count) replaces that round and it is not counted;
//   * while count > 0 and iters < max_iters: if the count fits cap, a push
//     round, else one dense round (a spill, counted in spills);
//   * a push round, for every live slot s and offset o with t = s + o in
//     the block: offer = min(I[t], J[s]) and imp = valid[t] && offer > J[t],
//     all read from the pre-round plane; a barrier; then each offer is
//     max-scattered into J[t] (atomicMax on int32, a compare-and-swap loop
//     on float32, which orders -inf correctly).  Scattering an offer that
//     did not improve is a no-op, since J only grows; so the plane equals
//     the reference's scatter of the improving offers.
//   * the improved cells of a dense round, and the improving contributions
//     of a push round (every one, duplicate targets included, no
//     deduplication), are appended to the next queue with warp-aggregated
//     atomicAdd on a shared counter; count is the number of all of them,
//     slots past cap are not written.  Their order is not observable: a
//     queue that fits is pushed from as a whole, max is order-free, and one
//     that overflows is not read.
//
// Shared memory: 13 B a cell (J twice, I, one byte of valid), 12 B a queue
// slot (this round's queue, the next one, the sources' pre-round values)
// and a 432 B header (the round counters and the offset table).  The
// wrapper refuses a capacity that does not fit beside its block
// (morph_tile.py check_queue_capacity); at T = 64 and the default cap 66 a
// block takes 57,852 B, at T = 128 and cap 130 221,692 B of the 232,448 B a
// CTA may use.
//
// What bounds it: a dense round costs n * (n_offsets + 2) shared-memory
// reads like the dense kernel; a push round costs live slots * n_offsets
// contributions twice (decide, then scatter), so a thin wavefront costs a
// few hundred contributions where a dense round costs thousands of cells.
// A round is still one CTA's latency chain (two barriers, an atomic
// counter), so a drain of many short rounds is bound by latency, not by
// the card's rate; one launch also lasts as long as its slowest block.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxOffsets = 26;
constexpr int kMaxDevices = 64;
// Shared header: 4 ints of round counters, then the offset table (dz, dy,
// dx, delta) that push rounds index by a per-thread offset number.
constexpr int kTableInts = 4 * kMaxOffsets;
constexpr int kHeaderBytes = (4 + kTableInts) * 4;

struct Offsets {
  int n;
  int dz[kMaxOffsets];
  int dy[kMaxOffsets];
  int dx[kMaxOffsets];
  int delta[kMaxOffsets];  // flat index step dz*H*W + dy*W + dx
};

template <typename T> struct Neutral;
template <> struct Neutral<int32_t> {
  __device__ static int32_t value() { return INT_MIN; }
};
template <> struct Neutral<float> {
  __device__ static float value() { return -CUDART_INF_F; }
};

__device__ __forceinline__ void atomic_max_shared(int32_t* addr, int32_t v) {
  atomicMax(addr, v);
}

__device__ __forceinline__ void atomic_max_shared(float* addr, float v) {
  int* word = reinterpret_cast<int*>(addr);
  int seen = *word;
  while (v > __int_as_float(seen)) {
    const int prev = atomicCAS(word, seen, __float_as_int(v));
    if (prev == seen) break;
    seen = prev;
  }
}

// Append the set flags of the calling warp to a shared queue: one atomicAdd
// on the counter per warp.  Every lane of the warp must call it.  Returns
// the flag's slot, or -1 for an unset flag.
__device__ __forceinline__ int warp_append(bool flag, int* counter) {
  const unsigned set = __ballot_sync(0xffffffffu, flag);
  if (set == 0) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(set) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(set));
  base = __shfl_sync(0xffffffffu, base, leader);
  return flag ? base + __popc(set & ((1u << lane) - 1u)) : -1;
}

// The offset table in shared memory: a push round indexes it by a number
// that differs from thread to thread, which the parameter struct does not
// allow without a copy to local memory.
struct Table {
  const int* dz;
  const int* dy;
  const int* dx;
  const int* delta;
};

// The in-block target of source s at offset o, or -1 outside the block.
__device__ __forceinline__ int target(int s, int o, int D, int H, int W,
                                      const Table& tab) {
  const int x = s % W + tab.dx[o];
  const int y = (s / W) % H + tab.dy[o];
  const int z = s / (H * W) + tab.dz[o];
  if (static_cast<unsigned>(x) < static_cast<unsigned>(W) &&
      static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
      static_cast<unsigned>(z) < static_cast<unsigned>(D))
    return s + tab.delta[o];
  return -1;
}

// One dense round cur -> nxt; the improved cells go to queue (the first cap
// of them) and are counted on *counter.
template <typename T>
__device__ void dense_round(const T* cur, T* nxt, const T* mask,
                            const uint8_t* valid, int n, int D, int H, int W,
                            const Offsets& offs, int* queue, int cap,
                            int* counter) {
  const T neut = Neutral<T>::value();
  const int HW = H * W;
  // Every thread runs the same number of steps: warp_append needs them all.
  for (int p0 = 0; p0 < n; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    bool improved = false;
    if (p < n) {
      const T c = cur[p];
      T out = neut;
      if (valid[p]) {
        const int x = p % W;
        const int y = (p / W) % H;
        const int z = p / HW;
        T m = c;
#pragma unroll
        for (int o = 0; o < kMaxOffsets; ++o) {
          if (o < offs.n) {
            const int xx = x + offs.dx[o];
            const int yy = y + offs.dy[o];
            const int zz = z + offs.dz[o];
            if (static_cast<unsigned>(xx) < static_cast<unsigned>(W) &&
                static_cast<unsigned>(yy) < static_cast<unsigned>(H) &&
                static_cast<unsigned>(zz) < static_cast<unsigned>(D)) {
              const T q = cur[p + offs.delta[o]];
              m = q > m ? q : m;
            }
          }
        }
        const T lim = mask[p];
        out = m < lim ? m : lim;
        improved = out != c;
      }
      nxt[p] = out;
    }
    const int slot = warp_append(improved, counter);
    if (slot >= 0 && slot < cap) queue[slot] = p;
  }
}

// Decide half of a push round, against the pre-round plane (nothing writes
// J before the barrier that follows): append every improving contribution
// of the first `span` slots of qcur to qnext, and keep each live source's
// value in qval for the scatter half.
template <typename T>
__device__ void push_decide(const T* cur, const T* mask, const uint8_t* valid,
                            int n, int D, int H, int W, const Table& tab,
                            int n_off, const int* qcur, int span, T* qval,
                            int* qnext, int cap, int* counter) {
  const int contributions = span * n_off;
  for (int c0 = 0; c0 < contributions; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    bool imp = false;
    int t = -1;
    if (c < contributions) {
      const int slot = c / n_off;
      const int o = c - slot * n_off;
      const int s = qcur[slot];
      if (s >= 0 && s < n) {
        const T vs = cur[s];
        if (o == 0) qval[slot] = vs;
        t = target(s, o, D, H, W, tab);
        if (t >= 0 && valid[t]) {
          const T lim = mask[t];
          const T offer = vs < lim ? vs : lim;
          imp = offer > cur[t];
        }
      }
    }
    const int k = warp_append(imp, counter);
    if (k >= 0 && k < cap) qnext[k] = t;
  }
}

// Scatter half of a push round: max every live contribution's offer into
// its target.  Offers that did not improve against the pre-round plane are
// at most the target's value by now, so they change nothing.
template <typename T>
__device__ void push_scatter(T* cur, const T* mask, const uint8_t* valid,
                             int n, int D, int H, int W, const Table& tab,
                             int n_off, const int* qcur, int span,
                             const T* qval) {
  const int contributions = span * n_off;
  for (int c = threadIdx.x; c < contributions; c += blockDim.x) {
    const int slot = c / n_off;
    const int o = c - slot * n_off;
    const int s = qcur[slot];
    if (s < 0 || s >= n) continue;
    const int t = target(s, o, D, H, W, tab);
    if (t < 0 || !valid[t]) continue;
    const T lim = mask[t];
    const T v = qval[slot];
    const T offer = v < lim ? v : lim;
    if (offer > cur[t]) atomic_max_shared(&cur[t], offer);
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
morph_tile_queued_kernel(const T* __restrict__ j_in, const T* __restrict__ i_in,
                         const uint8_t* __restrict__ valid_in,
                         const int32_t* __restrict__ seed,
                         const int32_t* __restrict__ seed_count,
                         T* __restrict__ j_out, int32_t* __restrict__ iters,
                         int32_t* __restrict__ spills_out, int D, int H, int W,
                         Offsets offs, int max_iters, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * H * W;
  // Three round counters in rotation: round r appends on counter[r % 3]
  // and resets counter[(r + 1) % 3], whose last readers have all passed a
  // barrier of round r - 1 by then.
  int* counter = reinterpret_cast<int*>(smem);
  int* table = counter + 4;
  const Table tab{table, table + kMaxOffsets, table + 2 * kMaxOffsets,
                  table + 3 * kMaxOffsets};
  T* buf_a = reinterpret_cast<T*>(smem + kHeaderBytes);
  T* buf_b = buf_a + n;
  T* mask = buf_b + n;
  int* queue_a = reinterpret_cast<int*>(mask + n);
  int* queue_b = queue_a + cap;
  T* qval = reinterpret_cast<T*>(queue_b + cap);
  uint8_t* valid = reinterpret_cast<uint8_t*>(qval + cap);

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const T neut = Neutral<T>::value();
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const uint8_t v = valid_in[base + p];
    valid[p] = v;
    mask[p] = i_in[base + p];
    buf_a[p] = v ? j_in[base + p] : neut;
  }
  if (seed != nullptr) {
    const size_t qbase = static_cast<size_t>(blockIdx.x) * cap;
    for (int k = threadIdx.x; k < cap; k += blockDim.x)
      queue_a[k] = seed[qbase + k];
  }
  if (threadIdx.x < 3) counter[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    // Constant indices only, so the parameter struct stays in the
    // constant bank (an index that varies would copy it to local memory).
#pragma unroll
    for (int o = 0; o < kMaxOffsets; ++o) {
      if (o < offs.n) {
        table[o] = offs.dz[o];
        table[kMaxOffsets + o] = offs.dy[o];
        table[2 * kMaxOffsets + o] = offs.dx[o];
        table[3 * kMaxOffsets + o] = offs.delta[o];
      }
    }
  }
  __syncthreads();

  T* cur = buf_a;
  T* nxt = buf_b;
  int* qcur = queue_a;
  int* qnext = queue_b;
  int round = 0;
  int it, count, span;
  if (seed != nullptr) {
    it = 0;
    count = seed_count[blockIdx.x];
    span = cap;  // a seed's live slots may lie anywhere in it
  } else {
    dense_round<T>(cur, nxt, mask, valid, n, D, H, W, offs, qcur, cap,
                   &counter[0]);
    __syncthreads();
    count = counter[0];
    T* t = cur; cur = nxt; nxt = t;
    it = 1;
    round = 1;
    span = count < cap ? count : cap;
  }
  int spills = 0;
  while (count > 0 && it < max_iters) {
    int* c = &counter[round % 3];
    if (threadIdx.x == 0) counter[(round + 1) % 3] = 0;
    if (count > cap) {
      dense_round<T>(cur, nxt, mask, valid, n, D, H, W, offs, qnext, cap, c);
      __syncthreads();
      T* t = cur; cur = nxt; nxt = t;
      ++spills;
    } else {
      push_decide<T>(cur, mask, valid, n, D, H, W, tab, offs.n, qcur, span,
                     qval, qnext, cap, c);
      __syncthreads();
      push_scatter<T>(cur, mask, valid, n, D, H, W, tab, offs.n, qcur, span,
                      qval);
      __syncthreads();
    }
    count = *c;
    int* q = qcur; qcur = qnext; qnext = q;
    span = count < cap ? count : cap;
    ++it;
    ++round;
  }

  for (int p = threadIdx.x; p < n; p += blockDim.x) j_out[base + p] = cur[p];
  if (threadIdx.x == 0) {
    iters[blockIdx.x] = it;
    spills_out[blockIdx.x] = spills;
  }
}

// Raise the kernel's dynamic shared-memory limit to the device's opt-in
// maximum, once per dtype and device.  Each launch asks for its own size.
template <typename T>
cudaError_t allow_large_smem(size_t smem) {
  static bool done[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(morph_tile_queued_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* j_in, const void* i_in, const uint8_t* valid_in,
           const int32_t* seed, const int32_t* seed_count, void* j_out,
           int32_t* iters, int32_t* spills, int K, int D, int H, int W,
           const Offsets& offs, int max_iters, int cap, cudaStream_t stream) {
  const int n = D * H * W;
  const size_t smem = kHeaderBytes + static_cast<size_t>(n) * (3 * sizeof(T) + 1)
                      + static_cast<size_t>(cap) * (2 * sizeof(int) + sizeof(T));
  const int threads = n >= 8192 ? 1024 : 512;
  cudaError_t err = allow_large_smem<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  morph_tile_queued_kernel<T><<<K, threads, smem, stream>>>(
      static_cast<const T*>(j_in), static_cast<const T*>(i_in), valid_in,
      seed, seed_count, static_cast<T*>(j_out), iters, spills, D, H, W, offs,
      max_iters, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  dtype: 0 = int32, 1 = float32.  seed
// and seed_count are null, or a (K, cap) int32 queue per block (flat
// indices, -1 dead) and its (K,) live counts.  The offsets are a host array
// of n_off (dz, dy, dx) triples.  All device arrays are contiguous
// (K, D, H, W); valid holds one byte 0/1 a cell.  Returns the cudaError_t
// of the launch (0 on success); never synchronises.
extern "C" int morph_tile_drain_queued(int dtype, const void* j_in,
                                       const void* i_in, const void* valid_in,
                                       const void* seed, const void* seed_count,
                                       void* j_out, void* iters, void* spills,
                                       int K, int D, int H, int W,
                                       const int* offsets, int n_off,
                                       int max_iters, int cap, void* stream) {
  if (n_off < 1 || n_off > kMaxOffsets || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((seed == nullptr) != (seed_count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.n = n_off;
  for (int o = 0; o < n_off; ++o) {
    offs.dz[o] = offsets[3 * o];
    offs.dy[o] = offsets[3 * o + 1];
    offs.dx[o] = offsets[3 * o + 2];
    offs.delta[o] = offs.dz[o] * H * W + offs.dy[o] * W + offs.dx[o];
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const uint8_t*>(valid_in);
  auto sq = static_cast<const int32_t*>(seed);
  auto sc = static_cast<const int32_t*>(seed_count);
  auto it = static_cast<int32_t*>(iters);
  auto sp = static_cast<int32_t*>(spills);
  if (dtype == 0)
    return launch<int32_t>(j_in, i_in, v, sq, sc, j_out, it, sp, K, D, H, W,
                           offs, max_iters, cap, s);
  if (dtype == 1)
    return launch<float>(j_in, i_in, v, sq, sc, j_out, it, sp, K, D, H, W,
                         offs, max_iters, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
