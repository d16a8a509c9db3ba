// Dense morphological-reconstruction tile drain for Hopper (sm_90a).
//
// Replaces the Pallas kernels morph_tile_solve and morph_tile_solve_batched
// of the JAX package (repro/kernels/morph_tile.py, _make_kernel).  One
// launch drains K halo blocks, grid = (K,); K = 1 is the single-block form.
// One CTA owns one block of (T+2)^ndim cells and loops Jacobi rounds
//
//     J'(p) = valid(p) ? min(I(p), max(J(p), max_{o} J(p + o))) : neutral
//
// until its own block is stable or max_iters rounds have run.  Reads outside
// the block are neutral (INT_MIN or -inf), invalid cells are pinned to
// neutral before the first round and after every round, and the halo ring
// updates like every other cell, as in the reference.  iters counts round
// executions: the loop starts with changed = true and it = 0 and runs while
// changed && it < max_iters.
//
// Buffers: J double-buffered in shared memory (each round reads the
// pre-round plane), I and valid beside it: 13 bytes a cell, so within the
// 232,448 B a CTA may use a 2-D block fits up to T = 131 (133^2 cells,
// 229,957 B; the engine's T = 128 takes 219,700 B) and a 3-D block up to
// T = 24 (26^3 cells, 228,488 B).  A 2-D block is a 3-D one of depth 1;
// the offset table arrives by value, so conn4, conn8, conn6, conn18 and
// conn26 share one kernel.
//
// What bounds it: each launch reads 9 B and writes 4 B a cell of device
// memory once; between them each round does n_offsets + 2 shared-memory reads
// a cell, iters * (T+2)^ndim * (n_offsets + 2) in all.  The rounds, not the
// device-memory traffic, dominate for any drain of more than a few rounds.
// This first version keeps that loop simple (one cell per thread step,
// integer div/mod for coordinates); staging with cp.async or TMA and a
// warp-level round loop are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxOffsets = 26;
constexpr int kMaxDevices = 64;

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

template <typename T>
__global__ void __launch_bounds__(1024)
morph_tile_drain_kernel(const T* __restrict__ j_in, const T* __restrict__ i_in,
                        const uint8_t* __restrict__ valid_in,
                        T* __restrict__ j_out, int32_t* __restrict__ iters,
                        int D, int H, int W, Offsets offs, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = D * H * W;
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = buf_a + n;
  T* mask = buf_b + n;
  uint8_t* valid = reinterpret_cast<uint8_t*>(mask + n);

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const T neut = Neutral<T>::value();
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const uint8_t v = valid_in[base + p];
    valid[p] = v;
    mask[p] = i_in[base + p];
    buf_a[p] = v ? j_in[base + p] : neut;
  }
  __syncthreads();

  T* cur = buf_a;
  T* nxt = buf_b;
  int it = 0;
  int changed = 1;
  const int HW = H * W;
  while (changed && it < max_iters) {
    int local = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
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
        local |= (out != c);
      }
      nxt[p] = out;
    }
    // Barrier and block-wide OR in one: every write of this round is
    // visible before the next round reads nxt as cur.
    changed = __syncthreads_or(local);
    T* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }

  for (int p = threadIdx.x; p < n; p += blockDim.x) j_out[base + p] = cur[p];
  if (threadIdx.x == 0) iters[blockIdx.x] = it;
}

// Raise the kernel's dynamic shared-memory limit to the device's opt-in
// maximum, once per dtype and device rather than once per launch.  The
// attribute is a ceiling; each launch still asks for just its own size.
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
  err = cudaFuncSetAttribute(morph_tile_drain_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* j_in, const void* i_in, const uint8_t* valid_in,
           void* j_out, int32_t* iters, int K, int D, int H, int W,
           const Offsets& offs, int max_iters, cudaStream_t stream) {
  const int n = D * H * W;
  const size_t smem = static_cast<size_t>(n) * (3 * sizeof(T) + 1);
  const int threads = n >= 8192 ? 1024 : 512;
  cudaError_t err = allow_large_smem<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  morph_tile_drain_kernel<T><<<K, threads, smem, stream>>>(
      static_cast<const T*>(j_in), static_cast<const T*>(i_in), valid_in,
      static_cast<T*>(j_out), iters, D, H, W, offs, max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  dtype: 0 = int32, 1 = float32.  The
// offsets are a host array of n_off (dz, dy, dx) triples.  All device arrays
// are contiguous (K, D, H, W); valid holds one byte 0/1 a cell.  Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int morph_tile_drain(int dtype, const void* j_in, const void* i_in,
                                const void* valid_in, void* j_out, void* iters,
                                int K, int D, int H, int W,
                                const int* offsets, int n_off, int max_iters,
                                void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
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
  auto it = static_cast<int32_t*>(iters);
  if (dtype == 0)
    return launch<int32_t>(j_in, i_in, v, j_out, it, K, D, H, W, offs, max_iters, s);
  if (dtype == 1)
    return launch<float>(j_in, i_in, v, j_out, it, K, D, H, W, offs, max_iters, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
