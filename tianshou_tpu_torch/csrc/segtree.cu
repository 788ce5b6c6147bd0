// Sum tree of prioritized replay for Hopper (sm_90a): a batch's descent in
// one launch, a batch's write-back in one launch.
//
// Replaces no Pallas kernel.  The JAX package's sum tree
// (tianshou_tpu/ops/segtree.py, segtree_update and segtree_sample) is jnp
// code, a lax.fori_loop over the tree's levels that XLA fuses; the port's
// plain version (tianshou_tpu_torch/ops/segtree.py) is a Python loop of a
// few small launches a level, 17 levels at 2^17 leaves: about 105 launches
// a draw and 70 a write-back, each a graph node of a few microseconds that
// moves a few hundred bytes.  These kernels were added because that loop is
// bound by launches, not by work.
//
// The tree is one float32 array in heap layout: the root at 1, node n's
// children at 2n and 2n + 1, the leaves at [cap, 2 cap), cap a power of two.
//
// - segtree_draw_kernel: one thread a draw, any batch, as many blocks as it
//   needs.  Each block first stages the tree's top 11 levels (nodes below
//   2,048, 8 KB) in shared memory with one coalesced load, so a descent's
//   chain of 17 dependent reads holds 6 from L2 at 2^17 leaves.  The descent
//   is the plain loop's, operation for operation: u scaled by the root (a
//   rounded multiply, never contracted into the subtraction), then at each
//   level go right where u >= the left child's sum, subtracting it; the leaf
//   clamped to `slots - 1` (a draw at the very top may land on a padding
//   leaf), written as (leaf / row_len, leaf % row_len) with the leaf's
//   value.  Every intrinsic rounds to nearest, as PyTorch's
//   float32 kernels do, so the leaves and values are bitwise the plain
//   loop's.
// - segtree_update_kernel: one block of up to 1,024 threads, each looping
//   over its share of the batch.  It writes the leaves, then for each of
//   the 17 levels, after a __syncthreads() (which makes the block's global
//   writes visible to the whole block), rebuilds every touched ancestor as
//   one rounded add of its two children.  A duplicated leaf keeps one of its
//   written values, and every ancestor is rebuilt from the value that won,
//   as in the plain loop; with distinct leaves the tree is bitwise the
//   plain loop's.  The leaf of entry b is rows[b] * row_stride + idx[b]
//   (rows absent: b), a ring's flat slot env * capacity + pos.  A leaf
//   outside [0, cap) is a caller's fault: the kernel traps on it, so the
//   launch fails and the next synchronising call raises, as an index_put
//   out of range does (the CPU route raises IndexError).
//
// Bound: latency, not bytes or operations.  A draw batch reads a few KB and
// a write-back writes 17 nodes an entry; each is one launch plus its chain
// of dependent reads (6 L2 round trips a descent; 17 block barriers with an
// L2 round trip each for a write-back), about 5-10 us on an H100.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDrawThreads = 256;
constexpr int kStaged = 2048;  // nodes [0, 2048) in shared memory: the top 11 levels
constexpr int kMaxUpdateThreads = 1024;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kDrawThreads)
    segtree_draw_kernel(const float* __restrict__ tree, int64_t cap, int levels, const float* __restrict__ u,
                        int64_t B, int64_t slots, int64_t row_len, int64_t* __restrict__ env,
                        int64_t* __restrict__ pos, float* __restrict__ p) {
  __shared__ float top[kStaged];
  const int staged = static_cast<int>(2 * cap < kStaged ? 2 * cap : kStaged);
  for (int i = threadIdx.x; i < staged; i += blockDim.x) top[i] = tree[i];
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x = __fmul_rn(u[b], top[1]);
  int64_t node = 1;
  for (int level = 0; level < levels; ++level) {
    const int64_t left = 2 * node;
    const float left_sum = left < staged ? top[left] : tree[left];
    const bool right = x >= left_sum;
    node = left + (right ? 1 : 0);
    if (right) x = __fsub_rn(x, left_sum);
  }
  int64_t leaf = node - cap;
  if (leaf > slots - 1) leaf = slots - 1;
  env[b] = leaf / row_len;
  pos[b] = leaf % row_len;
  p[b] = tree[cap + leaf];
}

__device__ __forceinline__ int64_t leaf_of(const int64_t* rows, const int64_t* idx, int64_t row_stride,
                                           int64_t b) {
  return (rows != nullptr ? rows[b] : b) * row_stride + idx[b];
}

__global__ void __launch_bounds__(kMaxUpdateThreads)
    segtree_update_kernel(float* tree, int64_t cap, int levels, const int64_t* __restrict__ rows,
                          const int64_t* __restrict__ idx, int64_t row_stride, const float* __restrict__ values,
                          int64_t value_step, int64_t B) {
  for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
    const int64_t leaf = leaf_of(rows, idx, row_stride, b);
    if (leaf < 0 || leaf >= cap) __trap();
    tree[cap + leaf] = values[b * value_step];
  }
  for (int level = 1; level <= levels; ++level) {
    __syncthreads();
    for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
      const int64_t node = (cap + leaf_of(rows, idx, row_stride, b)) >> level;
      tree[node] = __fadd_rn(tree[2 * node], tree[2 * node + 1]);
    }
  }
}

// log2(cap) for a power of two >= 1, else -1.
int levels_of(int64_t cap) {
  if (cap < 1 || (cap & (cap - 1)) != 0) return -1;
  int levels = 0;
  while ((int64_t{1} << levels) < cap) ++levels;
  return levels;
}

// This library's runtime keeps its own current device.
cudaError_t use_device(int64_t device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaGetDevice(&current);
  return current == device ? cudaSuccess : cudaSetDevice(static_cast<int>(device));
}

}  // namespace

extern "C" {

// For each of the B draws u[b] in [0, 1), the leaf of the tree [2 cap]
// whose prefix-sum interval holds u[b] * root, at most `slots` - 1: `env` the
// leaf / row_len, `pos` the leaf % row_len, `p` the leaf's value.  On `device`'s `stream`; returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a cap that is not a power of two.
int ts_segtree_draw(const float* tree, int64_t cap, const float* u, int64_t B, int64_t slots, int64_t row_len,
                    int64_t* env, int64_t* pos, float* p, int64_t device, cudaStream_t stream) {
  const int levels = levels_of(cap);
  if (levels < 0 || slots < 1 || slots > cap || row_len < 1 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (B + kDrawThreads - 1) / kDrawThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  segtree_draw_kernel<<<static_cast<unsigned>(blocks), kDrawThreads, 0, stream>>>(
      tree, cap, levels, u, B, slots, row_len, env, pos, p);
  return static_cast<int>(cudaGetLastError());
}

// Sets the leaves rows[b] * row_stride + idx[b] (rows null: b * row_stride +
// idx[b]) of the tree [2 cap] to values[b * value_step] (value_step 0: one
// value for all) and rebuilds their ancestors, in place, in one block on
// `device`'s `stream`; a leaf outside [0, cap) traps.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a cap that is not a power of two.
int ts_segtree_update(float* tree, int64_t cap, const int64_t* rows, const int64_t* idx, int64_t row_stride,
                      const float* values, int64_t value_step, int64_t B, int64_t device, cudaStream_t stream) {
  const int levels = levels_of(cap);
  if (levels < 0 || B < 0 || value_step < 0 || value_step > 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t warps = (B + 31) / 32;
  const int threads = static_cast<int>(warps * 32 < kMaxUpdateThreads ? warps * 32 : kMaxUpdateThreads);
  segtree_update_kernel<<<1, threads, 0, stream>>>(tree, cap, levels, rows, idx, row_stride, values, value_step, B);
  return static_cast<int>(cudaGetLastError());
}

const char* ts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
