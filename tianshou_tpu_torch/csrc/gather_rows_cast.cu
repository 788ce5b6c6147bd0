// Fused replay-row gather + uint8 -> bfloat16 decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gather_rows_cast in
// tianshou_tpu/ops/pallas_gather.py (function gather_rows_cast, body _kernel):
//     out[b, :] = bf16(storage[idx[b], :])
// storage [R, F] uint8, idx [B] int64, out [B, F] bf16, all contiguous.
//
// Bound: pure bytes.  Each output row writes 2F bytes and each distinct row
// drawn reads F bytes, with one exact conversion a byte, so the card's
// memory rate is the limit (at R = 8192, F = 28224, B = 13312: 0.936 GB for
// the 6,566 rows these indices read, >= 0.280 ms at 3.35 TB/s).  A kernel
// that reads a row once per draw moves 1.127 GB there: duplicates are
// spread over the launch, so L2 rarely serves them.
//
// Three routes, chosen by the caller's launch plan (ops/gather.py
// launch_plan) from the shape and the alignment alone.  The two pipelines
// need F % 16 == 0 and both base pointers 16-byte aligned, and share their
// structure: a few persistent blocks on each SM; warp 0 produces, its lane 0
// bringing each row in as 16-byte-multiple chunks with 1-D bulk copies
// (cp.async.bulk, global -> shared) into a ring of `stages` buffers, each
// completing on its "full" mbarrier with a byte count; the other warps (8
// to 24) consume, each waiting on a stage's full barrier, converting 8 u8 to 8
// bf16 a thread and step (exact, by bit pattern) and writing them with
// 16-byte streaming stores, neighbouring lanes on neighbouring addresses,
// then arriving on the stage's "empty" mbarrier, which the producer waits
// on before it reuses the buffer.  Tens of KB per SM stay in flight
// whatever the thread count, and addresses are 64-bit throughout (a ring of
// 1,000,000 frames of 7,056 bytes passes 2^32 bytes).
//
// - "grouped" (many draws per row: B >= R / 4, with the row counts and the
//   block's output rows in shared memory): reads each distinct row once.
//   Each block counts the draws of every row and scans the counts, which
//   orders the draws by row without a sort; it owns a contiguous range of
//   rows holding about B / G draws, lists their output rows, and stores
//   each row it reads at every output row that draws it.
// - "pipeline" (other aligned inputs): output order, block k the output
//   rows k, k + G, ...; the producer warp's 32 lanes hold the indices of the
//   block's next 32 rows and load the 32 after those a round ahead, so no
//   row read waits on its own index.
// - "simple" (anything else, and on request for comparison): one block per
//   output row and 4,096-byte slice, 16-byte loads and stores where F and
//   the pointers allow, a scalar loop otherwise.
//
// Indices are assumed in [0, R), as in the TPU kernel (the grouped route
// skips others; their output rows are left unwritten).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // simple route
constexpr int kVec = 16;       // simple route: bytes of u8 input per thread per iteration

// pipelines: a block is one producer warp and CW consumer warps
template <int CW>
constexpr int kPipeThreads = (CW + 1) * 32;
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full and empty barriers ahead of the ring
constexpr int kMaxDevices = 64;

enum Route : int64_t { kSimple = 0, kPipeline = 1, kGrouped = 2 };

// Exact u8 -> f32: the bits 0x4B000000 | v are the float 2^23 + v.
__device__ __forceinline__ float u8_to_f32(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// Four u8 packed in one word -> four bf16 packed in two words (low byte first).
__device__ __forceinline__ uint2 cvt4(uint32_t w) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(u8_to_f32(w & 0xFFu), u8_to_f32((w >> 8) & 0xFFu));
  __nv_bfloat162 hi = __floats2bfloat162_rn(u8_to_f32((w >> 16) & 0xFFu), u8_to_f32(w >> 24));
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

// ---- simple route ----------------------------------------------------------

// grid (B, ceil(F / (kThreads * kVec))): blockIdx.x is the output row,
// blockIdx.y strides over the row.
template <bool kVectorized>
__global__ void __launch_bounds__(kThreads)
gather_rows_cast_kernel(const uint8_t* __restrict__ storage,
                        const int64_t* __restrict__ idx,
                        __nv_bfloat16* __restrict__ out, int64_t F) {
  const int64_t b = blockIdx.x;
  const uint8_t* src = storage + idx[b] * F;
  __nv_bfloat16* dst = out + b * F;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (kVectorized) {
    const int64_t nvec = F / kVec;
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int64_t v = first; v < nvec; v += stride) {
      const uint4 in = __ldg(src4 + v);
      const uint2 a = cvt4(in.x), c = cvt4(in.y), d = cvt4(in.z), e = cvt4(in.w);
      dst4[2 * v] = make_uint4(a.x, a.y, c.x, c.y);
      dst4[2 * v + 1] = make_uint4(d.x, d.y, e.x, e.y);
    }
    head = nvec * kVec;
  }
  for (int64_t f = head + first; f < F; f += stride) {
    dst[f] = __float2bfloat16_rn(u8_to_f32(src[f]));
  }
}

// ---- pipeline route: mbarriers and bulk copies -----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One side's view of the ring: `stages` buffers of `chunk` bytes, each with a
// "full" barrier (one arrival and the bulk copy's bytes) and an "empty"
// barrier (one arrival per consumer warp).  Producer and consumers walk the
// same sequence of chunks, so each keeps its own stage and phase.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* buf;
  int chunk, stages, s;
  uint32_t phase;

  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// Carves the barriers and the ring out of dynamic shared memory; thread 0
// initialises the barriers.  The caller synchronises the block after.
template <int CW>
__device__ __forceinline__ Ring make_ring(uint8_t* smem, int chunk, int stages, bool producer) {
  Ring ring{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<uint64_t*>(smem) + kMaxStages,
            smem + kBarrierBytes, chunk, stages, 0, producer ? 1u : 0u};  // the ring starts empty
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return ring;
}

// Producer (one lane): row `src` of F bytes into the ring, chunk by chunk.
__device__ __forceinline__ void produce_row(Ring& ring, const uint8_t* src, int64_t F) {
  for (int64_t off = 0; off < F; off += ring.chunk) {
    const uint32_t bytes = static_cast<uint32_t>(F - off < ring.chunk ? F - off : ring.chunk);
    mbar_wait(&ring.empty[ring.s], ring.phase);
    mbar_arrive_expect_tx(&ring.full[ring.s], bytes);
    bulk_load(ring.buf + static_cast<int64_t>(ring.s) * ring.chunk, src + off, bytes, &ring.full[ring.s]);
    ring.advance();
  }
}

// Consumers (threads 32 on): each chunk of one row, as it arrives,
// converted 8 bytes a thread and step and stored with 16-byte streaming
// stores at each of the `n` output rows `dst(0) ... dst(n - 1)`.
template <int CW, typename Dst>
__device__ __forceinline__ void consume_row(Ring& ring, int64_t F, Dst dst, int n) {
  const int tid = threadIdx.x - 32;
  for (int64_t off = 0; off < F; off += ring.chunk) {
    const int units = static_cast<int>((F - off < ring.chunk ? F - off : ring.chunk) / 8);
    const uint8_t* in = ring.buf + static_cast<int64_t>(ring.s) * ring.chunk;
    mbar_wait(&ring.full[ring.s], ring.phase);
    for (int u = tid; u < units; u += CW * 32) {
      const uint2 w = *reinterpret_cast<const uint2*>(in + 8 * u);
      const uint2 lo = cvt4(w.x), hi = cvt4(w.y);
      const uint4 v = make_uint4(lo.x, lo.y, hi.x, hi.y);
      for (int i = 0; i < n; ++i) __stcs(reinterpret_cast<uint4*>(dst(i) + off + 8 * u), v);
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&ring.empty[ring.s]);
    ring.advance();
  }
}

// "pipeline": persistent blocks in output order, block k the output rows
// k, k + G, k + 2G, ... (the blocks together write a window of about G
// neighbouring rows at a time).
template <int CW>
__global__ void __launch_bounds__(kPipeThreads<CW>)
gather_rows_cast_pipeline(const uint8_t* __restrict__ storage, const int64_t* __restrict__ idx,
                          __nv_bfloat16* __restrict__ out, int64_t F, int64_t B, int chunk, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Ring ring = make_ring<CW>(smem, chunk, stages, warp == 0);
  const int64_t G = gridDim.x, b0 = blockIdx.x;
  __syncthreads();
  if (warp == 0) {
    // lane j holds the index of the block's (32 i + j)-th row of the current
    // 32 in `mine`, and of the next 32 in `ahead`, loaded a round before use
    int64_t mine = b0 + lane * G < B ? idx[b0 + lane * G] : 0;
    int64_t ahead = b0 + (32 + lane) * G < B ? idx[b0 + (32 + lane) * G] : 0;
    for (int64_t i = 0; b0 + i * G < B; ++i) {
      const int j = static_cast<int>(i & 31);
      if (j == 0 && i != 0) {
        mine = ahead;
        const int64_t b = b0 + (i + 32 + lane) * G;
        ahead = b < B ? idx[b] : 0;
      }
      const int64_t row = __shfl_sync(0xffffffffu, mine, j);
      if (lane == 0) produce_row(ring, storage + row * F, F);
      __syncwarp();
    }
  } else {
    for (int64_t b = b0; b < B; b += G) {
      __nv_bfloat16* dst = out + b * F;
      consume_row<CW>(ring, F, [dst](int) { return dst; }, 1);
    }
  }
}

// fn(b, idx[b]) for every b, spread over the block's T threads: 16-byte
// loads of two draws each, 8 of them in flight a thread before their uses
// (the passes over idx are bound by the latency of those loads).
template <int T, typename Fn>
__device__ __forceinline__ void for_each_draw(const int64_t* __restrict__ idx, int64_t B, Fn fn) {
  constexpr int U = 8;
  const int64_t head = (reinterpret_cast<uintptr_t>(idx) % 16 != 0 && B > 0) ? 1 : 0;
  if (head && threadIdx.x == 0) fn(0, idx[0]);
  const longlong2* pairs = reinterpret_cast<const longlong2*>(idx + head);
  const int64_t n = (B - head) / 2;
  int64_t p = threadIdx.x;
  for (; p + (U - 1) * T < n; p += U * T) {
    longlong2 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = __ldg(pairs + p + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      fn(head + 2 * (p + u * T), x[u].x);
      fn(head + 2 * (p + u * T) + 1, x[u].y);
    }
  }
  for (; p < n; p += T) {
    const longlong2 x = __ldg(pairs + p);
    fn(head + 2 * p, x.x);
    fn(head + 2 * p + 1, x.y);
  }
  if ((B - head) % 2 != 0 && threadIdx.x == 0) fn(B - 1, idx[B - 1]);
}

// "grouped": every block counts, in shared memory, how often each storage
// row is drawn over all B indices and takes the exclusive prefix C of the
// counts, so that the sorted order of the draws is known without a sort.
// Block k owns the rows r drawn at least once with C(r) in
// [B k / G, B (k + 1) / G): a contiguous range of rows with about B / G
// output rows, the same in every block.  It lists the output rows of each
// of its rows (a second pass over idx) and then reads each row once, into
// the ring, and stores it at every output row that draws it.
template <int CW>
__global__ void __launch_bounds__(kPipeThreads<CW>)
gather_rows_cast_grouped(const uint8_t* __restrict__ storage, const int64_t* __restrict__ idx,
                         __nv_bfloat16* __restrict__ out, int64_t R, int64_t F, int64_t B, int chunk,
                         int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int T = kPipeThreads<CW>, kWarps = CW + 1;
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int own[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  Ring ring = make_ring<CW>(smem, chunk, stages, warp == 0);
  uint32_t* count = reinterpret_cast<uint32_t*>(ring.buf + static_cast<int64_t>(stages) * chunk);  // R entries
  uint16_t* pos = reinterpret_cast<uint16_t*>(count + R);  // this block's output rows, by storage row

  for (int64_t r = tid; r < R; r += T) count[r] = 0;
  if (tid == 0) {
    own[0] = 0x7fffffff;
    own[1] = -1;
  }
  __syncthreads();
  for_each_draw<T>(idx, B, [count, R](int64_t, int64_t r) {
    if (static_cast<uint64_t>(r) < static_cast<uint64_t>(R)) atomicAdd(&count[r], 1u);
  });
  __syncthreads();

  // exclusive scan of the counts: thread t a contiguous segment of rows
  const int64_t seg = (R + T - 1) / T;
  const int64_t r0 = tid * seg < R ? tid * seg : R, r1 = r0 + seg < R ? r0 + seg : R;
  uint32_t sum = 0;
  for (int64_t r = r0; r < r1; ++r) sum += count[r];
  uint32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t mine = lane < kWarps ? warp_sums[lane] : 0;
    uint32_t v = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane < kWarps) warp_sums[lane] = v - mine;
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - sum;
  int lo = 0x7fffffff, hi = -1;
  for (int64_t r = r0; r < r1; ++r) {
    const uint32_t c = count[r];
    count[r] = run;  // now C(r)
    if (c > 0 && static_cast<uint64_t>(run) * gridDim.x / B == blockIdx.x) {
      lo = lo < r ? lo : static_cast<int>(r);
      hi = static_cast<int>(r);
    }
    run += c;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicMin(&own[0], lo);
    atomicMax(&own[1], hi);
  }
  __syncthreads();
  const int64_t r_lo = own[0], r_hi = static_cast<int64_t>(own[1]) + 1;  // empty where r_lo >= r_hi
  const uint32_t c_lo = r_lo < r_hi ? count[r_lo] : 0;
  __syncthreads();  // every thread has C(r_lo) before the scatter moves it
  for_each_draw<T>(idx, B, [count, pos, r_lo, r_hi, c_lo](int64_t b, int64_t r) {
    if (r >= r_lo && r < r_hi) pos[atomicAdd(&count[r], 1u) - c_lo] = static_cast<uint16_t>(b);
  });
  __syncthreads();
  // count[r] is now C(r + 1) for r in [r_lo, r_hi): row r's output rows are
  // pos[start - c_lo, count[r] - c_lo) with start the previous row's end

  if (warp == 0) {
    if (lane == 0) {
      uint32_t start = c_lo;
      for (int64_t r = r_lo; r < r_hi; ++r) {
        const uint32_t end = count[r];
        if (end == start) continue;
        start = end;
        produce_row(ring, storage + r * F, F);
      }
    }
  } else {
    uint32_t start = c_lo;
    for (int64_t r = r_lo; r < r_hi; ++r) {
      const uint32_t end = count[r];
      if (end == start) continue;
      const uint16_t* rows = pos + (start - c_lo);
      consume_row<CW>(ring, F, [rows, out, F](int i) { return out + static_cast<int64_t>(rows[i]) * F; },
                  static_cast<int>(end - start));
      start = end;
    }
  }
}

// Raises a kernel's dynamic shared memory limit once per device, to the
// largest plan seen.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t* set, int64_t smem_bytes) {
  if (smem_bytes <= *set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (e == cudaSuccess) *set = smem_bytes;
  return e;
}

// One pipeline launch with CW consumer warps.
template <int CW>
cudaError_t launch_pipeline(bool grouped, const uint8_t* storage, const int64_t* idx, __nv_bfloat16* out,
                            int64_t R, int64_t F, int64_t B, int64_t grid, int64_t chunk, int64_t stages,
                            int64_t smem_bytes, int64_t device, cudaStream_t stream) {
  static int64_t smem_set[2][kMaxDevices] = {};
  const dim3 blocks(static_cast<unsigned>(grid)), threads(kPipeThreads<CW>);
  cudaError_t e;
  if (grouped) {
    e = allow_smem(gather_rows_cast_grouped<CW>, &smem_set[1][device], smem_bytes);
    if (e != cudaSuccess) return e;
    gather_rows_cast_grouped<CW><<<blocks, threads, static_cast<size_t>(smem_bytes), stream>>>(
        storage, idx, out, R, F, B, static_cast<int>(chunk), static_cast<int>(stages));
  } else {
    e = allow_smem(gather_rows_cast_pipeline<CW>, &smem_set[0][device], smem_bytes);
    if (e != cudaSuccess) return e;
    gather_rows_cast_pipeline<CW><<<blocks, threads, static_cast<size_t>(smem_bytes), stream>>>(
        storage, idx, out, F, B, static_cast<int>(chunk), static_cast<int>(stages));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[b, :] = bf16(storage[idx[b], :]) on `device`'s `stream`, by the plan
// of ops/gather.py launch_plan: `route` 0 (simple), 1 (pipeline) or 2
// (grouped), the pipelines with `grid` persistent blocks of one producer
// warp and `warps` (8, 16, 24 or 31) consumer warps, `chunk`-byte bulk copies, a
// ring of `stages` and `smem_bytes` of dynamic shared memory
// (grouped: also 4 R + 2 B bytes of counts and output rows).  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan
// the inputs do not allow.
int ts_gather_rows_cast(const uint8_t* storage, const int64_t* idx, __nv_bfloat16* out, int64_t R, int64_t F,
                        int64_t B, int64_t route, int64_t grid, int64_t warps, int64_t chunk, int64_t stages,
                        int64_t smem_bytes, int64_t device, cudaStream_t stream) {
  if (B <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // this library's runtime keeps its own current device
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) {
    const cudaError_t e = cudaSetDevice(static_cast<int>(device));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool aligned = F % kVec == 0 && reinterpret_cast<uintptr_t>(storage) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (route == kPipeline || route == kGrouped) {
    const bool grouped = route == kGrouped;
    const int64_t need = kBarrierBytes + stages * chunk + (grouped ? 4 * R + 2 * B : 0);
    if (!aligned || chunk <= 0 || chunk % 16 != 0 || chunk > (1 << 20) || stages < 1 || stages > kMaxStages ||
        grid < 1 || grid > B || grid > 2147483647LL || smem_bytes < need ||
        (grouped && (B > 65536 || R > (1LL << 30)))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e;
    switch (warps) {
      case 8:
        e = launch_pipeline<8>(grouped, storage, idx, out, R, F, B, grid, chunk, stages, smem_bytes, device, stream);
        break;
      case 16:
        e = launch_pipeline<16>(grouped, storage, idx, out, R, F, B, grid, chunk, stages, smem_bytes, device,
                                stream);
        break;
      case 24:
        e = launch_pipeline<24>(grouped, storage, idx, out, R, F, B, grid, chunk, stages, smem_bytes, device,
                                stream);
        break;
      case 31:
        e = launch_pipeline<31>(grouped, storage, idx, out, R, F, B, grid, chunk, stages, smem_bytes, device,
                                stream);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(e);
  }
  if (route != kSimple) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);  // grid.x limit
  // The kernel strides over a row, so grid.y may stop at its hardware limit.
  const int64_t slices = (F + kThreads * kVec - 1) / (kThreads * kVec);
  const dim3 simple_grid(static_cast<unsigned>(B), static_cast<unsigned>(slices < 65535 ? slices : 65535));
  if (aligned) {
    gather_rows_cast_kernel<true><<<simple_grid, kThreads, 0, stream>>>(storage, idx, out, F);
  } else {
    gather_rows_cast_kernel<false><<<simple_grid, kThreads, 0, stream>>>(storage, idx, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
