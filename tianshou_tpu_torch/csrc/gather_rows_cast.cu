// Fused replay-row gather + uint8 -> bfloat16 decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gather_rows_cast in
// tianshou_tpu/ops/pallas_gather.py (function gather_rows_cast, body _kernel):
//     out[b, :] = bf16(storage[idx[b], :])
// storage [R, F] uint8, idx [B] int64, out [B, F] bf16, all contiguous.
//
// Bound: pure bytes.  Each output row reads F bytes and writes 2F bytes and
// does one exact conversion per byte, so the card's memory rate is the
// limit (at R = 8192, F = 28224, B = 13312: 1.127 GB, >= 0.336 ms at
// 3.35 TB/s).  The design moves 16 bytes per load and per store: each thread
// reads 16 u8 as one uint4 and writes 16 bf16 as two uint4, neighbouring
// threads on neighbouring addresses.  Each block reads its own idx[b]; the
// TPU's scalar prefetch and its [R, 8, F/8] tiling view have no counterpart
// here.  When F % 16 != 0 or a base pointer is not 16-byte aligned the
// kernel takes a scalar loop instead.  Indices are assumed in [0, R), as in
// the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // bytes of u8 input per thread per iteration

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

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int ts_gather_rows_cast(const uint8_t* storage, const int64_t* idx,
                        __nv_bfloat16* out, int64_t R, int64_t F, int64_t B,
                        cudaStream_t stream) {
  (void)R;  // rows are not bound-checked, as in the TPU kernel
  if (B <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (B > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);  // grid.x limit
  // The kernel strides over a row, so grid.y may stop at its hardware limit.
  const int64_t chunks = (F + kThreads * kVec - 1) / (kThreads * kVec);
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>(chunks < 65535 ? chunks : 65535));
  const bool aligned = F % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(storage) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    gather_rows_cast_kernel<true><<<grid, kThreads, 0, stream>>>(storage, idx, out, F);
  } else {
    gather_rows_cast_kernel<false><<<grid, kThreads, 0, stream>>>(storage, idx, out, F);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
