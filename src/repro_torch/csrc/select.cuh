// Shared pieces of the scan, distance and top-k kernels: input loads,
// the metric epilogue, the (score, id) sort key, the in-block bitonic sort
// and the host-side merge of per-block partial top-k lists.
//
// Selection order (the repo's canonical tie-break): score descending, then
// id ascending. A (score, id) pair packs into one 64-bit key whose unsigned
// order is exactly that order, so sorting and merging compare integers and
// never see a tie. Key 0 is the empty slot: masked rows, padding, and any
// score not strictly above NEG_INF (the reference's buffer starts at NEG_INF
// and only admits strict improvements). It decodes to (NEG_INF, id 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MINT_CHUNK 1024          // rows (columns) one block sorts
#define MINT_NEG_INF (-3.0e38f)

typedef unsigned long long u64;

enum { METRIC_DOT = 0, METRIC_COSINE = 1, METRIC_L2 = 2 };
enum { DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_F16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// metric epilogue: the reference's formulas (norms clamped at 1e-24 under
// the square root for cosine; -L2^2 = -(|q|^2 - 2 q.x + |x|^2))
__device__ __forceinline__ float metric_epilogue(int metric, float acc, float qsq,
                                                 float xsq) {
  if (metric == METRIC_COSINE)
    return acc / (sqrtf(fmaxf(qsq, 1e-24f)) * sqrtf(fmaxf(xsq, 1e-24f)));
  if (metric == METRIC_L2) return -(qsq - 2.0f * acc + xsq);
  return acc;
}

__device__ __forceinline__ uint32_t order_bits(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(uint32_t o) {
  uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 make_key(float s, int id) {
  if (!(s > MINT_NEG_INF)) return 0ull;
  return ((u64)order_bits(s) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)id);
}

// Sort `rows` independent rows of n keys (n a power of two) held in shared
// memory, each descending. All threads of the block must call it.
__device__ __forceinline__ void bitonic_sort_desc(u64* keys, int rows, int n) {
  const int half = n >> 1;
  const int pairs = rows * half;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int r = p / half;
        const int j = p - r * half;
        const int i = 2 * stride * (j / stride) + (j % stride);
        u64* row = keys + (size_t)r * n;
        const u64 a = row[i], b = row[i + stride];
        const bool desc = (i & size) == 0;
        if (desc ? (a < b) : (a > b)) {
          row[i] = b;
          row[i + stride] = a;
        }
      }
    }
  }
  __syncthreads();
}

// Merge the B x P sorted partial lists of length L in `a` (F lists a
// round, `b` as the ping-pong buffer) down to one list of k keys per query,
// then decode it into (vals, ids). Returns the first CUDA error.
cudaError_t mint_merge_finalize(u64* a, u64* b, int B, int P, int L, int k, int F,
                                float* vals, int* ids, cudaStream_t stream);
