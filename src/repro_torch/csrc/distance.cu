// Batched distance kernel: (B, d) queries x (N, d) rows -> (B, N) f32 scores.
//
// Replaces src/repro/kernels/distance/kernel.py:_distance_kernel (the
// K-blocked MXU product with a dot / cosine / -L2^2 epilogue on the last K
// step). On the main path it scores IVF centroids (B <= 64 queries against
// ~1e3 centroids of padded width 128), the rerank over a group's candidate
// union (up to ~1e6 rows of width 128-1024) and the two-pass flat scan.
// What limits it on an H100 depends on B: each row element read (4 bytes)
// feeds 2 * B flops, and the card's FP32 ridge is about 67e12 / 3.35e12 =
// 20 flops a byte. At B = 64 that is 32 flops a byte, so the kernel is
// limited by FP32 operations; at B of a few queries it is limited by reading
// the rows.
//
// Design: a shared-memory-tiled FP32 GEMM, 64 x 64 output tile per block,
// 256 threads each owning a 4 x 4 micro-tile, K in steps of 16 staged
// through shared memory. The register micro-tile gives 16 FMAs per 8
// shared-memory loads, and each row tile is read from global memory once
// per 64 queries, so at B <= 64 every row is read once. Plain FP32 FMA, no
// tensor cores and no TF32 (tensor cores would lift the operation limit; a
// later step): the product over d is summed in index order, the same order
// as the streaming scan, so the two-pass and one-pass scans score rows
// bit-identically.
#include "select.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
distance_kernel(const T* __restrict__ q, const T* __restrict__ db,
                const float* __restrict__ qsq, const float* __restrict__ dbsq,
                float* __restrict__ out, int B, int N, int d, int metric) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int rr = e / BK, cc = e % BK;
      const int gc = k0 + cc;
      const int gq = m0 + rr, gn = n0 + rr;
      As[cc][rr] = (gq < B && gc < d) ? to_f(q[(size_t)gq * d + gc]) : 0.f;
      Bs[cc][rr] = (gn < N && gc < d) ? to_f(db[(size_t)gn * d + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = m0 + ty * 4 + i;
    if (gq >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      const float qs = qsq ? qsq[gq] : 0.f;
      const float xs = dbsq ? dbsq[gn] : 0.f;
      out[(size_t)gq * N + gn] = metric_epilogue(metric, acc[i][j], qs, xs);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* db, const float* qsq, const float* dbsq,
                   float* out, int B, int N, int d, int metric, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  distance_kernel<T><<<grid, THREADS, 0, s>>>((const T*)q, (const T*)db, qsq, dbsq,
                                              out, B, N, d, metric);
  return cudaGetLastError();
}

}  // namespace

// qsq / dbsq are the squared norms for cosine and l2 (null for dot).
extern "C" int mint_batched_scores(const void* q, const void* db, const void* qsq,
                                   const void* dbsq, void* out, int B, int N, int d,
                                   int metric, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* qs = (const float*)qsq;
  const float* ds = (const float*)dbsq;
  float* o = (float*)out;
  switch (dtype) {
    case DTYPE_F32: return launch<float>(q, db, qs, ds, o, B, N, d, metric, s);
    case DTYPE_BF16: return launch<__nv_bfloat16>(q, db, qs, ds, o, B, N, d, metric, s);
    case DTYPE_F16: return launch<__half>(q, db, qs, ds, o, B, N, d, metric, s);
  }
  return cudaErrorInvalidValue;
}
