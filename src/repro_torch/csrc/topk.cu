// Top-k over a (B, N) score matrix -> (B, k) f32 values and int32 ids,
// best first, ties by ascending id.
//
// Replaces src/repro/kernels/topk/kernel.py:_topk_kernel (a sequential fold
// over column tiles into one revisited (bm, k) buffer, then an ordering
// pass). Bound: reading the B * N scores once. On the two-pass scan path it
// runs at B <= 64 over up to 1e6 columns. This first version is limited by
// the in-block bitonic sort of 1024 keys (55 compare passes over shared
// memory), not by the read; a threshold pass before the sort would cut it.
//
// Design: the columns are split across blocks instead of folded in order.
// Block (chunk, row) turns MINT_CHUNK scores into sort keys in shared
// memory, bitonic-sorts them, and writes its best min(k, chunk) keys; the
// merge pass in select.cu folds the partial lists pairwise in a fixed order.
// So every SM has work at B = 1, and no atomics decide the selection.
#include "select.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_chunk_kernel(const T* __restrict__ scores, int N, int P, int Lc,
                  u64* __restrict__ out) {
  __shared__ u64 keys[MINT_CHUNK];
  const int chunk = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < MINT_CHUNK; i += THREADS) {
    const int col = chunk * MINT_CHUNK + i;
    keys[i] = col < N ? make_key(to_f(scores[(size_t)b * N + col]), col) : 0ull;
  }
  bitonic_sort_desc(keys, 1, MINT_CHUNK);
  u64* dst = out + ((size_t)b * P + chunk) * Lc;
  for (int i = threadIdx.x; i < Lc; i += THREADS) dst[i] = keys[i];
}

template <typename T>
cudaError_t launch(const void* scores, int B, int N, int P, int Lc, u64* a,
                   cudaStream_t s) {
  topk_chunk_kernel<T><<<dim3(P, B), THREADS, 0, s>>>((const T*)scores, N, P, Lc, a);
  return cudaGetLastError();
}

}  // namespace

// P = ceil(N / MINT_CHUNK) and Lc = min(k, MINT_CHUNK), computed by the
// wrapper, which sizes the two scratch buffers for every merge round.
extern "C" int mint_topk_scores(const void* scores, int B, int N, int k, int P,
                                int Lc, int dtype, void* scratch_a, void* scratch_b,
                                void* vals, void* ids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  u64* a = (u64*)scratch_a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32: err = launch<float>(scores, B, N, P, Lc, a, s); break;
    case DTYPE_BF16: err = launch<__nv_bfloat16>(scores, B, N, P, Lc, a, s); break;
    case DTYPE_F16: err = launch<__half>(scores, B, N, P, Lc, a, s); break;
  }
  if (err != cudaSuccess) return err;
  return mint_merge_finalize(a, (u64*)scratch_b, B, P, Lc, k, (float*)vals,
                             (int*)ids, s);
}
