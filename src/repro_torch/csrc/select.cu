// Merge of per-block partial top-k lists, shared by the streaming scan
// and the top-k kernel.
//
// Replaces the cross-grid-step carry of the TPU kernels: on the TPU one
// (bm, k) buffer is revisited by every sequential row tile; on Hopper the
// row tiles run as independent blocks, each leaving a sorted partial list,
// and this pass folds them. Each round merges list pairs by merge path: one
// thread per output slot binary-searches its split point, so a round is one
// launch with no atomics and a fixed result. Bound: the partial-list bytes,
// B * P * min(k, chunk) * 8 read and written per round, halving P.
#include "select.cuh"

__global__ void merge_pairs_kernel(const u64* __restrict__ in, int B, int P, int L,
                                   u64* __restrict__ out, int P2, int L2) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * P2 * L2;
  if (tid >= total) return;
  const int i = (int)(tid % L2);
  const size_t rest = tid / L2;
  const int j = (int)(rest % P2);
  const int b = (int)(rest / P2);
  const u64* A = in + ((size_t)b * P + 2 * j) * L;
  const u64* Bl = A + L;
  const int La = L;
  const int Lb = (2 * j + 1 < P) ? L : 0;
  u64 v = 0ull;
  if (i < La + Lb) {
    int lo = max(0, i - Lb), hi = min(i, La);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A[mid] >= Bl[i - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    const int ia = lo, ib = i - lo;
    if (ib >= Lb) v = A[ia];
    else if (ia >= La) v = Bl[ib];
    else v = (A[ia] >= Bl[ib]) ? A[ia] : Bl[ib];
  }
  out[((size_t)b * P2 + j) * L2 + i] = v;
}

__global__ void finalize_kernel(const u64* __restrict__ keys, int B, int L, int k,
                                float* __restrict__ vals, int* __restrict__ ids) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (size_t)B * k) return;
  const int b = (int)(tid / k), i = (int)(tid % k);
  const u64 key = keys[(size_t)b * L + i];
  if (key == 0ull) {
    vals[tid] = MINT_NEG_INF;
    ids[tid] = 0;
  } else {
    vals[tid] = unorder_bits((uint32_t)(key >> 32));
    ids[tid] = (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
  }
}

cudaError_t mint_merge_finalize(u64* a, u64* b, int B, int P, int L, int k,
                                float* vals, int* ids, cudaStream_t stream) {
  const int threads = 256;
  u64* cur = a;
  u64* nxt = b;
  while (P > 1) {
    const int P2 = (P + 1) / 2;
    const int L2 = min(k, 2 * L);
    const size_t total = (size_t)B * P2 * L2;
    merge_pairs_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                         stream>>>(cur, B, P, L, nxt, P2, L2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    u64* t = cur;
    cur = nxt;
    nxt = t;
    P = P2;
    L = L2;
  }
  if (L < k) return cudaErrorInvalidValue;  // the lists never reached k slots
  const size_t total = (size_t)B * k;
  finalize_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    stream>>>(cur, B, L, k, vals, ids);
  return cudaGetLastError();
}

extern "C" const char* mint_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int mint_chunk_rows() { return MINT_CHUNK; }
