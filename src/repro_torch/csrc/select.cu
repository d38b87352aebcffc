// Merge of per-block partial top-k lists, shared by the streaming scan
// and the top-k kernel.
//
// Replaces the cross-grid-step carry of the TPU kernels: on the TPU one
// (bm, k) buffer is revisited by every sequential row tile; on Hopper the
// row tiles run as independent blocks, each leaving a sorted partial list,
// and this pass folds them. Each round folds groups of F lists (F from
// kernels/common.py: merge_fan_in -- 8 for small lists, so a B = 1 scan's
// 261 lists take 3 launches, 2 for large ones, where each key's F - 1
// binary searches would cost more than the launches saved): every key
// finds its rank in its group's union, so a round is one launch with no
// atomics and a fixed result. Bound: the partial-list bytes.
#include "select.cuh"

// Count of keys in the descending list `l` of length n that are > a
// (strict) or >= a: the first position whose key is <= a (or < a).
__device__ __forceinline__ int count_above(const u64* l, int n, u64 a, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (or_equal ? l[mid] >= a : l[mid] > a) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One round: groups of F lists of length L fold into lists of L2 keys.
// Each key finds its rank in its group's union -- its own position plus
// the keys above it in the other lists (equal keys, which only the empty
// key 0 can have, go to the earlier list) -- so the ranks are a
// permutation and each output slot is written once; slots past the
// group's key count are zero.
__global__ void merge_rank_kernel(const u64* __restrict__ in, int B, int P, int L,
                                  u64* __restrict__ out, int P2, int L2, int F) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < (size_t)B * P2 * L2) {
    const int s = (int)(tid % L2), g = (int)((tid / L2) % P2);
    if (s >= min(F, P - g * F) * L) out[tid] = 0ull;
  }
  if (tid >= (size_t)B * P * L) return;
  const int i = (int)(tid % L), p = (int)((tid / L) % P), b = (int)(tid / ((size_t)L * P));
  const int g = p / F, q1 = min(g * F + F, P);
  const u64 a = in[tid];
  int rank = i;
  for (int q = g * F; q < q1; ++q)
    if (q != p) rank += count_above(in + ((size_t)b * P + q) * L, L, a, q < p);
  if (rank < L2) out[((size_t)b * P2 + g) * L2 + rank] = a;
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

cudaError_t mint_merge_finalize(u64* a, u64* b, int B, int P, int L, int k, int F,
                                float* vals, int* ids, cudaStream_t stream) {
  const int threads = 256;
  if (F < 2) return cudaErrorInvalidValue;
  u64* cur = a;
  u64* nxt = b;
  while (P > 1) {
    const int P2 = (P + F - 1) / F;
    const int L2 = min(k, F * L);
    const size_t total = max((size_t)B * P * L, (size_t)B * P2 * L2);
    merge_rank_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
        cur, B, P, L, nxt, P2, L2, F);
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
