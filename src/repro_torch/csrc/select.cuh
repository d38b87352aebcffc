// Shared pieces of the scan, distance and top-k kernels: input loads,
// the metric epilogue, the (score, id) sort key, threshold selection into
// per-block sorted lists and the host-side merge of those partial lists.
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

// Threshold selection, shared by the streaming scan and the top-k kernel.
// A block keeps, per list r, its best Lpad keys sorted descending in
// list[r * Lpad ..] and a candidate buffer of cap keys (both powers of two,
// cap <= Lpad) with a count. A key that does not beat the list's threshold
// (its Lc-th key) is dropped in registers; survivors are appended by
// `append_above`, and `flush_lists` folds full buffers into the lists,
// which raises the thresholds. Exact: keys are totally ordered, so neither
// the order of appends nor block scheduling changes what a list keeps.

// Warp-wide (all lanes call it, with one list per warp): lanes whose key
// beats thr append it to the buffer `cand` of `cap` keys, one shared atomic
// per warp. Returns true where a lane's key passed but found the buffer
// full; the caller keeps that key pending and offers it again after a flush.
__device__ __forceinline__ bool append_above(u64 key, u64 thr, u64* cand, int* cnt,
                                             int cap, int lane) {
  const bool pass = key > thr;
  const unsigned m = __ballot_sync(0xffffffffu, pass);
  if (m == 0u) return false;
  const int leader = __ffs(m) - 1;
  int slot0 = 0;
  if (lane == leader) slot0 = atomicAdd(cnt, __popc(m));
  const int slot = __shfl_sync(0xffffffffu, slot0, leader) + __popc(m & ((1u << lane) - 1u));
  if (pass && slot < cap) {
    cand[slot] = key;
    return false;
  }
  return pass;
}

// One compare-exchange step of a bitonic network over keys held one a
// thread (thread t holds key t of `buf`'s n = ROWS x row-length keys): the
// partner t ^ stride by a warp shuffle below 32, else through `buf` (two
// barriers). Thread t keeps the larger key where it is the lower index of a
// descending pair (or the upper of an ascending one). Block-wide.
__device__ __forceinline__ u64 bitonic_exchange(u64 v, int t, int n, int stride, bool desc,
                                                u64* buf) {
  u64 w;
  if (stride >= 32) {
    if (t < n) buf[t] = v;
    __syncthreads();
    w = t < n ? buf[t ^ stride] : 0ull;
    __syncthreads();
  } else {
    w = __shfl_xor_sync(0xffffffffu, v, stride);
  }
  const bool keep_max = ((t & stride) == 0) == desc;
  return keep_max ? (v > w ? v : w) : (v < w ? v : w);
}

// Fold every non-empty candidate buffer of the ROWS lists into its sorted
// list: sort the buffer (descending), take max(list[i], buf[Lpad-1-i]) -- a
// bitonic sequence holding the best Lpad of both -- and bitonic-merge it.
// Block-wide: all THREADS threads call it; counts end at 0. Where the
// buffers (or the lists) hold at most one key a thread, the network runs in
// registers, with shuffles for strides under 32 and a shared exchange (two
// barriers) above; else one shared pass and barrier per stride.
template <int ROWS, int THREADS>
__device__ void flush_lists(u64* list, u64* cand, int* cnt, int Lpad, int cap) {
  const int lc = __ffs(cap) - 1, ll = __ffs(Lpad) - 1, t = threadIdx.x;
  if (ROWS * cap <= THREADS) {
    const int n = ROWS * cap, r = t >> lc, e = t & (cap - 1);
    u64 v = (t < n && e < cnt[r]) ? cand[t] : 0ull;
    for (int size = 2; size <= cap; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        v = bitonic_exchange(v, t, n, stride, (e & size) == 0, cand);
    if (t < n) {
      u64* dst = list + (r << ll) + Lpad - 1 - e;
      if (v > *dst) *dst = v;
    }
  } else {
    for (int e = t; e < ROWS * cap; e += THREADS)
      if ((e & (cap - 1)) >= cnt[e >> lc]) cand[e] = 0ull;
    __syncthreads();
    for (int size = 2; size <= cap; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = t; p < ROWS * cap / 2; p += THREADS) {
          const int r = p >> (lc - 1), j = p & (cap / 2 - 1);
          if (cnt[r] == 0) continue;
          const int i = 2 * stride * (j / stride) + (j % stride);
          u64* row = cand + (r << lc);
          const u64 a = row[i], b = row[i + stride];
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            row[i] = b;
            row[i + stride] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int e = t; e < ROWS * cap; e += THREADS) {
      const int r = e >> lc, i = e & (cap - 1);
      if (cnt[r] == 0) continue;
      u64* dst = list + (r << ll) + Lpad - cap + i;
      const u64 c = cand[(r << lc) + cap - 1 - i];
      if (c > *dst) *dst = c;
    }
  }
  __syncthreads();
  if (ROWS * Lpad <= THREADS) {
    const int n = ROWS * Lpad;
    u64 v = t < n ? list[t] : 0ull;
    for (int stride = Lpad >> 1; stride > 0; stride >>= 1)
      v = bitonic_exchange(v, t, n, stride, true, list);
    if (t < n) list[t] = v;
  } else {
    for (int stride = Lpad >> 1; stride > 0; stride >>= 1) {
      for (int p = t; p < ROWS * Lpad / 2; p += THREADS) {
        const int r = p >> (ll - 1), j = p & (Lpad / 2 - 1);
        if (cnt[r] == 0) continue;
        const int i = 2 * stride * (j / stride) + (j % stride);
        u64* row = list + (r << ll);
        const u64 a = row[i], b = row[i + stride];
        if (a < b) {
          row[i] = b;
          row[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int e = t; e < ROWS; e += THREADS) cnt[e] = 0;
  __syncthreads();
}

// Merge the B x P sorted partial lists of length L in `a` (F lists a
// round, `b` as the ping-pong buffer) down to one list of k keys per query,
// then decode it into (vals, ids). Returns the first CUDA error.
cudaError_t mint_merge_finalize(u64* a, u64* b, int B, int P, int L, int k, int F,
                                float* vals, int* ids, cudaStream_t stream);
