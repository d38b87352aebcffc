// Top-k over a (B, N) score matrix -> (B, k) f32 values and int32 ids,
// best first, ties by ascending id.
//
// Replaces src/repro/kernels/topk/kernel.py:_topk_kernel (a sequential fold
// over column tiles into one revisited (bm, k) buffer, then an ordering
// pass). Bound: reading the B * N scores once. On the two-pass scan path it
// runs at B <= 64 over up to 1e6 columns.
//
// Design: the streaming scan's selection without the product.
// - Block (column range, row) walks `cols` contiguous columns of one row
//   (the grid comes from kernels/topk/kernel.py: topk_grid, about two
//   blocks per SM over the whole call), reading the scores with VB-byte
//   loads (16 where the rows allow; 8, 4 or 2 for f16 / bf16 rows of odd
//   N), 64 bytes a thread in flight: the next tile's loads are issued
//   before this tile's keys are judged. Two 8-warp blocks an SM.
// - The block keeps its best Lpad keys sorted in shared memory; the Lc-th is
//   the threshold. A key that does not beat it is dropped in registers,
//   survivors are appended by warp ballot and one shared atomic a warp, and
//   a full buffer is sorted and merged into the list (select.cuh:
//   append_above, flush_lists -- the scan's code). With random scores about
//   k (1 + ln(cols / k)) keys of a block's columns survive; scores that rise
//   along the row make every key a survivor, the slow but exact worst case.
// - Before the first tile's keys are judged, each thread's best key of that
//   tile seeds the list, so the threshold starts near the top Lc of the
//   tile instead of at the empty list's (which every key beats): without
//   the seeds each block flushed its whole first tile, 16 times at cap 256.
// - Each block writes its sorted best Lc = min(k, cols) keys; select.cu's
//   rank merge folds the S lists of a row (one round at fan-in 8 for
//   B = 64, S = 4).
#include "select.cuh"
#include "stage.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BUF_BYTES = 64;  // bytes of scores a thread has in flight, per buffer
constexpr int SMEM_MAX = 232448;

// VB bytes of scores, loaded with one streaming (evict-first) load
template <int VB> struct Piece;
template <> struct Piece<16> { uint4 r; };
template <> struct Piece<8> { uint2 r; };
template <> struct Piece<4> { unsigned int r; };
template <> struct Piece<2> { unsigned short r; };

template <int VB>
__device__ __forceinline__ Piece<VB> load_piece(const char* p) {
  using R = decltype(Piece<VB>::r);
  return Piece<VB>{__ldcs(reinterpret_cast<const R*>(p))};
}

// the piece zero-extended to 16 bytes, for stage.cuh: lane_val
__device__ __forceinline__ uint4 widen(const Piece<16>& p) { return p.r; }
__device__ __forceinline__ uint4 widen(const Piece<8>& p) {
  return make_uint4(p.r.x, p.r.y, 0u, 0u);
}
__device__ __forceinline__ uint4 widen(const Piece<4>& p) { return make_uint4(p.r, 0u, 0u, 0u); }
__device__ __forceinline__ uint4 widen(const Piece<2>& p) { return make_uint4(p.r, 0u, 0u, 0u); }

template <typename T, int VB>
__global__ void __launch_bounds__(THREADS, 2)
topk_select_kernel(const T* __restrict__ scores, int N, int cols, int S, int Lc, int Lpad,
                   int cap, u64* __restrict__ out) {
  constexpr int V = VB / (int)sizeof(T);  // scores a load
  constexpr int UNROLL = BUF_BYTES / VB;  // loads a buffer
  constexpr int TILE = THREADS * UNROLL * V;
  static_assert(UNROLL * V <= 64, "pending bits");
  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem);  // [Lpad]
  u64* cand = list + Lpad;                   // [cap]
  int* cnt = reinterpret_cast<int*>(cand + cap);

  const int blk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int c0 = blk * cols, c1 = min(c0 + cols, N);
  const char* row = reinterpret_cast<const char*>(scores + (size_t)b * N);
  for (int e = tid; e < Lpad; e += THREADS) list[e] = 0ull;
  if (tid == 0) *cnt = 0;
  __syncthreads();

  auto load = [&](Piece<VB> (&r)[UNROLL], int t0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int col = t0 + (u * THREADS + tid) * V;
      if (col < c1) r[u] = load_piece<VB>(row + (size_t)col * sizeof(T));
    }
  };

  u64 thr = 0ull;
  Piece<VB> cur[UNROLL], nxt[UNROLL];
  load(cur, c0);
  for (int t0 = c0; t0 < c1; t0 += TILE) {
    if (t0 + TILE < c1) load(nxt, t0 + TILE);
    unsigned long long pend = 0ull;
    bool first = true;
    if (t0 == c0) {
      // Seed the list with each thread's best key of the first tile, so the
      // threshold is already high when the tile's other keys are judged
      // (against the empty list every key of the first tile would survive
      // and be sorted in). The THREADS seeds fit the empty buffer (cap >=
      // THREADS); each thread then offers its other keys.
      u64 best = 0ull;
      int best_bit = 0;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int col = t0 + (u * THREADS + tid) * V + v;
          const u64 key = col < c1
              ? make_key(lane_val(widen(cur[u]), v, static_cast<const T*>(nullptr)), col)
              : 0ull;
          if (key > best) {
            best = key;
            best_bit = u * V + v;
          }
        }
      }
      append_above(best, 0ull, cand, cnt, cap, lane);
      __syncthreads();
      flush_lists<1, THREADS>(list, cand, cnt, Lpad, cap);
      thr = list[Lc - 1];
      first = false;
      pend = ~(1ull << best_bit);
    }
    while (true) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int bit = u * V + v;
          const int col = t0 + (u * THREADS + tid) * V + v;
          u64 key = 0ull;
          if (col < c1 && (first || ((pend >> bit) & 1ull)))
            key = make_key(lane_val(widen(cur[u]), v, static_cast<const T*>(nullptr)), col);
          if (append_above(key, thr, cand, cnt, cap, lane))
            pend |= 1ull << bit;
          else
            pend &= ~(1ull << bit);
        }
      }
      __syncthreads();
      if (!__syncthreads_or(tid == 0 && *cnt >= cap)) break;
      flush_lists<1, THREADS>(list, cand, cnt, Lpad, cap);
      thr = list[Lc - 1];
      first = false;
      if (!__syncthreads_or(pend != 0ull)) break;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
  }

  __syncthreads();
  if (__syncthreads_or(tid == 0 && *cnt > 0))
    flush_lists<1, THREADS>(list, cand, cnt, Lpad, cap);
  u64* dst = out + ((size_t)b * S + blk) * Lc;
  for (int i = tid; i < Lc; i += THREADS) dst[i] = list[i];
}

template <typename T, int VB>
cudaError_t launch_vb(const void* scores, int B, int N, int cols, int S, int Lc, int Lpad,
                      int cap, u64* a, cudaStream_t s) {
  const size_t smem = (size_t)(Lpad + cap) * sizeof(u64) + 16;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel<T, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_select_kernel<T, VB><<<dim3(S, B), THREADS, smem, s>>>(
      (const T*)scores, N, cols, S, Lc, Lpad, cap, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int vb, const void* scores, int B, int N, int cols, int S, int Lc,
                   int Lpad, int cap, u64* a, cudaStream_t s) {
  switch (vb) {
    case 16: return launch_vb<T, 16>(scores, B, N, cols, S, Lc, Lpad, cap, a, s);
    case 8: return launch_vb<T, 8>(scores, B, N, cols, S, Lc, Lpad, cap, a, s);
    case 4: return launch_vb<T, 4>(scores, B, N, cols, S, Lc, Lpad, cap, a, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vb<T, 2>(scores, B, N, cols, S, Lc, Lpad, cap, a, s);
  }
  return cudaErrorInvalidValue;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// The grid (cols, S, Lc, Lpad, cap) comes from kernels/topk/kernel.py:
// topk_grid; vb is the byte width of the score loads (16, 8, 4 or 2, at
// least one score) and fan_in the merge's (kernels/common.py:
// merge_fan_in). The wrapper sizes the two scratch buffers for every merge
// round.
extern "C" int mint_topk_scores(const void* scores, int B, int N, int k, int cols, int S,
                                int Lc, int Lpad, int cap, int vb, int fan_in, int dtype,
                                void* scratch_a, void* scratch_b, void* vals, void* ids,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!pow2(Lpad) || !pow2(cap) || cap > Lpad || cap < THREADS || Lc > Lpad || Lc < 1 ||
      cols % 8)
    return cudaErrorInvalidValue;
  u64* a = (u64*)scratch_a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32: err = launch<float>(vb, scores, B, N, cols, S, Lc, Lpad, cap, a, s); break;
    case DTYPE_BF16:
      err = launch<__nv_bfloat16>(vb, scores, B, N, cols, S, Lc, Lpad, cap, a, s);
      break;
    case DTYPE_F16: err = launch<__half>(vb, scores, B, N, cols, S, Lc, Lpad, cap, a, s); break;
  }
  if (err != cudaSuccess) return err;
  return mint_merge_finalize(a, (u64*)scratch_b, B, S, Lc, k, fan_in, (float*)vals,
                             (int*)ids, s);
}
