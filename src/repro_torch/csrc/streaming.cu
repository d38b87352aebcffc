// Streaming fused scan: distance + row masking + top-k in one pass over the
// rows, never writing the (B, N) score matrix.
//
// Replaces src/repro/kernels/streaming/kernel.py:streaming_kernel (row
// tiles streamed through VMEM in grid order, each folded into one revisited
// (bm, k) buffer, with an optional delta second row source whose ids are
// offset by the padded base rows). A serving group holds 1-64 queries over
// 1e6 rows of width 128-1024 (0.5-4 GB). Each row element read (4 bytes)
// feeds 2 * B flops against an H100 FP32 ridge of about 20 flops a byte, so
// at B = 1 the least time is reading the rows once, and at B = 64 it is the
// FP32 operations. This first version is further from both: each 8-query
// tile (grid.y = ceil(B / 8)) re-reads every row, 8 times at B = 64, and
// each block bitonic-sorts its 1024 keys per query in shared memory.
//
// Design for the card rather than the TPU grid: the ROW axis is split across
// blocks, because a plan group rarely has more than a few queries and one
// block per query tile would leave most of the 132 SMs idle. Block
// (chunk, query tile) scores MINT_CHUNK rows for 8 queries: 128-row x 32-dim
// tiles of the rows are staged through shared memory, each thread owns one
// row and 4 queries, and sums q.x in index order with FP32 FMA (no TF32, the
// same order as the distance kernel). The epilogue applies the metric, the
// row mask (past valid_n, dead, not kept) and packs (score, id) keys into
// shared memory; the block bitonic-sorts each query's keys and writes its
// best min(k, chunk). The merge pass in select.cu folds the partial lists
// in a fixed order, so the result never depends on block scheduling. Wider
// query tiles (one read of the rows for all 64 queries) and a threshold
// pass before the sort are the next steps against the re-reads and the sort.
#include "select.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QT = 8;     // queries per block
constexpr int RT = 128;   // rows per staged tile (one per thread column)
constexpr int KT = 32;    // feature dims per staged tile
constexpr int QPT = QT * RT / THREADS;  // queries per thread
constexpr size_t SMEM = (size_t)QT * MINT_CHUNK * sizeof(u64) +
                        (size_t)RT * (KT + 1) * sizeof(float) +
                        (size_t)QT * KT * sizeof(float);

struct Source {
  const void* rows;
  const float* sq;
  const uint8_t* dead;
  const uint8_t* keep;
  int n, valid, id_offset;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
streaming_chunk_kernel(const T* __restrict__ q, const float* __restrict__ qsq,
                       Source base, Source delta, int n_base_chunks, int B, int d,
                       int metric, int P, int Lc, u64* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  float* xs = reinterpret_cast<float*>(keys + QT * MINT_CHUNK);
  float* qs = xs + RT * (KT + 1);

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const bool in_base = chunk < n_base_chunks;
  const Source src = in_base ? base : delta;
  const T* rows = static_cast<const T*>(src.rows);
  const int row0 = (in_base ? chunk : chunk - n_base_chunks) * MINT_CHUNK;
  const int t = threadIdx.x;
  const int r = t % RT;
  const int qg = t / RT;

  for (int sub = 0; sub < MINT_CHUNK / RT; ++sub) {
    const int rbase = row0 + sub * RT;  // uniform across the block
    u64* kout = keys + sub * RT + r;
    if (rbase >= src.n) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) kout[(size_t)(qg * QPT + j) * MINT_CHUNK] = 0ull;
      continue;
    }
    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KT) {
      __syncthreads();
      for (int e = t; e < RT * KT; e += THREADS) {
        const int rr = e / KT, cc = e % KT;
        const int gr = rbase + rr, gc = k0 + cc;
        xs[rr * (KT + 1) + cc] =
            (gr < src.n && gc < d) ? to_f(rows[(size_t)gr * d + gc]) : 0.f;
      }
      for (int e = t; e < QT * KT; e += THREADS) {
        const int qq = e / KT, cc = e % KT;
        const int gq = q0 + qq, gc = k0 + cc;
        qs[qq * KT + cc] = (gq < B && gc < d) ? to_f(q[(size_t)gq * d + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < KT; ++cc) {
        const float x = xs[r * (KT + 1) + cc];
#pragma unroll
        for (int j = 0; j < QPT; ++j)
          acc[j] = fmaf(qs[(qg * QPT + j) * KT + cc], x, acc[j]);
      }
    }
    const int row = rbase + r;
    const bool live = row < src.n && row < src.valid &&
                      !(src.dead && src.dead[row]) && (!src.keep || src.keep[row]);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int gq = q0 + qg * QPT + j;
      u64 key = 0ull;
      if (live && gq < B) {
        const float s = metric_epilogue(metric, acc[j], qsq ? qsq[gq] : 0.f,
                                        src.sq ? src.sq[row] : 0.f);
        key = make_key(s, src.id_offset + row);
      }
      kout[(size_t)(qg * QPT + j) * MINT_CHUNK] = key;
    }
  }

  // only the tile's real queries are sorted (a B = 1 scan sorts one row)
  bitonic_sort_desc(keys, min(QT, B - q0), MINT_CHUNK);
  for (int e = t; e < QT * Lc; e += THREADS) {
    const int qq = e / Lc, i = e % Lc;
    const int gq = q0 + qq;
    if (gq < B) out[((size_t)gq * P + chunk) * Lc + i] = keys[(size_t)qq * MINT_CHUNK + i];
  }
}

template <typename T>
cudaError_t launch(const void* q, const float* qsq, Source base, Source delta,
                   int n_base_chunks, int B, int d, int metric, int P, int Lc, u64* a,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      streaming_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(P, (B + QT - 1) / QT);
  streaming_chunk_kernel<T><<<grid, THREADS, SMEM, s>>>(
      (const T*)q, qsq, base, delta, n_base_chunks, B, d, metric, P, Lc, a);
  return cudaGetLastError();
}

}  // namespace

// Rows: base (Nb, d) and an optional delta (Nd, d) in the queries' dtype.
// Masks are uint8 per row or null; sq are squared row norms for cosine and
// l2 (null for dot). Delta ids are delta_id_offset + row. P is the number of
// chunks over both sources and Lc = min(k, MINT_CHUNK).
extern "C" int mint_streaming_scan(
    const void* q, const void* base, const void* delta, const void* qsq,
    const void* bsq, const void* dsq, const void* bdead, const void* bkeep,
    const void* ddead, const void* dkeep, int B, int d, int Nb, int nb_valid, int Nd,
    int nd_valid, int delta_id_offset, int k, int P, int Lc, int metric, int dtype,
    void* scratch_a, void* scratch_b, void* vals, void* ids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Source sb = {base, (const float*)bsq, (const uint8_t*)bdead,
                     (const uint8_t*)bkeep, Nb, nb_valid, 0};
  const Source sd = {delta, (const float*)dsq, (const uint8_t*)ddead,
                     (const uint8_t*)dkeep, Nd, nd_valid, delta_id_offset};
  const int n_base_chunks = (Nb + MINT_CHUNK - 1) / MINT_CHUNK;
  const float* qs = (const float*)qsq;
  u64* a = (u64*)scratch_a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32:
      err = launch<float>(q, qs, sb, sd, n_base_chunks, B, d, metric, P, Lc, a, s);
      break;
    case DTYPE_BF16:
      err = launch<__nv_bfloat16>(q, qs, sb, sd, n_base_chunks, B, d, metric, P, Lc, a, s);
      break;
    case DTYPE_F16:
      err = launch<__half>(q, qs, sb, sd, n_base_chunks, B, d, metric, P, Lc, a, s);
      break;
  }
  if (err != cudaSuccess) return err;
  return mint_merge_finalize(a, (u64*)scratch_b, B, P, Lc, k, (float*)vals, (int*)ids,
                             s);
}
