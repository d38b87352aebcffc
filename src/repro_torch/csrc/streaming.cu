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
// FP32 operations (67 TFLOP/s outside the tensor cores).
//
// Contract that shapes the design: every score is FP32 FMA over d in index
// order from 0, one accumulator per (query, row), d never split -- the order
// of csrc/distance.cu -- so the one-pass and two-pass scans give identical
// ids. Hence no tensor cores and no TF32 for the product.
//
// Design for the card:
// - One read of each row for a whole query tile. Block (row range, query
//   tile) walks a contiguous range of `rb` rows (one block per SM per
//   query tile: the grid is computed in kernels/streaming/kernel.py:
//   scan_grid) in 256-row tiles. A query tile holds up to 64 queries
//   (QT in {64, 16, 4, 1}, chosen by B and by k), so at B <= 64 each row is
//   read from device memory once.
// - SGEMM-style register micro-tiles: at QT = 64, 512 threads each own 8
//   queries x 4 rows (32 accumulators); below, 256 threads. Per 16-byte
//   slice of the d axis a thread issues one 16-byte shared load per row,
//   and per d step two broadcast 16-byte loads of the queries: 6 shared
//   loads per 32 FMAs at QT = 64.
// - Row tiles (128 bytes of each row per k step, 256 at QT = 1; the
//   queries as a pre-transposed (d, B) f32 block) are staged through shared
//   memory by cp.async in two stages, so the next step's copy overlaps this
//   step's FMAs. 16-byte copies where the row width allows. (On an H100,
//   64-byte steps in 3-4 stages were slower.)
// - Threshold selection instead of a full sort. Per query the block keeps
//   its running best Lpad keys sorted in shared memory; the Lc-th of them is
//   the threshold. A fresh key that does not beat it is dropped in
//   registers. Survivors are appended to a per-query candidate buffer by
//   warp ballot and one shared atomic per warp; only when a buffer fills
//   (or the block ends) are the buffers bitonic-sorted and folded into the
//   lists (max against the reversed buffer, then a bitonic merge), which
//   raises the thresholds. Exact: a key under the block's Lc-th key cannot
//   reach the final top-k, and keys are totally ordered, so neither the
//   order of appends nor block scheduling changes the result. The append
//   and the fold are select.cuh's `append_above` and `flush_lists`, which
//   the top-k kernel shares; the row staging is stage.cuh's, which the
//   distance kernel shares.
// - Each block writes its sorted best Lc = min(k, rb) keys; select.cu's
//   merge folds the P lists by rank, a fixed result.
// What bounds it now: at B = 64 the FP32 FMA issue rate (selection and
// merge are a few percent once the lists fill); at B = 1 the row read.
#include "select.cuh"
#include "stage.cuh"

namespace {

constexpr int RT = 256;                   // rows per tile
constexpr int SMEM_MAX = 232448;

struct Source {
  const void* rows;
  const float* sq;
  const uint8_t* dead;
  const uint8_t* keep;
  int n, valid, id_offset;
};

// the grid of kernels/streaming/kernel.py:scan_grid and the call's shapes
struct Params {
  const float* qt;   // (d, qtw) f32: the queries transposed, zero past B
  const float* qsq;  // (B,) squared query norms, or null for dot
  Source base, delta;
  int B, d, qtw, rb, n_base_blocks, P, Lc, Lpad, cap, vb, metric;
  u64* out;          // (B, P, Lc) partial lists
};

// thread layout of a query tile: TM queries x TN rows per thread
template <int QT>
struct Layout {
  // 16 warps at the 64-query tile: with 8 (8 x 8 register tiles, 249
  // registers, one block an SM) the FMA loop ran 1.4x slower on an H100
  static constexpr int THREADS = QT == 64 ? 512 : 256;
  static constexpr int TM = QT < 8 ? QT : 8;
  static constexpr int TY = QT / TM;
  static constexpr int TX = THREADS / TY;
  static constexpr int TN = RT / TX;
  static constexpr int QTP = QT < 4 ? 4 : QT;  // staged query columns (16-byte copies)
  // bytes of each row a k step stages (a single query streams 256-byte
  // pieces, faster than 128 on an H100), in two stages
  static constexpr int ROW_BYTES = QT == 1 ? 256 : 128;
  static constexpr int NST = 2;
  static constexpr int RSTRIDE = ROW_BYTES + 16;  // shared row stride: conflict-free reads
};

template <typename T, int QT>
__host__ __device__ constexpr int stage_bytes() {
  using L = Layout<QT>;
  return RT * L::RSTRIDE + (L::ROW_BYTES / (int)sizeof(T)) * L::QTP * 4;
}

template <int QT>
__device__ __forceinline__ int qidx(int i, int ty) {
  if constexpr (Layout<QT>::TM == 8) return i < 4 ? ty * 4 + i : QT / 2 + ty * 4 + i - 4;
  else return i;
}

template <typename T, int QT>
__global__ void __launch_bounds__(Layout<QT>::THREADS, 1) scan_kernel(const Params p) {
  using L = Layout<QT>;
  constexpr int TM = L::TM, TN = L::TN, TX = L::TX, QTP = L::QTP, THREADS = L::THREADS;
  constexpr int ROW_BYTES = L::ROW_BYTES, NST = L::NST, RSTRIDE = L::RSTRIDE;
  constexpr int KT = ROW_BYTES / (int)sizeof(T);  // d elements per k step
  constexpr int VECK = 16 / (int)sizeof(T);
  constexpr int SB = stage_bytes<T, QT>();
  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem + NST * SB);  // [QT][Lpad]
  u64* cand = list + QT * p.Lpad;                        // [QT][cap]
  int* cnt = reinterpret_cast<int*>(cand + QT * p.cap);  // [QT]

  const int blk = blockIdx.x, q0 = blockIdx.y * QT;
  const bool in_base = blk < p.n_base_blocks;
  const Source src = in_base ? p.base : p.delta;
  const int rb0 = (in_base ? blk : blk - p.n_base_blocks) * p.rb;
  const int rb1 = min(rb0 + p.rb, src.n);
  const char* rows = static_cast<const char*>(src.rows);
  const size_t rbytes = (size_t)p.d * sizeof(T);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX, lane = tid & 31;
  const int nk = (p.d + KT - 1) / KT;
  const int total = ((rb1 - rb0 + RT - 1) / RT) * nk;

  for (int e = tid; e < QT * p.Lpad; e += THREADS) list[e] = 0ull;
  for (int e = tid; e < QT; e += THREADS) cnt[e] = 0;

  auto issue = [&](int s) {
    unsigned char* xs = smem + (s % NST) * SB;
    float* qs = reinterpret_cast<float*>(xs + RT * RSTRIDE);
    const int r0 = rb0 + (s / nk) * RT, c0 = (s % nk) * KT;
    const size_t cb0 = (size_t)c0 * sizeof(T);
    stage_rows_vb<THREADS, ROW_BYTES, RT>(p.vb, xs, rows, rbytes, r0, rb1, cb0);
    constexpr int QC = QTP / 4;
    for (int e = tid; e < KT * QC; e += THREADS) {
      const int kk = e / QC, c = (e % QC) * 4;
      const bool ok = c0 + kk < p.d;
      cp_async<16>(qs + kk * QTP + c, ok ? p.qt + (size_t)(c0 + kk) * p.qtw + q0 + c : p.qt,
                   ok);
    }
  };

  float acc[TM][TN];
  u64 thr[TM];
  float qn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    thr[i] = 0ull;
    const int gq = q0 + qidx<QT>(i, ty);
    qn[i] = (p.qsq && gq < p.B) ? p.qsq[gq] : 0.f;
  }

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < total) issue(s + NST - 1);
    cp_async_commit();
    const int kt = s % nk;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    const unsigned char* xs = smem + (s % NST) * SB;
    const float* qs = reinterpret_cast<const float*>(xs + RT * RSTRIDE);
#pragma unroll 2
    for (int kv = 0; kv < KT; kv += VECK) {
      uint4 xr[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        xr[j] = *reinterpret_cast<const uint4*>(xs + (tx + j * TX) * RSTRIDE +
                                                kv * (int)sizeof(T));
#pragma unroll
      for (int v = 0; v < VECK; ++v) {
        const float* qrow = qs + (kv + v) * QTP;
        float qv[TM];
        if constexpr (TM == 8) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + ty * 4);
          const float4 b = *reinterpret_cast<const float4*>(qrow + QT / 2 + ty * 4);
          qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
          qv[4] = b.x; qv[5] = b.y; qv[6] = b.z; qv[7] = b.w;
        } else if constexpr (TM == 4) {
          const float4 a = *reinterpret_cast<const float4*>(qrow);
          qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) qv[i] = qrow[i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float x = lane_val(xr[j], v, static_cast<const T*>(nullptr));
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(qv[i], x, acc[i][j]);
        }
      }
    }
    if (kt != nk - 1) continue;

    // epilogue of a row tile: keys, threshold filter, appends, flushes
    const int r0 = rb0 + (s / nk) * RT;
    bool live[TN];
    float xn[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = r0 + tx + j * TX;
      live[j] = row < rb1 && row < src.valid && !(src.dead && src.dead[row]) &&
                (!src.keep || src.keep[row]);
      xn[j] = (live[j] && src.sq) ? src.sq[row] : 0.f;
    }
    unsigned long long pend = 0ull;
    bool first = true;
    while (true) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int qi = qidx<QT>(i, ty);
        const bool qok = q0 + qi < p.B;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int bit = i * TN + j;
          u64 key = 0ull;
          if (qok && live[j] && (first || ((pend >> bit) & 1ull)))
            key = make_key(metric_epilogue(p.metric, acc[i][j], qn[i], xn[j]),
                           src.id_offset + r0 + tx + j * TX);
          if (append_above(key, thr[i], cand + qi * p.cap, cnt + qi, p.cap, lane))
            pend |= 1ull << bit;
          else
            pend &= ~(1ull << bit);
        }
      }
      __syncthreads();
      if (!__syncthreads_or(tid < QT && cnt[tid] >= p.cap)) break;
      flush_lists<QT, THREADS>(list, cand, cnt, p.Lpad, p.cap);
#pragma unroll
      for (int i = 0; i < TM; ++i) thr[i] = list[qidx<QT>(i, ty) * p.Lpad + p.Lc - 1];
      first = false;
      if (!__syncthreads_or(pend != 0ull)) break;
    }
  }

  __syncthreads();
  if (__syncthreads_or(tid < QT && cnt[tid] > 0))
    flush_lists<QT, THREADS>(list, cand, cnt, p.Lpad, p.cap);
  for (int e = tid; e < QT * p.Lc; e += THREADS) {
    const int r = e / p.Lc, i = e % p.Lc;
    const int gq = q0 + r;
    if (gq < p.B) p.out[((size_t)gq * p.P + blk) * p.Lc + i] = list[r * p.Lpad + i];
  }
}

template <typename T, int QT>
cudaError_t launch(const Params& p, int n_qtiles, cudaStream_t s) {
  const size_t smem = (size_t)Layout<QT>::NST * stage_bytes<T, QT>() +
                      (size_t)QT * (p.Lpad + p.cap) * sizeof(u64) + (size_t)QT * sizeof(int);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scan_kernel<T, QT><<<dim3(p.P, n_qtiles), Layout<QT>::THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qt(int qt, const Params& p, int n_qtiles, cudaStream_t s) {
  switch (qt) {
    case 64: return launch<T, 64>(p, n_qtiles, s);
    case 16: return launch<T, 16>(p, n_qtiles, s);
    case 4: return launch<T, 4>(p, n_qtiles, s);
    case 1: return launch<T, 1>(p, n_qtiles, s);
  }
  return cudaErrorInvalidValue;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Queries come transposed: qt is (d, qtw) float32, zero past column B,
// with qtw a multiple of 4 covering n_qtiles * qt_rows columns. Rows: base
// (Nb, d) and an optional delta (Nd, d) in `dtype`. Masks are uint8 per row
// or null; sq are squared row norms for cosine and l2 (null for dot). Delta
// ids are delta_id_offset + row. The grid (qt_rows, n_qtiles, rb,
// n_base_blocks, P, Lc, Lpad, cap) comes from kernels/streaming/kernel.py:
// scan_grid; vb is the byte width of the row copies (16, 8, 4 or 2);
// fan_in is the merge's (kernels/common.py: merge_fan_in).
extern "C" int mint_streaming_scan(
    const void* qt, const void* base, const void* delta, const void* qsq,
    const void* bsq, const void* dsq, const void* bdead, const void* bkeep,
    const void* ddead, const void* dkeep, int B, int d, int qtw, int Nb, int nb_valid,
    int Nd, int nd_valid, int delta_id_offset, int k, int qt_rows, int n_qtiles, int rb,
    int n_base_blocks, int P, int Lc, int Lpad, int cap, int vb, int fan_in, int metric,
    int dtype, void* scratch_a, void* scratch_b, void* vals, void* ids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!pow2(Lpad) || !pow2(cap) || cap > Lpad || Lc > Lpad || rb % RT || qtw % 4)
    return cudaErrorInvalidValue;
  Params p;
  p.qt = (const float*)qt;
  p.qsq = (const float*)qsq;
  p.base = {base, (const float*)bsq, (const uint8_t*)bdead, (const uint8_t*)bkeep, Nb,
            nb_valid, 0};
  p.delta = {delta, (const float*)dsq, (const uint8_t*)ddead, (const uint8_t*)dkeep, Nd,
             nd_valid, delta_id_offset};
  p.B = B; p.d = d; p.qtw = qtw; p.rb = rb; p.n_base_blocks = n_base_blocks; p.P = P;
  p.Lc = Lc; p.Lpad = Lpad; p.cap = cap; p.vb = vb; p.metric = metric;
  p.out = (u64*)scratch_a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32: err = launch_qt<float>(qt_rows, p, n_qtiles, s); break;
    case DTYPE_BF16: err = launch_qt<__nv_bfloat16>(qt_rows, p, n_qtiles, s); break;
    case DTYPE_F16: err = launch_qt<__half>(qt_rows, p, n_qtiles, s); break;
  }
  if (err != cudaSuccess) return err;
  return mint_merge_finalize(p.out, (u64*)scratch_b, B, P, Lc, k, fan_in, (float*)vals,
                             (int*)ids, s);
}
