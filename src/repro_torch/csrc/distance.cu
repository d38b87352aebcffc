// Batched distance kernel: (B, d) queries x (N, d) rows -> (B, N) f32 scores.
//
// Replaces src/repro/kernels/distance/kernel.py:_distance_kernel (the
// K-blocked MXU product with a dot / cosine / -L2^2 epilogue on the last K
// step). On the main path it scores IVF centroids (B <= 64 queries against
// ~1e3 centroids of padded width 128), the rerank over a group's candidate
// union (up to ~1e6 rows of width 128-1024) and the two-pass flat scan.
// Each row element read (4 bytes) feeds 2 * B flops against an H100 FP32
// ridge of about 67e12 / 3.35e12 = 20 flops a byte, so at B = 64 the FP32
// FMA rate bounds it, and at a few queries the row read.
//
// Contract that shapes it: every score is an FP32 fmaf(q, x, acc) chain over
// d in index order from 0, one accumulator per (query, row), d never split,
// zero padding past d as the streaming scan pads -- so the two-pass scan
// (this kernel, a mask, top-k) and the one-pass scan (csrc/streaming.cu)
// give the same ids and values bit for bit. Hence no tensor cores and no
// TF32.
//
// Design (an FFMA-bound SGEMM within that contract):
// - Block tile BM queries x BN rows of warps of 4 x 8 lanes, each lane a
//   TM x TM register tile: queries qg + 4 i and rows rg + 8 j of its warp's
//   4 TM x 8 TM tile, lane = qg + 4 rg. kernels/distance/kernel.py:
//   distance_tiles picks 64 x 256 of 8 x 8 thread tiles (8 warps, 64
//   accumulators a thread) for large calls, and 16 x 32 of 4 x 4 (one warp)
//   where the wide tile would leave SMs idle: a small call waits for one
//   thread's chain of TM * TM * d FMAs, and with 8 x 8 tiles the IVF
//   centroid shape ran slower on an H100 than a 4 x 4 SGEMM.
// - Queries and rows are both staged as row-major pieces of 128 bytes of
//   each row per k step through shared memory by cp.async, two stages, so
//   the next step's copies overlap this step's FMAs (stage.cuh:
//   stage_rows, the scan's staging). bf16 / f16 elements are upcast exactly
//   on the shared read (stage.cuh: lane_val).
// - Per 4 elements of d a thread issues TM row and TM query loads (LDS.128
//   for float32, LDS.64 for bf16 / f16) for TM x TM x 4 FFMA. The lanes of a
//   warp read 8 neighbouring rows and 4 neighbouring queries at a 144-byte
//   stride: one shared wavefront per load, no bank conflict.
// - __launch_bounds__ caps the wide tile at 128 registers a thread: two
//   8-warp blocks an SM (16 warps) to hide the shared-memory latency.
// - The metric epilogue runs on the finished sums, goes through shared
//   memory, and leaves as coalesced 16-byte stores where N % 4 == 0.
#include "select.cuh"
#include "stage.cuh"

namespace {

constexpr int ROW_BYTES = 128, RSTRIDE = ROW_BYTES + 16, NST = 2;

// 4 consecutive elements of a staged row as float32 (exact): one LDS.128
// for float32, one LDS.64 for bf16 / f16
__device__ __forceinline__ void load4(const unsigned char* p, float (&o)[4], const float*) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float (&o)[4], const T* tp) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const uint4 w = make_uint4(r.x, r.y, 0u, 0u);
#pragma unroll
  for (int v = 0; v < 4; ++v) o[v] = lane_val(w, v, tp);
}

// BM x BN block tile of warps of 4 x 8 lanes, each lane a TM x TM register
// tile: a warp covers 4 TM queries x 8 TM rows
template <int BM, int BN, int TM>
struct Tile {
  static constexpr int WARPS_Q = BM / (4 * TM), WARPS_R = BN / (8 * TM);
  static constexpr int THREADS = 32 * WARPS_Q * WARPS_R;
  // two 8-warp blocks an SM (a 128-register cap); the one-warp tile takes
  // the registers it needs (with a 128 cap it spilled on an H100)
  static constexpr int MIN_BLOCKS = THREADS >= 256 ? 2 : 1;
  static constexpr int STAGE = (BM + BN) * RSTRIDE;
  static constexpr int OSTRIDE = BN + 8;  // epilogue tile stride (floats)
  static constexpr int SMEM = NST * STAGE;
  static_assert(BM * OSTRIDE * 4 <= SMEM, "epilogue tile fits the stages");
};

struct Params {
  const void* q;
  const void* db;
  const float* qsq;  // (B,) squared norms, or null for dot
  const float* dbsq; // (N,)
  float* out;        // (B, N)
  int B, N, d, metric, vb;
};

template <typename T, int BM, int BN, int TM>
__global__ void __launch_bounds__(Tile<BM, BN, TM>::THREADS, Tile<BM, BN, TM>::MIN_BLOCKS)
distance_kernel(const Params p) {
  using L = Tile<BM, BN, TM>;
  constexpr int THREADS = L::THREADS, EB = 4 * (int)sizeof(T);  // bytes of 4 elements
  const T* tp = nullptr;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane & 3, rg = lane >> 2;
  const int wq = (warp % L::WARPS_Q) * 4 * TM, wr = (warp / L::WARPS_Q) * 8 * TM;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const size_t rbytes = (size_t)p.d * sizeof(T);
  const int nk = (int)((rbytes + ROW_BYTES - 1) / ROW_BYTES);
  const char* qrows = static_cast<const char*>(p.q);
  const char* xrows = static_cast<const char*>(p.db);

  auto issue = [&](int s) {
    unsigned char* qs = smem + (s % NST) * L::STAGE;
    const size_t cb0 = (size_t)s * ROW_BYTES;
    stage_rows_vb<THREADS, ROW_BYTES, BM>(p.vb, qs, qrows, rbytes, m0, p.B, cb0);
    stage_rows_vb<THREADS, ROW_BYTES, BN>(p.vb, qs + BM * RSTRIDE, xrows, rbytes, n0, p.N,
                                          cb0);
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (s + NST - 1 < nk) issue(s + NST - 1);
    cp_async_commit();
    const unsigned char* qs = smem + (s % NST) * L::STAGE + (wq + qg) * RSTRIDE;
    const unsigned char* xs = smem + (s % NST) * L::STAGE + (BM + wr + rg) * RSTRIDE;
#pragma unroll 1
    for (int ob = 0; ob < ROW_BYTES; ob += EB) {
      float x[TM][4];
#pragma unroll
      for (int j = 0; j < TM; ++j) load4(xs + 8 * j * RSTRIDE + ob, x[j], tp);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float qv[4];
        load4(qs + 4 * i * RSTRIDE + ob, qv, tp);
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(qv[v], x[j][v], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: metric on the finished sums, through shared memory, then
  // coalesced stores of whole row pieces
  float* ot = reinterpret_cast<float*>(smem);  // [BM][OSTRIDE]
  float xn[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int gn = n0 + wr + rg + 8 * j;
    xn[j] = (p.dbsq && gn < p.N) ? p.dbsq[gn] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = wq + qg + 4 * i;
    const float qn = (p.qsq && m0 + r < p.B) ? p.qsq[m0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j)
      ot[r * L::OSTRIDE + wr + rg + 8 * j] = metric_epilogue(p.metric, acc[i][j], qn, xn[j]);
  }
  __syncthreads();
  const bool vec = (p.N & 3) == 0;
  for (int e = tid; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int gq = m0 + r, gn = n0 + c;
    if (gq >= p.B || gn >= p.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(ot + r * L::OSTRIDE + c);
    float* dst = p.out + (size_t)gq * p.N + gn;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 4 && gn + t < p.N; ++t) dst[t] = w[t];
    }
  }
}

template <typename T, int BM, int BN, int TM>
cudaError_t launch(const Params& p, cudaStream_t s) {
  using L = Tile<BM, BN, TM>;
  cudaError_t err = cudaFuncSetAttribute(distance_kernel<T, BM, BN, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + BN - 1) / BN, (p.B + BM - 1) / BM);
  distance_kernel<T, BM, BN, TM><<<grid, L::THREADS, L::SMEM, s>>>(p);
  return cudaGetLastError();
}

// the tiles of kernels/distance/kernel.py: WIDE_TILE and NARROW_TILE
template <typename T>
cudaError_t launch_tile(int bm, int bn, int tm, const Params& p, cudaStream_t s) {
  if (bm == 64 && bn == 256 && tm == 8) return launch<T, 64, 256, 8>(p, s);
  if (bm == 16 && bn == 32 && tm == 4) return launch<T, 16, 32, 4>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// qsq / dbsq are the squared norms for cosine and l2 (null for dot). The
// block tile (bm, bn) and thread tile tm x tm come from
// kernels/distance/kernel.py: distance_tiles;
// vb is the byte width of the row copies (16, 8, 4 or 2) that every query
// and row starts on.
extern "C" int mint_batched_scores(const void* q, const void* db, const void* qsq,
                                   const void* dbsq, void* out, int B, int N, int d,
                                   int metric, int dtype, int bm, int bn, int tm,
                                   int vb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Params p{q, db, (const float*)qsq, (const float*)dbsq, (float*)out, B, N, d,
                 metric, vb};
  switch (dtype) {
    case DTYPE_F32: return launch_tile<float>(bm, bn, tm, p, s);
    case DTYPE_BF16: return launch_tile<__nv_bfloat16>(bm, bn, tm, p, s);
    case DTYPE_F16: return launch_tile<__half>(bm, bn, tm, p, s);
  }
  return cudaErrorInvalidValue;
}
