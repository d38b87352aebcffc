// Flash attention backward, tensor-core route: the dK / dV and dQ kernels
// for bf16 / f16 inputs (flash_bwd.cu launches the delta pre-pass before
// them and holds the route rule). Semantics as in flash_bwd.cu.
//
// What bounds it: operations. At granite-moe-1b-a400m's training call
// (8, 16, 2048, 64), causal, the gradient is 2.5x the forward's 4 d flops
// per kept (q, k) pair and head; without atomics the dQ kernel computes S
// and dP again, so 14 d flops a pair run. Every product runs on Hopper's
// warpgroup tensor-core instruction (wgmma.mma_async m64nNk16, bf16 / f16
// operands, f32 accumulators): a block is one warpgroup of 4 warps and 64
// rows, so the warpgroup reads each shared-memory operand once where
// mma.sync would read it once per warp.
// - dK / dV (key-row orientation): one block per (64-key tile, KV head,
//   batch row) holds its K and V tiles in shared memory and walks the
//   group's query heads and their kept 64-row q tiles in a fixed order;
//   each Q and dO tile, with its rows' lse and D, arrives by cp.async two
//   stages deep (the next tile's copy overlaps this one's products).
//   S^T = K Q^T and dP^T = V dO^T take both operands from shared memory;
//   P^T and dS^T are formed on the accumulators and packed in registers as
//   the A operands of dV += P^T dO and dK += dS^T Q, whose B operands (dO,
//   Q) are read MN-major from the same tiles. P and dS never touch shared
//   memory.
// - dQ (query-row orientation): one block per (64-row q tile, q head, batch
//   row) holds Q and dO; K and V tiles arrive by two-stage cp.async;
//   S = Q K^T, dP = dO V^T, dS in registers as the A operand of
//   dQ += dS K.
// - Tiles sit in shared memory in wgmma's swizzled layout (SwTile), written
//   there by cp.async; the key or q tile is the grid's slowest axis, the
//   longest blocks first.
// - No atomics: every sum runs in a fixed order, so two calls give the same
//   bits. dQ is recomputed, not summed from per-key-tile partials (at
//   granite's shape those would be ~1.1 GB written and read again).
// - P is the forward's: scores in log2 units, x = s scale log2 e, or
//   cap log2 e tanh.approx(s scale / cap) under the softcap (a template
//   flag), and p = ex2.approx(x - lse log2 e), so rows whose forward
//   probabilities sum to 1 stay consistent; the softcap's derivative
//   1 - t^2 uses that t. The scale is applied once, to dK and dQ at the
//   store.
// - Tiles that the causal mask or the window masks entirely are skipped;
//   interior tiles take a pass without compares, only diagonal,
//   window-edge and ragged tiles apply them. A row with no kept key
//   contributes exactly 0.
#include <type_traits>

#include "flash.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128, NT = 8;
static_assert(THREADS == 2 * BQ && BKV == NT * 8, "tile split");

// A 64-row tile of D bf16 / f16 columns in shared memory, in wgmma's
// swizzled layout: column blocks of up to 64 elements (128-byte rows,
// 128-byte swizzle; d = 32: 64-byte rows, 64-byte swizzle), each 64 rows
// deep; in a block, the 16-byte chunk c of row r sits at chunk
// c ^ ((r * RB / 128) % CPR) of its row. The same tile is a K-major operand
// (rows = M or N, columns = K) and an MN-major one (rows = K).
template <int D>
struct SwTile {
  static constexpr int CB = D < 64 ? D : 64;  // columns per block
  static constexpr int RB = CB * 2;           // bytes per block row
  static constexpr int CPR = RB / 16;         // 16-byte chunks per block row
  static constexpr int BLOCK = 64 * RB;       // bytes per block
  static constexpr int BYTES = 64 * D * 2;    // bytes per tile
  static constexpr int SWIZZLE = RB == 128 ? 1 : 2;
  // byte offset of chunk c (of D / 8) of row r
  static __device__ __forceinline__ int off(int r, int c) {
    return (c / CPR) * BLOCK + r * RB + (((c % CPR) ^ ((r * RB >> 7) & (CPR - 1))) << 4);
  }
  // k-step kk (columns 16kk..16kk+15) of the tile as a K-major operand
  static __device__ __forceinline__ uint64_t kmajor(const unsigned char* t, int kk) {
    constexpr int KPB = CB / 16;  // k-steps per block
    return wgmma_desc(t + (kk / KPB) * BLOCK + (kk % KPB) * 32, 16, 8 * RB, SWIZZLE);
  }
  // k-step kk (rows 16kk..16kk+15) of the tile as an MN-major operand
  static __device__ __forceinline__ uint64_t mnmajor(const unsigned char* t, int kk) {
    return wgmma_desc(t + kk * 16 * RB, BLOCK, 8 * RB, SWIZZLE);
  }
};

// dynamic shared memory: six tiles and two stages of 64 rows' lse and D,
// plus the slack that aligns the tiles to 1024 bytes
template <int D>
constexpr int smem_bytes() { return 6 * SwTile<D>::BYTES + 2 * 2 * BQ * 4 + 1024; }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return p + ((1024 - smem_addr(p) % 1024) % 1024);
}

// acc (64 x 64 over the warpgroup) = A . B^T for the K-major tiles A and B
template <typename T, int D>
__device__ __forceinline__ void tile_by_tile(float (&acc)[NT][4], const unsigned char* A,
                                             const unsigned char* B) {
  const T* tag = nullptr;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(acc, SwTile<D>::kmajor(A, kk), SwTile<D>::kmajor(B, kk), tag);
}

// acc (64 x D over the warpgroup) += F (64 x 64, packed A fragments) . B,
// B the tile read MN-major
template <typename T, int D>
__device__ __forceinline__ void frags_by_tile(float (&acc)[D / 8][4],
                                              const uint32_t (&F)[BKV / 16][4],
                                              const unsigned char* B) {
  const T* tag = nullptr;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs_tb(acc, F[kk], SwTile<D>::mnmajor(B, kk), tag);
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// accumulator group n's four values as the A fragment slots of the next
// product (the forward's P -> PV packing)
template <typename T>
__device__ __forceinline__ void pack_group(uint32_t (&F)[BKV / 16][4], int n, const float* v) {
  const T* tag = nullptr;
  F[n / 2][(n % 2) * 2] = pack2(v[0], v[1], tag);
  F[n / 2][(n % 2) * 2 + 1] = pack2(v[2], v[3], tag);
}

// Whether q row `r` (position r + Skv - Sq) keeps kv position `kpos`.
__device__ __forceinline__ bool keeps(const BwdArgs& a, int r, int kpos) {
  const int qpos = r + a.Skv - a.Sq;
  return r < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// Whether every (q row, key) pair of the tiles at q row i0 and key j0 is
// kept: no compare needed.
__device__ __forceinline__ bool tile_interior(const BwdArgs& a, int i0, int j0) {
  const int shift = a.Skv - a.Sq;
  return i0 + BQ <= a.Sq && j0 + BKV <= a.Skv && (!a.causal || j0 + BKV - 1 <= i0 + shift) &&
         (a.window <= 0 || j0 > i0 + BQ - 1 + shift - a.window);
}

// The forward's score arithmetic: x (log2 units) = s * pre, or
// post * tanh(s * pre) under the softcap (CAPPED).
template <bool CAPPED>
struct ScoreMap {
  float pre, post;
  __device__ __forceinline__ explicit ScoreMap(const BwdArgs& a)
      : pre(CAPPED ? a.scale / a.softcap : a.scale * LOG2E), post(a.softcap * LOG2E) {}
  // s <- p = 2^(x - lse2), dp <- dS / scale = p (dp - dsum) (1 - t^2); 0 when
  // the pair is not kept
  __device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float dsum,
                                       bool keep) const {
    float x = s * pre, t = 0.f;
    if constexpr (CAPPED) {
      t = tanh_approx(x);
      x = post * t;
    }
    const float p = keep ? exp2_approx(x - lse2) : 0.f;
    float ds = p * (dp - dsum);
    if constexpr (CAPPED) ds *= 1.f - t * t;
    s = p;
    dp = ds;
  }
};

// rows [0, 64) of a 64 x D operand whose row r starts at src + r * stride,
// zero from row `valid` on, by 16-byte cp.async into the swizzled tile dst
template <typename T, int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src, long long stride,
                                           int valid) {
  constexpr int PER = D / 8;
#pragma unroll
  for (int u = 0; u < 64 * PER / THREADS; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / PER, c = e % PER;
    const bool ok = r < valid;
    cp_async<16>(dst + SwTile<D>::off(r, c), src + (ok ? r : 0) * stride + c * 8, ok);
  }
}

// this thread's copies but the newest group have landed; after the barrier
// that follows, every one of them is visible to wgmma
__device__ __forceinline__ void copies_landed() {
  cp_async_wait<1>();
  fence_async_shared();
}

// a warp's 16 rows x D accumulator, times `mul`, into rows row0 + g and
// row0 + g + 8 (below `rows`) of the strided output at base
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride, int row0, int rows,
                                           const float (&acc)[D / 8][4], float mul, int lane) {
  const T* tag = nullptr;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    if (r >= rows) continue;
    T* o = base + r * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t) =
          pack2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul, tag);
  }
}

// Blocks an SM, from ptxas's registers (three blocks allow 168 a thread):
// three where that spills nothing, else two.
template <typename T, int D, bool CAPPED>
__global__ void __launch_bounds__(THREADS, D <= 32 ? 3 : 2) flash_bwd_dkdv_tc(const BwdArgs a) {
  using L = SwTile<D>;
  constexpr int DT = D / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = aligned_smem(smem_raw);
  unsigned char* Vs = Ks + L::BYTES;
  unsigned char* QG = Vs + L::BYTES;  // [stage][Q, dO]
  float* stats = reinterpret_cast<float*>(QG + 4 * L::BYTES);  // [stage][lse, D][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  // the key tile is the grid's slowest axis: under the causal mask the first
  // key tiles keep the most q tiles, so the longest blocks start first
  const int j0 = blockIdx.z * BKV, hk = blockIdx.x, b = blockIdx.y;
  const int group = a.Hq / a.Hkv;
  stage_rows<T, D>(Ks, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh + j0 * a.k_ss,
                   a.k_ss, a.Skv - j0);
  stage_rows<T, D>(Vs, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh + j0 * a.v_ss,
                   a.v_ss, a.Skv - j0);
  cp_async_commit();

  // the q rows [i_lo, i_hi) that keep some key of [j0, j1), walked per
  // query head of the group in tiles of BQ from i_first
  const long long shift = a.Skv - a.Sq, j1 = min(j0 + BKV, a.Skv);
  long long i_lo = 0, i_hi = a.Sq;
  if (a.causal) i_lo = max(i_lo, j0 - shift);
  if (a.window > 0) i_hi = min(i_hi, j1 - 1 + a.window - shift);
  const int i_first = (int)(i_lo / BQ) * BQ;
  const int per_head = i_hi > i_first ? (int)((i_hi - i_first + BQ - 1) / BQ) : 0;
  const int ntiles = group * per_head;

  auto load = [&](int it, int stage) {
    const int h = hk * group + it / per_head, i0 = i_first + (it % per_head) * BQ;
    const long long hrow = (long long)b * a.Hq + h;
    unsigned char* qs = QG + stage * 2 * L::BYTES;
    stage_rows<T, D>(qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + i0 * a.q_ss,
                     a.q_ss, a.Sq - i0);
    stage_rows<T, D>(qs + L::BYTES, static_cast<const T*>(a.dout) + (hrow * a.Sq + i0) * D, D,
                     a.Sq - i0);
    const int r = tid % BQ;  // threads [0, BQ) copy lse, [BQ, 2 BQ) delta
    const bool ok = i0 + r < a.Sq;
    const float* src = (tid < BQ ? a.lse : a.delta) + hrow * a.Sq + (ok ? i0 + r : 0);
    cp_async<4>(stats + stage * 2 * BQ + tid, src, ok);
  };
  if (ntiles > 0) load(0, 0);
  cp_async_commit();

  const ScoreMap<CAPPED> sm(a);
  const int k_a = j0 + warp * 16 + lane / 4;  // this thread's key rows k_a, k_a + 8
  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1, (it + 1) & 1);
    cp_async_commit();
    copies_landed();  // K / V and this tile
    __syncthreads();
    const int i0 = i_first + (it % per_head) * BQ;
    const unsigned char* Qs = QG + (it & 1) * 2 * L::BYTES;
    const unsigned char* Gs = Qs + L::BYTES;
    const float* Ls = stats + (it & 1) * 2 * BQ;
    const float* Ds = Ls + BQ;

    float st[NT][4], dpt[NT][4];  // S^T and dP^T: rows = keys, columns = q rows
    zero(st);
    zero(dpt);
    wgmma_pin(st);
    wgmma_pin(dpt);
    wgmma_fence();
    tile_by_tile<T, D>(st, Ks, Qs);
    tile_by_tile<T, D>(dpt, Vs, Gs);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(st);
    wgmma_pin(dpt);
    // P^T and dS^T, packed as the next products' A operands; interior
    // tiles skip the compares
    uint32_t pf[BKV / 16][4], sf[BKV / 16][4];
    auto pass = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * t;
        const float2 lse = *reinterpret_cast<const float2*>(Ls + c);
        const float2 dsum = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep =
              !decltype(masked)::value || keeps(a, i0 + c + (e & 1), k_a + (e / 2) * 8);
          sm.p_ds(st[n][e], dpt[n][e], ((e & 1) ? lse.y : lse.x) * LOG2E,
                  (e & 1) ? dsum.y : dsum.x, keep);
        }
        pack_group<T>(pf, n, st[n]);
        pack_group<T>(sf, n, dpt[n]);
      }
    };
    if (tile_interior(a, i0, j0)) pass(std::false_type());
    else pass(std::true_type());
    wgmma_pin(dv);
    wgmma_pin(dk);
    wgmma_fence();
    frags_by_tile<T, D>(dv, pf, Gs);  // dV += P^T dO
    frags_by_tile<T, D>(dk, sf, Qs);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dv);
    wgmma_pin(dk);
    __syncthreads();  // this stage is read before the next load overwrites it
  }

  store_rows<T, D>(static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh, a.dk_ss,
                   j0 + warp * 16, a.Skv, dk, a.scale, lane);
  store_rows<T, D>(static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh, a.dv_ss,
                   j0 + warp * 16, a.Skv, dv, 1.f, lane);
}

template <typename T, int D, bool CAPPED>
__global__ void __launch_bounds__(THREADS, D <= 32 || (D == 64 && !CAPPED) ? 3 : 2)
    flash_bwd_dq_tc(const BwdArgs a) {
  using L = SwTile<D>;
  constexpr int DT = D / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);
  unsigned char* Gs = Qs + L::BYTES;  // dO
  unsigned char* KV = Gs + L::BYTES;  // [stage][K, V]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  // the q tile is the grid's slowest axis, the longest (last) tiles first
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int i0 = (n_qt - 1 - (int)blockIdx.z) * BQ, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const long long hrow = (long long)b * a.Hq + h;
  stage_rows<T, D>(Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + i0 * a.q_ss,
                   a.q_ss, a.Sq - i0);
  stage_rows<T, D>(Gs, static_cast<const T*>(a.dout) + (hrow * a.Sq + i0) * D, D, a.Sq - i0);
  cp_async_commit();
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the kv range any row of this tile keeps (the forward's cut)
  const int shift = a.Skv - a.Sq;
  const int qlo = i0 + shift, qhi = min(i0 + BQ, a.Sq) - 1 + shift;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, qhi + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, qlo - a.window + 1);
  const int j_first = (kv_begin / BKV) * BKV;
  const int ntiles = kv_end > j_first ? (kv_end - j_first + BKV - 1) / BKV : 0;

  auto load = [&](int j0, int stage) {
    unsigned char* ks = KV + stage * 2 * L::BYTES;
    stage_rows<T, D>(ks, kb + j0 * a.k_ss, a.k_ss, a.Skv - j0);
    stage_rows<T, D>(ks + L::BYTES, vb + j0 * a.v_ss, a.v_ss, a.Skv - j0);
  };
  if (ntiles > 0) load(j_first, 0);
  cp_async_commit();

  // this thread's rows r_a and r_a + 8: their lse (log2 units) and D
  const int r_a = i0 + warp * 16 + lane / 4;
  float lse2[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_a + 8 * i;
    lse2[i] = r < a.Sq ? a.lse[hrow * a.Sq + r] * LOG2E : 0.f;
    dsum[i] = r < a.Sq ? a.delta[hrow * a.Sq + r] : 0.f;
  }
  const ScoreMap<CAPPED> sm(a);
  float dq[DT][4];
  zero(dq);

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = j_first + it * BKV;
    if (it + 1 < ntiles) load(j0 + BKV, (it + 1) & 1);
    cp_async_commit();
    copies_landed();  // Q / dO and this tile
    __syncthreads();
    const unsigned char* Ks = KV + (it & 1) * 2 * L::BYTES;
    const unsigned char* Vs = Ks + L::BYTES;

    float s[NT][4], dp[NT][4];  // rows = q rows, columns = keys
    zero(s);
    zero(dp);
    wgmma_pin(s);
    wgmma_pin(dp);
    wgmma_fence();
    tile_by_tile<T, D>(s, Qs, Ks);
    tile_by_tile<T, D>(dp, Gs, Vs);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);
    // dS, packed as the next product's A operand; interior tiles skip the
    // compares
    uint32_t sf[BKV / 16][4];
    auto pass = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = !decltype(masked)::value ||
                            keeps(a, r_a + (e / 2) * 8, j0 + n * 8 + 2 * t + (e & 1));
          sm.p_ds(s[n][e], dp[n][e], lse2[e / 2], dsum[e / 2], keep);
        }
        pack_group<T>(sf, n, dp[n]);
      }
    };
    if (tile_interior(a, i0, j0)) pass(std::false_type());
    else pass(std::true_type());
    wgmma_pin(dq);
    wgmma_fence();
    frags_by_tile<T, D>(dq, sf, Ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dq);
    __syncthreads();  // this stage is read before the next load overwrites it
  }

  store_rows<T, D>(static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh, a.dq_ss,
                   i0 + warp * 16, a.Sq, dq, a.scale, lane);
}

template <typename T, int D, bool CAPPED>
cudaError_t launch_bwd_tc(const BwdArgs& a, cudaStream_t s) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<T, D, CAPPED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc<T, D, CAPPED>
      <<<dim3(a.Hkv, a.B, (a.Skv + BKV - 1) / BKV), THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<T, D, CAPPED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<T, D, CAPPED><<<dim3(a.Hq, a.B, (a.Sq + BQ - 1) / BQ), THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_tc(const BwdArgs& a, cudaStream_t s) {
  return a.softcap > 0.f ? launch_bwd_tc<T, D, true>(a, s) : launch_bwd_tc<T, D, false>(a, s);
}

}  // namespace

template <typename T>
cudaError_t flash_bwd_tensor_core(const BwdArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_bwd_tc<T, 32>(a, s);
    case 64: return launch_bwd_tc<T, 64>(a, s);
    case 128: return launch_bwd_tc<T, 128>(a, s);
  }
  return cudaErrorInvalidValue;
}

template cudaError_t flash_bwd_tensor_core<__nv_bfloat16>(const BwdArgs&, int, cudaStream_t);
template cudaError_t flash_bwd_tensor_core<__half>(const BwdArgs&, int, cudaStream_t);
