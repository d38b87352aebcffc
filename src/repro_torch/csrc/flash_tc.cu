// Flash attention, route (b): tensor-core prefill for bf16 / f16 inputs
// whose q rows of one KV head exceed the split-KV tile. Semantics as in
// flash_attention.cu.
//
// What bounds it: operations. At Gemma-2-27B's prefill (2, 32, 8192, 128),
// causal, the work is 4 * d flops per kept (q, k) pair and head, about
// 1.1e12 flops, against 0.4 GB of q, k, v and out. So both products run on
// the tensor cores: mma.sync.m16n8k16 with bf16 / f16 operands and f32
// accumulation (the FlashAttention-2 shape). Hopper's wgmma with TMA-fed
// tiles, warp-specialised, is the step after this one.
// - One block per (64-query tile, q head, batch row), 4 warps of 16 q rows
//   each, two blocks per SM; the q tile's A fragments stay in registers for
//   the whole walk. The longest (last) q tiles are scheduled first. (On an
//   H100, 128-row tiles in 8 warps, one block per SM, were slower.)
// - K / V tiles of 64 keys arrive by 16-byte cp.async in two stages, so the
//   next tile's copy overlaps this tile's products. Rows are padded by 16
//   bytes, so every ldmatrix is free of bank conflicts.
// - S = Q K^T from ldmatrix'd K, online softmax on the accumulator
//   fragments in the exp2 domain (row max and sum across a quad by
//   shuffles), P cast to bf16 / f16 in registers as PV's A operand, V by
//   ldmatrix.trans.
// - Fully masked tiles are skipped (exact: they would leave (m, l, acc) as
//   they are); interior tiles, which no mask cuts, skip the compares; only
//   diagonal and window-edge tiles apply them.
// - The softcap uses tanh.approx.f32 and p = 2^x with ex2.approx: one SFU
//   operation each per score. tanh.approx has a relative error of about
//   2^-11 (PTX ISA), so a capped logit at cap 50 may move by up to ~0.025;
//   the grid's bf16 / f16 tolerance and the model's logit checks hold it
//   (chip_smoke.py; PERF.md has the measured errors).
#include "cp_async.cuh"
#include "flash.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = BQ / 16, THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcLayout {
  static constexpr int LD = D + 8;  // shared row stride in elements (+16 bytes)
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BKV * LD;
  static constexpr int SMEM = (Q_ELEMS + 4 * KV_ELEMS) * 2;  // bytes
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), f32 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1,
                                    const __nv_bfloat16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1,
                                    const __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of two 16-bit values, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, const __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one SFU instruction each: the route's softmax would otherwise issue three
// SFU operations per score (exp and reciprocal for tanh, exp for p)
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) tc_kernel(const FlashArgs a) {
  using L = TcLayout<D>;
  constexpr int LD = L::LD, KSTEPS = D / 16, NT = BKV / 8, DT = D / 8, PER = D / 8;
  const T* tag = nullptr;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][LD]
  T* KVs = Qs + L::Q_ELEMS;            // [stage][K, V][BKV][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int e = tid; e < BQ * PER; e += THREADS) {
    const int r = e / PER, c = (e % PER) * 8;
    const bool ok = q0 + r < a.Sq;
    cp_async<16>(Qs + r * LD + c, ok ? qb + (long long)(q0 + r) * a.q_ss + c : qb, ok);
  }
  cp_async_commit();

  // positions of this tile's real rows and the kv range any of them keeps
  const int shift = a.Skv - a.Sq;
  const int qlo = q0 + shift, qhi = min(q0 + BQ, a.Sq) - 1 + shift;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, qhi + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, qlo - a.window + 1);
  const int j_first = (kv_begin / BKV) * BKV;
  const int ntiles = kv_end > j_first ? (kv_end - j_first + BKV - 1) / BKV : 0;

  auto load = [&](int j0, int stage) {
    T* ks = KVs + stage * 2 * L::KV_ELEMS;
    T* vs = ks + L::KV_ELEMS;
    for (int e = tid; e < BKV * PER; e += THREADS) {
      const int r = e / PER, c = (e % PER) * 8;
      const bool ok = j0 + r < a.Skv;
      const long long row = ok ? j0 + r : 0;
      cp_async<16>(ks + r * LD + c, kb + row * a.k_ss + c, ok);
      cp_async<16>(vs + r * LD + c, vb + row * a.v_ss + c, ok);
    }
  };
  if (ntiles > 0) load(j_first, 0);
  cp_async_commit();

  cp_async_wait<1>();  // the q tile
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const int pa = ra + shift, pb = rb + shift;      // their positions
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // scores are kept in log2 units (x * log2 e), so p = 2^(x - m)
  float m[2] = {MINT_NEG_INF, MINT_NEG_INF}, l[2] = {0.f, 0.f};
  const bool capped = a.softcap > 0.f;
  const float pre = capped ? a.scale / a.softcap : a.scale * LOG2E;
  const float post = a.softcap * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = j_first + it * BKV;
    if (it + 1 < ntiles) load(j0 + BKV, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = KVs + (it & 1) * 2 * L::KV_ELEMS;
    const T* Vs = Ks + L::KV_ELEMS;

    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma(sc[2 * np], qf[kk], kf[0], kf[1], tag);
        mma(sc[2 * np + 1], qf[kk], kf[2], kf[3], tag);
      }
    }

    // scale, softcap, mask (edge tiles only), online softmax in log2 units
    const bool interior = (!a.causal || j0 + BKV - 1 <= qlo) &&
                          (a.window <= 0 || j0 > qhi - a.window) && j0 + BKV <= a.Skv;
    float mx[2] = {MINT_NEG_INF, MINT_NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * pre;
        if (capped) x = post * tanh_approx(x);
        if (!interior) {
          const int kpos = j0 + n * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? pa : pb;
          const bool keep = kpos < a.Skv && (!a.causal || kpos <= qpos) &&
                            (a.window <= 0 || kpos > qpos - a.window);
          if (!keep) x = MINT_NEG_INF;
        }
        sc[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with nothing kept yet keeps p = 0 (its x are all NEG_INF)
      mb[i] = m_new == MINT_NEG_INF ? 0.f : m_new;
      alpha[i] = exp2_approx(m[i] - mb[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = exp2_approx(sc[n][0] - mb[0]);
      const float p1 = exp2_approx(sc[n][1] - mb[0]);
      const float p2 = exp2_approx(sc[n][2] - mb[1]);
      const float p3 = exp2_approx(sc[n][3] - mb[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack2(p0, p1, tag);
      pf[n / 2][(n % 2) * 2 + 1] = pack2(p2, p3, tag);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p . v
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma(o[2 * dp], pf[kk], vf[0], vf[1], tag);
        mma(o[2 * dp + 1], pf[kk], vf[2], vf[3], tag);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  T* ob = static_cast<T*>(a.out) + ((long long)b * a.Hq + h) * a.Sq * D;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < a.Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)ra * D + c) =
          pack2(o[n][0] * l[0], o[n][1] * l[0], tag);
    if (rb < a.Sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)rb * D + c) =
          pack2(o[n][2] * l[1], o[n][3] * l[1], tag);
  }
}

template <typename T, int D>
cudaError_t launch_tc(const FlashArgs& a, cudaStream_t s) {
  constexpr int smem = TcLayout<D>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  tc_kernel<T, D><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t flash_tensor_core(const FlashArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_tc<T, 32>(a, s);
    case 64: return launch_tc<T, 64>(a, s);
    case 128: return launch_tc<T, 128>(a, s);
  }
  return cudaErrorInvalidValue;
}

template cudaError_t flash_tensor_core<__nv_bfloat16>(const FlashArgs&, int, cudaStream_t);
template cudaError_t flash_tensor_core<__half>(const FlashArgs&, int, cudaStream_t);
