// The gradient of the RWKV-6 scan for NVIDIA Hopper (sm_90a), float32 on
// the TF32 tensor cores ("tf32x3"), plain C++ interface.  Built with the
// other sources by repro_torch/kernels/build.py; launched through
// rwkv6_scan_bwd_launch (rwkv6_scan_bwd.cu) for every call that
// kernels/rwkv6_scan.scan_bwd_route sends to this route.  The token-serial
// rwkv6_scan_bwd_kernel in rwkv6_scan_bwd.cu ("serial") stays beside it as
// its yardstick, and rwkv6_du_reduce_kernel there sums du's per-row
// partials by head for both.
//
//  * rwkv6_scan_bwd_tf32x3_kernel <- port-only: the gradient of
//    src/repro/kernels/rwkv6_scan.py rwkv6_scan (:69, pallas_call at :84);
//    the reference has no backward pallas_call (JAX differentiates its jnp
//    scan).  For the forward
//      S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//      y_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t,
//    it returns dr, dk, dv, dw, du's per-row partials and ds0 from dy and
//    the final state's gradient.  r, k, w (BH, T, K), v, dy (BH, T, V),
//    state, ds_end, ds0 (BH, K, V), float32; the plain version is
//    kernels/ref.py rwkv6_scan_bwd_ref.
//
// Bound on this card: bytes.  At (1280, 128, 64, 64) the function reads r,
// k, v, w, dy and writes dr, dk, dv, dw (about 378 MB, 0.113 ms at
// 3.35 TB/s); its products, three TF32 passes each, are far from the
// tensor cores' rate.  The form is route C's (rwkv6_scan_sm90.cu) walked
// backward:
//   - one block of four warps a row.  The state entering each chunk of
//     kC = 16 tokens comes from route C of the forward, which holds it in
//     registers anyway and writes it out under autograd: 16 KB a chunk,
//     168 MB at (1280, 128), half of the serial route's checkpoints
//     (ops.RWKV6ScanFn keeps them for the backward; called without them,
//     the wrapper runs route C first).  The kernel takes the chunks last
//     to first with dS^T, the gradient of the state leaving the chunk, in
//     registers as accumulator fragments (warp i: value rows 16i..16i+15):
//       dS_start = diag(F) dS_end + R~^T dY      (R~ = r decayed to the
//                                                 chunk's start)
//   - per chunk, on the tensor cores (mma.sync m16n8k8 TF32, every operand
//     split into a big and a small part, hi*lo + lo*hi + hi*hi, each 8-deep
//     k-step into a fresh accumulator added to float32 sums):
//       M2 = dY S0^T, M1 = V dS_end^T            (16 x 64 each)
//       H  = dY V^T                              (16 x 16, four partials)
//       dv = K~ dS_end + Sc^T dY                 (dS^T from registers)
//       the carry above
//     with the in-chunk scores Sc laid out as route C's: the bonus
//     r_s . (u (.) k_s) on the diagonal; pairs s < t inside a sub-block of 8
//     on the CUDA cores, weighted by a running product of w; the second
//     sub-block's targets against the first's sources on the tensor cores,
//     anchored at their boundary.  On the CUDA cores too: g = sum_v dS_end
//     (.) S0 and, one thread a column k of K and direction, the in-chunk
//     terms of dr, dk and dw as recursions over the chunk's tokens:
//       dr_i = P_i M2_i + G_i[i] + H_ii u k_i,
//              G_{i+1}[t] = w_i G_i[t] + k_i H_ti,
//       dk_i = Q_i M1_i + L_i[i] + H_ii u r_i,
//              L_{i-1}[s] = w_i L_i[s] + r_i H_is,
//       dw_i = Q_i (P_i g + c_i) + d_i + P_i e_i,
//              c_{i+1} = w_i c_i + k_i M1_i,  e_{i-1} = w_i e_i + r_i M2_i,
//       d_i  = sum_{t>i} prod_{i<j<t} w_j r_t G_i[t]   (i < 8, forward walk)
//            = sum_{s<i} prod_{s<j<i} w_j k_s L_i[s]   (i >= 8, backward walk)
//     with P_i the product of w before i in the chunk and Q_i the one after
//     it.  dw, which needs each token's state and state gradient, is thus
//     formed from sums that straddle i: S0 x dS_end through the one
//     K-vector g, the cross terms through M1 and M2, the in-chunk pairs
//     s < i < t through G or L and a Horner sum.
//   - no decay product is ever divided by: every factor is a running
//     product of w over a forward interval, at most 1.  A factor that
//     underflows to 0 is the right answer, so the kernel is finite wherever
//     the token-serial recurrence is (the reference's chunked form, which
//     divides by in-chunk products, is not under strong decay).
//   - du's partials stay per row (rwkv6_du_reduce_kernel sums them by head
//     in a fixed order): no float atomics, so two runs give the same bits.
//   - r, k, w, v, dy and the chunk's state are copied into shared memory
//     by cp.async (16-byte copies where K and V are multiples of 4 and the
//     rows 16-byte aligned, else 4-byte ones), zero-filling columns past K
//     or V and tokens past T; a padded token's w is read as 1.  The next
//     chunk's copies are issued once the per-column recursions hold their
//     column in registers, and land while they run (the forward pass keeps
//     two stages).
// Shared memory is ~96 KB a block: two blocks (eight warps) an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;          // tokens a chunk
constexpr int kW = 64;          // K and V, zero-padded on chip
constexpr int kThreads = 128;   // warp i owns value rows 16i..16i+15 of dS^T
constexpr int kLd = 72;         // rows of the 64-wide tiles (floats)
constexpr int kLdS = 24;        // rows of the 16 x 16 score tiles
// shared-memory layout, in floats
constexpr int kTile = kC * kLd;             // one [16][64] tile
constexpr int kOffR = 0;
constexpr int kOffK = kOffR + kTile;
constexpr int kOffWt = kOffK + kTile;
constexpr int kOffV = kOffWt + kTile;
constexpr int kOffDy = kOffV + kTile;
constexpr int kOffS0 = kOffDy + kTile;      // S0^T [v][k]
constexpr int kOffD = kOffS0 + kW * kLd;    // dS_end^T [v][k]
constexpr int kOffRt = kOffD + kW * kLd;    // R~ [t][k]
constexpr int kOffKt = kOffRt + kTile;      // K~ [s][k]
constexpr int kOffSc = kOffKt + kTile;      // Sc [t][s]
constexpr int kOffH = kOffSc + kC * kLdS;   // H [t][s]
constexpr int kOffM1 = kOffH + kC * kLdS;   // M1 [s][k]
constexpr int kOffM2 = kOffM1 + kTile;      // M2 [t][k]
constexpr int kOffG = kOffM2 + kTile;       // g's partials [warp][k]
constexpr int kOffDwB = kOffG + 4 * kW;     // dw's second part [t][k]
constexpr int kOffU = kOffDwB + kC * kW;    // u, zero-padded
constexpr int kOffF = kOffU + kW;           // the chunk's prod w
constexpr int kLdX = 68;                    // rows of r', k'
constexpr int kOffRp = kOffF + kW;          // r' [t - 8][k]
constexpr int kOffKp = kOffRp + 8 * kLdX;   // k' [s][k]
constexpr int kOffXs = kOffKp + 8 * kLdX;   // cross scores [warp][8][8]
constexpr int kOffHp = kOffXs + 4 * 64;     // H's partials [warp][16][kLdS]
constexpr int kSmemFloats = kOffHp + 4 * kC * kLdS;
constexpr int kSmemBytes = 4 * kSmemFloats;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 for a finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the big and small TF32 parts of x: x - hi is exact in float32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) split into its parts: x = {A[g][tg], A[g+8][tg],
// A[g][tg+4], A[g+8][tg+4]}.
struct FragA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2,
                                        float x3) {
  FragA f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
  return f;
}

// p = a * b over one 8-deep k-step into a fresh accumulator: the small
// products first, then the big one; b = {B[tg][g], B[tg+4][g]}
__device__ __forceinline__ void mma3(float (&p)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  p[0] = p[1] = p[2] = p[3] = 0.0f;
  mma_tf32(p, a.hi, l0, l1);
  mma_tf32(p, a.lo, h0, h1);
  mma_tf32(p, a.hi, h0, h1);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&p)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// 16- and 4-byte copies into shared memory; nothing is read and zeros are
// written when `in` is false
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tokens t0..t0+15 of one row (`row` = its first element) of a (T, width)
// array into a [16][kLd] tile, zero-filled past `nc` tokens and `width`
// columns
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* row,
                                          int t0, int nc, int width) {
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < kC * (kW / 4); i += kThreads) {
      const int t = i >> 4, c = (i & 15) * 4;
      const bool in = t < nc && c < width;
      cp_async16(dst + t * kLd + c,
                 row + (in ? (long long)(t0 + t) * width + c : 0), in);
    }
  } else {
    for (int i = threadIdx.x; i < kC * kW; i += kThreads) {
      const int t = i >> 6, c = i & 63;
      const bool in = t < nc && c < width;
      cp_async4(dst + t * kLd + c,
                row + (in ? (long long)(t0 + t) * width + c : 0), in);
    }
  }
}

// a padded token decays nothing
__device__ __forceinline__ void pad_decay(float* sw, int nc) {
  if (nc >= kC) return;
  for (int i = nc * kLd + threadIdx.x; i < kTile; i += kThreads) sw[i] = 1.0f;
  __syncthreads();
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_scan_bwd_tf32x3_kernel(const float* __restrict__ r,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ u,
                                 const float* __restrict__ dy,
                                 const float* __restrict__ ds_end,
                                 const float* __restrict__ states,
                                 float* __restrict__ du_row,
                                 float* __restrict__ dr, float* __restrict__ dk,
                                 float* __restrict__ dv, float* __restrict__ dw,
                                 float* __restrict__ ds0, int T, int K, int V,
                                 int u_rows) {
  extern __shared__ __align__(16) float sm[];
  float* const sr = sm + kOffR;
  float* const sk = sm + kOffK;
  float* const sw = sm + kOffWt;
  float* const sv = sm + kOffV;
  float* const sdy = sm + kOffDy;
  float* const ss0 = sm + kOffS0;
  float* const sd = sm + kOffD;
  float* const rt = sm + kOffRt;
  float* const kt = sm + kOffKt;
  float* const sc = sm + kOffSc;
  float* const sh = sm + kOffH;
  float* const m1 = sm + kOffM1;
  float* const m2 = sm + kOffM2;
  float* const gpart = sm + kOffG;
  float* const dwb = sm + kOffDwB;
  float* const su = sm + kOffU;
  float* const sf = sm + kOffF;
  float* const rp = sm + kOffRp;
  float* const kp = sm + kOffKp;
  float* const xs = sm + kOffXs;
  float* const hp = sm + kOffHp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long bh = blockIdx.x;
  const float* const rk_r = r + bh * T * K;
  const float* const rk_k = k + bh * T * K;
  const float* const rk_w = w + bh * T * K;
  const float* const rv_v = v + bh * T * V;
  const float* const rv_dy = dy + bh * T * V;
  const int n = (T + kC - 1) / kC;
  const float* const str = states + bh * (long long)n * kW * kW;
  // this thread's value rows of S^T and dS^T, and its columns k of n-tile j:
  // 8j + 2tg (elements 0, 2) and 8j + 2tg + 1 (elements 1, 3)
  const int v0 = 16 * warp + g, v1 = v0 + 8;

  if (tid < kW) su[tid] = tid < K ? u[(bh % u_rows) * K + tid] : 0.0f;

  // ---------------------------------------------------------------------
  // backward, chunk by chunk, last to first
  float D[8][4];   // dS^T
  {
    const float* dse = ds_end == nullptr ? nullptr : ds_end + bh * K * V;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * tg + (e & 1), vv = e & 2 ? v1 : v0;
        D[j][e] = dse != nullptr && kk < K && vv < V
                      ? dse[(long long)kk * V + vv]
                      : 0.0f;
      }
  }
  auto bwd_issue = [&](int c) {
    const int t0 = c * kC, nc = min(kC, T - t0);
    load_tile<VEC>(sr, rk_r, t0, nc, K);
    load_tile<VEC>(sk, rk_k, t0, nc, K);
    load_tile<VEC>(sw, rk_w, t0, nc, K);
    load_tile<VEC>(sv, rv_v, t0, nc, V);
    load_tile<VEC>(sdy, rv_dy, t0, nc, V);
    const float* src = str + (long long)c * kW * kW;
    for (int i = tid; i < kW * (kW / 4); i += kThreads) {
      const int vv = i >> 4, c4 = (i & 15) * 4;
      cp_async16(ss0 + vv * kLd + c4, src + vv * kW + c4, true);
    }
    cp_commit();
  };
  // the column of the per-k phase: threads 0..63 walk the chunk forward
  // (dr, dw's first part, du), threads 64..127 backward (dk, dw's second)
  const bool fwd_role = tid < kW;
  const int kc = tid & (kW - 1);
  const bool kin = kc < K;
  const float uk = kin ? u[(bh % u_rows) * K + kc] : 0.0f;
  float du_acc = 0.0f;
  // the scores inside sub-block sb = warp & 1: sources s1 = sp and
  // s2 = 7 - sp, columns 4kg..4kg+3
  const int sb = warp & 1, sp = 2 * (warp >> 1) + (lane >> 4), kg = lane & 15;
  // the scores above the diagonal are never written
  for (int i = tid; i < kC * kLdS; i += kThreads) sc[i] = 0.0f;

  if (n > 0) bwd_issue(n - 1);
  for (int c = n - 1; c >= 0; --c) {
    cp_wait_all();
    __syncthreads();
    const int t0 = c * kC, nc = min(kC, T - t0);
    pad_decay(sw, nc);

    // ---- phase 1: dS_end^T to shared memory, decays, scores and H
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = 8 * j + 2 * tg;
      *reinterpret_cast<float2*>(sd + v0 * kLd + kk) =
          make_float2(D[j][0], D[j][1]);
      *reinterpret_cast<float2*>(sd + v1 * kLd + kk) =
          make_float2(D[j][2], D[j][3]);
    }
    if (fwd_role) {
      // R~_t = r_t prod_{j<t} w_j, F the whole product, and for the second
      // sub-block r'_t = r_t prod_{8<=j<t} w_j
      float p = 1.0f, p8 = 1.0f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float x = sr[t * kLd + kc], wt = sw[t * kLd + kc];
        rt[t * kLd + kc] = x * p;
        if (t >= 8) {
          rp[(t - 8) * kLdX + kc] = x * p8;
          p8 *= wt;
        }
        p *= wt;
      }
      sf[kc] = p;
    } else {
      // K~_s = k_s prod_{s<j<16} w_j, and for the first sub-block
      // k'_s = k_s prod_{s<j<8} w_j
      float q = 1.0f, q8 = 1.0f;
#pragma unroll
      for (int s = kC - 1; s >= 0; --s) {
        const float x = sk[s * kLd + kc], ws = sw[s * kLd + kc];
        kt[s * kLd + kc] = x * q;
        if (s < 8) {
          kp[s * kLdX + kc] = x * q8;
          q8 *= ws;
        }
        q *= ws;
      }
    }
    __syncthreads();

    // ---- the in-chunk scores Sc and dY V^T, all four warps
    {
      // inside sub-block sb, on the CUDA cores: E = k_s prod_{s<j<t} w_j as
      // a running product; the seven targets of s1 and s2 in turn, then
      // the bonus of each
      const int T0 = 8 * sb, s1 = sp, s2 = 7 - sp;
      const float* rr = sr + T0 * kLd + 4 * kg;
      const float* kr = sk + T0 * kLd + 4 * kg;
      const float* wr = sw + T0 * kLd + 4 * kg;
      float4 E = ld4(kr + s1 * kLd);
      const float4 k2 = ld4(kr + s2 * kLd);
      const float4 uu = ld4(su + 4 * kg);
      float part[9];
      {
        const float4 a = ld4(rr + s1 * kLd), b = ld4(rr + s2 * kLd);
        part[7] = fmaf(a.x, uu.x * E.x, a.y * (uu.y * E.y)) +
                  fmaf(a.z, uu.z * E.z, a.w * (uu.w * E.w));
        part[8] = fmaf(b.x, uu.x * k2.x, b.y * (uu.y * k2.y)) +
                  fmaf(b.z, uu.z * k2.z, b.w * (uu.w * k2.w));
      }
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        if (i == 7 - s1) E = k2;
        const int t = i < 7 - s1 ? s1 + 1 + i : i + 1;
        const float4 a = ld4(rr + t * kLd), d = ld4(wr + t * kLd);
        part[i] = fmaf(a.x, E.x, a.y * E.y) + fmaf(a.z, E.z, a.w * E.w);
        E.x *= d.x;
        E.y *= d.y;
        E.z *= d.z;
        E.w *= d.w;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
#pragma unroll
        for (int i = 0; i < 9; ++i)
          part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      // every lane now holds all nine sums: lane kg < 9 stores sum kg
      if (kg < 9) {
        float x = part[0];
#pragma unroll
        for (int i = 1; i < 9; ++i) x = kg == i ? part[i] : x;
        const bool first = kg < 7 - s1;
        const int t = kg == 7   ? s1
                      : kg == 8 ? s2
                      : first   ? s1 + 1 + kg
                                : kg + 1;
        const int s = kg == 7 ? s1 : kg == 8 ? s2 : first ? s1 : s2;
        sc[(T0 + t) * kLdS + T0 + s] = x;
      }
      // targets 8..15 (rows g) against sources 0..7 (columns 2tg, 2tg + 1),
      // anchored at the sub-blocks' boundary, on the tensor cores: k-steps
      // 2 warp and 2 warp + 1; rows g + 8 of the tile are zero
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * warp + jj;
        const float* ra = rp + g * kLdX + 8 * j + tg;
        const float* kb = kp + g * kLdX + 8 * j + tg;
        const FragA a = frag_a(ra[0], 0.0f, ra[4], 0.0f);
        float p[4];
        mma3(p, a, kb[0], kb[4]);
        add4(acc, p);
      }
      *reinterpret_cast<float2*>(xs + (warp * 8 + g) * 8 + 2 * tg) =
          make_float2(acc[0], acc[1]);
      // H = dY V^T over this warp's value columns 16 warp..16 warp + 15
      float hacc[2][4] = {};
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const float* x = sdy + g * kLd + 16 * warp + 8 * st + tg;
        const FragA a = frag_a(x[0], x[8 * kLd], x[4], x[8 * kLd + 4]);
#pragma unroll
        for (int js = 0; js < 2; ++js) {
          const float* b = sv + (8 * js + g) * kLd + 16 * warp + 8 * st + tg;
          float p[4];
          mma3(p, a, b[0], b[4]);
          add4(hacc[js], p);
        }
      }
      float* hw = hp + warp * kC * kLdS;
#pragma unroll
      for (int js = 0; js < 2; ++js) {
        *reinterpret_cast<float2*>(hw + g * kLdS + 8 * js + 2 * tg) =
            make_float2(hacc[js][0], hacc[js][1]);
        *reinterpret_cast<float2*>(hw + (g + 8) * kLdS + 8 * js + 2 * tg) =
            make_float2(hacc[js][2], hacc[js][3]);
      }
    }
    __syncthreads();

    // ---- phase 2: H from its four partials, in order, for phase 3; the
    // products of warp `warp`
    for (int i = tid; i < kC * kC; i += kThreads) {
      const int e = (i >> 4) * kLdS + (i & 15);
      sh[e] = ((hp[e] + hp[kC * kLdS + e]) + hp[2 * kC * kLdS + e]) +
              hp[3 * kC * kLdS + e];
    }
    {
      // g's partial over this warp's value rows
      float gp[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * j + 2 * tg;
        const float2 x0 =
            *reinterpret_cast<const float2*>(ss0 + v0 * kLd + kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(ss0 + v1 * kLd + kk);
        gp[j][0] = fmaf(D[j][2], x1.x, D[j][0] * x0.x);
        gp[j][1] = fmaf(D[j][3], x1.y, D[j][1] * x0.y);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          gp[j][0] += __shfl_xor_sync(0xffffffffu, gp[j][0], o);
          gp[j][1] += __shfl_xor_sync(0xffffffffu, gp[j][1], o);
        }
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(gpart + warp * kW + 8 * j + 2 * tg) =
              make_float2(gp[j][0], gp[j][1]);

      // M2 = dY S0^T and M1 = V dS_end^T, n-tiles 2 warp and 2 warp + 1
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const float* A = which ? sv : sdy;      // rows t or s, columns v
        const float* B = which ? sd : ss0;      // [v][k]
        float* M = which ? m1 : m2;
        float acc[2][4] = {};
#pragma unroll
        for (int st = 0; st < 8; ++st) {
          const float* x = A + g * kLd + 8 * st + tg;
          const FragA a = frag_a(x[0], x[8 * kLd], x[4], x[8 * kLd + 4]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* b = B + (8 * st + tg) * kLd + 8 * (2 * warp + jj) + g;
            float p[4];
            mma3(p, a, b[0], b[4 * kLd]);
            add4(acc[jj], p);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int kk = 8 * (2 * warp + jj) + 2 * tg;
          *reinterpret_cast<float2*>(M + g * kLd + kk) =
              make_float2(acc[jj][0], acc[jj][1]);
          *reinterpret_cast<float2*>(M + (g + 8) * kLd + kk) =
              make_float2(acc[jj][2], acc[jj][3]);
        }
      }

      // dv^T = dS^T K~^T + dY^T Sc: rows v0, v1, columns s (two n-tiles)
      float dva[2][4] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the accumulator fragments as A fragments, k-dim order 2tg, 2tg+1
        const FragA a = frag_a(D[j][0], D[j][2], D[j][1], D[j][3]);
#pragma unroll
        for (int js = 0; js < 2; ++js) {
          const float2 b = *reinterpret_cast<const float2*>(
              kt + (8 * js + g) * kLd + 8 * j + 2 * tg);
          float p[4];
          mma3(p, a, b.x, b.y);
          add4(dva[js], p);
        }
      }
      FragA ay[2];   // dY^T: rows v0, v1, k-dim t
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const float* x = sdy + (8 * st + tg) * kLd;
        ay[st] = frag_a(x[v0], x[v1], x[4 * kLd + v0], x[4 * kLd + v1]);
      }
      {
        float p[4];
        const float* b = sc + tg * kLdS + g;
        mma3(p, ay[0], b[0], b[4 * kLdS]);                  // s 0..7, t 0..7
        add4(dva[0], p);
        // s 0..7, t 8..15: the cross block, the sum of the four partials
        const float* x = xs + tg * 8 + g;
        const float c0 = ((x[0] + x[64]) + x[128]) + x[192];
        const float c1 = ((x[32] + x[96]) + x[160]) + x[224];
        mma3(p, ay[1], c0, c1);
        add4(dva[0], p);
        mma3(p, ay[1], b[8 * kLdS + 8], b[12 * kLdS + 8]);  // s 8..15
        add4(dva[1], p);
      }
      float* dvr = dv + (bh * T + t0) * V;
#pragma unroll
      for (int js = 0; js < 2; ++js)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 8 * js + 2 * tg + (e & 1), vv = e & 2 ? v1 : v0;
          if (s < nc && vv < V) dvr[(long long)s * V + vv] = dva[js][e];
        }

      // the carry: dS^T = diag(F) dS^T + dY^T R~
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* b = rt + tg * kLd + 8 * j + g;
        float p[4], q[4];
        mma3(p, ay[0], b[0], b[4 * kLd]);
        mma3(q, ay[1], b[8 * kLd], b[12 * kLd]);
        const float2 f = *reinterpret_cast<const float2*>(sf + 8 * j + 2 * tg);
        D[j][0] = fmaf(f.x, D[j][0], p[0] + q[0]);
        D[j][1] = fmaf(f.y, D[j][1], p[1] + q[1]);
        D[j][2] = fmaf(f.x, D[j][2], p[2] + q[2]);
        D[j][3] = fmaf(f.y, D[j][3], p[3] + q[3]);
      }
    }
    __syncthreads();

    // ---- phase 3: dr, dk and dw, one column k a thread.  The column's
    // r, k and w go to registers first; then the stage is free and the
    // next chunk's copies run while the recursions do
    float wv[kC], rv[kC], kv[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      wv[t] = sw[t * kLd + kc];
      rv[t] = sr[t * kLd + kc];
      kv[t] = sk[t * kLd + kc];
    }
    __syncthreads();
    if (c > 0) bwd_issue(c - 1);
    float dwa[kC];
    const long long ob = (bh * T + t0) * K + kc;
    if (fwd_role) {
      const float gk = ((gpart[kc] + gpart[kW + kc]) + gpart[2 * kW + kc]) +
                       gpart[3 * kW + kc];
      float Q[kC];
      Q[kC - 1] = 1.0f;
#pragma unroll
      for (int t = kC - 2; t >= 0; --t) Q[t] = Q[t + 1] * wv[t + 1];
      float G[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) G[t] = 0.0f;
      float cc = 0.0f, p = 1.0f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float ki = kv[i], b2 = sh[i * kLdS + i];
        if (kin && i < nc)
          dr[ob + (long long)i * K] =
              fmaf(p, m2[i * kLd + kc], G[i]) + b2 * (uk * ki);
        // dw's in-chunk pairs s < i < t for the first half of the chunk,
        // by Horner over t (the backward walk takes the second half)
        float d = 0.0f;
        if (i < kC / 2) {
#pragma unroll
          for (int t = kC - 1; t > i; --t) d = fmaf(wv[t], d, rv[t] * G[t]);
        }
        dwa[i] = fmaf(Q[i], fmaf(p, gk, cc), d);
        du_acc = fmaf(b2, rv[i] * ki, du_acc);
#pragma unroll
        for (int t = i + 1; t < kC; ++t)
          G[t] = fmaf(wv[i], G[t], ki * sh[t * kLdS + i]);
        cc = fmaf(wv[i], cc, ki * m1[i * kLd + kc]);
        p *= wv[i];
      }
    } else {
      float P[kC];
      P[0] = 1.0f;
#pragma unroll
      for (int t = 1; t < kC; ++t) P[t] = P[t - 1] * wv[t - 1];
      float L[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) L[t] = 0.0f;
      float e = 0.0f, q = 1.0f;
#pragma unroll
      for (int i = kC - 1; i >= 0; --i) {
        const float b2 = sh[i * kLdS + i];
        if (kin && i < nc)
          dk[ob + (long long)i * K] =
              fmaf(q, m1[i * kLd + kc], L[i]) + b2 * (uk * rv[i]);
        // dw's in-chunk pairs s < i < t for the second half, by Horner over
        // s: sum_{s<i} prod_{s<j<i} w_j k_s L_i[s]
        float d = 0.0f;
        if (i >= kC / 2) {
#pragma unroll
          for (int s = 0; s < i; ++s) d = fmaf(wv[s], d, kv[s] * L[s]);
        }
        dwb[i * kW + kc] = fmaf(P[i], e, d);
#pragma unroll
        for (int s = 0; s < i; ++s)
          L[s] = fmaf(wv[i], L[s], rv[i] * sh[i * kLdS + s]);
        e = fmaf(wv[i], e, rv[i] * m2[i * kLd + kc]);
        q *= wv[i];
      }
    }
    __syncthreads();
    if (fwd_role && kin)
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (i < nc) dw[ob + (long long)i * K] = dwa[i] + dwb[i * kW + kc];
  }

  if (fwd_role && kin) du_row[bh * K + kc] = du_acc;
  if (ds0 != nullptr) {
    float* o = ds0 + bh * (long long)K * V;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * tg + (e & 1), vv = e & 2 ? v1 : v0;
        if (kk < K && vv < V) o[(long long)kk * V + vv] = D[j][e];
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool VEC>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* ds_end,
           const float* states, float* du_row, float* dr, float* dk,
           float* dv, float* dw, float* ds0, int BH, int T, int K, int V,
           int u_rows, cudaStream_t stream) {
  auto kernel = rwkv6_scan_bwd_tf32x3_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<BH, kThreads, kSmemBytes, stream>>>(r, k, v, w, u, dy, ds_end,
                                               states, du_row, dr, dk, dv, dw,
                                               ds0, T, K, V, u_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Route "tf32x3" of rwkv6_scan_bwd_launch (rwkv6_scan_bwd.cu), which has
// checked the arguments: BH >= 1, T >= 0, K and V in [1, 64], u_rows >= 1
// dividing BH; states holds the BH * ceil(T / 16) tiles of 64 x 64 floats
// that route C of the forward wrote (rwkv6_scan_sm90.cu), 16-byte
// aligned; du_row (BH, K) takes du's per-row partials.
int rwkv6_scan_bwd_tf32x3_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* dy,
                                 const void* ds_end, const void* states,
                                 void* du_row, void* dr, void* dk, void* dv,
                                 void* dw, void* ds0, int BH, int T, int K,
                                 int V, int u_rows, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const bool vec = K % 4 == 0 && V % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(w) && aligned16(v) && aligned16(dy);
  if (vec)
    return launch<true>(f(r), f(k), f(v), f(w), f(u), f(dy), f(ds_end),
                        f(states), o(du_row), o(dr), o(dk), o(dv), o(dw),
                        o(ds0), BH, T, K, V, u_rows, stream);
  return launch<false>(f(r), f(k), f(v), f(w), f(u), f(dy), f(ds_end),
                       f(states), o(du_row), o(dr), o(dk), o(dv), o(dw),
                       o(ds0), BH, T, K, V, u_rows, stream);
}
