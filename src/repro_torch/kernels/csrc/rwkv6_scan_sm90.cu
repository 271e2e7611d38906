// RWKV-6 linear-attention scan for NVIDIA Hopper (sm_90a), float32 on the
// TF32 tensor cores ("route C", "tf32x3"), plain C interface.  Built with
// the other sources by repro_torch/kernels/build.py; launched through
// rwkv6_scan_launch (rwkv6_scan.cu) for every call that
// kernels/rwkv6_scan.scan_route sends to route C.  Route S, the token-serial
// rwkv6_scan_kernel in rwkv6_scan.cu, stays beside it.
//
//  * rwkv6_scan_tf32x3_kernel <- src/repro/kernels/rwkv6_scan.py rwkv6_scan
//                                (:69, pallas_call at :84)
//    For each (batch*head) row bh, over tokens t:
//      y_t = r_t . S_{t-1} + (r_t . (u (.) k_t)) v_t
//      S_t = diag(w_t) S_{t-1} + k_t^T v_t
//    r, k, w (BH, T, K), v (BH, T, V), state (BH, K, V), all float32.
//
// Bound on this card: bytes.  At the RWKV-6 path's stacked shape
// (1280, 128, 64, 64) a call moves 230 MB (0.0689 ms at 3.35 TB/s); the
// token-serial form issues ~3 float32 instructions per (k, v, token), about
// 0.09 ms of pure issue there.  The chunked form moves that work to the
// tensor cores, and what is left on the CUDA cores is what bounds this
// kernel in practice: it is designed to issue few instructions a token.
//   - one block of four warps per row walks the row's chunks of kC = 16
//     tokens in order (the TPU grid's sequential axis).  The state stays in
//     registers for the whole sequence, transposed (value columns as rows):
//     warp i holds S^T for value columns 16i..16i+15 as the accumulator
//     fragments of an m16n8 tile, which are, up to an order of k that both
//     operands share, the A fragments of the next chunk's r . S product.
//     It is read once and written once.
//   - the four products of a chunk run as mma.sync m16n8k8 TF32 with every
//     operand split into a big and a small TF32 part (hi = rna(x),
//     lo = rna(x - hi)), three products each (hi*lo + lo*hi + hi*hi), each
//     8-k step (32-k for r . S) into a fresh accumulator that is added to
//     float32 sums on the CUDA cores (the tensor cores truncate their
//     partial sums):
//       y^T   += S^T (decayed r)^T          (inter-chunk, K-deep)
//       y^T   += V^T A^T                    (in-chunk scores times V)
//       A_x    = (decayed r) (decayed k)^T  (scores across the two
//                                            8-token sub-blocks)
//       S^T    = diag(decay) S^T + V^T (decayed k)
//     The bonus and the scores inside a sub-block (the causal diagonal) are
//     formed on the CUDA cores; that work and the cross-sub-block scores are
//     spread over all four warps.
//   - no decay product is ever divided by.  Every factor is a product of w
//     over a forward interval, at most 1, built by running products: r_t by
//     prod_{chunk start <= j < t} w_j, k_s by prod_{s < j < chunk end} w_j,
//     the state by the whole chunk's product; across the two sub-blocks the
//     factors are anchored at their boundary (r_t by the product from the
//     boundary to t-1, k_s by the one from s+1 to the boundary); inside a
//     sub-block each pair is weighted directly by a running product.  A
//     factor that underflows to 0 is the right answer, so the kernel is
//     finite wherever the token-serial recurrence is (the reference's form,
//     which divides by the in-chunk products, is not under strong decay).
//   - with a states buffer (the scan under autograd), the state entering
//     each chunk is written out for the backward, 16 KB a chunk.
//   - r, k, w and v of chunk c+1 are copied into a two-stage ring while
//     chunk c computes: by TMA (four 3-D boxes of 16 tokens x 64 columns,
//     issued by one thread, completion on an mbarrier) where K and V are
//     multiples of 4 and the tensors 16-byte aligned, else by 4-byte
//     cp.async.  Both zero-fill columns past K or V and tokens past T (a
//     padded token's w is read as 1).
// Shared memory is ~62 KB a block: three blocks (twelve warps) an SM.

#include "masked_act_sm90.cuh"

namespace {

constexpr int kC = 16;          // tokens a chunk
constexpr int kSub = 8;         // tokens a sub-block, two a chunk
constexpr int kW = 64;          // K and V, zero-padded on chip
constexpr int kThreads = 128;   // warp i owns value columns 16i..16i+15
constexpr int kStages = 2;      // chunks in the copy ring
constexpr int kYStep = 4;       // k-steps a fresh accumulator of r . S
// shared-memory rows, in floats or float4s; the padded ones keep the
// fragment loads free of bank conflicts
constexpr int kRow = 64;        // r, k, w, v rows of a stage (floats)
constexpr int kTile = kC * kRow;          // one array of a stage (floats)
constexpr int kStage = 4 * kTile;         // r, k, w, v (floats)
constexpr int kRt = 72;         // R~ big and small parts, rows t (floats)
constexpr int kXRow = 68;       // R', K' rows (floats)
constexpr int kK4 = 12;         // K~^T rows: 8 s-pairs + 4 (float4)
constexpr int kA4 = 12;         // A rows: 8 s-pairs + 4 (float4)

// byte offsets from the base of dynamic shared memory
constexpr int kOffRing = 0;
constexpr int kOffRtHi = kOffRing + 4 * kStages * kStage;
constexpr int kOffRtLo = kOffRtHi + 4 * kC * kRt;
constexpr int kOffKt = kOffRtLo + 4 * kC * kRt;
constexpr int kOffA = kOffKt + 16 * kW * kK4;
constexpr int kOffRp = kOffA + 16 * kC * kA4;
constexpr int kOffKp = kOffRp + 4 * kSub * kXRow;
constexpr int kOffX = kOffKp + 4 * kSub * kXRow;   // 4 partial 8x8 tiles
constexpr int kOffDec = kOffX + 4 * 4 * kSub * kSub;
constexpr int kOffU = kOffDec + 4 * kW;
constexpr int kOffBar = kOffU + 4 * kW;
constexpr int kSmemBytes = kOffBar + 8 * kStages;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for a finite x, in two integer
// instructions instead of its four
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the big and small TF32 parts of x: x - hi is exact in float32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ float as_f(uint32_t x) {
  return __uint_as_float(x);
}
__device__ __forceinline__ uint32_t as_u(float x) {
  return __float_as_uint(x);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p = a * b over one 8-k step, a and b each as big and small parts: the
// small products first, into a fresh accumulator, then the big one.
// bb = {hi of row tg, hi of row tg + 4, lo of row tg, lo of row tg + 4} of
// the B fragment.
__device__ __forceinline__ void mma3(float (&p)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 bb) {
  p[0] = p[1] = p[2] = p[3] = 0.0f;
  mma_tf32(p, ah, as_u(bb.z), as_u(bb.w));
  mma_tf32(p, al, as_u(bb.x), as_u(bb.y));
  mma_tf32(p, ah, as_u(bb.x), as_u(bb.y));
}

__device__ __forceinline__ float4 split2(float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split(x0, h0, l0);
  split(x1, h1, l1);
  return make_float4(as_f(h0), as_f(h1), as_f(l0), as_f(l1));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 4-byte copy into shared memory; nothing is read and a zero is written
// when `in` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

struct Maps {
  CUtensorMap r, k, w, v;   // (BH, T, K) and (BH, T, V), boxes of 16 x 64
};

// TMA = true: r, k, w and v arrive by TMA; false: by 4-byte cp.async
template <bool TMA>
__global__ void __launch_bounds__(kThreads, 3)
    rwkv6_scan_tf32x3_kernel(const __grid_constant__ Maps maps,
                             const float* __restrict__ r,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ w,
                             const float* __restrict__ u,
                             const float* __restrict__ s0,
                             float* __restrict__ y, float* __restrict__ s_out,
                             float* __restrict__ states,
                             int T, int K, int V, int u_rows,
                             long long s0_stride) {
  // (typed offsets from the array itself, so that every access is known to
  // be to shared memory; the TMA boxes need 128-byte alignment)
  extern __shared__ __align__(128) uint8_t base[];
  float* ring = reinterpret_cast<float*>(base + kOffRing);
  // R~ = r (.) prod_{0<=j<t} w, big and small parts: [t][k]
  float* rt_hi = reinterpret_cast<float*>(base + kOffRtHi);
  float* rt_lo = reinterpret_cast<float*>(base + kOffRtLo);
  // K~^T = (k (.) prod_{s<j<16} w)^T: [k][s-pair] {hi s0, hi s1, lo s0, lo s1}
  float4* kt4 = reinterpret_cast<float4*>(base + kOffKt);
  // the scores inside the sub-blocks, bonus on the diagonal: [t][s-pair]
  float4* a4 = reinterpret_cast<float4*>(base + kOffA);
  float* rp = reinterpret_cast<float*>(base + kOffRp);   // r (.) prod_{8<=j<t}
  float* kp = reinterpret_cast<float*>(base + kOffKp);   // k (.) prod_{s<j<8}
  // the scores of targets 8..15 against sources 0..7, four partial sums
  float* xs = reinterpret_cast<float*>(base + kOffX);
  float* dec = reinterpret_cast<float*>(base + kOffDec);  // the chunk's prod w
  float* su = reinterpret_cast<float*>(base + kOffU);     // u, zero-padded
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kOffBar);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.x;
  const long long row_k = (long long)bh * T * K, row_v = (long long)bh * T * V;
  const int nchunks = (T + kC - 1) / kC;

  // A's entries above the diagonal, and its cross block, are never written
  for (int i = tid; i < kC * kA4; i += kThreads)
    a4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < kW)
    su[tid] = tid < K ? u[(long long)(bh % u_rows) * K + tid] : 0.0f;
  if (TMA && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // S^T: value columns v0 = 16*warp + g and v1 = v0 + 8 are the rows,
  // k = 8j + 2tg (+1) the columns of n-tile j (accumulator layout)
  const int v0 = 16 * warp + g, v1 = v0 + 8;
  float S[8][4];
  {
    const float* s0r = s0 + bh * s0_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * tg + (e & 1), vv = e & 2 ? v1 : v0;
        S[j][e] = kk < K && vv < V ? s0r[(long long)kk * V + vv] : 0.0f;
      }
  }
  __syncthreads();

  // chunk c's copies into stage c % 2
  auto issue = [&](int c) {
    float* st = ring + (c % kStages) * kStage;
    const int t0 = c * kC;
    if constexpr (TMA) {
      if (tid == 0) {
        uint64_t* bar = &full[c % kStages];
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar, 4 * kStage);
        tma_load_3d(st, &maps.r, 0, t0, bh, bar);
        tma_load_3d(st + kTile, &maps.k, 0, t0, bh, bar);
        tma_load_3d(st + 2 * kTile, &maps.w, 0, t0, bh, bar);
        tma_load_3d(st + 3 * kTile, &maps.v, 0, t0, bh, bar);
      }
    } else {
      const int n = min(kC, T - t0);
      for (int i = tid; i < 4 * kTile; i += kThreads) {
        const int a = i / kTile, t = (i / kRow) % kC, col = i % kRow;
        const bool isv = a == 3;
        const int width = isv ? V : K;
        const bool in = t < n && col < width;
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : v;
        src += (isv ? row_v : row_k) +
               (in ? (long long)(t0 + t) * width + col
                   : (long long)t0 * width);
        cp_async4(st + i, src, in);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };

  // lane-fixed fragment addresses, y offset, and columns in V
  const int yo = 2 * tg * V + v0;
  const bool in0 = v0 < V, in1 = v1 < V;
  const float* rt_hi_l = rt_hi + g * kRt + 2 * tg;
  const float* rt_lo_l = rt_lo + g * kRt + 2 * tg;
  const float4* kt4_l = kt4 + g * kK4 + tg;
  const float4* a4_l = a4 + g * kA4 + tg;
  // the decay pass: column kc of sub-block h
  const int kc = tid & 63, h = tid >> 6;
  // the scores inside sub-block sb = warp & 1: sources s1 = sp and
  // s2 = 7 - sp, columns 4kg..4kg+3
  const int sb = warp & 1, sp = 2 * (warp >> 1) + (lane >> 4), kg = lane & 15;

  if (nchunks > 0) issue(0);

  for (int c = 0; c < nchunks; ++c) {
    if constexpr (TMA)
      mbar_wait(&full[c % kStages], (c / kStages) & 1);
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // chunk c has landed; chunk c-1 is done everywhere
    const int t0 = c * kC, n = min(kC, T - t0);
    if (c + 1 < nchunks) issue(c + 1);
    if (states != nullptr) {
      // the state entering chunk c, for the backward: (v, k) of a 64 x 64
      // tile
      float* dst = states + ((long long)bh * nchunks + c) * kW * kW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * j + 2 * tg;
        *reinterpret_cast<float2*>(dst + v0 * kW + kk) =
            make_float2(S[j][0], S[j][1]);
        *reinterpret_cast<float2*>(dst + v1 * kW + kk) =
            make_float2(S[j][2], S[j][3]);
      }
    }
    float* st = ring + (c % kStages) * kStage;
    const float* sr = st;
    const float* sk = st + kTile;
    float* sw = st + 2 * kTile;
    const float* sv = st + 3 * kTile;
    if (n < kC) {
      // tokens past T arrived as zeros: a padded token decays nothing
      for (int i = n * kRow + tid; i < kTile; i += kThreads) sw[i] = 1.0f;
      __syncthreads();
    }

    // ---- decays: running products of w down column kc, never divided by
    {
      float wa[8];       // this sub-block's w
      float Fo = 1.0f;   // the other sub-block's whole product
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wa[i] = sw[(8 * h + i) * kRow + kc];
        Fo *= sw[(8 * (1 - h) + i) * kRow + kc];
      }
      // P[i] = prod_{8h<=j<8h+i} w, Q[i] = prod_{8h+i<j<8h+8} w
      float P[8], Q[8];
      P[0] = Q[7] = 1.0f;
#pragma unroll
      for (int i = 1; i < 8; ++i) P[i] = P[i - 1] * wa[i - 1];
#pragma unroll
      for (int i = 6; i >= 0; --i) Q[i] = Q[i + 1] * wa[i + 1];
      const float Fh = P[7] * wa[7];
      const float F0 = h ? Fo : Fh, F1 = h ? Fh : Fo;
      uint32_t kh[8], kl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * h + i;
        const float rv = sr[t * kRow + kc], kv = sk[t * kRow + kc];
        uint32_t rh, rl;
        split(rv * (h ? P[i] * F0 : P[i]), rh, rl);
        rt_hi[t * kRt + kc] = as_f(rh);
        rt_lo[t * kRt + kc] = as_f(rl);
        split(kv * (h ? Q[i] : Q[i] * F1), kh[i], kl[i]);
        if (h)
          rp[i * kXRow + kc] = rv * P[i];
        else
          kp[i * kXRow + kc] = kv * Q[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kt4[kc * kK4 + 4 * h + i] =
            make_float4(as_f(kh[2 * i]), as_f(kh[2 * i + 1]),
                        as_f(kl[2 * i]), as_f(kl[2 * i + 1]));
      if (h == 0) dec[kc] = F0 * F1;
    }
    __syncthreads();

    // ---- the in-chunk scores, all four warps
    {
      // inside sub-block sb, on the CUDA cores: E = k_s (.) prod_{s<j<t} w_j
      // as a running product; the seven targets of s1 and s2 in turn, then
      // the bonus of each
      const int T0 = 8 * sb, s1 = sp, s2 = 7 - sp;
      const float* rr = sr + T0 * kRow + 4 * kg;
      const float* kr = sk + T0 * kRow + 4 * kg;
      const float* wr = sw + T0 * kRow + 4 * kg;
      float4 E = ld4(kr + s1 * kRow);
      const float4 k2 = ld4(kr + s2 * kRow);
      const float4 uu = ld4(su + 4 * kg);
      float part[9];
      {
        const float4 a = ld4(rr + s1 * kRow), b = ld4(rr + s2 * kRow);
        part[7] = fmaf(a.x, uu.x * E.x, a.y * (uu.y * E.y)) +
                  fmaf(a.z, uu.z * E.z, a.w * (uu.w * E.w));
        part[8] = fmaf(b.x, uu.x * k2.x, b.y * (uu.y * k2.y)) +
                  fmaf(b.z, uu.z * k2.z, b.w * (uu.w * k2.w));
      }
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        if (i == 7 - s1) E = k2;
        const int t = i < 7 - s1 ? s1 + 1 + i : i + 1;
        const float4 a = ld4(rr + t * kRow), d = ld4(wr + t * kRow);
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
        uint32_t hi, lo;
        split(x, hi, lo);
        float* af = reinterpret_cast<float*>(a4) +
                    ((T0 + t) * kA4 + ((T0 + s) >> 1)) * 4 + (s & 1);
        af[0] = as_f(hi);
        af[2] = as_f(lo);
      }
      // targets 8..15 (rows g) against sources 0..7 (columns 2tg, 2tg + 1)
      // on the tensor cores, k-steps 2*warp and 2*warp + 1; rows g + 8 of
      // the tile are zero
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * warp + jj;
        const float* ra = rp + g * kXRow + 8 * j + tg;
        const float* kb = kp + g * kXRow + 8 * j + tg;
        uint32_t ah[4] = {0, 0, 0, 0}, al[4] = {0, 0, 0, 0};
        split(ra[0], ah[0], al[0]);
        split(ra[4], ah[2], al[2]);
        float p[4];
        mma3(p, ah, al, split2(kb[0], kb[4]));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p[e];
      }
      *reinterpret_cast<float2*>(xs + (warp * kSub + g) * kSub + 2 * tg) =
          make_float2(acc[0], acc[1]);
    }
    __syncthreads();

    // ---- the products of warp `warp`: value columns v0, v1
    {
      // V^T as A fragments: rows v0, v1; s = 8j + 2tg, 8j + 2tg + 1
      uint32_t vh[2][4], vl[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* sa = sv + (8 * j + 2 * tg) * kRow;
        split(sa[v0], vh[j][0], vl[j][0]);
        split(sa[v1], vh[j][1], vl[j][1]);
        split(sa[kRow + v0], vh[j][2], vl[j][2]);
        split(sa[kRow + v1], vh[j][3], vl[j][3]);
      }
      float yacc[2][4] = {};
      float p[4];
      // y^T += V^T A^T: target tile 0 takes source step 0 (sub-block 0);
      // tile 1 takes step 0 (the cross block, the sum of the four partial
      // tiles) and step 1 (sub-block 1)
      mma3(p, vh[0], vl[0], a4_l[0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[0][e] += p[e];
      {
        const float* x = xs + g * kSub + 2 * tg;
        float2 xa = *reinterpret_cast<const float2*>(x);
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          const float2 xb =
              *reinterpret_cast<const float2*>(x + q * kSub * kSub);
          xa.x += xb.x;
          xa.y += xb.y;
        }
        mma3(p, vh[0], vl[0], split2(xa.x, xa.y));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[1][e] += p[e];
      mma3(p, vh[1], vl[1], a4_l[8 * kA4 + 4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[1][e] += p[e];
      // y^T += S^T R~^T: k-step j is n-tile j of the state; a fresh
      // accumulator per kYStep k-steps
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += kYStep) {
        float q[2][4] = {};
#pragma unroll
        for (int j = j0; j < j0 + kYStep; ++j) {
          uint32_t ah[4], al[4];
          split(S[j][0], ah[0], al[0]);
          split(S[j][2], ah[1], al[1]);
          split(S[j][1], ah[2], al[2]);
          split(S[j][3], ah[3], al[3]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float2 bh = *reinterpret_cast<const float2*>(
                rt_hi_l + 8 * m * kRt + 8 * j);
            const float2 bl = *reinterpret_cast<const float2*>(
                rt_lo_l + 8 * m * kRt + 8 * j);
            mma_tf32(q[m], ah, as_u(bl.x), as_u(bl.y));
            mma_tf32(q[m], al, as_u(bh.x), as_u(bh.y));
            mma_tf32(q[m], ah, as_u(bh.x), as_u(bh.y));
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[m][e] += q[m][e];
      }
      float* yc = y + row_v + (long long)t0 * V + yo;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * m + 2 * tg + (e & 1) < n && (e & 2 ? in1 : in0))
            yc[(8 * m + (e & 1)) * V + (e & 2 ? 8 : 0)] = yacc[m][e];
      // S^T = diag(decay) S^T + V^T K~
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float q[4];
        mma3(p, vh[0], vl[0], kt4_l[8 * j * kK4]);
        mma3(q, vh[1], vl[1], kt4_l[8 * j * kK4 + 4]);
        const float2 d =
            *reinterpret_cast<const float2*>(dec + 8 * j + 2 * tg);
        S[j][0] = fmaf(d.x, S[j][0], p[0] + q[0]);
        S[j][1] = fmaf(d.y, S[j][1], p[1] + q[1]);
        S[j][2] = fmaf(d.x, S[j][2], p[2] + q[2]);
        S[j][3] = fmaf(d.y, S[j][3], p[3] + q[3]);
      }
    }
  }

  float* so = s_out + (long long)bh * K * V;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * j + 2 * tg + (e & 1), vv = e & 2 ? v1 : v0;
      if (kk < K && vv < V) so[(long long)kk * V + vv] = S[j][e];
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a (outer, mid, inner) float32 tensor, boxes of (1, box_mid, box_inner);
// elements outside the tensor arrive as zeros
bool encode_3d(CUtensorMap* map, const void* p, long long inner,
               long long mid, long long outer, int box_inner, int box_mid) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)(inner * 4),
                                 (cuuint64_t)(inner * mid * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_mid, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA>
int launch(const Maps& maps, const float* r, const float* k, const float* v,
           const float* w, const float* u, const float* s0, float* y,
           float* s_out, float* states, int BH, int T, int K, int V,
           int u_rows, long long s0_stride, cudaStream_t stream) {
  auto kernel = rwkv6_scan_tf32x3_kernel<TMA>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<BH, kThreads, kSmemBytes, stream>>>(maps, r, k, v, w, u, s0, y,
                                               s_out, states, T, K, V,
                                               u_rows, s0_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Route C of rwkv6_scan_launch (rwkv6_scan.cu), which has checked the
// arguments: BH >= 1, T >= 0, K and V in [1, 64], u_rows >= 1 dividing BH,
// s0_stride K*V or 0.  states, if not null, holds BH * ceil(T / 16) tiles
// of 64 x 64 floats and takes the state entering each chunk, (v, k) of a
// tile, for the backward (rwkv6_scan_bwd_sm90.cu).
int rwkv6_scan_tf32x3_launch(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* y, void* s_out, void* states, int BH,
                             int T, int K, int V, int u_rows,
                             long long s0_stride, cudaStream_t stream) {
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  Maps maps{};
  const bool tma = K % 4 == 0 && V % 4 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(v) && aligned16(w) && T > 0 &&
                   encode_3d(&maps.r, r, K, T, BH, kW, kC) &&
                   encode_3d(&maps.k, k, K, T, BH, kW, kC) &&
                   encode_3d(&maps.w, w, K, T, BH, kW, kC) &&
                   encode_3d(&maps.v, v, V, T, BH, kW, kC);
  if (tma)
    return launch<true>(maps, fp(r), fp(k), fp(v), fp(w), fp(u), fp(s0),
                        o(y), o(s_out), o(states), BH, T, K, V, u_rows,
                        s0_stride, stream);
  return launch<false>(maps, fp(r), fp(k), fp(v), fp(w), fp(u), fp(s0), o(y),
                       o(s_out), o(states), BH, T, K, V, u_rows, s0_stride,
                       stream);
}
