// Fused gate -> 3x3 convolution for NVIDIA Hopper (sm_90a), float32 on the
// tensor cores ("route T", "tf32x3"), plain C interface.  Built with the
// other sources by repro_torch/kernels/build.py; launched through
// masked_act_conv3x3_launch (masked_act.cu), which hands it every call that
// kernels/masked_act.conv_route sends to route T: float32 with B % 64 == 0,
// Cin and Cout multiples of 8, 16-byte aligned operands.  Every other call
// takes route F, gate_conv3x3_kernel in masked_act.cu (float32 FMA).
//
//  * gate_conv3x3_tf32x3_kernel <- src/repro/kernels/masked_act.py
//                                  masked_act_conv3x3 (:393) and
//                                  masked_act_conv3x3_batched (:424)
//    out[n, b, oy, ox, :] = sum over the in-image taps (ky, kx) and ci of
//      gate(x[n|0, b, oy*s + ky - pt, ox*s + kx - pl, ci], m[n, ., ., ci])
//      * w[ky, kx, ci, :],  SAME pads as XLA, float32 sums.
//
//    Bound by operations.  Float32 products reach the tensor cores only as
//    TF32 (10 mantissa bits), so each operand is split into a TF32 "big"
//    part and a TF32 "small" part (hi = rna(v), lo = rna(v - hi)) and
//    a*b is taken as hi_a*hi_b + hi_a*lo_b + lo_a*hi_b, float32 sums: about
//    22 significant bits a product, the float32 level, for three TF32
//    products (495 TFLOP/s dense, so 165 TFLOP/s of float32 work against
//    67 outside the tensor cores).  The design:
//      - pixel-major tiles: a block owns one output pixel (oy, ox) of one
//        candidate, 128 images (two 64-row wgmma fragments, one consumer
//        warpgroup each) and BN = 64 or 128 output channels.  Every
//        row of the tile reads the same input pixel per tap, so a tap in
//        the padding is skipped for the whole tile (nothing loaded, nothing
//        multiplied), the A slice of a (tap, 32-channel box) is a plain
//        2-D box of x viewed as (B, H*W*Cin), and its mask slice is one
//        row of 32 floats shared by all 128 rows;
//      - one producer thread keeps TMA loads in flight into a ring of
//        stages:
//        the x box (128 rows x 32 floats, 128-byte swizzle), the mask row,
//        and w_hi / w_lo boxes (BN rows x 32 k, K-major, 128-byte swizzle)
//        from a (2*Cout, 9*Cin) copy of the weights that split_weights_kernel
//        writes first, in the same stream, into scratch the caller gives;
//      - consumers read their A fragment (rows g, g+8, k t, t+4 of each 8-k
//        step) from the swizzled tile, gate it with gate_n<KIND>, split it,
//        and issue three wgmma.m64nBNk8.f32.tf32.tf32 with A from registers;
//        one slice's products stay in flight while the next fragment is
//        gated.  The tensor cores truncate each partial sum toward zero, so
//        a running sum over all of K drifts by about one float32 ulp per
//        product issued (5.7x the plain version's error against float64
//        at ResNet18's stage 0 on an H100): a stage's products (32 k at BN = 128, 64 k in two
//        boxes at BN = 64, so that its fixed costs are spread over as
//        many products) go into a fresh accumulator p, which is added to
//        the float32 sums d, rounded to nearest, when they have completed;
//        the stage then goes back to the producer.  d and p together cap a
//        block at BN = 128;
//      - a persistent grid, one block (384 threads: two consumer
//        warpgroups, one producer warpgroup that hands its registers to
//        them with setmaxnreg) on each SM, walks the tiles in a heavy-first
//        order: pixels whose nine taps are all in the image, then the
//        border, so the short tiles fill the last round; the producer runs
//        into the next tile while the consumers store this one.
//    Ragged images (B not a multiple of 128) and columns past Cout are
//    computed from the next candidate's rows / the other half of the split
//    weights and never stored.  A Cin that is not a multiple of 32 ends in
//    a partial step whose 8-k slices past Cin are not multiplied.

#include "masked_act_common.cuh"
#include "masked_act_sm90.cuh"

namespace {

constexpr int T3_BM = 128;                     // images per block
constexpr int T3_BK = 32;                      // k per box: 128 bytes
constexpr int T3_CONSUMERS = 256;              // two warpgroups
constexpr int T3_THREADS = T3_CONSUMERS + 128; // + the producer warpgroup
constexpr int T3_A_TILE = T3_BM * T3_BK * 4;   // 16 KB

// for each tile width: the stages of the ring and the 32-k boxes a stage
// (a stage's products go into one fresh accumulator), within 227 KB of
// shared memory, one block an SM
template <int BN> struct T3Cfg;
template <> struct T3Cfg<64> {
  static constexpr int kStages = 3, kAtoms = 2;
};
template <> struct T3Cfg<128> {
  static constexpr int kStages = 4, kAtoms = 1;
};

template <int BN>
constexpr int t3_smem() {
  return 1024 +                                     // alignment slack
         T3Cfg<BN>::kStages * T3Cfg<BN>::kAtoms *
             (T3_A_TILE + 2 * BN * T3_BK * 4 + T3_BK * 4) +
         2 * T3Cfg<BN>::kStages * 8;
}

struct T3Geom {
  int B, H, W, Cin, Cout, Ho, Wo, stride, pad_h, pad_w;
  int x_cand_rows;        // B for a stacked x, 0 for a shared one
  int mask_cand;          // 1 for a mask per candidate, 0 for one mask
  int n_cand, img_tiles, n_tiles;
  int iy0, iy1, ix0, ix1;  // output pixels whose nine taps are in the image
};

// the output pixel, candidate, image tile and column tile of block t:
// column tiles, image tiles and candidates vary fastest, and the pixels come
// interior first, then the border rows above, beside and below it
__device__ __forceinline__ void t3_tile(const T3Geom& g, int t, int& cand,
                                        int& it, int& nt, int& oy, int& ox) {
  nt = t % g.n_tiles;
  t /= g.n_tiles;
  it = t % g.img_tiles;
  t /= g.img_tiles;
  cand = t % g.n_cand;
  t /= g.n_cand;
  const int iw = g.ix1 - g.ix0, ih = g.iy1 - g.iy0;
  if (t < ih * iw) {
    oy = g.iy0 + t / iw;
    ox = g.ix0 + t % iw;
    return;
  }
  t -= ih * iw;
  if (t < g.iy0 * g.Wo) {
    oy = t / g.Wo;
    ox = t % g.Wo;
    return;
  }
  t -= g.iy0 * g.Wo;
  const int side = g.Wo - iw;
  if (t < ih * side) {
    oy = g.iy0 + t / side;
    const int r = t % side;
    ox = r < g.ix0 ? r : r + iw;
    return;
  }
  t -= ih * side;
  oy = g.iy1 + t / g.Wo;
  ox = t % g.Wo;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// wgmma descriptor of a K-major B tile with the 128-byte swizzle: rows of
// 32 k (128 bytes), eight rows an atom; the stride byte offset steps one
// atom (1024 bytes, in 16-byte units); the leading offset is unused
__device__ __forceinline__ uint64_t t3_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d[64 x 64] = A[64 x 8] (tf32 in registers) * B[8 x 64] (tf32 in shared
// memory, K-major, by descriptor) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

// d[64 x 128] = A[64 x 8] (tf32 in registers) * B[8 x 128] (tf32 in
// shared memory, K-major, by descriptor) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int acc) {
  if constexpr (BN == 64) wgmma_tf32_n64(d, a, desc_b, acc);
  else wgmma_tf32_n128(d, a, desc_b, acc);
}

// w (K, Cout) row-major, K = 9*Cin (HWIO flattened) -> ws[0] = rna(w)^T and
// ws[1] = rna(w - rna(w))^T, each (Cout, K): the K-major big and small
// parts of the weights.  32 x 32 tiles through shared memory.
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ ws,
                     int K, int Cout) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < Cout) ? w[(long long)k * Cout + n] : 0.0f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < Cout && k < K) {
      const float v = tile[tx][i];
      const float hi = __uint_as_float(tf32_rna(v));
      const long long o = (long long)n * K + k;
      ws[o] = hi;
      ws[(long long)Cout * K + o] = __uint_as_float(tf32_rna(v - hi));
    }
  }
}

template <int KIND, int BN>
__global__ void __launch_bounds__(T3_THREADS, 1)
gate_conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_mask,
                           float* __restrict__ out, const T3Geom g,
                           const int tiles) {
  constexpr int STAGES = T3Cfg<BN>::kStages;
  constexpr int ATOMS = T3Cfg<BN>::kAtoms;          // 32-k boxes a stage
  constexpr int SK = ATOMS * T3_BK;                 // k a stage
  constexpr int B_ATOM = BN * T3_BK * 4;            // BN rows x 128 bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: A box a at as + (s*ATOMS + a) * T3_A_TILE; w_hi box a at
  // bs + (2*s*ATOMS + a) * B_ATOM, w_lo box a ATOMS boxes further; the
  // mask's 32 floats of box a at ms + (s*ATOMS + a) * T3_BK
  uint8_t* as = smem;
  uint8_t* bs = as + STAGES * ATOMS * T3_A_TILE;
  float* ms = reinterpret_cast<float*>(bs + STAGES * 2 * ATOMS * B_ATOM);
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + STAGES * SK);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int csteps = (g.Cin + SK - 1) / SK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T3_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Both sides walk the same tiles (blockIdx.x, then every gridDim.x-th),
  // in-image taps and channel steps; kt counts the stages across tiles, so
  // the producer runs into the next tile while the consumers store this one.
  if (tid >= T3_CONSUMERS) {
    // ---- producer: one thread keeps the ring full; its warpgroup gives
    // its registers to the consumers (one big branch each, never rejoined)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == T3_CONSUMERS) {
      const uint32_t bytes = ATOMS * (T3_A_TILE + 2 * B_ATOM + T3_BK * 4);
      int kt = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int cand, it, nt, oy, ox;
        t3_tile(g, tile, cand, it, nt, oy, ox);
        const int xrow = cand * g.x_cand_rows + it * T3_BM;
        const int mrow = cand * g.mask_cand;
        const int n0 = nt * BN;
        const int iy0 = oy * g.stride - g.pad_h;
        const int ix0 = ox * g.stride - g.pad_w;
        for (int tap = 0; tap < 9; ++tap) {
          const int iy = iy0 + tap / 3, ix = ix0 + tap % 3;
          if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
          const int col = (iy * g.W + ix) * g.Cin;
          for (int c = 0; c < csteps; ++c, ++kt) {
            const int s = kt % STAGES;
            if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) + 1) & 1);
            mbar_expect_tx(&full[s], bytes);
#pragma unroll
            for (int a = 0; a < ATOMS; ++a) {
              const int c0 = c * SK + a * T3_BK;
              const int k0 = tap * g.Cin + c0;
              uint8_t* bh = bs + (2 * s * ATOMS + a) * B_ATOM;
              tma_load_2d(as + (s * ATOMS + a) * T3_A_TILE, &tm_x, col + c0,
                          xrow, &full[s]);
              tma_load_2d(bh, &tm_w, k0, n0, &full[s]);
              tma_load_2d(bh + ATOMS * B_ATOM, &tm_w, k0, g.Cout + n0,
                          &full[s]);
              tma_load_2d(ms + (s * ATOMS + a) * T3_BK, &tm_mask, col + c0,
                          mrow, &full[s]);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns images 64*wg .. 64*wg + 63; lane holds
  // rows r and r + 8 at k t and t + 4 of each 8-k slice, which the 128-byte
  // swizzle puts in 16-byte chunks (2j) ^ (r % 8) and (2j + 1) ^ (r % 8)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
  const uint32_t a_row = r * 128 + 4 * t;
  const int sw = r & 7;

  // fragments, double-buffered: [buffer][hi 0..3, lo 0..3]
  uint32_t a[2][2][4] = {};
  int kt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int cand, it, nt, oy, ox;
    t3_tile(g, tile, cand, it, nt, oy, ox);
    const int iy0 = oy * g.stride - g.pad_h;
    const int ix0 = ox * g.stride - g.pad_w;
    // d: the float32 sums; p: one stage's products, summed by the tensor
    // cores, which truncate every partial sum to float32 toward zero
    float d[BN / 2], p[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = p[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(p[i]);

    for (int tap = 0; tap < 9; ++tap) {
      const int iy = iy0 + tap / 3, ix = ix0 + tap % 3;
      if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
      for (int c = 0; c < csteps; ++c, ++kt) {
        const int s = kt % STAGES;
        const int nsub = min(SK, g.Cin - c * SK) / 8;
        mbar_wait(&full[s], (kt / STAGES) & 1);
        const uint32_t as_s = smem_u32(as + s * ATOMS * T3_A_TILE) + a_row;
        const uint32_t bs_s = smem_u32(bs + 2 * s * ATOMS * B_ATOM);
        const float* mk = ms + s * SK;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          if (j < nsub) {
            // slice jj of box j / 4
            const int jj = j & 3;
            const uint32_t ab = as_s + (j >> 2) * T3_A_TILE;
            const uint32_t bh = bs_s + (j >> 2) * B_ATOM;
            const uint32_t bl = bh + ATOMS * B_ATOM;
            const uint32_t c_lo = ((2 * jj) ^ sw) << 4;
            const uint32_t c_hi = ((2 * jj + 1) ^ sw) << 4;
            float v[4], m[4];
            asm volatile("ld.shared.f32 %0, [%1];"
                         : "=f"(v[0]) : "r"(ab + c_lo));
            asm volatile("ld.shared.f32 %0, [%1];"
                         : "=f"(v[1]) : "r"(ab + 1024 + c_lo));
            asm volatile("ld.shared.f32 %0, [%1];"
                         : "=f"(v[2]) : "r"(ab + c_hi));
            asm volatile("ld.shared.f32 %0, [%1];"
                         : "=f"(v[3]) : "r"(ab + 1024 + c_hi));
            m[0] = m[1] = mk[8 * j + t];
            m[2] = m[3] = mk[8 * j + 4 + t];
            gate_n<KIND, 4>(v, m);
            uint32_t(&hi)[4] = a[j & 1][0];
            uint32_t(&lo)[4] = a[j & 1][1];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              hi[q] = tf32_rna(v[q]);
              lo[q] = tf32_rna(v[q] - __uint_as_float(hi[q]));
            }
            wgmma_fence();
            // the small products first, then the big one; the stage's
            // first product starts p afresh
            wgmma_tf32<BN>(p, hi, t3_desc(bl + 32 * jj), j > 0);
            wgmma_tf32<BN>(p, lo, t3_desc(bh + 32 * jj), 1);
            wgmma_tf32<BN>(p, hi, t3_desc(bh + 32 * jj), 1);
            wgmma_commit();
            wgmma_wait<1>();
            // the previous slice's products have completed: its fragment
            // registers are free
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              fence_reg(a[(j + 1) & 1][0][q]);
              fence_reg(a[(j + 1) & 1][1][q]);
            }
          }
        }
        // the stage's products are in p: hand the stage back and add p to
        // the float32 sums, rounded to nearest (12 or 24 truncated partial
        // sums of one stage, instead of a running sum over all of K)
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_reg(p[i]);
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[i] += p[i];
      }
    }

    // accumulator i of this thread: row r (+8 when i % 4 >= 2), column
    // 8*(i/4) + 2*t + i%2
    const int n0 = nt * BN;
    const int b = it * T3_BM + r;
    float* orow = out + ((((long long)cand * g.B + b) * g.Ho + oy) * g.Wo +
                         ox) * g.Cout;
    const long long row8 = (long long)8 * g.Ho * g.Wo * g.Cout;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int col = n0 + 8 * (i >> 2) + 2 * t;
      const bool low = (i & 2) == 0;
      if (col < g.Cout && (low ? b : b + 8) < g.B)
        *reinterpret_cast<float2*>(orow + (low ? 0 : row8) + col) =
            make_float2(d[i], d[i + 1]);
    }
  }
}

// ------------------------------------------------------------------ host

// [lo, hi) of the output positions along one axis whose three taps are all
// in the image, clamped to [0, out]
void interior(int size, int out, int stride, int pad, int& lo, int& hi) {
  const int first = (pad + stride - 1) / stride;   // o*stride >= pad
  const int last = size - 3 + pad;                 // o*stride <= last
  lo = first < out ? first : out;
  hi = last < 0 ? lo : last / stride + 1;
  hi = hi > out ? out : hi < lo ? lo : hi;
}

// a persistent grid: one block on each SM (or one a tile), each walking
// every gridDim.x-th tile of the heavy-first order
template <int KIND, int BN>
int launch_tf32x3(const CUtensorMap& tx, const CUtensorMap& tw,
                  const CUtensorMap& tm, float* out, const T3Geom& g,
                  int tiles, cudaStream_t stream) {
  auto kernel = gate_conv3x3_tf32x3_kernel<KIND, BN>;
  constexpr int smem = t3_smem<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiles < sms ? tiles : sms, T3_THREADS, smem, stream>>>(
      tx, tw, tm, out, g, tiles);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_tf32x3_bn(int bn, const CUtensorMap& tx, const CUtensorMap& tw,
                     const CUtensorMap& tm, float* out, const T3Geom& g,
                     int tiles, cudaStream_t stream) {
  if (bn == 64)
    return launch_tf32x3<KIND, 64>(tx, tw, tm, out, g, tiles, stream);
  return launch_tf32x3<KIND, 128>(tx, tw, tm, out, g, tiles, stream);
}

}  // namespace

// Route T of masked_act_conv3x3_launch: float32 x, mask, w and out, and
// scratch for 2 * Cout * 9 * Cin floats.  Refuses (cudaErrorInvalidValue)
// what it cannot take: B not a multiple of 64, Cin or Cout not a multiple
// of 8, an operand not 16-byte aligned, a candidate stride other than 0 or
// B*H*W*Cin (H*W*Cin for the mask), a coordinate out of TMA's range.
int masked_act_conv3x3_tf32x3_launch(
    const void* x, const void* mask, const void* w, void* scratch, void* out,
    int n_cand, int B, int H, int W, int Cin, int Cout, int Ho, int Wo,
    int stride, int pad_h, int pad_w, long long x_cand_stride,
    long long mask_cand_stride, int kind, cudaStream_t stream) {
  const long long pix = (long long)H * W * Cin;
  const int bn = Cout <= 64 ? 64 : 128;
  const int n_tiles = (Cout + bn - 1) / bn;
  const int img_tiles = (B + T3_BM - 1) / T3_BM;
  const long long tiles = (long long)n_cand * Ho * Wo * img_tiles * n_tiles;
  const bool ok =
      B % 64 == 0 && Cin % 8 == 0 && Cout % 8 == 0 && Cin > 0 &&
      (stride == 1 || stride == 2) && aligned16(x) && aligned16(mask) &&
      aligned16(w) && aligned16(scratch) && aligned16(out) &&
      (x_cand_stride == 0 || x_cand_stride == pix * B) &&
      (mask_cand_stride == 0 || mask_cand_stride == pix) &&
      pix <= 2147483647LL && (long long)n_cand * B <= 2147483647LL &&
      9LL * Cin <= 2147483647LL && tiles <= 2147483647LL && kind >= 0 &&
      kind <= 3;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int K = 9 * Cin;
  dim3 sgrid((K + 31) / 32, (Cout + 31) / 32);
  split_weights_kernel<<<sgrid, 256, 0, stream>>>(
      static_cast<const float*>(w), static_cast<float*>(scratch), K, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tx, tw, tm;
  const bool enc =
      encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, pix,
                x_cand_stride ? (long long)n_cand * B : B, T3_BK, T3_BM,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scratch, K,
                2LL * Cout, T3_BK, bn, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mask, pix,
                mask_cand_stride ? n_cand : 1, T3_BK, 1,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!enc) return (int)cudaErrorInvalidValue;
  T3Geom g{B, H, W, Cin, Cout, Ho, Wo, stride, pad_h, pad_w,
           x_cand_stride ? B : 0, mask_cand_stride ? 1 : 0, n_cand,
           img_tiles, n_tiles, 0, 0, 0, 0};
  interior(H, Ho, stride, pad_h, g.iy0, g.iy1);
  interior(W, Wo, stride, pad_w, g.ix0, g.ix1);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case kRelu:
      return launch_tf32x3_bn<kRelu>(bn, tx, tw, tm, o, g, (int)tiles,
                                     stream);
    case kGelu:
      return launch_tf32x3_bn<kGelu>(bn, tx, tw, tm, o, g, (int)tiles,
                                     stream);
    case kSilu:
      return launch_tf32x3_bn<kSilu>(bn, tx, tw, tm, o, g, (int)tiles,
                                     stream);
    default:
      return launch_tf32x3_bn<kSqrelu>(bn, tx, tw, tm, o, g, (int)tiles,
                                       stream);
  }
}
