// Fused Griffin-Lim phase iterations in frame space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `griffin_lim_phases_pallas`
// in adaptive_voice_conversion_tpu/kernels/griffin_lim.py. It computes the
// same thing with the same bf16 rounding points; the f32 summation order
// and the projection's last few ulp differ.
//
// State: re, im, mag are (M, F) f32, M = stacked utterances (or segments),
// each a block of t_pad frame rows; F = f_pad = 1152 frequency columns.
// Basis: cs = [w*cos | -w*sin], (S, 2F), S = s_pad = 1280 samples of the
// window support. One iteration:
//   (1) a_syn = bf16([re*ck | im*ck])                      (M, 2F)
//   (2) syn   = a_syn x cs^T, f32 accumulation              (M, S)
//   (3) acc   = syn + sum_{d=1..n_taps} shifted neighbours, masked at each
//       t_pad block's rows (the band never crosses utterances);
//       a_ana = bf16(acc * g)                                (M, S)
//   (4) [re2 | im2] = a_ana x cs, f32 accumulation          (M, 2F)
//   (5) (re, im) = mag * (re2, im2) / max(|(re2, im2)|, 1e-8)
//
// What bounds it on the H100: the two bf16 products, 2*2*M*S*2F FLOP per
// iteration (4.06 GFLOP at M=344), ~4 us at the 989 TFLOP/s tensor-core
// peak. The TPU kept the 5.9 MB basis and all state in VMEM; a Hopper block
// has 227 KB of shared memory, so here the basis stays in device memory and
// is served from the 50 MB L2, as are syn and the bf16 operands between the
// launches. At M ~ 344 the products are small and what limits them is how
// fast one SM can pull its operand tiles from L2: per-thread 16-byte copies
// (cp.async) stalled every design at about the same rate per SM whatever
// the tiling, pipeline depth or MMA instruction. So every bf16 operand is
// kept in device memory already in wgmma's shared-memory layout, tile by
// tile ("tiled" below), and a stage of a block's pipeline is two
// contiguous bulk copies (cp.async.bulk, the TMA engine's 1-D form), issued
// by one thread and completed on an mbarrier. The tensor cores read both
// operands straight from shared memory (wgmma m64n128k16, one warpgroup per
// block); the tiles are as large as still give ~one block per SM (syn:
// 6 x 10 tiles x a two-way split of K; ana: 6 x 18 tiles).
//
// Tiled layout of an (R*rt x 64*kt) bf16 operand with R-row tiles: tile
// (rt, kt) is R*64 contiguous elements, and inside it the 8-element piece
// kc of row r sits at element (kc*R + r)*8: wgmma's no-swizzle "core
// matrix" layout (8 rows x 16 bytes), K-major. The A operands (a_syn,
// a_ana) use 64-row tiles; gl_tile_bases builds the B operands once from
// the plain basis with 128-row tiles: syn_b from cs, and ana_b from cs^T
// with the rows of tile ft = the cos columns ft*64.. and then the sin
// columns F+ft*64.. of cs, so that one ana block holds matching re and im
// columns. The layout is known to this file alone.
//
// Three launches per iteration on the caller's stream, from gl_run's loop,
// each a programmatic dependent launch (it may start while the previous one
// runs and waits on it before touching its outputs), which hides most of
// the gap between launches:
//   gl_syn_gemm   bf16 GEMM (2), its K split in SYN_SPLIT parts written as
//                 separate partial sums (row-major f32);
//   gl_band       elementwise (3): adds the partial sums, reads each output's
//                 9 band taps once, applies the gain, rounds to bf16;
//   gl_ana_gemm   bf16 GEMM (4) whose epilogue does (5) and writes the next
//                 iteration's (1) as well.
// One extra launch (gl_prep) makes the first a_syn. A persistent launch for
// the whole loop is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows of a block tile, A tile rows (wgmma m64)
constexpr int BN = 128;       // columns of a block tile, B tile rows (wgmma n128)
constexpr int BK = 64;        // contraction depth of one stage (4 x k16)
constexpr int STAGES = 4;     // pipeline depth
constexpr int THREADS = 128;  // one warpgroup
constexpr int SYN_SPLIT = 2;  // parts of the syn product's K (2F)
constexpr int A_ELEMS = BM * BK;
constexpr int B_ELEMS = BN * BK;
constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;  // 24 KB
constexpr int LDC = BN + 4;  // floats: rows of the epilogue's staging tile
constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES =
    ((PIPE_BYTES > BM * LDC * 4) ? PIPE_BYTES : BM * LDC * 4) + 64;  // + mbarriers

// Element (m, k) of a tiled operand with R-row tiles and K columns.
template <int R>
__device__ __forceinline__ size_t tiled(int m, int k, int K) {
  return ((((size_t)(m / R) * (K >> 6) + (k >> 6)) * 8 + ((k >> 3) & 7)) * R +
          (m % R)) * 8 + (k & 7);
}

// The two B operands from the basis cs (S, 2F) bf16, row-major, both with
// BN-row tiles: syn_b is cs tiled (row = sample, K = 2F); ana_b is cs^T
// tiled (K = S) with its rows paired, tile ft holding the cos columns
// ft*64.. and then the sin columns F+ft*64.. of cs.
__global__ void gl_tile_bases_kernel(const bf16* __restrict__ cs,
                                     bf16* __restrict__ syn_b,
                                     bf16* __restrict__ ana_b, int F, int S) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * 2 * F) return;
  int s = idx / (2 * F), c = idx - s * 2 * F;
  int h = c >= F, f = c - h * F;  // h: the sin half
  int row = (f / (BN / 2)) * BN + h * (BN / 2) + f % (BN / 2);
  syn_b[tiled<BN>(s, c, 2 * F)] = cs[idx];
  ana_b[tiled<BN>(row, s, S)] = cs[idx];
}

// (1): a_syn[m, k] = bf16(re[m, k]*ck[k]), a_syn[m, F + k] = bf16(im*ck)
__global__ void gl_prep(const float* __restrict__ re,
                        const float* __restrict__ im,
                        const float* __restrict__ ck,
                        bf16* __restrict__ a_syn, int M, int F) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * F) return;
  int m = idx / F, k = idx - m * F;
  float c = ck[k];
  a_syn[tiled<BM>(m, k, 2 * F)] = __float2bfloat16_rn(__fmul_rn(re[idx], c));
  a_syn[tiled<BM>(m, F + k, 2 * F)] = __float2bfloat16_rn(__fmul_rn(im[idx], c));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch: the loop's launches may start while the
// previous one runs. A kernel reads no output of earlier launches, and
// writes nothing, before wait_prior_grid(); it then lets the next launch
// start its own prologue.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One 1-D bulk copy global -> shared, counted on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// wgmma descriptor of the k16 slice s of an (R x BK) tile in the tiled
// layout: start at piece 2s; the next piece along K is R*16 bytes on (the
// leading byte offset), the next 8 rows 128 bytes on (the stride byte
// offset); no swizzle.
__device__ __forceinline__ uint64_t tile_desc(const bf16* tile, int R, int s) {
  uint32_t addr = smem_addr(tile + 2 * s * R * 8);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((R * 16) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (64 x 128 f32, spread over the warpgroup) += A (64 x 16) x B (128 x 16)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared main loop of both products: d = A (BM x K) x B (BN x K)^T over
// k-steps [0, n_steps), where step t's tiles are a_tiles + t*A_ELEMS and
// b_tiles + t*B_ELEMS (consecutive k tiles of one row tile are adjacent in
// the tiled layout). Thread 0 issues the bulk copies; stage s completes on
// full[s], whose phase flips once per use.
__device__ __forceinline__ void mainloop(unsigned char* smem, const bf16* a_tiles,
                                         const bf16* b_tiles, int n_steps,
                                         float (&d)[64]) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PIPE_BYTES);
  auto issue = [&](int step) {
    int s = step % STAGES;
    bf16* st = reinterpret_cast<bf16*>(smem + s * STAGE_BYTES);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(&full[s])),
                 "r"(STAGE_BYTES)
                 : "memory");
    bulk_load(st, a_tiles + (size_t)step * A_ELEMS, A_ELEMS * 2, &full[s]);
    bulk_load(st + A_ELEMS, b_tiles + (size_t)step * B_ELEMS, B_ELEMS * 2, &full[s]);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < STAGES && t < n_steps; ++t) issue(t);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int ks = 0; ks < n_steps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const bf16* st = reinterpret_cast<const bf16*>(smem + s * STAGE_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n128k16(d, tile_desc(st, BM, k), tile_desc(st + A_ELEMS, BN, k));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    __syncthreads();  // every warp is done reading stage s
    if (threadIdx.x == 0 && ks + STAGES < n_steps) issue(ks + STAGES);
  }
}

// Stages the accumulators in shared memory as a (BM x BN) f32 tile. Thread
// t of the warpgroup holds, for each 8-column block j, rows
// 16*(t/32) + (t%32)/4 (+8) and columns 8j + 2*(t%4) (+1).
__device__ __forceinline__ float* stage_acc(unsigned char* smem, const float (&d)[64]) {
  float* Cs = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(Cs + row * LDC + col) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(Cs + (row + 8) * LDC + col) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  __syncthreads();
  return Cs;
}

// (2): syn_z (M, S) = a_syn[:, kz] x cs[:, kz]^T for part z of K = 2F.
// a_syn is tiled (64-row tiles, K columns), syn_b is cs tiled (128-row
// tiles). Grid (ceil(M/BM), S/BN, SYN_SPLIT); part z is written row-major
// to syn + z*M*S.
__global__ void __launch_bounds__(THREADS)
gl_syn_gemm(const bf16* __restrict__ a, const bf16* __restrict__ syn_b,
            float* __restrict__ syn, int M, int S, int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt = K / BK, steps = kt / SYN_SPLIT, t0 = blockIdx.z * steps;
  float d[64];
  wait_prior_grid();
  mainloop(smem, a + ((size_t)blockIdx.x * kt + t0) * A_ELEMS,
           syn_b + ((size_t)blockIdx.y * kt + t0) * B_ELEMS, steps, d);
  const float* Cs = stage_acc(smem, d);
  float* out = syn + (size_t)blockIdx.z * M * S;
  for (int v = threadIdx.x; v < BM * BN / 4; v += THREADS) {
    int r = v / (BN / 4), c = (v - r * (BN / 4)) * 4;
    if (m0 + r < M)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * S + n0 + c) =
          *reinterpret_cast<const float4*>(Cs + r * LDC + c);
  }
}

// 8 adjacent floats (16-byte aligned) as two 16-byte accesses.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
// bf16(v[j] * s[j]) for j = 0..7, packed in element order.
__device__ __forceinline__ uint4 bf16x8(const float (&v)[8], const float (&s)[8]) {
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(v[2 * j], s[2 * j]),
                                             __fmul_rn(v[2 * j + 1], s[2 * j + 1]));
    w[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  return out;
}

// acc[0..3] += syn[i..i+3] summed over the SYN_SPLIT partial products
// (in order), i a multiple of 4.
__device__ __forceinline__ void add_syn4(float* acc, const float* __restrict__ syn,
                                         size_t MS, size_t i) {
  float4 s = *reinterpret_cast<const float4*>(syn + i);
#pragma unroll
  for (int z = 1; z < SYN_SPLIT; ++z) {
    float4 p = *reinterpret_cast<const float4*>(syn + z * MS + i);
    s = make_float4(__fadd_rn(s.x, p.x), __fadd_rn(s.y, p.y), __fadd_rn(s.z, p.z),
                    __fadd_rn(s.w, p.w));
  }
  acc[0] = __fadd_rn(acc[0], s.x);
  acc[1] = __fadd_rn(acc[1], s.y);
  acc[2] = __fadd_rn(acc[2], s.z);
  acc[3] = __fadd_rn(acc[3], s.w);
}

// (3): the banded overlap-add and re-framing, then the analysis gain.
// dest[t, n] += syn[t+d, n-d*hop] where t < t_pad-d and n >= d*hop;
// dest[t, n] += syn[t-d, n+d*hop] where t >= d and n < S-d*hop;
// t is the row inside its own t_pad block. Summed in the TPU kernel's order.
// A thread makes 8 adjacent columns n0.. of one row, with 16-byte accesses:
// hop % 4 == 0, so each half of the 8 lies wholly inside or outside a
// tap's column range. a_ana is written tiled (64-row tiles, S columns).
__global__ void gl_band(const float* __restrict__ syn,
                        const float* __restrict__ g, bf16* __restrict__ a_ana,
                        int M, int S, int t_pad, int hop, int n_taps) {
  wait_prior_grid();
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (S / 8)) return;
  const size_t MS = (size_t)M * S;
  int m = idx / (S / 8), n0 = (idx - m * (S / 8)) * 8;
  int t = m % t_pad;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* a4 = acc + 4 * h;
    const int n = n0 + 4 * h;
    add_syn4(a4, syn, MS, (size_t)m * S + n);  // the centre tap (0 + x is exact)
    for (int d = 1; d <= n_taps; ++d) {
      int sh = d * hop;
      if (t < t_pad - d && n >= sh) add_syn4(a4, syn, MS, (size_t)(m + d) * S + n - sh);
      if (t >= d && n + 4 <= S - sh) add_syn4(a4, syn, MS, (size_t)(m - d) * S + n + sh);
    }
  }
  float gv[8];
  load8(gv, g + n0);
  *reinterpret_cast<uint4*>(a_ana + tiled<BM>(m, n0, S)) = bf16x8(acc, gv);
}

// (4)+(5): [re2 | im2] = a_ana (M, K=S) x ana_b^T; the block at column
// tile ft computes re2 columns f0..f0+63 and im2 columns F+f0..F+f0+63
// (f0 = 64*ft, the rows of ana_b's tile ft), so the epilogue projects onto
// the magnitude in place and also writes the next iteration's bf16
// synthesis operand (tiled). Grid (ceil(M/BM), F/64).
__global__ void __launch_bounds__(THREADS)
gl_ana_gemm(const bf16* __restrict__ a, const bf16* __restrict__ ana_b,
            const float* __restrict__ mag, const float* __restrict__ ck,
            float* __restrict__ re, float* __restrict__ im,
            bf16* __restrict__ a_syn, int M, int F, int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int HALF = BN / 2;  // 64 frequency columns per block
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * HALF;
  const int kt = K / BK;
  // The epilogue's thread owns the 8 adjacent columns f.. of rows
  // r0, r0+16, r0+32, r0+48, so that it loads and stores 16 bytes at a
  // time; its magnitudes and ck are loaded before the main loop so that
  // their latency hides behind it.
  constexpr int EPI = BM * (HALF / 8) / THREADS;  // 4 rows per thread
  const int r0 = threadIdx.x >> 3, f = f0 + 8 * (threadIdx.x & 7);
  float c_k[8], mg[EPI][8];
  load8(c_k, ck + f);
#pragma unroll
  for (int e = 0; e < EPI; ++e) {
    int m = m0 + r0 + e * (THREADS / 8);
    if (m < M) {
      load8(mg[e], mag + (size_t)m * F + f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) mg[e][j] = 0.0f;
    }
  }
  float d[64];
  wait_prior_grid();
  mainloop(smem, a + (size_t)blockIdx.x * kt * A_ELEMS,
           ana_b + (size_t)blockIdx.y * kt * B_ELEMS, kt, d);
  const float* Cs = stage_acc(smem, d);
#pragma unroll
  for (int e = 0; e < EPI; ++e) {
    int r = r0 + e * (THREADS / 8), m = m0 + r;
    if (m >= M) break;
    float nre[8], nim[8];
    load8(nre, Cs + r * LDC + f - f0);         // re2
    load8(nim, Cs + r * LDC + HALF + f - f0);  // im2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // mag / max(|X2|, 1e-8) through one approximate reciprocal square
      // root (a few ulp) instead of an IEEE square root and two divisions,
      // which made this epilogue slower than the main loop
      float ss = __fadd_rn(__fmul_rn(nre[j], nre[j]), __fmul_rn(nim[j], nim[j]));
      float scale = __fmul_rn(mg[e][j], ss > 1e-16f ? rsqrtf(ss) : 1e8f);
      nre[j] = __fmul_rn(nre[j], scale);
      nim[j] = __fmul_rn(nim[j], scale);
    }
    store8(re + (size_t)m * F + f, nre);
    store8(im + (size_t)m * F + f, nim);
    *reinterpret_cast<uint4*>(a_syn + tiled<BM>(m, f, 2 * F)) = bf16x8(nre, c_k);
    *reinterpret_cast<uint4*>(a_syn + tiled<BM>(m, F + f, 2 * F)) = bf16x8(nim, c_k);
  }
}

// Launches kernel with programmatic stream serialization (see
// wait_prior_grid).
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

}  // namespace

// The number of partial sums of the syn product: gl_run's syn scratch
// holds this many (M, S) f32 arrays.
extern "C" int gl_syn_split() { return SYN_SPLIT; }

// The rows of an A operand's tile: gl_run's a_syn and a_ana scratch hold
// M rounded up to a multiple of this.
extern "C" int gl_tile_rows() { return BM; }

// Tiles the plain basis cs (S, 2F) bf16 into syn_b and ana_b (S * 2F bf16
// each), the layout gl_run reads, on `stream`. Returns cudaGetLastError().
extern "C" int gl_tile_bases(const bf16* cs, bf16* syn_b, bf16* ana_b, int F, int S,
                             void* stream_ptr) {
  if (S % BN != 0 || S % BK != 0 || F % (BN / 2) != 0 || (2 * F) % BK != 0)
    return (int)cudaErrorInvalidValue;
  const int ew = 256;
  gl_tile_bases_kernel<<<(S * 2 * F + ew - 1) / ew, ew, 0,
                         reinterpret_cast<cudaStream_t>(stream_ptr)>>>(cs, syn_b, ana_b, F, S);
  return (int)cudaGetLastError();
}

// Runs n_iter iterations on `stream`. re/im receive the final state.
// syn_b and ana_b are the tiled bases made by gl_tile_bases. Scratch,
// caller-allocated: a_syn (ceil(M/BM)*BM, 2F) and a_ana (ceil(M/BM)*BM, S)
// bf16, tiled, ZEROED (rows M.. are never written and must read as 0); syn
// (SYN_SPLIT, M, S) f32. Shapes must satisfy S % 128 == 0, F % 64 == 0,
// 2F/SYN_SPLIT % 64 == 0 and hop % 4 == 0 (checked here). Returns
// cudaGetLastError() after the launches, so a refused launch is reported;
// nothing is synchronised.
extern "C" int gl_run(const float* mag, const float* re0, const float* im0,
                      const bf16* syn_b, const bf16* ana_b, const float* ck,
                      const float* g, float* re, float* im, bf16* a_syn,
                      float* syn, bf16* a_ana, int M, int F, int S, int t_pad,
                      int hop, int n_taps, int n_iter, void* stream_ptr) {
  if (M <= 0 || S % BN != 0 || S % BK != 0 || F % (BN / 2) != 0 ||
      (2 * F) % (SYN_SPLIT * BK) != 0 || hop % 4 != 0 || t_pad <= n_taps ||
      n_iter < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // both GEMMs take more than the default 48 KB of dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      gl_syn_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gl_ana_gemm,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int ew = 256;
  gl_prep<<<(M * F + ew - 1) / ew, ew, 0, stream>>>(re0, im0, ck, a_syn, M, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_syn((M + BM - 1) / BM, S / BN, SYN_SPLIT);
  const dim3 grid_ana((M + BM - 1) / BM, F / (BN / 2));
  const int band_blocks = (M * (S / 8) + ew - 1) / ew;
  for (int it = 0; it < n_iter && err == cudaSuccess; ++it) {
    err = launch_pdl(gl_syn_gemm, grid_syn, THREADS, SMEM_BYTES, stream, a_syn, syn_b,
                     syn, M, S, 2 * F);
    if (err == cudaSuccess)
      err = launch_pdl(gl_band, dim3(band_blocks), ew, 0, stream, syn, g, a_ana, M, S,
                       t_pad, hop, n_taps);
    if (err == cudaSuccess)
      err = launch_pdl(gl_ana_gemm, grid_ana, THREADS, SMEM_BYTES, stream, a_ana, ana_b,
                       mag, ck, re, im, a_syn, M, F, S);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
