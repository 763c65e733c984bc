// Flash-attention backward (K5 dq, K6 dk/dv) for Hopper, sm_90a.
//
// Replaces elasticdl_tpu/ops/flash_attention.py:_dq_kernel (K5) and
// :_dkv_kernel (K6), both launched by _bwd through pl.pallas_call. Same
// function: with s = q k^T * scale (masked to -1e30 above the causal
// diagonal), p = exp(s - lse) from the forward's lse, dp = do v^T and
// delta = rowsum(o * do) (computed by the caller in fp32, as _bwd does
// outside its kernels):
//   K5: ds = p * (dp - delta) * scale cast to k's dtype, dq = ds k;
//   K6: dv = p^T do with p cast to do's dtype, dk = ds^T q with ds cast
//       to q's dtype.
// Products run in the input dtype with fp32 accumulation, and each
// output is cast to its input's dtype once at the end.
//
// Bound at the training shape (B=8, H=12, S=1024, D=64, bf16, causal,
// B*H = 96; causal keeps 1024 * 1025 / 2 = 524,800 (q, k) pairs a head):
// - K5 does three products (q k^T, do v^T, ds k): 6 * 96 * 64 * 524,800
//   = 19.3 GFLOP, 19.6 us at 989 TFLOP/s; it reads q, k, v, do and
//   writes dq (5 * 12.6 MB) plus 0.8 MB of lse and delta: 63.7 MB,
//   19.0 us at 3.35 TB/s. Bound by operations at about 19.6 us.
// - K6 does four (q k^T, do v^T, p^T do, ds^T q): 25.8 GFLOP, 26.1 us;
//   it reads q, k, v, do and writes dk, dv: 76.3 MB, 22.8 us. Bound by
//   operations at about 26.1 us.
// A training step makes 12 launches of each (one per layer).
//
// bf16 design (warp-specialised and persistent, K4's parts in another
// order; flash_fwd.cu's note has the layouts):
// - Two kernels, no atomics: K5 owns dq rows, K6 owns dk and dv rows,
//   and two launches on the same inputs give the same bits.
// - A work tile is 128 rows of one head that the kernel owns (queries in
//   K5, keys in K6). One CTA per SM (grid min(SMs, work tiles)) walks
//   the work tiles longest first: under causal masking K5's last query
//   tiles (they see the most keys), K6's first key tiles (they are seen
//   by the most queries).
// - 384 threads: two consumer warpgroups of 64 owned rows each (wgmma's
//   M = 64) and a producer warpgroup whose first thread issues every TMA
//   load (in K6 its second warp also loads lse and delta); setmaxnreg
//   moves registers from the producer (40) to the consumers (232).
// - The owned operands (K5: q and do; K6: k and v) are loaded once per
//   work tile behind an own_full/own_empty mbarrier pair. The other side
//   streams through a ring of kStages stages that runs on across work
//   tiles, each stage with two "full" mbarriers (TMA completion,
//   expect_tx bytes) and an "empty" one the 8 consumer warps arrive on.
//   K5 streams k (full_a) and v (full_b) tiles; K6 streams q with its
//   lse (full_a) and do with its delta (full_b): the statistics warp
//   loads a query tile's lse (times log2e) and delta into the stage with
//   plain loads, zeros past S, and its 32 lanes arrive on both full
//   barriers beside the TMA thread. Every bf16 tile is 128B-swizzled in
//   64-column atoms, as K4's.
// - K5 per key tile: S = Q K^T and dP = dO V^T (wgmma, both operands
//   K-major in shared memory); P = exp2(S * scale * log2e - lse * log2e)
//   and dS = P (dP - delta) scale in the accumulators' own registers,
//   each thread holding the lse and delta of its two rows in registers
//   for the whole work tile; dS converted to bf16 A fragments in
//   registers (the fp32 accumulator layout is the bf16 A-fragment
//   layout), and dQ += dS K with K read MN-major from the same shared
//   tile. The dQ accumulator stays in registers and is stored once.
// - K6 per query tile: S^T = K Q^T and dP^T = V dO^T (K or V the A
//   operand from shared memory); P^T and dS^T in registers with the
//   columns' lse and delta read from the stage; dV += P^T dO and dK +=
//   dS^T Q with A from registers and dO, Q read MN-major. dK and dV stay
//   in registers and are stored once. The query tiles walk from the
//   causal diagonal on.
// - Masks: element by element only on the causal diagonal tile and on
//   the ragged last tile. K5's k and v tiles and both kernels' owned
//   tiles come through 3-D tensor maps (D, S, B*H), so a ragged tail
//   reads zeros inside its own head; keys past S still score -1e30 (a
//   zero key would give p = exp(-lse)), and owned rows past S are never
//   written. K6's q and do stream through 2-D maps over all heads' rows
//   (D, B*H*S): a ragged query tile reads the next head's first rows
//   (the last head's read zeros), so the mask of queries past S (score
//   -1e30, hence p = 0 and dS = 0) is what keeps them out of dk and dv.
//   Their lse and delta (rows of S * 4 bytes, no 16-byte stride for a
//   tensor map) come through the statistics warp.
// - Tile widths, from ptxas's report with 0 spills: the streamed tile is
//   128 rows at D 64 and 64 at D 128, so the fp32 accumulators a
//   consumer thread holds are 64 + 64 + 32 (K5 D 64: S, dP, dQ) or 32 +
//   32 + 64 (D 128), and 64 + 64 + 32 + 32 (K6 D 64: S^T, dP^T, dK, dV)
//   or 32 + 32 + 64 + 64 (D 128); ptxas: 168 registers at launch, 0
//   spills, for all four entries. 3 ring stages: 132,184 (K5 D 64),
//   164,952 (K5 D 128), 135,256 (K6 D 64) and 166,488 (K6 D 128) bytes
//   of dynamic shared memory, 1 KB of it alignment slack.
// - Not kept: the first design (nvcuda::wmma, 64-row blocks launched in
//   index order, every tile copied through registers, two
//   __syncthreads() per tile, s and dp written to shared memory as fp32
//   and p, ds back as bf16: 0.41 and 0.48 ms at the training shape);
//   lse and delta through 1-D fp32 tensor maps over B*H*S values (an
//   illegal instruction at S = 1, where the map's one dimension, 6
//   values, was shorter than its 128-value box). A fused kernel
//   accumulating dq with atomics is left out: it would drop determinism.
//
// fp32 path: the tensor cores take no full-precision fp32, so products
// are FMAs. Four threads share a row (each holds a quarter of it in
// registers); the other side's tiles of 32 rows sit in shared memory.
// Keys (K5) or queries (K6) past S get p = 0 and rows past S are never
// written.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): edl_flash_bwd_dq and edl_flash_bwd_dkv launch on the given
// stream, do not synchronise, and return a cudaError_t. The tensor
// maps' encoder, cuTensorMapEncodeTiled, is a driver function fetched at
// run time through the runtime's entry-point query, so nothing links
// -lcuda. The TMA, mbarrier and wgmma helpers are copies of
// flash_fwd.cu's: the library's name hashes this one source.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the forward's causal mask value
constexpr int kThreads = 128;      // fp32 path
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// bf16 path: TMA + mbarrier ring + wgmma
// ---------------------------------------------------------------------------

constexpr int kOwn = 128;      // rows a work tile owns: queries (K5), keys (K6)
constexpr int kConsumers = 2;  // consumer warpgroups, 64 owned rows each
constexpr int kBwdThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kAtomBytes = 128;  // one swizzle atom row: 64 bf16
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// rows of the streamed tile: keys (K5) or queries (K6)
template <int D>
struct Stream {
  static constexpr int kN = D == 64 ? 128 : 64;
};

// K5: q and do of the work tile, then the k ring, the v ring, then the
// barriers (own_full, own_empty, full_a[S], full_b[S], empty[S])
template <int D>
struct DqLayout {
  static constexpr int kN = Stream<D>::kN;
  static constexpr int kOwnBytes = kOwn * D * 2;  // q or do
  static constexpr int kTileBytes = kN * D * 2;   // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kOwnBytes;
  static constexpr int kK = kDo + kOwnBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
};

// K6: k and v of the work tile, then the q ring, the do ring, the lse
// ring, the delta ring, then the barriers as K5's
template <int D>
struct DkvLayout {
  static constexpr int kN = Stream<D>::kN;
  static constexpr int kOwnBytes = kOwn * D * 2;  // k or v
  static constexpr int kTileBytes = kN * D * 2;   // one q or do tile
  static constexpr int kStatBytes = kN * 4;       // its lse or delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kOwnBytes;
  static constexpr int kQ = kV + kOwnBytes;
  static constexpr int kDo = kQ + kStages * kTileBytes;
  static constexpr int kLse = kDo + kStages * kTileBytes;
  static constexpr int kDelta = kLse + kStages * kStatBytes;
  static constexpr int kBar = kDelta + kStages * kStatBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a tensor map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-column atoms), stride byte offset 1024 (the stride between
// 8-row groups), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(i)                                                               \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 64 fp32) (+)= A (64 x 16) * B (16 x 64), both K-major in
// shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 fp32) (+)= A (64 x 16) * B (16 x 128), both K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major
// in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128,
// MN-major in shared memory, two 64-column atoms)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K5: key tiles a query work tile visits: up to its last row's diagonal
// under causal masking, all of them otherwise
template <int kN>
__device__ __forceinline__ int dq_key_tiles(int q0, int seq, int causal) {
  const int q_last = min(q0 + kOwn, seq) - 1;
  return causal ? q_last / kN + 1 : (seq + kN - 1) / kN;
}

// S (or S^T) = A B^T over D: a consumer warpgroup's 64 rows of the A
// tile (`a_rows` rows a 64-column atom) against the kN rows of the B
// tile, both K-major
template <int D, int kN>
__device__ __forceinline__ void scores(float (&acc)[kN / 2], uint32_t a_wg,
                                       int a_rows, uint32_t b_tile) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // 16 bf16 inside a 128-byte atom
    wgmma_ss(acc, sw128_desc(a_wg + (kk / 4) * a_rows * kAtomBytes + col, 16),
             sw128_desc(b_tile + (kk / 4) * kN * kAtomBytes + col, 16),
             kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += A (64 x kN, bf16 fragments) B (kN x D, MN-major in the
// shared tile `b_tile` of kN rows)
template <int D, int kN>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&a)[kN / 16][4],
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    wgmma_rs(acc, a[kk], sw128_desc(b_tile + kk * 16 * kAtomBytes, kN * kAtomBytes));
  }
}

// rows r and r + 8 of a warpgroup's 64 x D accumulator (r from the
// accumulator layout, c its column in each 8-column chunk) as bf16 into
// rows row0 + r, row0 + r + 8 of a (seq, D) matrix; rows past seq are
// not written
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* out, int row0, int r,
                                           int c, int seq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16* dst = out + (size_t)row * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// `full` arrivals complete a ring stage's full_a and full_b: the TMA
// thread's (with its bytes), and K6's statistics warp's 32 lanes
__device__ __forceinline__ void init_barriers(uint32_t bar, int full) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);                   // own_full
    mbar_init(bar + 8, kConsumers * 4);  // own_empty: every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 16 + 8 * s, full);                         // full_a
      mbar_init(bar + 16 + 8 * (kStages + s), full);             // full_b
      mbar_init(bar + 16 + 8 * (2 * kStages + s), kConsumers * 4);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// K5: dq of a persistent CTA's query work tiles
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   __nv_bfloat16* __restrict__ dq,
                                   int bh_count, int seq, int causal,
                                   float scale, float scale_log2) {
  using L = DqLayout<D>;
  constexpr int kN = L::kN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t do_s = base + L::kDo;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t bar_own_full = base + L::kBar;
  const uint32_t bar_own_empty = bar_own_full + 8;
  const uint32_t bar_full_k = bar_own_full + 16;
  const uint32_t bar_full_v = bar_full_k + 8 * kStages;
  const uint32_t bar_empty = bar_full_v + 8 * kStages;
  const int m_tiles = (seq + kOwn - 1) / kOwn;
  const int n_work = bh_count * m_tiles;
  init_barriers(bar_own_full, 1);

  // work tile t -> (head, first query row), longest first: every head's
  // last query tile, then every head's tile before it, and so on
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;
      for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
        const int bh = t % bh_count;
        const int q0 = (m_tiles - 1 - t / bh_count) * kOwn;
        // the previous work tile's products are done with q and do
        mbar_wait(bar_own_empty, (w & 1) ^ 1);
        mbar_expect_tx(bar_own_full, 2 * L::kOwnBytes);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          tma_load_3d(q_s + a * kOwn * kAtomBytes, &tm_q, bar_own_full, 64 * a,
                      q0, bh);
          tma_load_3d(do_s + a * kOwn * kAtomBytes, &tm_do, bar_own_full,
                      64 * a, q0, bh);
        }
        const int n_tiles = dq_key_tiles<kN>(q0, seq, causal);
        for (int n = 0; n < n_tiles; ++n, ++kv) {
          const int stage = kv % kStages;
          // the first turn of the ring finds every stage empty
          mbar_wait(bar_empty + 8 * stage, ((kv / kStages) & 1) ^ 1);
          const uint32_t full_k = bar_full_k + 8 * stage;
          const uint32_t full_v = bar_full_v + 8 * stage;
          mbar_expect_tx(full_k, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            tma_load_3d(k_s + stage * L::kTileBytes + a * kN * kAtomBytes, &tm_k,
                        full_k, 64 * a, n * kN, bh);
          }
          mbar_expect_tx(full_v, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            tma_load_3d(v_s + stage * L::kTileBytes + a * kN * kAtomBytes, &tm_v,
                        full_v, 64 * a, n * kN, bh);
          }
        }
      }
    }
  } else {
    // consumer warpgroup `wg`: query rows [qw, qw + 64) of each work tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // accumulator layout: this thread holds rows r and r + 8 of the
    // warpgroup's 64 and, per 8-column chunk j, columns 8j + c, 8j + c + 1
    const int r = (tid / 32) * 16 + lane / 4;
    const int c = (lane % 4) * 2;
    const uint32_t q_wg = q_s + wg * 64 * kAtomBytes;
    const uint32_t do_wg = do_s + wg * 64 * kAtomBytes;
    int kv = 0;
    for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
      const int bh = t % bh_count;
      const int q0 = (m_tiles - 1 - t / bh_count) * kOwn;
      const int qw = q0 + wg * 64;
      const int n_tiles = dq_key_tiles<kN>(q0, seq, causal);
      // the lse (base 2) and delta of this thread's two rows
      float lse_r[2], delta_r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q_pos = qw + r + 8 * h;
        const size_t at = (size_t)bh * seq + q_pos;
        lse_r[h] = q_pos < seq ? lse[at] * kLog2e : 0.f;
        delta_r[h] = q_pos < seq ? delta[at] : 0.f;
      }
      float acc_dq[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_dq[j] = 0.f;

      mbar_wait(bar_own_full, w & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      for (int n = 0; n < n_tiles; ++n, ++kv) {
        const int stage = kv % kStages;
        const uint32_t parity = (kv / kStages) & 1;
        const int k0 = n * kN;
        const uint32_t k_src = k_s + stage * L::kTileBytes;
        const uint32_t v_src = v_s + stage * L::kTileBytes;

        // S = Q K^T and dP = dO V^T (64 x kN per warpgroup)
        float acc_s[kN / 2];
        float acc_dp[kN / 2];
        mbar_wait(bar_full_k + 8 * stage, parity);
        __syncwarp();
        scores<D, kN>(acc_s, q_wg, kOwn, k_src);
        mbar_wait(bar_full_v + 8 * stage, parity);
        __syncwarp();
        scores<D, kN>(acc_dp, do_wg, kOwn, v_src);
        wgmma_wait_all();
        fence_regs(acc_s);
        fence_regs(acc_dp);
        // the work tile's last S and dP products are in: q and do may be
        // reloaded
        if (n == n_tiles - 1 && lane == 0) mbar_arrive(bar_own_empty);

        // P and dS in the accumulators' layout, dS as bf16 A fragments
        const bool edge = k0 + kN > seq || (causal && k0 + kN - 1 > qw);
        uint32_t ds_frag[kN / 16][4];
#pragma unroll
        for (int j = 0; j < kN / 2; j += 2) {
          const int h = (j >> 1) & 1;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = acc_s[j + e] * scale_log2;
            if (edge) {
              const int k_pos = k0 + (j / 4) * 8 + c + e;
              const int q_pos = qw + r + 8 * h;
              if (k_pos >= seq || (causal && k_pos > q_pos)) s = kNegInf;
            }
            const float p = fast_exp2(s - lse_r[h]);
            ds[e] = p * (acc_dp[j + e] - delta_r[h]) * scale;
          }
          ds_frag[j / 8][(j % 8) / 2] = pack_bf16(ds[0], ds[1]);
        }

        // dQ += dS K (64 x D per warpgroup), K MN-major
        fence_regs(acc_dq);
        wgmma_fence();
        accumulate<D, kN>(acc_dq, ds_frag, k_src);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_dq);
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }
      store_rows<D>(acc_dq, dq + (size_t)bh * seq * D, qw, r, c, seq);
    }
  }
}

// K6: dk and dv of a persistent CTA's key work tiles
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv,
                                    int bh_count, int seq, int causal,
                                    float scale, float scale_log2) {
  using L = DkvLayout<D>;
  constexpr int kN = L::kN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_s = base + L::kQ;
  const uint32_t do_s = base + L::kDo;
  float* lse_ring = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kLse);
  float* delta_ring =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDelta);
  const uint32_t bar_own_full = base + L::kBar;
  const uint32_t bar_own_empty = bar_own_full + 8;
  const uint32_t bar_full_q = bar_own_full + 16;
  const uint32_t bar_full_do = bar_full_q + 8 * kStages;
  const uint32_t bar_empty = bar_full_do + 8 * kStages;
  const int k_tiles = (seq + kOwn - 1) / kOwn;
  const int q_tiles = (seq + kN - 1) / kN;
  const int n_work = bh_count * k_tiles;
  init_barriers(bar_own_full, 1 + 32);

  // work tile t -> (head, first key row), longest first: every head's
  // first key tile (seen by every query under causal masking), then
  // every head's next one, and so on; its query tiles run from the
  // causal diagonal on
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: its first thread issues every TMA load, its
    // second warp loads each query tile's lse (times log2e) and delta
    // into the stage, zeros past S
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = threadIdx.x - kConsumers * 128;
    if (ptid / 32 == 1) {
      int kv = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const int bh = t % bh_count;
        const int k0 = (t / bh_count) * kOwn;
        for (int n = causal ? k0 / kN : 0; n < q_tiles; ++n, ++kv) {
          const int stage = kv % kStages;
          mbar_wait(bar_empty + 8 * stage, ((kv / kStages) & 1) ^ 1);
#pragma unroll
          for (int i = 0; i < kN / 32; ++i) {
            const int col = 32 * i + ptid % 32;
            const int q_pos = n * kN + col;
            const size_t at = (size_t)bh * seq + q_pos;
            lse_ring[stage * kN + col] = q_pos < seq ? lse[at] * kLog2e : 0.f;
            delta_ring[stage * kN + col] = q_pos < seq ? delta[at] : 0.f;
          }
          // each lane's stores are released by its own arrival
          mbar_arrive(bar_full_q + 8 * stage);
          mbar_arrive(bar_full_do + 8 * stage);
        }
      }
    } else if (ptid == 0) {
      int kv = 0;
      for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
        const int bh = t % bh_count;
        const int k0 = (t / bh_count) * kOwn;
        mbar_wait(bar_own_empty, (w & 1) ^ 1);
        mbar_expect_tx(bar_own_full, 2 * L::kOwnBytes);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          tma_load_3d(k_s + a * kOwn * kAtomBytes, &tm_k, bar_own_full, 64 * a,
                      k0, bh);
          tma_load_3d(v_s + a * kOwn * kAtomBytes, &tm_v, bar_own_full, 64 * a,
                      k0, bh);
        }
        for (int n = causal ? k0 / kN : 0; n < q_tiles; ++n, ++kv) {
          const int stage = kv % kStages;
          mbar_wait(bar_empty + 8 * stage, ((kv / kStages) & 1) ^ 1);
          // row bh * seq + q0 of the tensors over all heads' rows
          const int row = bh * seq + n * kN;
          const uint32_t full_q = bar_full_q + 8 * stage;
          const uint32_t full_do = bar_full_do + 8 * stage;
          mbar_expect_tx(full_q, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            tma_load_2d(q_s + stage * L::kTileBytes + a * kN * kAtomBytes, &tm_q,
                        full_q, 64 * a, row);
          }
          mbar_expect_tx(full_do, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < D / 64; ++a) {
            tma_load_2d(do_s + stage * L::kTileBytes + a * kN * kAtomBytes,
                        &tm_do, full_do, 64 * a, row);
          }
        }
      }
    }
  } else {
    // consumer warpgroup `wg`: key rows [kw, kw + 64) of each work tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r = (tid / 32) * 16 + lane / 4;
    const int c = (lane % 4) * 2;
    const uint32_t k_wg = k_s + wg * 64 * kAtomBytes;
    const uint32_t v_wg = v_s + wg * 64 * kAtomBytes;
    int kv = 0;
    for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
      const int bh = t % bh_count;
      const int k0 = (t / bh_count) * kOwn;
      const int kw = k0 + wg * 64;
      const int first = causal ? k0 / kN : 0;
      float acc_dk[D / 2];
      float acc_dv[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_dk[j] = acc_dv[j] = 0.f;

      mbar_wait(bar_own_full, w & 1);
      __syncwarp();
      for (int n = first; n < q_tiles; ++n, ++kv) {
        const int stage = kv % kStages;
        const uint32_t parity = (kv / kStages) & 1;
        const int q0 = n * kN;
        const uint32_t q_src = q_s + stage * L::kTileBytes;
        const uint32_t do_src = do_s + stage * L::kTileBytes;
        const float* lse_t = lse_ring + stage * kN;
        const float* delta_t = delta_ring + stage * kN;

        // S^T = K Q^T and dP^T = V dO^T (64 x kN per warpgroup)
        float acc_s[kN / 2];
        float acc_dp[kN / 2];
        mbar_wait(bar_full_q + 8 * stage, parity);
        __syncwarp();
        scores<D, kN>(acc_s, k_wg, kOwn, q_src);
        mbar_wait(bar_full_do + 8 * stage, parity);
        __syncwarp();
        scores<D, kN>(acc_dp, v_wg, kOwn, do_src);
        wgmma_wait_all();
        fence_regs(acc_s);
        fence_regs(acc_dp);
        // the work tile's last S^T and dP^T products are in: k and v may
        // be reloaded
        if (n == q_tiles - 1 && lane == 0) mbar_arrive(bar_own_empty);

        // P^T and dS^T in the accumulators' layout (rows: this thread's
        // keys; columns: queries), as bf16 A fragments
        const bool edge = q0 + kN > seq || (causal && kw + 63 > q0);
        uint32_t p_frag[kN / 16][4];
        uint32_t ds_frag[kN / 16][4];
#pragma unroll
        for (int j = 0; j < kN / 2; j += 2) {
          const int h = (j >> 1) & 1;
          const int col = (j / 4) * 8 + c;
          const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + col);
          const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + col);
          const float lse_c[2] = {lse2.x, lse2.y};
          const float delta_c[2] = {delta2.x, delta2.y};
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = acc_s[j + e] * scale_log2;
            if (edge) {
              const int q_pos = q0 + col + e;
              const int k_pos = kw + r + 8 * h;
              // a query past S holds the next head's row here
              if (q_pos >= seq || (causal && k_pos > q_pos)) s = kNegInf;
            }
            p[e] = fast_exp2(s - lse_c[e]);
            ds[e] = p[e] * (acc_dp[j + e] - delta_c[e]) * scale;
          }
          p_frag[j / 8][(j % 8) / 2] = pack_bf16(p[0], p[1]);
          ds_frag[j / 8][(j % 8) / 2] = pack_bf16(ds[0], ds[1]);
        }

        // dV += P^T dO and dK += dS^T Q (64 x D per warpgroup), dO and Q
        // MN-major
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        wgmma_fence();
        accumulate<D, kN>(acc_dv, p_frag, do_src);
        accumulate<D, kN>(acc_dk, ds_frag, q_src);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }
      const size_t head = (size_t)bh * seq * D;
      store_rows<D>(acc_dk, dk + head, kw, r, c, seq);
      store_rows<D>(acc_dv, dv + head, kw, r, c, seq);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path: FMAs
// ---------------------------------------------------------------------------

constexpr int kRowsF = kThreads / 4;  // rows a block owns: 4 threads a row
constexpr int kTileF = 32;            // rows per tile of the other side

// the sum over the four threads of a row (consecutive lanes)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int seq, int causal,
                            float scale) {
  __shared__ float ks[kTileF][D];
  __shared__ float vs[kTileF][D];

  // thread `sub` of a row holds elements 4i + sub
  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsF;
  const int q_pos = q0 + row;
  const size_t base = (size_t)bh * seq * D;
  const bool real_row = q_pos < seq;

  float qr[D / 4];
  float dor[D / 4];
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const size_t at = base + (size_t)q_pos * D + 4 * i + sub;
    qr[i] = real_row ? q[at] : 0.f;
    dor[i] = real_row ? dout[at] : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = real_row ? lse[(size_t)bh * seq + q_pos] : 0.f;
  const float delta_r = real_row ? delta[(size_t)bh * seq + q_pos] : 0.f;

  const int q_last = min(q0 + kRowsF, seq) - 1;
  const int n_tiles =
      causal ? q_last / kTileF + 1 : (seq + kTileF - 1) / kTileF;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool real = k0 + r < seq;
      const size_t at = base + (size_t)(k0 + r) * D + c;
      ks[r][c] = real ? k[at] : 0.f;
      vs[r][c] = real ? v[at] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kTileF; ++j) {
      float s_part = 0.f;
      float dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        s_part = fmaf(qr[i], ks[j][4 * i + sub], s_part);
        dp_part = fmaf(dor[i], vs[j][4 * i + sub], dp_part);
      }
      const int k_pos = k0 + j;
      float s = quad_sum(s_part) * scale;
      if (causal && k_pos > q_pos) s = kNegInf;
      const float p = k_pos < seq ? expf(s - lse_r) : 0.f;
      const float ds = p * (quad_sum(dp_part) - delta_r) * scale;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(ds, ks[j][4 * i + sub], acc[i]);
    }
  }
  if (real_row) {
    float* out = dq + base + (size_t)q_pos * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) out[4 * i + sub] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int seq, int causal, float scale) {
  __shared__ float qs[kTileF][D];
  __shared__ float dos[kTileF][D];
  __shared__ float lse_s[kTileF];
  __shared__ float delta_s[kTileF];

  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRowsF;
  const int k_pos = k0 + row;
  const size_t base = (size_t)bh * seq * D;
  const bool real_row = k_pos < seq;

  float kr[D / 4];
  float vr[D / 4];
  float dk_acc[D / 4];
  float dv_acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const size_t at = base + (size_t)k_pos * D + 4 * i + sub;
    kr[i] = real_row ? k[at] : 0.f;
    vr[i] = real_row ? v[at] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_tiles = (seq + kTileF - 1) / kTileF;
  // causal: tiles of queries before k0 see none of these keys
  for (int t = causal ? k0 / kTileF : 0; t < n_tiles; ++t) {
    const int q0 = t * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool real = q0 + r < seq;
      const size_t at = base + (size_t)(q0 + r) * D + c;
      qs[r][c] = real ? q[at] : 0.f;
      dos[r][c] = real ? dout[at] : 0.f;
    }
    for (int i = threadIdx.x; i < kTileF; i += kThreads) {
      const bool real = q0 + i < seq;
      lse_s[i] = real ? lse[(size_t)bh * seq + q0 + i] : 0.f;
      delta_s[i] = real ? delta[(size_t)bh * seq + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kTileF; ++j) {
      float s_part = 0.f;
      float dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        s_part = fmaf(kr[i], qs[j][4 * i + sub], s_part);
        dp_part = fmaf(vr[i], dos[j][4 * i + sub], dp_part);
      }
      const int q_pos = q0 + j;
      float s = quad_sum(s_part) * scale;
      if (causal && k_pos > q_pos) s = kNegInf;
      const float p = q_pos < seq ? expf(s - lse_s[j]) : 0.f;
      const float ds = p * (quad_sum(dp_part) - delta_s[j]) * scale;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        dv_acc[i] = fmaf(p, dos[j][4 * i + sub], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[j][4 * i + sub], dk_acc[i]);
      }
    }
  }
  if (real_row) {
    float* dk_out = dk + base + (size_t)k_pos * D;
    float* dv_out = dv + base + (size_t)k_pos * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      dk_out[4 * i + sub] = dk_acc[i];
      dv_out[4 * i + sub] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a tensor map of `rank` dimensions (innermost first; strides in bytes
// of every dimension but the first) whose box is `box`; what lies past
// the tensor reads as zeros
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
            const void* ptr, const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (D, seq, bh) bf16 tensor at `ptr`, a box = one 64-column swizzle
// atom of `rows` rows of one head; rows past seq read as zeros
bool encode_heads(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                  int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same tensor as (D, bh * seq): all heads' rows in one run
bool encode_rows(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                 int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)bh * seq};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  int bh;
  int seq;
  int causal;
  float scale;
  cudaStream_t stream;
};

// above 48 KB of shared memory: opt in, once per device (the attribute
// holds for the current device only), and read the device's SM count.
// Two threads racing here both do it: harmless.
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, int smem, int (&sm_count)[kMaxDevices],
                    int& sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  sms = device < kMaxDevices ? sm_count[device] : 0;
  if (sms != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices) sm_count[device] = sms;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  constexpr int kN = Stream<D>::kN;
  const int m_tiles = (a.seq + kOwn - 1) / kOwn;
  if ((long long)a.bh * m_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_work = a.bh * m_tiles;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_heads(&tm_q, a.q, a.bh, a.seq, D, kOwn) ||
      !encode_heads(&tm_k, a.k, a.bh, a.seq, D, kN) ||
      !encode_heads(&tm_v, a.v, a.bh, a.seq, D, kN) ||
      !encode_heads(&tm_do, a.dout, a.bh, a.seq, D, kOwn)) {
    return cudaErrorInvalidValue;
  }
  static int sm_count[kMaxDevices] = {};
  const int smem = DqLayout<D>::kBytes;
  int sms = 0;
  const cudaError_t err =
      prepare(flash_bwd_dq_bf16_wgmma_kernel<D>, smem, sm_count, sms);
  if (err != cudaSuccess) return err;
  // one CTA per SM walks the work tiles
  const int grid = n_work < sms ? n_work : sms;
  flash_bwd_dq_bf16_wgmma_kernel<D><<<grid, kBwdThreads, smem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq),
      a.bh, a.seq, a.causal, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  constexpr int kN = Stream<D>::kN;
  // the streamed maps address rows bh * seq + q0 with 32-bit coordinates
  if ((long long)a.bh * a.seq + kN > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_work = a.bh * ((a.seq + kOwn - 1) / kOwn);
  CUtensorMap tm_k, tm_v, tm_q, tm_do;
  if (!encode_heads(&tm_k, a.k, a.bh, a.seq, D, kOwn) ||
      !encode_heads(&tm_v, a.v, a.bh, a.seq, D, kOwn) ||
      !encode_rows(&tm_q, a.q, a.bh, a.seq, D, kN) ||
      !encode_rows(&tm_do, a.dout, a.bh, a.seq, D, kN)) {
    return cudaErrorInvalidValue;
  }
  static int sm_count[kMaxDevices] = {};
  const int smem = DkvLayout<D>::kBytes;
  int sms = 0;
  const cudaError_t err =
      prepare(flash_bwd_dkv_bf16_wgmma_kernel<D>, smem, sm_count, sms);
  if (err != cudaSuccess) return err;
  const int grid = n_work < sms ? n_work : sms;
  flash_bwd_dkv_bf16_wgmma_kernel<D><<<grid, kBwdThreads, smem, a.stream>>>(
      tm_k, tm_v, tm_q, tm_do, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.bh, a.seq, a.causal, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  const dim3 grid((a.seq + kRowsF - 1) / kRowsF, a.bh);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, static_cast<float*>(dq), a.seq, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.seq + kRowsF - 1) / kRowsF, a.bh);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.seq,
      a.causal, a.scale);
  return cudaGetLastError();
}

bool valid(int bh, int seq, int head_dim) {
  return bh > 0 && seq > 0 && bh <= 65535 && (head_dim == 64 || head_dim == 128);
}

}  // namespace

// q, k, v, dout, dq: (bh, seq, head_dim) contiguous, bf16 (is_bf16 = 1)
// or fp32, 16-byte aligned; lse, delta: (bh, 1, seq) fp32, 16-byte
// aligned. Returns a cudaError_t (0 = launched).
extern "C" int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int seq,
                                int head_dim, int is_bf16, int causal,
                                float scale, void* stream) {
  if (!valid(bh, seq, head_dim)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, seq, causal, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16) {
    err = head_dim == 64 ? launch_dq_bf16<64>(a, dq) : launch_dq_bf16<128>(a, dq);
  } else {
    err = head_dim == 64 ? launch_dq_f32<64>(a, dq) : launch_dq_f32<128>(a, dq);
  }
  return (int)err;
}

// as edl_flash_bwd_dq; dk, dv: (bh, seq, head_dim) like k and v
extern "C" int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int seq, int head_dim, int is_bf16,
                                 int causal, float scale, void* stream) {
  if (!valid(bh, seq, head_dim)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), bh, seq, causal, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16) {
    err = head_dim == 64 ? launch_dkv_bf16<64>(a, dk, dv)
                         : launch_dkv_bf16<128>(a, dk, dv);
  } else {
    err = head_dim == 64 ? launch_dkv_f32<64>(a, dk, dv)
                         : launch_dkv_f32<128>(a, dk, dv);
  }
  return (int)err;
}
