// Flash-attention forward (K4) for Hopper, sm_90a.
//
// Replaces elasticdl_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd through pl.pallas_call). Same function: blockwise online-softmax
// attention of (B*H, Sq, D) q over (B*H, Sk, D) k and v (Sq and Sk may
// differ; under the causal mask query row i sees keys j <= i, both
// counted from 0), causal blocks above the diagonal skipped, masked scores set to -1e30 (not -inf), products in the input
// dtype with fp32 accumulation, p cast to the input dtype before the PV
// product, softmax statistics in fp32, a fully-masked row gives o = 0,
// and lse = m + log(max(l, 1e-30)) in natural log.
//
// Bound at the serving shape (B=8, H=12, S=1024, D=64, bf16, causal,
// B*H = 96): the causal pairs need 4 * 96 * 64 * 1024 * 1025 / 2
// = 12.9 GFLOP, 13.0 us at 989 TFLOP/s; q, k, v and o are 4 * 12.6 MB
// = 50.3 MB plus 0.4 MB of lse, 15.1 us at 3.35 TB/s. So one launch is
// bounded by memory at about 15 us, with the tensor cores close behind,
// and a served batch makes 12 launches (one per layer).
//
// bf16 design (warp-specialised and persistent):
// - A work tile is 128 query rows of one head. One CTA per SM (grid
//   min(SMs, work tiles)) walks them longest first: every head's last
//   query tile (the most key tiles under causal masking), then every
//   head's tile before it, and so on; CTA b takes tiles b, b + grid, ...
//   So a tile's Q and first K/V loads overlap the previous tile's last
//   products and epilogue, and short tiles fill the tail.
// - 384 threads: two consumer warpgroups of 64 query rows each (wgmma's
//   M = 64) and a producer warpgroup whose first thread issues every TMA
//   load; setmaxnreg moves registers from the producer (40) to the
//   consumers (232).
// - TMA through 3-D tensor maps (D, Sq, B*H) for Q and (D, Sk, B*H) for
//   K and V, so a ragged tail zero-fills inside its own head. Q is loaded once per work tile, behind a
//   q_full/q_empty mbarrier pair (the next tile's Q lands once the last
//   S product of this one is in). K and V tiles of 128 keys stream
//   through a ring of kStages stages (3 at D 64, 2 at D 128) that runs
//   on across work tiles, each stage with a "full" mbarrier for K and
//   one for V (TMA completion, expect_tx bytes) and an "empty" mbarrier
//   the 8 consumer warps arrive on. Every tile is 128B-swizzled, in
//   64-column (128-byte) atoms: one per row at D 64, two side by side
//   at D 128, four at D 256.
// - D 256: a 128-key K or V tile is 64 KB, so Q (64 KB) and two stages
//   of K and V would need 320 KB of the 227 KB a block can have. The
//   key tile is 64 rows there (FwdLayout::kBlockN): Q plus two stages is
//   192 KB. The fp32 O accumulator is 64 x 256 per warpgroup, 128
//   registers a thread; S over 64 keys adds 32 and P's bf16 fragments
//   16, under setmaxnreg's 232.
// - S = Q K^T: wgmma m64nNk16 (N = the key tile: 128, or 64 at D 256),
//   both operands K-major in shared memory.
//   The scores stay in registers; the softmax runs in the accumulator's
//   own layout (a thread holds two rows, a quad of lanes shares a row:
//   two shuffles per reduction), in base 2 on scores pre-scaled by
//   scale * log2(e). Only the key tiles that cross the causal diagonal
//   (k0 <= q + 63 < k0 + kBlockN for some row q of the warpgroup: with
//   Sq != Sk that is not the tile of the same index) and the ragged
//   last key tile are masked element by element.
// - O += P V: P converted to bf16 in registers is wgmma's A operand (the
//   fp32 accumulator layout of S is the bf16 A-fragment layout of P);
//   V is MN-major in shared memory (trans-b). The fp32 O accumulator
//   stays in registers and the online-softmax rescale is register
//   arithmetic.
// - Epilogue: O / l stored as bf16 pairs straight from registers, lse
//   by the first lane of each quad; rows past Sq are not written.
// - No atomics and no split over keys: two launches on the same inputs
//   give the same bits.
//
// fp32 path: the tensor cores take no full-precision fp32, so products
// are FMAs. Two threads share a query row (eight at D 256, so a thread
// holds 32 + 32 floats and not 128 + 128), each holding its share of q
// and of the accumulator in registers; K/V tiles of 32 rows (16 at
// D 256: 32 KB of static shared memory) sit in shared memory. Keys past
// Sk score -inf (they do not exist, so they add
// nothing), and no output is written past Sq; neither path demands that
// Sq or Sk divide by a block size.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): edl_flash_fwd launches on the given stream, does not
// synchronise, and returns a cudaError_t. The tensor maps' encoder,
// cuTensorMapEncodeTiled, is a driver function fetched at run time
// through the runtime's entry-point query, so nothing links -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // K4's mask value (flash_attention.py NEG_INF)
constexpr int kBlockQ = 64;        // fp32 path: query rows per block

// ---------------------------------------------------------------------------
// bf16 path: TMA + mbarrier ring + wgmma
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;  // query rows per CTA
constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kFwdThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kAtomBytes = 128;  // one swizzle atom row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdLayout {
  static constexpr int kAtoms = D / 64;  // 64-column atoms per row
  static constexpr int kBlockN = D == 256 ? 64 : 128;  // key rows per K/V tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  // byte offsets from the 1024-aligned base: Q, the K ring, the V ring,
  // then the barriers (q_full, q_empty, full_k[S], full_v[S], empty[S])
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
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

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
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
// shared memory; scale_d 0 overwrites d
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

// d (64 x 256 fp32) += A (64 x 16 bf16, registers) * B (16 x 256,
// MN-major in shared memory, four 64-column atoms)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
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

// key tiles of kBlockN keys a query tile visits: up to its last row's
// diagonal under causal masking (and no further than the last key), all
// of them otherwise
template <int kBlockN>
__device__ __forceinline__ int key_tiles(int q0, int seq_q, int seq_k,
                                         int causal) {
  const int all = (seq_k + kBlockN - 1) / kBlockN;
  const int q_last = min(q0 + kBlockM, seq_q) - 1;
  return causal ? min(q_last / kBlockN + 1, all) : all;
}

// work tile t -> (head, first query row), longest first: every head's
// last query tile (the most key tiles under causal masking), then every
// head's tile before it, and so on
__device__ __forceinline__ void work_tile(int t, int bh_count, int m_tiles,
                                          int& bh, int& q0) {
  bh = t % bh_count;
  q0 = (m_tiles - 1 - t / bh_count) * kBlockM;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int bh_count,
                                int seq_q, int seq_k, int causal,
                                float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int kStages = L::kStages;
  constexpr int kBlockN = L::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t bar_q_full = base + L::kBar;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full_k = bar_q_empty + 8;
  const uint32_t bar_full_v = bar_full_k + 8 * kStages;
  const uint32_t bar_empty = bar_full_v + 8 * kStages;
  const int m_tiles = (seq_q + kBlockM - 1) / kBlockM;
  const int n_work = bh_count * m_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, kConsumers * 4);  // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // persistent: CTA b takes work tiles b, b + gridDim.x, ...; the K/V
  // ring's count `kv` runs on across them, so a tile's loads overlap the
  // previous tile's last products and epilogue
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;
      for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
        int bh, q0;
        work_tile(t, bh_count, m_tiles, bh, q0);
        // the previous work tile's S products are done with Q
        mbar_wait(bar_q_empty, (w & 1) ^ 1);
        mbar_expect_tx(bar_q_full, L::kQBytes);
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(q_s + a * kBlockM * kAtomBytes, &tm_q, bar_q_full, 64 * a,
                   q0, bh);
        }
        const int n_tiles = key_tiles<kBlockN>(q0, seq_q, seq_k, causal);
        for (int n = 0; n < n_tiles; ++n, ++kv) {
          const int stage = kv % kStages;
          // the first turn of the ring finds every stage empty
          mbar_wait(bar_empty + 8 * stage, ((kv / kStages) & 1) ^ 1);
          const uint32_t full_k = bar_full_k + 8 * stage;
          const uint32_t full_v = bar_full_v + 8 * stage;
          const uint32_t k_dst = k_s + stage * L::kTileBytes;
          const uint32_t v_dst = v_s + stage * L::kTileBytes;
          mbar_expect_tx(full_k, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a) {
            tma_load(k_dst + a * kBlockN * kAtomBytes, &tm_k, full_k, 64 * a,
                     n * kBlockN, bh);
          }
          mbar_expect_tx(full_v, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a) {
            tma_load(v_dst + a * kBlockN * kAtomBytes, &tm_v, full_v, 64 * a,
                     n * kBlockN, bh);
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
    int kv = 0;
    for (int t = blockIdx.x, w = 0; t < n_work; t += gridDim.x, ++w) {
      int bh, q0;
      work_tile(t, bh_count, m_tiles, bh, q0);
      const int qw = q0 + wg * 64;
      const int n_tiles = key_tiles<kBlockN>(q0, seq_q, seq_k, causal);
      float acc_o[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc_o[j] = 0.f;
      float m_run[2] = {kNegInf, kNegInf};  // base-2 running max per row
      float l_part[2] = {0.f, 0.f};  // this thread's share of the row sum

      mbar_wait(bar_q_full, w & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      for (int n = 0; n < n_tiles; ++n, ++kv) {
        const int stage = kv % kStages;
        const uint32_t parity = (kv / kStages) & 1;
        const int k0 = n * kBlockN;
        const uint32_t k_src = k_s + stage * L::kTileBytes;
        const uint32_t v_src = v_s + stage * L::kTileBytes;

        // S = Q K^T (64 x kBlockN per warpgroup)
        float acc_s[kBlockN / 2];
        mbar_wait(bar_full_k + 8 * stage, parity);
        __syncwarp();
        fence_regs(acc_s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;  // 16 bf16 inside a 128-byte atom
          wgmma_ss(
              acc_s,
              sw128_desc(q_wg + (kk / 4) * kBlockM * kAtomBytes + col, 16),
              sw128_desc(k_src + (kk / 4) * kBlockN * kAtomBytes + col, 16),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_s);
        // the work tile's last S product is in: Q may be reloaded
        if (n == n_tiles - 1 && lane == 0) mbar_arrive(bar_q_empty);

        // online softmax in base 2, in the accumulator's layout
        const bool edge =
            k0 + kBlockN > seq_k || (causal && k0 + kBlockN - 1 > qw);
        float tile_max[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int j = 0; j < kBlockN / 2; ++j) {
          float s = acc_s[j] * scale_log2;
          if (edge) {
            const int k_pos = k0 + (j / 4) * 8 + c + (j & 1);
            const int q_pos = qw + r + ((j >> 1) & 1) * 8;
            if (k_pos >= seq_k) {
              s = -INFINITY;  // past the ragged edge: no key here
            } else if (causal && k_pos > q_pos) {
              s = kNegInf;
            }
          }
          acc_s[j] = s;
          tile_max[(j >> 1) & 1] = fmaxf(tile_max[(j >> 1) & 1], s);
        }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = tile_max[h];
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          corr[h] = fast_exp2(m_run[h] - mx);
          m_run[h] = mx;
          l_part[h] *= corr[h];
        }
        uint32_t p_frag[kBlockN / 16][4];
#pragma unroll
        for (int j = 0; j < kBlockN / 2; j += 2) {
          const int h = (j >> 1) & 1;
          const float p0 = fast_exp2(acc_s[j] - m_run[h]);
          const float p1 = fast_exp2(acc_s[j + 1] - m_run[h]);
          l_part[h] += p0 + p1;
          p_frag[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc_o[i] *= corr[(i >> 1) & 1];

        // O += P V (64 x D per warpgroup)
        mbar_wait(bar_full_v + 8 * stage, parity);
        __syncwarp();
        fence_regs(acc_o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs(acc_o, p_frag[kk],
                   sw128_desc(v_src + kk * 16 * kAtomBytes,
                              kBlockN * kAtomBytes));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_o);
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }

      // epilogue: o = acc / l in bf16, lse in natural log
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_part[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int q_pos = qw + r + 8 * h;
        if (q_pos < seq_q) {
          const float inv = l > 0.f ? 1.f / l : 1.f;
          __nv_bfloat16* out = o + ((size_t)bh * seq_q + q_pos) * D + c;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(acc_o[4 * j + 2 * h] * inv,
                                      acc_o[4 * j + 2 * h + 1] * inv);
          }
          if ((lane & 3) == 0) {
            lse[(size_t)bh * seq_q + q_pos] =
                m_run[h] * kLn2 + logf(fmaxf(l, 1e-30f));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path: FMAs
// ---------------------------------------------------------------------------

template <int D>
struct F32Layout {
  static constexpr int kSplit = D == 256 ? 8 : 2;  // threads a query row
  static constexpr int kThreads = kBlockQ * kSplit;
  static constexpr int kTileF = D == 256 ? 16 : 32;  // key rows per tile
};

template <int D>
__global__ void __launch_bounds__(F32Layout<D>::kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int seq_q, int seq_k,
                         int causal, float scale) {
  constexpr int kSplit = F32Layout<D>::kSplit;
  constexpr int kThreads = F32Layout<D>::kThreads;
  constexpr int kTileF = F32Layout<D>::kTileF;
  constexpr int kPart = D / kSplit;  // elements of a row a thread holds
  __shared__ float ks[kTileF][D];
  __shared__ float vs[kTileF][D];

  // kSplit threads per query row; thread `half` holds elements
  // kSplit * i + half
  const int row = threadIdx.x / kSplit;
  const int half = threadIdx.x % kSplit;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int q_pos = q0 + row;
  const size_t base = (size_t)bh * seq_q * D;    // q and o
  const size_t base_k = (size_t)bh * seq_k * D;  // k and v

  float qr[kPart];
  float acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    qr[i] = q_pos < seq_q ? q[base + (size_t)q_pos * D + kSplit * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBlockQ, seq_q) - 1;
  const int all = (seq_k + kTileF - 1) / kTileF;
  const int n_tiles = causal ? min(q_last / kTileF + 1, all) : all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool real = k0 + r < seq_k;
      const size_t at = base_k + (size_t)(k0 + r) * D + c;
      ks[r][c] = real ? k[at] : 0.f;
      vs[r][c] = real ? v[at] : 0.f;
    }
    __syncthreads();

    float sv[kTileF];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPart; ++i) {
        part = fmaf(qr[i], ks[j][kSplit * i + half], part);
      }
      // the row's sum over its kSplit threads (consecutive lanes)
#pragma unroll
      for (int lanes = 1; lanes < kSplit; lanes <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, lanes);
      }
      const float s = part * scale;
      const int k_pos = k0 + j;
      sv[j] = k_pos >= seq_k ? -INFINITY
              : (causal && k_pos > q_pos) ? kNegInf
                                          : s;
      tile_max = fmaxf(tile_max, sv[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kPart; ++i) acc[i] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kPart; ++i) {
        acc[i] = fmaf(p, vs[j][kSplit * i + half], acc[i]);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (q_pos < seq_q) {
    const float denom = l > 0.f ? l : 1.f;
    float* out = o + base + (size_t)q_pos * D;
#pragma unroll
    for (int i = 0; i < kPart; ++i) out[kSplit * i + half] = acc[i] / denom;
    if (half == 0) {
      lse[(size_t)bh * seq_q + q_pos] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// launch
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

// the (D, seq, bh) bf16 tensor at `ptr` as a 3-D tensor map whose box is
// one 64-column swizzle atom of `rows` rows of one head; rows past seq
// read as zeros
bool encode_bf16(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                 int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int seq_q, int seq_k, int causal,
                        float scale, cudaStream_t stream) {
  const int m_tiles = (seq_q + kBlockM - 1) / kBlockM;
  if ((long long)bh * m_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_work = bh * m_tiles;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bf16(&tm_q, q, bh, seq_q, D, kBlockM) ||
      !encode_bf16(&tm_k, k, bh, seq_k, D, FwdLayout<D>::kBlockN) ||
      !encode_bf16(&tm_v, v, bh, seq_k, D, FwdLayout<D>::kBlockN)) {
    return cudaErrorInvalidValue;
  }
  // above 48 KB: opt in, once per device (the attribute holds for the
  // current device only), and read the device's SM count. Two threads
  // racing here both do it: harmless.
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  const int smem = FwdLayout<D>::kBytes;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = device < kMaxDevices ? sm_count[device] : 0;
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_fwd_bf16_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) sm_count[device] = sms;
  }
  // one CTA per SM walks the work tiles
  const int grid = n_work < sms ? n_work : sms;
  flash_fwd_bf16_wgmma_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, bh, seq_q, seq_k,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq_q, int seq_k, int causal,
                       float scale, cudaStream_t stream) {
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<D><<<grid, F32Layout<D>::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq_q, seq_k,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (bh, seq_q, head_dim) and k, v: (bh, seq_k, head_dim) contiguous,
// bf16 (is_bf16 = 1) or fp32, head_dim 64, 128 or 256, 16-byte aligned;
// lse: (bh, 1, seq_q) fp32. Returns a cudaError_t (0 = launched).
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int seq_q,
                             int seq_k, int head_dim, int is_bf16, int causal,
                             float scale, void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (is_bf16) {
    if (head_dim == 64) {
      err = launch_bf16<64>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                            scale, st);
    } else if (head_dim == 128) {
      err = launch_bf16<128>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                             scale, st);
    } else if (head_dim == 256) {
      err = launch_bf16<256>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                             scale, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    if (head_dim == 64) {
      err = launch_f32<64>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                           scale, st);
    } else if (head_dim == 128) {
      err = launch_f32<128>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                            scale, st);
    } else if (head_dim == 256) {
      err = launch_f32<256>(q, k, v, o, lse_f, bh, seq_q, seq_k, causal,
                            scale, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
