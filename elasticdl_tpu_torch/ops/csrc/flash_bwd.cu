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
// Design (a first, right kernel; wgmma, TMA and pipelining come later):
// - The TPU's sequential grid axis becomes a loop inside the block, and
//   every output row is owned by exactly one block: no atomics.
//   K5: grid (ceil(S / 64), B*H); a block owns 64 query rows of one head
//   and walks the key tiles up to the diagonal. K6: grid (ceil(S / 64),
//   B*H); a block owns 64 key rows and walks the query tiles from the
//   diagonal on.
// - bf16: four warps, 16 rows each. Tiles of 64 rows sit in shared
//   memory; every product runs on the tensor cores through nvcuda::wmma
//   bf16 fragments with fp32 accumulators. The accumulators of dq (K5)
//   and of dk, dv (K6) stay in registers for the whole loop: unlike the
//   forward's output, they are never rescaled, so wmma's hidden
//   fragment layout does not matter until the final store.
// - The scores of each step go through per-warp fp32 tiles in shared
//   memory (s and dp), where each lane pair owns one row and does the
//   elementwise p / ds step; p and ds are written back as bf16 tiles
//   that feed the next product.
// - K6 computes the transposed scores s^T = k q^T and dp^T = v do^T
//   directly: the query tile is read as a col_major wmma operand, as the
//   forward reads its key tile. p^T and ds^T then come out row-major
//   with the warp's own key rows, so p^T do and ds^T q are plain
//   row-major products into the warp's dk, dv accumulators. No
//   transpose is ever materialised and no warp touches another's rows.
// - fp32: the tensor cores take no full-precision fp32, so products are
//   FMAs. Four threads share a row (each holds a quarter of it in
//   registers); the other side's tiles of 32 rows sit in shared memory.
// - The ragged edge is masked in the kernel: rows past S load as zeros
//   and are never written; keys (K5) or queries (K6) past S get p = 0,
//   as the forward's -inf score gives them. The TPU version demanded
//   that S divide by the block sizes; this one does not.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): edl_flash_bwd_dq and edl_flash_bwd_dkv launch on the given
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;  // the forward's causal mask value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// bf16 path: wmma
// ---------------------------------------------------------------------------

constexpr int kBlock = 64;        // rows a block owns, and rows per tile
constexpr int kLdS = kBlock + 4;  // fp32 score row stride (pads bank conflicts)
constexpr int kLdP = kBlock + 8;  // bf16 p / ds row stride

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using RowA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                            wmma::row_major>;
using RowB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                            wmma::row_major>;
using ColB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                            wmma::col_major>;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int kLdT = D + 8;  // bf16 tile row stride
  static constexpr int kLdO = D + 4;  // fp32 output staging row stride
  static constexpr size_t kTile =
      align128(sizeof(__nv_bfloat16) * kBlock * kLdT);
  static constexpr size_t kScore = align128(sizeof(float) * kWarps * 16 * kLdS);
  static constexpr size_t kProbs =
      align128(sizeof(__nv_bfloat16) * kWarps * 16 * kLdP);
  static constexpr size_t kOut = align128(sizeof(float) * kWarps * 16 * kLdO);
  static constexpr size_t kStats = align128(sizeof(float) * kBlock);
  // K5: q, do, k, v tiles; s and dp; ds; dq staging
  static constexpr size_t kDqBytes = 4 * kTile + 2 * kScore + kProbs + kOut;
  // K6: k, v, q, do tiles; s^T and dp^T; p^T and ds^T; dk / dv staging;
  // lse and delta of the query tile
  static constexpr size_t kDkvBytes =
      4 * kTile + 2 * kScore + 2 * kProbs + kOut + 2 * kStats;
};

// rows [row0, row0 + rows) of a (seq, D) bf16 matrix into a shared tile
// of row stride ld; rows past seq are zero
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, int ld,
                                               const __nv_bfloat16* src,
                                               int row0, int rows, int seq) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) {
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c];
    }
    reinterpret_cast<uint4*>(dst + r * ld)[c] = val;
  }
}

// out (16 x kBlock fp32, row stride kLdS) = a (16 x D) b^T, with a the
// warp's 16 rows and b a tile of kBlock rows, both of row stride kLdT:
// b read col_major is b^T
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out,
                                                  const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b) {
  constexpr int ld = Layout<D>::kLdT;
  RowA a_frag[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(a_frag[kk], a + kk * 16, ld);
  }
#pragma unroll
  for (int n = 0; n < kBlock / 16; ++n) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ColB b_frag;
      wmma::load_matrix_sync(b_frag, b + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc, a_frag[kk], b_frag, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// acc (16 x D) += p (16 x kBlock bf16, row stride kLdP) t (kBlock x D,
// row stride kLdT)
template <int D>
__device__ __forceinline__ void accumulate(AccFrag (&acc)[D / 16],
                                           const __nv_bfloat16* p,
                                           const __nv_bfloat16* t) {
  constexpr int ld = Layout<D>::kLdT;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    RowA p_frag;
    wmma::load_matrix_sync(p_frag, p + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      RowB t_frag;
      wmma::load_matrix_sync(t_frag, t + kk * 16 * ld + n * 16, ld);
      wmma::mma_sync(acc[n], p_frag, t_frag, acc[n]);
    }
  }
}

// the warp's 16 rows of acc (16 x D) cast to bf16 into rows
// [row0, row0 + 16) of out, rows past seq skipped; stage is the warp's
// fp32 staging tile
template <int D>
__device__ __forceinline__ void store_rows(AccFrag (&acc)[D / 16],
                                           float* stage,
                                           __nv_bfloat16* out, int row0,
                                           int seq) {
  constexpr int ld = Layout<D>::kLdO;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage + n * 16, acc[n], ld, wmma::mem_row_major);
  }
  __syncwarp();
  const int row = lane >> 1;
  const int half = lane & 1;
  if (row0 + row < seq) {
    __nv_bfloat16* dst = out + (size_t)(row0 + row) * D;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      const int col = 2 * c + half;
      dst[col] = __float2bfloat16(stage[row * ld + col]);
    }
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int seq,
                             int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::kTile);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::kTile);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * L::kTile);
  unsigned char* rest = smem + 4 * L::kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* s_w = reinterpret_cast<float*>(rest) + warp * 16 * kLdS;
  float* dp_w = reinterpret_cast<float*>(rest + L::kScore) + warp * 16 * kLdS;
  __nv_bfloat16* ds_w =
      reinterpret_cast<__nv_bfloat16*>(rest + 2 * L::kScore) +
      warp * 16 * kLdP;
  float* out_w = reinterpret_cast<float*>(rest + 2 * L::kScore + L::kProbs) +
                 warp * 16 * L::kLdO;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * seq * D;
  load_tile_bf16<D>(qs, L::kLdT, q + base, q0, kBlock, seq);
  load_tile_bf16<D>(dos, L::kLdT, dout + base, q0, kBlock, seq);

  // lane pair (2r, 2r+1) owns row r of the warp's 16; each takes the
  // interleaved half `half` of the columns
  const int row = lane >> 1;
  const int half = lane & 1;
  const int q_pos = q0 + warp * 16 + row;
  const float lse_r = q_pos < seq ? lse[(size_t)bh * seq + q_pos] : 0.f;
  const float delta_r = q_pos < seq ? delta[(size_t)bh * seq + q_pos] : 0.f;
  const __nv_bfloat16* q_w = qs + warp * 16 * L::kLdT;
  const __nv_bfloat16* do_w = dos + warp * 16 * L::kLdT;

  AccFrag dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  const int q_last = min(q0 + kBlock, seq) - 1;
  const int n_tiles =
      causal ? q_last / kBlock + 1 : (seq + kBlock - 1) / kBlock;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(ks, L::kLdT, k + base, k0, kBlock, seq);
    load_tile_bf16<D>(vs, L::kLdT, v + base, k0, kBlock, seq);
    __syncthreads();

    rows_times_tile_t<D>(s_w, q_w, ks);    // s  = q k^T
    rows_times_tile_t<D>(dp_w, do_w, vs);  // dp = do v^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBlock / 2; ++j) {
      const int col = 2 * j + half;
      const int k_pos = k0 + col;
      float s = s_w[row * kLdS + col] * scale;
      if (causal && k_pos > q_pos) s = kNegInf;
      const float p = k_pos < seq ? __expf(s - lse_r) : 0.f;
      const float ds = p * (dp_w[row * kLdS + col] - delta_r) * scale;
      ds_w[row * kLdP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<D>(dq_acc, ds_w, ks);  // dq += ds k
  }
  store_rows<D>(dq_acc, out_w, dq + base, q0 + warp * 16, seq);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq,
                              int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kTile);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::kTile);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + 3 * L::kTile);
  unsigned char* rest = smem + 4 * L::kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st_w = reinterpret_cast<float*>(rest) + warp * 16 * kLdS;
  float* dpt_w = reinterpret_cast<float*>(rest + L::kScore) + warp * 16 * kLdS;
  __nv_bfloat16* pt_w =
      reinterpret_cast<__nv_bfloat16*>(rest + 2 * L::kScore) +
      warp * 16 * kLdP;
  __nv_bfloat16* dst_w =
      reinterpret_cast<__nv_bfloat16*>(rest + 2 * L::kScore + L::kProbs) +
      warp * 16 * kLdP;
  unsigned char* after = rest + 2 * L::kScore + 2 * L::kProbs;
  float* out_w = reinterpret_cast<float*>(after) + warp * 16 * L::kLdO;
  float* lse_s = reinterpret_cast<float*>(after + L::kOut);
  float* delta_s = reinterpret_cast<float*>(after + L::kOut + L::kStats);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * seq * D;
  load_tile_bf16<D>(ks, L::kLdT, k + base, k0, kBlock, seq);
  load_tile_bf16<D>(vs, L::kLdT, v + base, k0, kBlock, seq);

  // lane pair (2r, 2r+1) owns key row r of the warp's 16
  const int row = lane >> 1;
  const int half = lane & 1;
  const int k_pos = k0 + warp * 16 + row;
  const __nv_bfloat16* k_w = ks + warp * 16 * L::kLdT;
  const __nv_bfloat16* v_w = vs + warp * 16 * L::kLdT;

  AccFrag dk_acc[D / 16];
  AccFrag dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  // causal: query tiles before the one holding k0 see none of these keys
  for (int t = causal ? blockIdx.x : 0; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile_bf16<D>(qs, L::kLdT, q + base, q0, kBlock, seq);
    load_tile_bf16<D>(dos, L::kLdT, dout + base, q0, kBlock, seq);
    for (int i = threadIdx.x; i < kBlock; i += kThreads) {
      const bool real = q0 + i < seq;
      lse_s[i] = real ? lse[(size_t)bh * seq + q0 + i] : 0.f;
      delta_s[i] = real ? delta[(size_t)bh * seq + q0 + i] : 0.f;
    }
    __syncthreads();

    rows_times_tile_t<D>(st_w, k_w, qs);    // s^T  = k q^T
    rows_times_tile_t<D>(dpt_w, v_w, dos);  // dp^T = v do^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kBlock / 2; ++j) {
      const int col = 2 * j + half;
      const int q_pos = q0 + col;
      float s = st_w[row * kLdS + col] * scale;
      if (causal && k_pos > q_pos) s = kNegInf;
      const float p = q_pos < seq ? __expf(s - lse_s[col]) : 0.f;
      const float ds = p * (dpt_w[row * kLdS + col] - delta_s[col]) * scale;
      pt_w[row * kLdP + col] = __float2bfloat16(p);
      dst_w[row * kLdP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<D>(dv_acc, pt_w, dos);  // dv += p^T do
    accumulate<D>(dk_acc, dst_w, qs);  // dk += ds^T q
  }
  store_rows<D>(dk_acc, out_w, dk + base, k0 + warp * 16, seq);
  store_rows<D>(dv_acc, out_w, dv + base, k0 + warp * 16, seq);
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

// above 48 KB of shared memory: opt in, once per device (the attribute
// holds for the current device only). Two threads racing here both set
// it: harmless.
template <typename Kernel>
cudaError_t ensure_smem(Kernel* kernel, size_t bytes,
                        bool (&configured)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices) configured[device] = true;
  return cudaSuccess;
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

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = Layout<D>::kDqBytes;
  cudaError_t err = ensure_smem(flash_bwd_dq_bf16_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.seq, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  static bool configured[kMaxDevices] = {};
  const size_t smem = Layout<D>::kDkvBytes;
  cudaError_t err =
      ensure_smem(flash_bwd_dkv_bf16_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kBlock - 1) / kBlock, a.bh);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.seq,
      a.causal, a.scale);
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
// or fp32; lse, delta: (bh, 1, seq) fp32. Returns a cudaError_t
// (0 = launched).
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
