// Flash-attention forward (K4) for Hopper, sm_90a.
//
// Replaces elasticdl_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd through pl.pallas_call). Same function: blockwise online-softmax
// attention over (B*H, S, D) q/k/v, causal blocks above the diagonal
// skipped, masked scores set to -1e30 (not -inf), products in the input
// dtype with fp32 accumulation, p cast to the input dtype before the PV
// product, softmax statistics in fp32, a fully-masked row gives o = 0,
// and lse = m + log(max(l, 1e-30)) in natural log.
//
// Bound at the serving shape (B=8, H=12, S=1024, D=64, bf16, causal,
// B*H = 96): the causal pairs need 4 * 96 * 64 * 1024 * 1025 / 2
// = 12.9 GFLOP, 13.0 us at 989 TFLOP/s; q, k, v and o are 4 * 12.6 MB
// = 50.3 MB plus 0.4 MB of lse, 15.1 us at 3.35 TB/s. So one launch is
// bounded by memory at about 15 us, and a served batch makes 12 launches
// (one per layer).
//
// Design (a first, right kernel; wgmma and TMA come later):
// - The TPU's sequential k-grid axis becomes a loop inside the block.
//   Grid (ceil(S / 64), B*H); one block owns 64 query rows of one head
//   and walks the key tiles, stopping at the diagonal under causal
//   masking.
// - bf16: four warps, 16 query rows each. K/V tiles of 64 rows are
//   staged in shared memory; QK^T and PV run on the tensor cores through
//   nvcuda::wmma bf16 fragments with fp32 accumulators. Each warp keeps
//   its scores, its bf16 p and its fp32 output accumulator in its own
//   slice of shared memory, so the per-row rescale by the online-softmax
//   correction is plain per-lane arithmetic. Two lanes share a row; the
//   running m and l live in their registers.
// - fp32: the tensor cores take no full-precision fp32, so products are
//   FMAs. Two threads share a query row, each holding half of q and of
//   the accumulator in registers; K/V tiles of 32 rows sit in shared
//   memory.
// - The ragged edge is masked in the kernel: rows past S load as zeros,
//   keys past S get a score of -inf (they do not exist, so they add
//   nothing), and no output is written past S. The TPU version demanded
//   that S divide by the block sizes; this one does not.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): edl_flash_fwd launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;  // K4's mask value (flash_attention.py NEG_INF)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;  // query rows per block (16 per warp on the bf16 path)

// ---------------------------------------------------------------------------
// bf16 path: wmma
// ---------------------------------------------------------------------------

constexpr int kBlockK = 64;          // key rows per tile
constexpr int kLdS = kBlockK + 4;    // fp32 score row stride (pads bank conflicts)
constexpr int kLdP = kBlockK + 8;    // bf16 p row stride

template <int D>
struct WmmaLayout {
  static constexpr int kLdT = D + 8;  // bf16 q/k/v tile row stride
  static constexpr int kLdO = D + 4;  // fp32 accumulator row stride
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(__nv_bfloat16) * kBlockQ * kLdT;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kBlockK * kLdT;
  static constexpr size_t kS = kV + sizeof(__nv_bfloat16) * kBlockK * kLdT;
  static constexpr size_t kP = kS + sizeof(float) * kWarps * 16 * kLdS;
  static constexpr size_t kO = kP + sizeof(__nv_bfloat16) * kWarps * 16 * kLdP;
  static constexpr size_t kBytes = kO + sizeof(float) * kWarps * 16 * kLdO;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int seq, int causal,
                          float scale) {
  using L = WmmaLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* s_w = reinterpret_cast<float*>(smem + L::kS) + warp * 16 * kLdS;
  __nv_bfloat16* p_w =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kP) + warp * 16 * kLdP;
  float* o_w = reinterpret_cast<float*>(smem + L::kO) + warp * 16 * L::kLdO;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)bh * seq * D;

  load_tile_bf16<D>(qs, L::kLdT, q + base, q0, kBlockQ, seq);
  for (int i = lane; i < 16 * L::kLdO; i += 32) o_w[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      q_frag[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(q_frag[kk], qs + warp * 16 * L::kLdT + kk * 16,
                           L::kLdT);
  }

  // two lanes per row: lane pair (2r, 2r+1) owns row r of the warp's 16;
  // each takes the interleaved half `half` of the columns
  const int row = lane >> 1;
  const int half = lane & 1;
  const int q_pos = q0 + warp * 16 + row;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int n_tiles =
      causal ? q_last / kBlockK + 1 : (seq + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(ks, L::kLdT, k + base, k0, kBlockK, seq);
    load_tile_bf16<D>(vs, L::kLdT, v + base, k0, kBlockK, seq);
    __syncthreads();

    // s_w = q_w k^T (16 x kBlockK), fp32 accumulation
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            k_frag;
        wmma::load_matrix_sync(k_frag, ks + n * 16 * L::kLdT + kk * 16,
                               L::kLdT);
        wmma::mma_sync(s_frag, q_frag[kk], k_frag, s_frag);
      }
      wmma::store_matrix_sync(s_w + n * 16, s_frag, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's 32 scores of row `row`
    float sv[kBlockK / 2];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int col = 2 * j + half;
      const int k_pos = k0 + col;
      float s = s_w[row * kLdS + col] * scale;
      if (k_pos >= seq) {
        s = -INFINITY;  // past the ragged edge: no key here
      } else if (causal && k_pos > q_pos) {
        s = kNegInf;
      }
      sv[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float corr = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const float p = __expf(sv[j] - m_new);
      psum += p;
      p_w[row * kLdP + 2 * j + half] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o_w[row * L::kLdO + 2 * c + half] *= corr;
    __syncwarp();

    // o_w += p_w v (16 x D), fp32 accumulation
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::load_matrix_sync(o_frag, o_w + n * 16, L::kLdO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            p_frag;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            v_frag;
        wmma::load_matrix_sync(p_frag, p_w + kk * 16, kLdP);
        wmma::load_matrix_sync(v_frag, vs + kk * 16 * L::kLdT + n * 16,
                               L::kLdT);
        wmma::mma_sync(o_frag, p_frag, v_frag, o_frag);
      }
      wmma::store_matrix_sync(o_w + n * 16, o_frag, L::kLdO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (q_pos < seq) {
    const float denom = l > 0.f ? l : 1.f;
    __nv_bfloat16* out = o + base + (size_t)q_pos * D;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      const int col = 2 * c + half;
      out[col] = __float2bfloat16(o_w[row * L::kLdO + col] / denom);
    }
    if (half == 0) {
      lse[(size_t)bh * seq + q_pos] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 path: FMAs
// ---------------------------------------------------------------------------

constexpr int kTileF = 32;  // key rows per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int seq, int causal,
                         float scale) {
  __shared__ float ks[kTileF][D];
  __shared__ float vs[kTileF][D];

  // two threads per query row; thread `half` holds elements 2i + half
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int q_pos = q0 + row;
  const size_t base = (size_t)bh * seq * D;

  float qr[D / 2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    qr[i] = q_pos < seq ? q[base + (size_t)q_pos * D + 2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(q0 + kBlockQ, seq) - 1;
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

    float sv[kTileF];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) part = fmaf(qr[i], ks[j][2 * i + half], part);
      const float s = (part + __shfl_xor_sync(0xffffffffu, part, 1)) * scale;
      const int k_pos = k0 + j;
      sv[j] = k_pos >= seq ? -INFINITY
              : (causal && k_pos > q_pos) ? kNegInf
                                          : s;
      tile_max = fmaxf(tile_max, sv[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(p, vs[j][2 * i + half], acc[i]);
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (q_pos < seq) {
    const float denom = l > 0.f ? l : 1.f;
    float* out = o + base + (size_t)q_pos * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) out[2 * i + half] = acc[i] / denom;
    if (half == 0) {
      lse[(size_t)bh * seq + q_pos] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int seq, int causal, float scale,
                        cudaStream_t stream) {
  // above 48 KB: opt in, once per device (the attribute holds for the
  // current device only). Two threads racing here both set it: harmless.
  constexpr int kMaxDevices = 64;
  static bool smem_configured[kMaxDevices] = {};
  const size_t smem = WmmaLayout<D>::kBytes;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !smem_configured[device]) {
    err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) smem_configured[device] = true;
  }
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      seq, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, seq, head_dim) contiguous, bf16 (is_bf16 = 1) or fp32;
// lse: (bh, 1, seq) fp32. Returns a cudaError_t (0 = launched).
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int seq,
                             int head_dim, int is_bf16, int causal,
                             float scale, void* stream) {
  if (bh <= 0 || seq <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (is_bf16) {
    if (head_dim == 64) {
      err = launch_bf16<64>(q, k, v, o, lse_f, bh, seq, causal, scale, st);
    } else if (head_dim == 128) {
      err = launch_bf16<128>(q, k, v, o, lse_f, bh, seq, causal, scale, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    if (head_dim == 64) {
      err = launch_f32<64>(q, k, v, o, lse_f, bh, seq, causal, scale, st);
    } else if (head_dim == 128) {
      err = launch_f32<128>(q, k, v, o, lse_f, bh, seq, causal, scale, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)err;
}
