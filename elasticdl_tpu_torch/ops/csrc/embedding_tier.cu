// Device-tier embedding kernels for Hopper, sm_90a: K1 gather-merge, K2
// set rows, K3 scatter-apply.
//
// Replace the three Pallas kernels of elasticdl_tpu/ops/embedding_tier.py:
// - K1 edl_tier_gather    <- _pallas_gather (one grid step per row there):
//   out[i] = table[slots[i]] if slots[i] >= 0 else miss[i] (zeros when no
//   miss buffer is given: the eviction read and gather_rows).
// - K2 edl_tier_set_rows  <- _pallas_set_rows: table[slots[i]] = rows[i]
//   in place (zeros when no rows are given: the optimizer-slot reset of a
//   staged promotion).
// - K3 edl_tier_scatter_apply <- _pallas_scatter_apply: one sparse
//   optimizer step (sgd, momentum, nesterov, adagrad, adam) per gradient
//   row, in place on the weights, the slot buffers and the per-row step
//   counts, at target = slots[i] >= 0 ? slots[i] : scratch (the table's
//   last row).
//
// Uniqueness contract (embedding_tier.py module docstring): slots are
// unique per launch except the scratch row, which may repeat. Its
// contents are garbage by contract, so racing writes to it are benign.
// A slot at or past the table's end is never read or written: K1 treats
// it as a miss, K2 skips it, K3 sends it to the scratch row.
//
// Bound at deepfm's deployment shapes (bench.py: 39 fields, batch 512, id
// capacity 8192, tier capacity 65536 + 1 scratch row, d = 8 for
// deepfm_emb and 1 for deepfm_linear, adam): every kernel moves bytes and
// does a handful of flops per byte, so memory bounds it. K1 on the
// combined buffer moves 8192 slots + 8192 read rows + 8192 written rows =
// 0.55 MB at d = 8, 0.16 us at 3.35 TB/s; K2 on a 2048-row staging chunk
// 0.14 MB, 0.04 us; K3 (adam) reads the gradient and reads and writes
// weights, m, v and the step count of 8192 rows, 1.9 MB, 0.56 us. A launch
// costs a few microseconds on its own, so at these sizes the launch, not
// the bytes, sets the time.
//
// Design (a first, right kernel): the rows are narrow, so no block or
// warp is spent on one row. K1 and K2 map one thread to one (row, 16-byte
// chunk) pair with float4 loads when d % 4 == 0 and every pointer is
// 16-byte aligned, else to one (row, element) pair; neighbouring threads
// touch neighbouring chunks of a row, then the next row. K3 maps one
// thread to one row and loops over the row's chunks: that thread alone
// reads the row's step count, increments it, uses it for the bias
// correction of every element of the row and writes it back. Rows are
// unique (scratch aside), so for any d no other thread reads or writes
// that count, and nothing ever sees it half-updated; the scratch row's
// count is garbage like its values. K3's arithmetic uses the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, ...), which the
// compiler never contracts into an FMA, in the order of the plain version
// (embedding_tier.py: scatter_apply_reference), so every optimizer but
// adam matches it bit for bit; adam's powf(beta, t) may differ from the
// host's pow by an ulp.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments it refuses).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Opt { kSgd = 0, kMomentum = 1, kNesterov = 2, kAdagrad = 3, kAdam = 4 };

struct Hyper {
  float lr, momentum, beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

template <int VEC>
struct Chunk;
template <>
struct Chunk<1> {
  using T = float;
  static __device__ T zero() { return 0.0f; }
};
template <>
struct Chunk<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

// ---------------------------------------------------------------------------
// K1: gather-merge
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ slots,
                              const float* __restrict__ miss,
                              float* __restrict__ out, long long items,
                              int chunks, int table_rows) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= items) return;
  const long long row = i / chunks;
  const int c = (int)(i - row * chunks);
  const int s = slots[row];
  T v;
  // only the value returned is read: a miss never touches the table
  if (s >= 0 && s < table_rows) {
    v = reinterpret_cast<const T*>(table)[(long long)s * chunks + c];
  } else if (miss != nullptr) {
    v = reinterpret_cast<const T*>(miss)[i];
  } else {
    v = C::zero();
  }
  reinterpret_cast<T*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// K2: set rows
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void set_rows_kernel(float* __restrict__ table,
                                const int* __restrict__ slots,
                                const float* __restrict__ rows,
                                long long items, int chunks, int table_rows) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= items) return;
  const long long row = i / chunks;
  const int c = (int)(i - row * chunks);
  const int s = slots[row];
  if (s < 0 || s >= table_rows) return;
  const T v = rows != nullptr ? reinterpret_cast<const T*>(rows)[i] : C::zero();
  reinterpret_cast<T*>(table)[(long long)s * chunks + c] = v;
}

// ---------------------------------------------------------------------------
// K3: scatter-apply
// ---------------------------------------------------------------------------

// One element's update, in the plain version's order of operations; each
// operation rounds once (no FMA contraction).
template <int OPT>
__device__ __forceinline__ void apply_one(float g, float& w, float& m,
                                          float& v, float bc1, float bc2,
                                          const Hyper& h) {
  if (OPT == kSgd) {
    w = __fsub_rn(w, __fmul_rn(h.lr, g));
  } else if (OPT == kMomentum || OPT == kNesterov) {
    m = __fadd_rn(__fmul_rn(h.momentum, m), g);
    const float dir =
        OPT == kNesterov ? __fadd_rn(g, __fmul_rn(h.momentum, m)) : m;
    w = __fsub_rn(w, __fmul_rn(h.lr, dir));
  } else if (OPT == kAdagrad) {
    m = __fadd_rn(m, __fmul_rn(g, g));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, g),
                               __fadd_rn(__fsqrt_rn(m), h.eps)));
  } else {  // adam
    m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.one_minus_beta1, g));
    v = __fadd_rn(__fmul_rn(h.beta2, v),
                  __fmul_rn(__fmul_rn(h.one_minus_beta2, g), g));
    const float mhat = __fdiv_rn(m, bc1);
    const float vhat = __fdiv_rn(v, bc2);
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, mhat),
                               __fadd_rn(__fsqrt_rn(vhat), h.eps)));
  }
}

template <int OPT>
__device__ __forceinline__ void apply_chunk(float g, float& w, float& m,
                                            float& v, float bc1, float bc2,
                                            const Hyper& h) {
  apply_one<OPT>(g, w, m, v, bc1, bc2, h);
}

template <int OPT>
__device__ __forceinline__ void apply_chunk(float4 g, float4& w, float4& m,
                                            float4& v, float bc1, float bc2,
                                            const Hyper& h) {
  apply_one<OPT>(g.x, w.x, m.x, v.x, bc1, bc2, h);
  apply_one<OPT>(g.y, w.y, m.y, v.y, bc1, bc2, h);
  apply_one<OPT>(g.z, w.z, m.z, v.z, bc1, bc2, h);
  apply_one<OPT>(g.w, w.w, m.w, v.w, bc1, bc2, h);
}

template <int OPT, int VEC>
__global__ void scatter_apply_kernel(const float* __restrict__ grads,
                                     const int* __restrict__ slots,
                                     float* __restrict__ rows,
                                     float* __restrict__ slot0,
                                     float* __restrict__ slot1,
                                     int* __restrict__ steps, int n,
                                     int chunks, int table_rows, Hyper h) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  constexpr bool kUsesM = OPT != kSgd;  // slot0: momentum, accumulator, m
  constexpr bool kUsesV = OPT == kAdam;  // slot1: adam's v
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int s = slots[r];
  const int target = (s >= 0 && s < table_rows) ? s : table_rows - 1;
  // this thread owns the target row: the only reader and writer of its
  // step count (see the note at the top of the file)
  const int t = steps[target] + 1;
  float bc1 = 1.0f, bc2 = 1.0f;
  if (OPT == kAdam) {
    const float tf = (float)t;
    bc1 = __fsub_rn(1.0f, powf(h.beta1, tf));
    bc2 = __fsub_rn(1.0f, powf(h.beta2, tf));
  }
  const T* g_row = reinterpret_cast<const T*>(grads) + (long long)r * chunks;
  T* w_row = reinterpret_cast<T*>(rows) + (long long)target * chunks;
  T* m_row = kUsesM
                 ? reinterpret_cast<T*>(slot0) + (long long)target * chunks
                 : nullptr;
  T* v_row = kUsesV
                 ? reinterpret_cast<T*>(slot1) + (long long)target * chunks
                 : nullptr;
  for (int c = 0; c < chunks; ++c) {
    const T g = g_row[c];
    T w = w_row[c];
    T m = kUsesM ? m_row[c] : C::zero();
    T v = kUsesV ? v_row[c] : C::zero();
    apply_chunk<OPT>(g, w, m, v, bc1, bc2, h);
    w_row[c] = w;
    if (kUsesM) m_row[c] = m;
    if (kUsesV) v_row[c] = v;
  }
  steps[target] = t;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + kThreads - 1) / kThreads);
}

template <int OPT>
cudaError_t launch_apply(const float* grads, const int* slots, float* rows,
                         float* slot0, float* slot1, int* steps, int n,
                         int dim, int table_rows, const Hyper& h,
                         cudaStream_t stream) {
  const bool vec = dim % 4 == 0 && aligned16(grads) && aligned16(rows) &&
                   aligned16(slot0) && aligned16(slot1);
  if (vec) {
    scatter_apply_kernel<OPT, 4><<<blocks_for(n), kThreads, 0, stream>>>(
        grads, slots, rows, slot0, slot1, steps, n, dim / 4, table_rows, h);
  } else {
    scatter_apply_kernel<OPT, 1><<<blocks_for(n), kThreads, 0, stream>>>(
        grads, slots, rows, slot0, slot1, steps, n, dim, table_rows, h);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: out [n, dim] = table [table_rows, dim] at slots [n], or miss [n, dim]
// (zeros when miss is null) where the slot is negative.
int edl_tier_gather(const void* table, const void* slots, const void* miss,
                    void* out, int n, int dim, int table_rows, void* stream) {
  if (n <= 0 || dim <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0 && aligned16(table) && aligned16(miss) &&
                   aligned16(out);
  const int chunks = vec ? dim / 4 : dim;
  const long long items = (long long)n * chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* sl = static_cast<const int*>(slots);
  const float* mi = static_cast<const float*>(miss);
  float* o = static_cast<float*>(out);
  if (vec) {
    gather_kernel<4><<<blocks_for(items), kThreads, 0, s>>>(
        t, sl, mi, o, items, chunks, table_rows);
  } else {
    gather_kernel<1><<<blocks_for(items), kThreads, 0, s>>>(
        t, sl, mi, o, items, chunks, table_rows);
  }
  return (int)cudaGetLastError();
}

// K2: table [table_rows, dim] at slots [n] = rows [n, dim] (zeros when rows
// is null), in place.
int edl_tier_set_rows(void* table, const void* slots, const void* rows,
                      int n, int dim, int table_rows, void* stream) {
  if (n <= 0 || dim <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0 && aligned16(table) && aligned16(rows);
  const int chunks = vec ? dim / 4 : dim;
  const long long items = (long long)n * chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(table);
  const int* sl = static_cast<const int*>(slots);
  const float* r = static_cast<const float*>(rows);
  if (vec) {
    set_rows_kernel<4><<<blocks_for(items), kThreads, 0, s>>>(
        t, sl, r, items, chunks, table_rows);
  } else {
    set_rows_kernel<1><<<blocks_for(items), kThreads, 0, s>>>(
        t, sl, r, items, chunks, table_rows);
  }
  return (int)cudaGetLastError();
}

// K3: one optimizer step of grads [n, dim] into rows / slot0 / slot1
// [table_rows, dim] and steps [table_rows] (int32) at slots [n], in place.
// opt: 0 sgd, 1 momentum, 2 nesterov, 3 adagrad (slot0), 4 adam (slot0 =
// m, slot1 = v). one_minus_beta* are 1 - beta* rounded once to fp32 on the
// host, as the plain version's (1.0 - beta) * g takes them.
int edl_tier_scatter_apply(const void* grads, const void* slots, void* rows,
                           void* slot0, void* slot1, void* steps, int n,
                           int dim, int table_rows, int opt, float lr,
                           float momentum, float beta1, float one_minus_beta1,
                           float beta2, float one_minus_beta2, float eps,
                           void* stream) {
  if (n <= 0 || dim <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
  if (opt != kSgd && slot0 == nullptr) return cudaErrorInvalidValue;
  if (opt == kAdam && slot1 == nullptr) return cudaErrorInvalidValue;
  const Hyper h{lr, momentum, beta1, one_minus_beta1, beta2, one_minus_beta2,
                eps};
  const float* g = static_cast<const float*>(grads);
  const int* sl = static_cast<const int*>(slots);
  float* w = static_cast<float*>(rows);
  float* m = static_cast<float*>(slot0);
  float* v = static_cast<float*>(slot1);
  int* st = static_cast<int*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (opt) {
    case kSgd:
      return (int)launch_apply<kSgd>(g, sl, w, m, v, st, n, dim, table_rows,
                                     h, s);
    case kMomentum:
      return (int)launch_apply<kMomentum>(g, sl, w, m, v, st, n, dim,
                                          table_rows, h, s);
    case kNesterov:
      return (int)launch_apply<kNesterov>(g, sl, w, m, v, st, n, dim,
                                          table_rows, h, s);
    case kAdagrad:
      return (int)launch_apply<kAdagrad>(g, sl, w, m, v, st, n, dim,
                                         table_rows, h, s);
    case kAdam:
      return (int)launch_apply<kAdam>(g, sl, w, m, v, st, n, dim, table_rows,
                                      h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
