// Device-tier embedding kernels for Hopper, sm_90a: K1 gather-merge, K2
// insert rows, K3 scatter-apply.
//
// Replace the three Pallas kernels of elasticdl_tpu/ops/embedding_tier.py:
// - K1 edl_tier_gather      <- _pallas_gather (one grid step per row there):
//   out[i] = table[slots[i]] if slots[i] >= 0 else miss[i] (zeros when no
//   miss buffer is given: the eviction read and gather_rows).
// - K2 edl_tier_insert_rows <- every _pallas_set_rows call of
//   _pallas_insert_gather and its XLA step reset (embedding_tier.py:
//   239-248): for each staged slot s = slots[i] of a chunk, in ONE
//   launch, the weights' row s = rows[i] (zeros when no rows are given),
//   each optimizer slot buffer's row s = 0 and the int32 step count s =
//   0. The slot buffers and the steps may be null, so with all three null
//   it is the plain one-buffer set (set_rows).
// - K3 edl_tier_scatter_apply <- _pallas_scatter_apply: one sparse
//   optimizer step (sgd, momentum, nesterov, adagrad, adam) per gradient
//   row whose slot is a resident row, in place on the weights, the slot
//   buffers and the per-row step counts.
//
// Uniqueness contract (embedding_tier.py module docstring): slots are
// unique per launch except the scratch row (the table's last), which may
// repeat; its contents are garbage by contract. A slot at or past the
// table's end is never read or written: K1 treats it as a miss, K2 skips
// it. K3 on the card leaves the scratch row alone: a slot < 0 (a miss or
// padding) or at or past table_rows - 1 returns before touching any
// buffer. The reference and the plain version send misses to the scratch
// row, which nothing reads, so nothing that anyone reads differs.
//
// Bound at deepfm's deployment shapes (bench.py: 39 fields, batch 512, id
// capacity 8192, tier capacity 65536 + 1 scratch row, d = 8 for
// deepfm_emb and 1 for deepfm_linear, adam): every kernel moves bytes and
// does a handful of flops per byte, so memory bounds it. K1 on the
// combined buffer moves 8192 slots + 8192 read rows + 8192 written rows =
// 0.55 MB at d = 8, 0.16 us at 3.35 TB/s; K2 on a 512-row staging chunk
// reads the slots and rows and writes the weights, m, v and the step
// counts, 0.07 MB, 0.02 us; K3 (adam) reads 8192 slots and, for about
// 3060 hits, the gradient and the weights, m, v and step count, and
// writes the last four, 0.74 MB, 0.22 us.
//
// Design: a launch costs a few microseconds on its own, so at these sizes
// the launch, the chain of launches and the chain of dependent loads
// inside each, not the bytes, set the time. So:
// - K2 inserts a staging chunk into the whole table state in one launch
//   (one launch per buffer and a torch index put for the step counts
//   would be five kernels under adam).
// - K1, K2 and K3 give each row a group of lanes inside one warp, one lane
//   per 16-byte chunk of the row (float4, when d % 4 == 0 and every
//   pointer is 16-byte aligned), else per element; the group is the chunk
//   count rounded up to a power of two, at most 32 (spare lanes idle; past
//   32 chunks a lane loops). In K2 and K3 the group's first lane loads
//   the slot once and broadcasts it with __shfl_sync; every lane of the
//   warp reaches that shuffle before any returns. In K1 every lane loads
//   the slot itself (the warp's slots arrive in one transaction).
// - K1 issues a lane's slot and miss-chunk loads together: a miss row
//   never needs the slot, so it does not wait for it. A miss never reads
//   the table, and a hit never stores the miss value.
// - K3's first lane alone reads the row's step count, computes t = steps
//   + 1 and adam's two bias corrections once, broadcasts the corrections
//   and then stores t. Rows are unique, so no other thread touches that
//   count.
// - K3 issues a lane's loads ahead of its arithmetic: the gradient before
//   the slot has arrived, the weights and slot buffers while the first
//   lane reads the step count. Slots and gradients (and K2's rows) come
//   through the read-only path (__ldg).
// - A K3 miss leaves at once. Sent to the scratch row, as the reference
//   sends it, every miss of a step (about 5100 of 8192 slots at deepfm's
//   shapes) would read-modify-write one address: thousands of updates
//   serialised in L2, for a row that nothing reads.
// - All three size their blocks so that a launch of 8192 rows spreads
//   over about 128 blocks (128 threads at d 8, 64 at d 1) on the card's
//   132 SMs (K1 had blocks of 256 threads: 64 blocks at d 8).
// - Each staging chunk runs K1 (the victims' rows) -> K2 (the insert) ->
//   K1 (the combined buffer) on one stream, each waiting on the one
//   before. The wrapper (fused_insert_gather) launches the second and
//   third with programmatic dependent launch (launch(), pdl = 1): K1 and
//   K2 call launch_dependents() first thing, so the next kernel's blocks
//   start while this one's last blocks finish, and load the host-copied
//   slots, miss rows and staged rows before wait_for_previous_grid().
//   They read the tier state and store anything only after it: the table
//   is what K2 writes, and the caching allocator may hand a buffer an
//   earlier kernel still reads to the next output. The first kernel of a
//   chain launches without the attribute, so it waits, as any launch
//   does, for everything before it; what the host copied before it is
//   then visible to the rest of the chain. K1 reads the table at L2
//   (__ldcg), so no line an SM cached before the wait can be stale.
//   K3 follows the dense step's torch kernels and launches plainly.
//
// K3's arithmetic uses the round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, ...), which the compiler never contracts into an FMA, in the
// order of the plain version (embedding_tier.py: scatter_apply_reference),
// so every optimizer but adam matches it bit for bit; adam's powf(beta, t)
// may differ from the host's pow by an ulp.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc takes
// seconds): each function launches on the given stream, does not
// synchronise, and returns the launch's error or cudaGetLastError()
// (cudaErrorInvalidValue for arguments it refuses).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
// blocks of 64 to 256 threads, as many as fill the SMs
constexpr int kSms = 132;  // H100 SXM
constexpr int kMinThreads = 64;
constexpr int kMaxThreads = 256;

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

// Programmatic dependent launch (PDL). A kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it in the stream is still running, once every block of that one
// has called launch_dependents() or exited. wait_for_previous_grid()
// blocks until the previous grid has finished and its stores are visible;
// in a kernel launched without the attribute it returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// K1: gather-merge
// ---------------------------------------------------------------------------

// Thread i serves lane i % group of row i / group, as in K2 and K3. Every
// lane loads its row's slot itself (one transaction for the warp's rows)
// and its first miss chunk beside it, both before the dependency wait:
// they were written before the chain's first kernel started, so no
// kernel still running writes them. The table (K2 of the chain may still
// be writing it) is read, and out (the allocator may hand it a buffer an
// earlier kernel of the chain still reads) is written, only after it.
template <int VEC>
__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ slots,
                              const float* __restrict__ miss,
                              float* __restrict__ out, int n, int chunks,
                              int log2_group, int table_rows) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  launch_dependents();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = i >> log2_group;
  const int group = 1 << log2_group;
  const int lane = (int)(i & (group - 1));
  const bool live = row < n;
  const T* miss_row = reinterpret_cast<const T*>(miss) + row * chunks;
  int s = -1;
  T first = C::zero();
  if (live) {
    s = __ldg(slots + row);
    if (miss != nullptr && lane < chunks) first = __ldg(miss_row + lane);
  }
  wait_for_previous_grid();
  if (!live) return;
  const bool in_table = s >= 0 && s < table_rows;
  const T* table_row =
      reinterpret_cast<const T*>(table) + (long long)s * chunks;
  T* out_row = reinterpret_cast<T*>(out) + row * chunks;
  // a hit reads the table (at L2: __ldcg) and never stores the miss
  // value; a miss never reads the table
  for (int c = lane; c < chunks; c += group) {
    T v;
    if (in_table) {
      v = __ldcg(table_row + c);
    } else if (c == lane) {
      v = first;
    } else {
      v = miss != nullptr ? __ldg(miss_row + c) : C::zero();
    }
    out_row[c] = v;
  }
}

// ---------------------------------------------------------------------------
// K2: insert rows
// ---------------------------------------------------------------------------

// Thread i serves lane i % group of row i / group (group = 1 << log2_group,
// dividing 32, so a row's lanes share a warp). Threads past the last row
// still reach the slot broadcast, then leave.
template <int VEC>
__global__ void insert_rows_kernel(float* __restrict__ rows,
                                   float* __restrict__ slot0,
                                   float* __restrict__ slot1,
                                   int* __restrict__ steps,
                                   const int* __restrict__ slots,
                                   const float* __restrict__ src, int n,
                                   int chunks, int log2_group,
                                   int table_rows) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  launch_dependents();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = i >> log2_group;
  const int group = 1 << log2_group;
  const int lane = (int)(i & (group - 1));
  const bool live = row < n;
  const T* src_t = reinterpret_cast<const T*>(src);
  // the staged values do not depend on the slot: their load goes first
  T first = C::zero();
  if (live && src != nullptr && lane < chunks) {
    first = __ldg(src_t + row * chunks + lane);
  }
  int s = -1;
  if (live && lane == 0) s = __ldg(slots + row);
  s = __shfl_sync(kFullWarp, s, 0, group);
  // the slots and staged rows above are host copies made before the
  // chain; the table state is written only after the previous kernel
  wait_for_previous_grid();
  if (!live || s < 0 || s >= table_rows) return;
  if (lane == 0 && steps != nullptr) steps[s] = 0;
  const long long base = (long long)s * chunks;
  for (int c = lane; c < chunks; c += group) {
    T v = first;
    if (c != lane) v = src != nullptr ? __ldg(src_t + row * chunks + c)
                                      : C::zero();
    reinterpret_cast<T*>(rows)[base + c] = v;
    if (slot0 != nullptr) reinterpret_cast<T*>(slot0)[base + c] = C::zero();
    if (slot1 != nullptr) reinterpret_cast<T*>(slot1)[base + c] = C::zero();
  }
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

// Lanes as in insert_rows_kernel. The lanes of a hit row go on past the
// slot broadcast (``live``, from a ballot of the whole warp); a miss's
// lanes leave there, so its bias-correction shuffle names only hit rows.
template <int OPT, int VEC>
__global__ void scatter_apply_kernel(const float* __restrict__ grads,
                                     const int* __restrict__ slots,
                                     float* __restrict__ rows,
                                     float* __restrict__ slot0,
                                     float* __restrict__ slot1,
                                     int* __restrict__ steps, int n,
                                     int chunks, int log2_group,
                                     int table_rows, Hyper h) {
  using C = Chunk<VEC>;
  using T = typename C::T;
  constexpr bool kUsesM = OPT != kSgd;  // slot0: momentum, accumulator, m
  constexpr bool kUsesV = OPT == kAdam;  // slot1: adam's v
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long row = i >> log2_group;
  const int group = 1 << log2_group;
  const int lane = (int)(i & (group - 1));
  const T* g_row = reinterpret_cast<const T*>(grads) + row * chunks;
  // the gradient does not depend on the slot: its load goes first
  T g0 = C::zero();
  if (row < n && lane < chunks) g0 = __ldg(g_row + lane);
  int s = -1;
  if (row < n && lane == 0) s = __ldg(slots + row);
  s = __shfl_sync(kFullWarp, s, 0, group);
  const bool hit = s >= 0 && s < table_rows - 1;
  const unsigned live = __ballot_sync(kFullWarp, row < n && hit);
  if (row >= n || !hit) return;
  T* w_row = reinterpret_cast<T*>(rows) + (long long)s * chunks;
  T* m_row =
      kUsesM ? reinterpret_cast<T*>(slot0) + (long long)s * chunks : nullptr;
  T* v_row =
      kUsesV ? reinterpret_cast<T*>(slot1) + (long long)s * chunks : nullptr;
  // this lane's first chunk, loaded while the first lane reads the count
  T w0 = C::zero(), m0 = C::zero(), v0 = C::zero();
  if (lane < chunks) {
    w0 = w_row[lane];
    if (kUsesM) m0 = m_row[lane];
    if (kUsesV) v0 = v_row[lane];
  }
  // the first lane owns the row's step count (see the note at the top)
  int t = 0;
  float c1 = 1.0f, c2 = 1.0f;
  if (lane == 0) {
    t = steps[s] + 1;
    if (OPT == kAdam) {
      const float tf = (float)t;
      c1 = __fsub_rn(1.0f, powf(h.beta1, tf));
      c2 = __fsub_rn(1.0f, powf(h.beta2, tf));
    }
  }
  float bc1 = 1.0f, bc2 = 1.0f;
  if (OPT == kAdam) {
    bc1 = __shfl_sync(live, c1, 0, group);
    bc2 = __shfl_sync(live, c2, 0, group);
  }
  if (lane == 0) steps[s] = t;
  for (int c = lane; c < chunks; c += group) {
    T g = g0, w = w0, m = m0, v = v0;
    if (c != lane) {
      g = __ldg(g_row + c);
      w = w_row[c];
      if (kUsesM) m = m_row[c];
      if (kUsesV) v = v_row[c];
    }
    apply_chunk<OPT>(g, w, m, v, bc1, bc2, h);
    w_row[c] = w;
    if (kUsesM) m_row[c] = m;
    if (kUsesV) v_row[c] = v;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// log2 of a row's lane group: its chunk count rounded up to a power of
// two, at most a warp
int group_log2(int chunks) {
  int log2 = 0;
  while (log2 < 5 && (1 << log2) < chunks) ++log2;
  return log2;
}

struct RowGrid {
  unsigned int blocks, threads;
};

// n rows of 1 << log2_group lanes each, in whole warps
RowGrid row_grid(int n, int log2_group) {
  const long long items = (long long)n << log2_group;
  long long threads = (items + kSms - 1) / kSms;
  threads = (threads + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return {(unsigned int)((items + threads - 1) / threads),
          (unsigned int)threads};
}

// Launch kernel on (g, stream); with pdl, under programmatic stream
// serialization: it may start before the previous kernel in the stream
// ends, so its loads before wait_for_previous_grid() must not read what
// that kernel writes.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), RowGrid g, int pdl,
                   cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(g.blocks);
  config.blockDim = dim3(g.threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <int OPT>
cudaError_t launch_apply(const float* grads, const int* slots, float* rows,
                         float* slot0, float* slot1, int* steps, int n,
                         int dim, int table_rows, const Hyper& h,
                         cudaStream_t stream) {
  const bool vec = dim % 4 == 0 && aligned16(grads) && aligned16(rows) &&
                   aligned16(slot0) && aligned16(slot1);
  const int chunks = vec ? dim / 4 : dim;
  const int lg = group_log2(chunks);
  const RowGrid g = row_grid(n, lg);
  if (vec) {
    scatter_apply_kernel<OPT, 4><<<g.blocks, g.threads, 0, stream>>>(
        grads, slots, rows, slot0, slot1, steps, n, chunks, lg, table_rows,
        h);
  } else {
    scatter_apply_kernel<OPT, 1><<<g.blocks, g.threads, 0, stream>>>(
        grads, slots, rows, slot0, slot1, steps, n, chunks, lg, table_rows,
        h);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: out [n, dim] = table [table_rows, dim] at slots [n], or miss [n, dim]
// (zeros when miss is null) where the slot is negative. pdl != 0 launches
// it as the dependent of the previous kernel in the stream (see launch):
// slots and miss must then be written before that kernel started.
int edl_tier_gather(const void* table, const void* slots, const void* miss,
                    void* out, int n, int dim, int table_rows, int pdl,
                    void* stream) {
  if (n <= 0 || dim <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0 && aligned16(table) && aligned16(miss) &&
                   aligned16(out);
  const int chunks = vec ? dim / 4 : dim;
  const int lg = group_log2(chunks);
  const RowGrid g = row_grid(n, lg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* sl = static_cast<const int*>(slots);
  const float* mi = static_cast<const float*>(miss);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      vec ? launch(gather_kernel<4>, g, pdl, s, t, sl, mi, o, n, chunks, lg,
                   table_rows)
          : launch(gather_kernel<1>, g, pdl, s, t, sl, mi, o, n, chunks, lg,
                   table_rows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K2: at slots [n], in place: rows [table_rows, dim] = ins_rows [n, dim]
// (zeros when ins_rows is null), slot0 and slot1 [table_rows, dim] = 0 and
// steps [table_rows] (int32) = 0; slot0, slot1 and steps may each be null
// (not written). pdl as for K1: slots and ins_rows written before the
// previous kernel started.
int edl_tier_insert_rows(void* rows, void* slot0, void* slot1, void* steps,
                         const void* slots, const void* ins_rows, int n,
                         int dim, int table_rows, int pdl, void* stream) {
  if (n <= 0 || dim <= 0 || table_rows <= 0) return cudaErrorInvalidValue;
  const bool vec = dim % 4 == 0 && aligned16(rows) && aligned16(slot0) &&
                   aligned16(slot1) && aligned16(ins_rows);
  const int chunks = vec ? dim / 4 : dim;
  const int lg = group_log2(chunks);
  const RowGrid g = row_grid(n, lg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(rows);
  float* m = static_cast<float*>(slot0);
  float* v = static_cast<float*>(slot1);
  int* st = static_cast<int*>(steps);
  const int* sl = static_cast<const int*>(slots);
  const float* src = static_cast<const float*>(ins_rows);
  const cudaError_t err =
      vec ? launch(insert_rows_kernel<4>, g, pdl, s, w, m, v, st, sl, src, n,
                   chunks, lg, table_rows)
          : launch(insert_rows_kernel<1>, g, pdl, s, w, m, v, st, sl, src, n,
                   chunks, lg, table_rows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K3: one optimizer step of grads [n, dim] into rows / slot0 / slot1
// [table_rows, dim] and steps [table_rows] (int32) at slots [n], in place;
// a slot < 0 or >= table_rows - 1 (the scratch row) is skipped.
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
