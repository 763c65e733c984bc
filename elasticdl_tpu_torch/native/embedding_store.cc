// Host-side sparse embedding store with fused optimizer kernels.
//
// Host-side equivalent of the reference's Go parameter server runtime:
//   - lazy hash-map embedding tables (go/pkg/common/embedding_table.go)
//   - sparse SGD/Momentum/Adagrad/Adam kernels (go/pkg/kernel/capi/
//     kernel_api.cc) — here applied row-wise in-place, slots stored
//     inline with the row so one cache line serves weight+slots
//   - id-sharded binary checkpoints (go/pkg/ps/checkpoint.go)
//
// The dense path of the reference PS is intentionally absent: dense
// parameters live on the device. Only the embedding-id axis —
// unbounded and hash-addressed — stays host-side.
//
// Exposed as a C API for ctypes (no pybind11 in this environment).
// ctypes releases the GIL for the duration of every call, so a whole
// deserialize+dedup+apply (edl_store_apply_blob) or a batched
// lookup/export runs GIL-free — that, not micro-optimization, is why
// the wire fast paths live behind single C entry points.
//
// FLOAT SEMANTICS: every kernel here is BIT-IDENTICAL to
// NumpyEmbeddingStore under numpy 2 / NEP 50. That pins three rules:
//   1. optimizer hyperparameters are carried as double (the python
//      float the twin stores) and rounded to float exactly where
//      numpy's weak-scalar promotion rounds them — e.g. Adam's
//      (1 - beta1) is float(1.0 - beta1_double), NOT 1.0f - beta1f;
//   2. elementwise math stays in float with numpy's operator order
//      (the Makefile passes -ffp-contract=off so gcc cannot fuse
//      a*b+c into fma and change the rounding);
//   3. bias corrections use libm pow on doubles, the same call
//      CPython's float.__pow__ makes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

enum class OptType { kSGD = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3 };

// Wire payload dtypes the blob entry points understand. Values match
// BLOB_DTYPE_CODES in the reference's ps/embedding_store.py.
enum WireDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

inline float bf16_to_f32(uint16_t h) {
  uint32_t u = static_cast<uint32_t>(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// Round-to-nearest-even f32 -> bf16, matching ml_dtypes/Eigen
// (numpy's astype(bfloat16)): NaN keeps sign + a set mantissa bit.
inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    return static_cast<uint16_t>((u >> 16) | 0x0040u);
  }
  const uint32_t bias = 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>((u + bias) >> 16);
}

inline float f16_to_f32(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t man = h & 0x3ffu;
  uint32_t u;
  if (exp == 0) {
    if (man == 0) {
      u = sign;  // +-0
    } else {
      // subnormal half: renormalize into the f32 exponent range
      int shift = 0;
      while (!(man & 0x400u)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3ffu;
      // man * 2^-24 normalized: 1.f * 2^(-14 - shift) -> biased 113-shift
      u = sign | (static_cast<uint32_t>(113 - shift) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    u = sign | 0x7f800000u | (man << 13);  // inf / nan
  } else {
    u = sign | ((exp + 112u) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// Round-to-nearest-even f32 -> f16 (numpy npy_half semantics),
// including subnormal results and overflow-to-inf.
inline uint16_t f32_to_f16(float ff) {
  uint32_t f;
  std::memcpy(&f, &ff, 4);
  const uint32_t sign = f & 0x80000000u;
  f ^= sign;
  uint16_t out;
  if (f >= ((127u + 16u) << 23)) {  // overflow, inf, nan
    out = (f > (255u << 23)) ? 0x7e00u : 0x7c00u;
  } else if (f < (113u << 23)) {
    // subnormal f16 result: the "denorm magic" add performs the
    // shift-and-round in float hardware (Giesen's rtne construction)
    const uint32_t denorm_magic = ((127u - 15u) + (23u - 10u) + 1u) << 23;
    float tmp;
    std::memcpy(&tmp, &f, 4);
    float magic;
    std::memcpy(&magic, &denorm_magic, 4);
    tmp += magic;
    uint32_t t;
    std::memcpy(&t, &tmp, 4);
    out = static_cast<uint16_t>(t - denorm_magic);
  } else {
    const uint32_t mant_odd = (f >> 13) & 1u;
    f += (static_cast<uint32_t>(15 - 127) << 23) + 0xfffu;
    f += mant_odd;
    out = static_cast<uint16_t>(f >> 13);
  }
  return static_cast<uint16_t>(out | (sign >> 16));
}

inline int wire_itemsize(int dtype) {
  switch (dtype) {
    case kF32: return 4;
    case kBF16: return 2;
    case kF16: return 2;
  }
  return -1;
}

// Decode one wire row into fp32 (upcast is exact for bf16/f16).
inline void decode_row(const uint8_t* src, int dtype, int64_t dim,
                       float* dst) {
  switch (dtype) {
    case kF32:
      std::memcpy(dst, src, sizeof(float) * dim);
      break;
    case kBF16: {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
      for (int64_t d = 0; d < dim; ++d) dst[d] = bf16_to_f32(h[d]);
      break;
    }
    case kF16: {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
      for (int64_t d = 0; d < dim; ++d) dst[d] = f16_to_f32(h[d]);
      break;
    }
  }
}

// ---------------------------------------------------------------------
// numpy pairwise summation over rows, bit-for-bit. np.add.reduceat's
// segment reduce is NOT a sequential left fold: it seeds the output
// with row 0, then reduces rows 1..n-1 with numpy's blocked pairwise
// algorithm (loops_utils.h pairwise_sum: < 8 rows sequential from
// 0.0, <= 128 rows eight running accumulators combined as
// ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), larger split in half rounded
// down to a multiple of 8). The dedup fast path must reproduce that
// exact association or fp32 segment sums drift by an ulp and the
// parity suite (tests/test_native_parity.py) catches it.
void pairwise_sum_rows(const float* a, int64_t n, int64_t dim,
                       float* out) {
  if (n <= 0) {
    std::memset(out, 0, sizeof(float) * dim);
    return;
  }
  if (n < 8) {
    for (int64_t d = 0; d < dim; ++d) {
      float res = 0.0f;
      for (int64_t i = 0; i < n; ++i) res += a[i * dim + d];
      out[d] = res;
    }
    return;
  }
  if (n <= 128) {
    std::vector<float> r(8 * dim);
    std::memcpy(r.data(), a, sizeof(float) * 8 * dim);
    int64_t i = 8;
    for (; i + 8 <= n; i += 8) {
      for (int j = 0; j < 8; ++j) {
        float* rj = r.data() + j * dim;
        const float* aj = a + (i + j) * dim;
        for (int64_t d = 0; d < dim; ++d) rj[d] += aj[d];
      }
    }
    for (int64_t d = 0; d < dim; ++d) {
      out[d] = ((r[0 * dim + d] + r[1 * dim + d]) +
                (r[2 * dim + d] + r[3 * dim + d])) +
               ((r[4 * dim + d] + r[5 * dim + d]) +
                (r[6 * dim + d] + r[7 * dim + d]));
    }
    for (; i < n; ++i) {
      const float* ai = a + i * dim;
      for (int64_t d = 0; d < dim; ++d) out[d] += ai[d];
    }
    return;
  }
  int64_t h = n / 2;
  h -= h % 8;
  std::vector<float> right(dim);
  pairwise_sum_rows(a, h, dim, out);
  pairwise_sum_rows(a + h * dim, n - h, dim, right.data());
  for (int64_t d = 0; d < dim; ++d) out[d] += right[d];
}

// reduceat segment semantics: out = rows[0] + pairwise_sum(rows[1:]).
void reduceat_segment(const float* rows, int64_t n, int64_t dim,
                      float* out) {
  if (n == 1) {
    std::memcpy(out, rows, sizeof(float) * dim);
    return;
  }
  std::vector<float> rest(dim);
  pairwise_sum_rows(rows + dim, n - 1, dim, rest.data());
  for (int64_t d = 0; d < dim; ++d) out[d] = rows[d] + rest[d];
}

// Row initializers (reference go/pkg/common/initializer.go:25-155:
// Zero/Constant/Uniform/Normal/TruncatedNormal). kConstant covers Zero
// via param=0.
enum class InitKind {
  kUniform = 0,         // U(-param, param)
  kConstant = 1,        // fill(param)
  kNormal = 2,          // N(0, param^2)
  kTruncatedNormal = 3  // N(0, param^2) resampled into [-2p, 2p]
};

struct OptConfig {
  OptType type = OptType::kSGD;
  // doubles: the exact python floats NumpyEmbeddingStore holds —
  // rounded to f32 only where numpy's weak-scalar promotion rounds
  double lr = 0.01;
  double momentum = 0.9;
  double beta1 = 0.9;
  double beta2 = 0.999;
  double epsilon = 1e-8;
  // variants (reference go/pkg/ps/optimizer.go supports
  // Momentum+nesterov and Adam+amsgrad)
  bool nesterov = false;
  bool amsgrad = false;
  int slots() const {
    switch (type) {
      case OptType::kSGD: return 0;
      case OptType::kMomentum: return 1;
      case OptType::kAdagrad: return 1;
      case OptType::kAdam: return amsgrad ? 3 : 2;
    }
    return 0;
  }
};

struct Table {
  std::string name;
  int64_t dim = 0;
  float init_scale = 0.05f;
  InitKind init_kind = InitKind::kUniform;
  int slots = 0;
  // row layout: [weight(dim) | slot0(dim) | slot1(dim)]
  std::unordered_map<int64_t, std::unique_ptr<float[]>> rows;
  // Adam per-row step counts for bias correction.
  std::unordered_map<int64_t, int64_t> row_steps;
  // Incremental-checkpoint bookkeeping, guarded by mu like
  // the rows themselves: dirty_ids = resident rows mutated (or first
  // materialized) since the last dirty export; dead_ids = ids dropped
  // since then, replayed as deletes by the delta restore so an
  // evicted row cannot resurrect. Invariants: dirty_ids is a subset
  // of the resident ids, dead_ids is disjoint from them — a drop
  // moves an id dirty->dead, a re-materialization moves it back.
  std::unordered_set<int64_t> dirty_ids;
  std::unordered_set<int64_t> dead_ids;
  // Per-table RNG: only touched under this table's unique lock, so
  // concurrent lookups on different tables never race on RNG state.
  std::mt19937 rng;
  mutable std::shared_mutex mu;

  float* get_or_init(int64_t id) {
    std::mt19937* rng = &this->rng;
    auto it = rows.find(id);
    if (it != rows.end()) return it->second.get();
    // a lazy init is a state change: a full save would carry the drawn
    // row, so the delta chain must too (the restored twin's RNG stream
    // is at a different position — absence would not reproduce it)
    dirty_ids.insert(id);
    dead_ids.erase(id);
    auto row = std::make_unique<float[]>(dim * (1 + slots));
    switch (init_kind) {
      case InitKind::kUniform: {
        std::uniform_real_distribution<float> dist(-init_scale, init_scale);
        for (int64_t d = 0; d < dim; ++d) row[d] = dist(*rng);
        break;
      }
      case InitKind::kConstant: {
        for (int64_t d = 0; d < dim; ++d) row[d] = init_scale;
        break;
      }
      case InitKind::kNormal: {
        if (init_scale <= 0.0f) break;  // stddev<=0: zeros (std UB guard)
        std::normal_distribution<float> dist(0.0f, init_scale);
        for (int64_t d = 0; d < dim; ++d) row[d] = dist(*rng);
        break;
      }
      case InitKind::kTruncatedNormal: {
        if (init_scale <= 0.0f) break;
        std::normal_distribution<float> dist(0.0f, init_scale);
        const float bound = 2.0f * init_scale;
        for (int64_t d = 0; d < dim; ++d) {
          float x = dist(*rng);
          while (x < -bound || x > bound) x = dist(*rng);
          row[d] = x;
        }
        break;
      }
    }
    std::memset(row.get() + dim, 0, sizeof(float) * dim * slots);
    float* ptr = row.get();
    rows.emplace(id, std::move(row));
    return ptr;
  }
};

struct Store {
  OptConfig opt;
  std::unordered_map<std::string, std::unique_ptr<Table>> tables;
  uint64_t seed = 0;
  std::mutex tables_mu;
  std::atomic<int64_t> version{0};

  Table* find(const char* name) {
    std::lock_guard<std::mutex> lock(tables_mu);
    auto it = tables.find(name);
    return it == tables.end() ? nullptr : it->second.get();
  }
};

// ``lr`` arrives as DOUBLE (opt.lr * lr_scale computed in double by
// the caller) and rounds to f32 once here — numpy computes the same
// product in python floats and rounds it at the weak-scalar op.
void apply_row(const OptConfig& opt, float* row, const float* grad,
               int64_t dim, double lr, int64_t step) {
  float* w = row;
  const float lrf = static_cast<float>(lr);
  switch (opt.type) {
    case OptType::kSGD: {
      for (int64_t d = 0; d < dim; ++d) w[d] -= lrf * grad[d];
      break;
    }
    case OptType::kMomentum: {
      float* vel = row + dim;
      const float mu = static_cast<float>(opt.momentum);
      if (opt.nesterov) {
        // lookahead step: w -= lr * (g + mu * vel_new)
        for (int64_t d = 0; d < dim; ++d) {
          vel[d] = mu * vel[d] + grad[d];
          w[d] -= lrf * (grad[d] + mu * vel[d]);
        }
      } else {
        for (int64_t d = 0; d < dim; ++d) {
          vel[d] = mu * vel[d] + grad[d];
          w[d] -= lrf * vel[d];
        }
      }
      break;
    }
    case OptType::kAdagrad: {
      float* acc = row + dim;
      const float eps = static_cast<float>(opt.epsilon);
      for (int64_t d = 0; d < dim; ++d) {
        acc[d] += grad[d] * grad[d];
        w[d] -= lrf * grad[d] / (std::sqrt(acc[d]) + eps);
      }
      break;
    }
    case OptType::kAdam: {
      float* m = row + dim;
      float* v = row + 2 * dim;
      float* vmax = opt.amsgrad ? row + 3 * dim : nullptr;
      const float b1 = static_cast<float>(opt.beta1);
      const float b2 = static_cast<float>(opt.beta2);
      // numpy rounds (1 - beta1) from the DOUBLE, which is not
      // 1.0f - b1 (e.g. beta1=0.9: f32(0.1) != 1.0f - 0.9f)
      const float omb1 = static_cast<float>(1.0 - opt.beta1);
      const float omb2 = static_cast<float>(1.0 - opt.beta2);
      const float eps = static_cast<float>(opt.epsilon);
      // bias corrections in double (libm pow = CPython float.__pow__)
      // then rounded, the same value the numpy store's weak python
      // scalar takes inside its float32 division
      const float bc1 = static_cast<float>(
          1.0 - std::pow(opt.beta1, static_cast<double>(step)));
      const float bc2 = static_cast<float>(
          1.0 - std::pow(opt.beta2, static_cast<double>(step)));
      for (int64_t d = 0; d < dim; ++d) {
        m[d] = b1 * m[d] + omb1 * grad[d];
        v[d] = b2 * v[d] + omb2 * grad[d] * grad[d];
        const float mhat = m[d] / bc1;
        float vv = v[d];
        if (vmax) {
          // amsgrad: denominator uses the running max of v
          vmax[d] = vv > vmax[d] ? vv : vmax[d];
          vv = vmax[d];
        }
        const float vhat = vv / bc2;
        w[d] -= lrf * mhat / (std::sqrt(vhat) + eps);
      }
      break;
    }
  }
}

}  // namespace

extern "C" {

// ABI clock for the ctypes loader (ps/embedding_store.py): bumped on
// every signature/semantics change of this C surface. A loader that
// finds a different value (or no symbol at all — pre-clock builds)
// falls back to the numpy store instead of calling through a drifted
// ABI. History: 1 = float hyperparameters, no blob entry
// points; 2 = double hyperparameters + apply_blob/lookup_cast/
// import_blob; 3 = drop_rows/drop_table (embedding lifecycle
// eviction); 4 = dirty-row tracking + export_dirty/
// dirty_count/clear_dirty (incremental checkpoints).
int64_t edl_store_abi_version(void) { return 4; }

void* edl_store_create(uint64_t seed) {
  auto* store = new Store();
  store->seed = seed;
  return store;
}

void edl_store_destroy(void* handle) { delete static_cast<Store*>(handle); }

int edl_store_set_optimizer(void* handle, const char* type, double lr,
                            double momentum, double beta1, double beta2,
                            double epsilon) {
  auto* store = static_cast<Store*>(handle);
  {
    // Rows size their slot memory from the optimizer at table-creation
    // time; swapping the optimizer afterwards would make apply_row write
    // past the allocation.
    std::lock_guard<std::mutex> lock(store->tables_mu);
    if (!store->tables.empty()) return -2;
  }
  OptConfig cfg;
  std::string t(type);
  if (t == "sgd") cfg.type = OptType::kSGD;
  else if (t == "momentum") cfg.type = OptType::kMomentum;
  else if (t == "nesterov") { cfg.type = OptType::kMomentum; cfg.nesterov = true; }
  else if (t == "adagrad") cfg.type = OptType::kAdagrad;
  else if (t == "adam") cfg.type = OptType::kAdam;
  else if (t == "amsgrad") { cfg.type = OptType::kAdam; cfg.amsgrad = true; }
  else return -1;
  cfg.lr = lr;
  cfg.momentum = momentum;
  cfg.beta1 = beta1;
  cfg.beta2 = beta2;
  cfg.epsilon = epsilon;
  store->opt = cfg;
  return 0;
}

// init_kind: InitKind value; init_param: scale / constant / stddev.
int edl_store_create_table_init(void* handle, const char* name, int64_t dim,
                                int init_kind, float init_param) {
  if (init_kind < 0 || init_kind > 3) return -2;
  auto* store = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(store->tables_mu);
  auto it = store->tables.find(name);
  if (it != store->tables.end()) {
    if (it->second->dim != dim) return -1;
    // Existing table: adopt the (possibly updated) initializer so a
    // restore-then-register sequence keeps the model's configured init.
    it->second->init_scale = init_param;
    it->second->init_kind = static_cast<InitKind>(init_kind);
    return 0;
  }
  auto table = std::make_unique<Table>();
  table->name = name;
  table->dim = dim;
  table->init_scale = init_param;
  table->init_kind = static_cast<InitKind>(init_kind);
  table->slots = store->opt.slots();
  table->rng.seed(store->seed * 1000003u + std::hash<std::string>{}(name));
  store->tables.emplace(name, std::move(table));
  return 0;
}

int edl_store_create_table(void* handle, const char* name, int64_t dim,
                           float init_scale) {
  return edl_store_create_table_init(
      handle, name, dim, (int)InitKind::kUniform, init_scale);
}

// Batch lookup; missing rows are lazily initialized (the reference's
// GetEmbeddingVector semantics, embedding_table.go:41-58).
int edl_store_lookup(void* handle, const char* name, const int64_t* ids,
                     int64_t n, float* out) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  for (int64_t i = 0; i < n; ++i) {
    const float* row = table->get_or_init(ids[i]);
    std::memcpy(out + i * table->dim, row, sizeof(float) * table->dim);
  }
  return 0;
}

// Sparse apply: grads is [n, dim] row-major, one row per id. lr_scale
// multiplies the configured LR (staleness modulation hook). Duplicate
// ids apply SEQUENTIALLY, one optimizer step per occurrence — the
// NumpyEmbeddingStore per-id-loop semantics; deduplicated single-apply
// semantics live in edl_store_apply_blob.
int edl_store_push_gradients(void* handle, const char* name,
                             const int64_t* ids, const float* grads,
                             int64_t n, double lr_scale) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  const double lr = store->opt.lr * lr_scale;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  for (int64_t i = 0; i < n; ++i) {
    float* row = table->get_or_init(ids[i]);
    int64_t step = ++table->row_steps[ids[i]];
    apply_row(store->opt, row, grads + i * table->dim, table->dim, lr, step);
    table->dirty_ids.insert(ids[i]);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Wire-blob fast path: one C call per table covering the
// whole deserialize + dedup + apply a push used to spread across
// python. ``ids`` points straight at the request's packed ids_blob
// (int64, host-endian == little on every deployment target) and
// ``grads`` at the TensorBlob payload bytes at ``grad_dtype``
// (kF32/kBF16/kF16; reduced dtypes upcast to fp32 exactly, matching
// numpy astype). ``dedup`` != 0 merges duplicate ids with a
// stable-sort + sequential segment sum — bit-identical to
// tensor_utils.deduplicate_indexed_slices (sort + np.add.reduceat) —
// then applies ONE optimizer step per unique id in ascending-id
// order, which is exactly what the numpy pipeline
// (deduplicate_indexed_slices -> NumpyEmbeddingStore.push_gradients)
// computes. Returns 0, -1 unknown table, -2 bad dtype.
int edl_store_apply_blob(void* handle, const char* name,
                         const int64_t* ids, int64_t n,
                         const void* grads, int grad_dtype,
                         double lr_scale, int dedup) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  const int itemsize = wire_itemsize(grad_dtype);
  if (itemsize < 0) return -2;
  if (n <= 0) return 0;
  const int64_t dim = table->dim;
  const double lr = store->opt.lr * lr_scale;
  const uint8_t* bytes = static_cast<const uint8_t*>(grads);
  const int64_t row_bytes = dim * itemsize;

  if (!dedup) {
    std::vector<float> scratch(dim);
    std::unique_lock<std::shared_mutex> lock(table->mu);
    for (int64_t i = 0; i < n; ++i) {
      decode_row(bytes + i * row_bytes, grad_dtype, dim, scratch.data());
      float* row = table->get_or_init(ids[i]);
      int64_t step = ++table->row_steps[ids[i]];
      apply_row(store->opt, row, scratch.data(), dim, lr, step);
      table->dirty_ids.insert(ids[i]);
    }
    return 0;
  }

  // stable sort of input positions by id: duplicates keep input order,
  // so the segment sums below add in exactly reduceat's order
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [ids](int64_t a, int64_t b) { return ids[a] < ids[b]; });

  std::vector<float> seg;     // decoded duplicate group, [len, dim]
  std::vector<float> scratch(dim);
  std::unique_lock<std::shared_mutex> lock(table->mu);
  int64_t s = 0;
  while (s < n) {
    const int64_t id = ids[order[s]];
    int64_t e = s + 1;
    while (e < n && ids[order[e]] == id) ++e;
    const int64_t len = e - s;
    const float* grad_row;
    if (len == 1 && grad_dtype == kF32) {
      // singleton f32 segment: apply straight from the wire buffer
      grad_row = reinterpret_cast<const float*>(bytes +
                                                order[s] * row_bytes);
    } else {
      seg.resize(len * dim);
      for (int64_t k = 0; k < len; ++k) {
        decode_row(bytes + order[s + k] * row_bytes, grad_dtype, dim,
                   seg.data() + k * dim);
      }
      reduceat_segment(seg.data(), len, dim, scratch.data());
      grad_row = scratch.data();
    }
    float* row = table->get_or_init(id);
    int64_t step = ++table->row_steps[id];
    apply_row(store->opt, row, grad_row, dim, lr, step);
    table->dirty_ids.insert(id);
    s = e;
  }
  return 0;
}

// Batched lookup emitting rows directly at the wire dtype: the f32 ->
// bf16/f16 downcast (round-to-nearest-even, numpy-astype-exact)
// happens inside this one GIL-released call instead of a separate
// python astype pass. out must hold n * dim * wire_itemsize bytes.
int edl_store_lookup_cast(void* handle, const char* name,
                          const int64_t* ids, int64_t n, void* out,
                          int out_dtype) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  const int itemsize = wire_itemsize(out_dtype);
  if (itemsize < 0) return -2;
  const int64_t dim = table->dim;
  uint8_t* bytes = static_cast<uint8_t*>(out);
  std::unique_lock<std::shared_mutex> lock(table->mu);
  for (int64_t i = 0; i < n; ++i) {
    const float* row = table->get_or_init(ids[i]);
    uint8_t* dst = bytes + i * dim * itemsize;
    switch (out_dtype) {
      case kF32:
        std::memcpy(dst, row, sizeof(float) * dim);
        break;
      case kBF16: {
        uint16_t* h = reinterpret_cast<uint16_t*>(dst);
        for (int64_t d = 0; d < dim; ++d) h[d] = f32_to_bf16(row[d]);
        break;
      }
      case kF16: {
        uint16_t* h = reinterpret_cast<uint16_t*>(dst);
        for (int64_t d = 0; d < dim; ++d) h[d] = f32_to_f16(row[d]);
        break;
      }
    }
  }
  return 0;
}

// Raw row import straight from wire bytes (device-tier writebacks,
// push_embedding_rows): values at ``dtype`` upcast to the fp32 master
// rows, duplicate ids resolve last-write-wins in input order (the
// import_table loop's semantics). No optimizer math, no version bump.
int edl_store_import_blob(void* handle, const char* name,
                          const int64_t* ids, int64_t n,
                          const void* values, int dtype, int shard_id,
                          int shard_num) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  const int itemsize = wire_itemsize(dtype);
  if (itemsize < 0) return -2;
  const int64_t dim = table->dim;
  const uint8_t* bytes = static_cast<const uint8_t*>(values);
  std::unique_lock<std::shared_mutex> lock(table->mu);
  for (int64_t i = 0; i < n; ++i) {
    if (shard_num > 0 &&
        (ids[i] % shard_num + shard_num) % shard_num != shard_id)
      continue;
    float* row = table->get_or_init(ids[i]);
    decode_row(bytes + i * dim * itemsize, dtype, dim, row);
    table->dirty_ids.insert(ids[i]);
  }
  return 0;
}

// Embedding lifecycle eviction: delete rows outright —
// weights, optimizer slots, AND per-row step counts, so a later
// re-admission of the id starts from the initializer exactly like a
// never-seen id (a leftover Adam step count would silently skew its
// bias correction). Returns the number of rows actually dropped
// (absent ids are not an error: a sweep may race a checkpoint
// restore), or -1 for an unknown table. The table's RNG stream is
// deliberately NOT rewound: eviction must not perturb the init draws
// of unrelated future rows.
int64_t edl_store_drop_rows(void* handle, const char* name,
                            const int64_t* ids, int64_t n) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  int64_t dropped = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (table->rows.erase(ids[i])) {
      ++dropped;
      // the id leaves the dirty set and enters the dead set: the next
      // delta checkpoint must replay this drop as a delete, or a
      // restored PS resurrects the evicted row from an older shard
      table->dirty_ids.erase(ids[i]);
      table->dead_ids.insert(ids[i]);
    }
    table->row_steps.erase(ids[i]);
  }
  return dropped;
}

// Drop a whole table (rows, slots, steps, metadata). 0 on success,
// -1 unknown table. NOT safe concurrently with traffic on the same
// table: find() hands out raw Table pointers, so the caller must
// quiesce RPCs first — this is an administrative entry point
// (schema retirement, tests), not a sweep-path one; sweeps use
// edl_store_drop_rows, which takes the per-table lock.
int edl_store_drop_table(void* handle, const char* name) {
  auto* store = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(store->tables_mu);
  auto it = store->tables.find(name);
  if (it == store->tables.end()) return -1;
  {
    // drain in-flight holders that already locked the table; new
    // finders are excluded by tables_mu held above
    std::unique_lock<std::shared_mutex> table_lock(it->second->mu);
  }
  store->tables.erase(it);
  return 0;
}

int64_t edl_store_table_size(void* handle, const char* name) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::shared_lock<std::shared_mutex> lock(table->mu);
  return (int64_t)table->rows.size();
}

int64_t edl_store_version(void* handle) {
  return static_cast<Store*>(handle)->version.load();
}

void edl_store_bump_version(void* handle) {
  static_cast<Store*>(handle)->version.fetch_add(1);
}

// Re-anchor the version clock (PS checkpoint auto-restore): one store,
// not O(version) bump calls at boot.
void edl_store_set_version(void* handle, int64_t version) {
  static_cast<Store*>(handle)->version.store(version);
}

// Export all (id, weight-row) pairs of a table into caller buffers.
// Call with out_ids == nullptr to get the count. Weights-only variant,
// used for serving export and weight inspection; checkpoints use
// edl_store_export_full below so optimizer slot state survives resume.
int64_t edl_store_export(void* handle, const char* name, int64_t* out_ids,
                         float* out_values, int64_t capacity) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::shared_lock<std::shared_mutex> lock(table->mu);
  if (out_ids == nullptr) return (int64_t)table->rows.size();
  int64_t i = 0;
  for (const auto& kv : table->rows) {
    if (i >= capacity) break;
    out_ids[i] = kv.first;
    std::memcpy(out_values + i * table->dim, kv.second.get(),
                sizeof(float) * table->dim);
    ++i;
  }
  return i;
}

// Bulk import rows (checkpoint restore / re-shard). Only ids with
// id % shard_num == shard_id are kept when shard_num > 0.
int edl_store_import(void* handle, const char* name, const int64_t* ids,
                     const float* values, int64_t n, int shard_id,
                     int shard_num) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  for (int64_t i = 0; i < n; ++i) {
    if (shard_num > 0 && (ids[i] % shard_num + shard_num) % shard_num != shard_id)
      continue;
    float* row = table->get_or_init(ids[i]);
    std::memcpy(row, values + i * table->dim, sizeof(float) * table->dim);
    table->dirty_ids.insert(ids[i]);
  }
  return 0;
}

int edl_store_table_slots(void* handle, const char* name) {
  Table* table = static_cast<Store*>(handle)->find(name);
  return table == nullptr ? -1 : table->slots;
}

// Full-state export: weight+slot rows ([count, (1+slots)*dim] floats)
// plus per-row optimizer step counts. The weights-only export above
// matches the reference's checkpoint content (ps/parameters.py:194-199
// drops slots); this variant closes that gap so a resumed Adam/Adagrad
// continues from its exact slot state instead of restarting bias
// correction (SURVEY.md s7 "optimizer-state checkpointing").
int64_t edl_store_export_full(void* handle, const char* name,
                              int64_t* out_ids, float* out_values,
                              int64_t* out_steps, int64_t capacity) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::shared_lock<std::shared_mutex> lock(table->mu);
  if (out_ids == nullptr) return (int64_t)table->rows.size();
  const int64_t row_floats = table->dim * (1 + table->slots);
  int64_t i = 0;
  for (const auto& kv : table->rows) {
    if (i >= capacity) break;
    out_ids[i] = kv.first;
    std::memcpy(out_values + i * row_floats, kv.second.get(),
                sizeof(float) * row_floats);
    auto step_it = table->row_steps.find(kv.first);
    out_steps[i] = step_it == table->row_steps.end() ? 0 : step_it->second;
    ++i;
  }
  return i;
}

// Full-state import. row_floats must equal (1+slots)*dim for the
// CURRENT optimizer; on mismatch (optimizer changed between save and
// restore) only the leading weight segment is imported and steps are
// dropped — degrading to the weights-only semantics instead of failing.
int edl_store_import_full(void* handle, const char* name,
                          const int64_t* ids, const float* values,
                          const int64_t* steps, int64_t n,
                          int64_t row_floats, int shard_id, int shard_num) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  if (row_floats < table->dim) return -2;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  const int64_t full = table->dim * (1 + table->slots);
  const bool exact = row_floats == full;
  for (int64_t i = 0; i < n; ++i) {
    if (shard_num > 0 && (ids[i] % shard_num + shard_num) % shard_num != shard_id)
      continue;
    float* row = table->get_or_init(ids[i]);
    std::memcpy(row, values + i * row_floats,
                sizeof(float) * (exact ? full : table->dim));
    if (exact && steps != nullptr) table->row_steps[ids[i]] = steps[i];
    table->dirty_ids.insert(ids[i]);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Incremental checkpoints: dirty-row delta export.

// Number of rows a dirty export would currently carry (the
// edl_ps_ckpt_dirty_rows gauge / buffer sizing). -1 unknown table.
int64_t edl_store_dirty_count(void* handle, const char* name) {
  Table* table = static_cast<Store*>(handle)->find(name);
  if (table == nullptr) return -1;
  std::shared_lock<std::shared_mutex> lock(table->mu);
  return (int64_t)table->dirty_ids.size();
}

int64_t edl_store_dead_count(void* handle, const char* name) {
  Table* table = static_cast<Store*>(handle)->find(name);
  if (table == nullptr) return -1;
  std::shared_lock<std::shared_mutex> lock(table->mu);
  return (int64_t)table->dead_ids.size();
}

// Snapshot-and-clear dirty export, the delta-checkpoint primitive:
// under ONE hold of the per-table unique lock, export every dirty
// row's full train state (ids ascending: checkpoint files must be
// deterministic — hash-set order is not) plus the dead-id tombstones,
// then clear both sets. Atomicity is the point: a row mutated after
// this call re-enters the dirty set and rides the NEXT delta; nothing
// can fall between an export and a separate clear.
//
// Sizing protocol: out_ids == nullptr is a count-only probe — returns
// the dirty count and writes the dead count through out_dead_count,
// clearing nothing. A fill call whose capacities are too small
// returns -3 having written and cleared nothing (the caller re-probes
// and retries). Returns the dirty-row count written, or -1 for an
// unknown table. ``clear`` == 0 keeps both sets (inspection).
int64_t edl_store_export_dirty(void* handle, const char* name,
                               int64_t* out_ids, float* out_values,
                               int64_t* out_steps, int64_t* out_dead,
                               int64_t capacity, int64_t dead_capacity,
                               int64_t* out_dead_count, int clear) {
  auto* store = static_cast<Store*>(handle);
  Table* table = store->find(name);
  if (table == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  const int64_t nd = (int64_t)table->dirty_ids.size();
  const int64_t ndead = (int64_t)table->dead_ids.size();
  if (out_ids == nullptr) {
    if (out_dead_count != nullptr) *out_dead_count = ndead;
    return nd;
  }
  if (nd > capacity || ndead > dead_capacity) return -3;
  std::vector<int64_t> ids(table->dirty_ids.begin(),
                           table->dirty_ids.end());
  std::sort(ids.begin(), ids.end());
  const int64_t row_floats = table->dim * (1 + table->slots);
  for (int64_t i = 0; i < nd; ++i) {
    out_ids[i] = ids[i];
    // invariant: every dirty id is resident (drops move ids to dead);
    // belt-and-braces zero fill rather than UB if it ever breaks
    auto it = table->rows.find(ids[i]);
    if (it == table->rows.end()) {
      std::memset(out_values + i * row_floats, 0,
                  sizeof(float) * row_floats);
      out_steps[i] = 0;
      continue;
    }
    std::memcpy(out_values + i * row_floats, it->second.get(),
                sizeof(float) * row_floats);
    auto step_it = table->row_steps.find(ids[i]);
    out_steps[i] =
        step_it == table->row_steps.end() ? 0 : step_it->second;
  }
  std::vector<int64_t> dead(table->dead_ids.begin(),
                            table->dead_ids.end());
  std::sort(dead.begin(), dead.end());
  for (int64_t i = 0; i < ndead; ++i) out_dead[i] = dead[i];
  if (out_dead_count != nullptr) *out_dead_count = ndead;
  if (clear) {
    table->dirty_ids.clear();
    table->dead_ids.clear();
  }
  return nd;
}

// Drop all dirty/dead bookkeeping for a table (taken before a FULL
// base export: the base carries complete state, so pre-base dirt is
// redundant — rows mutated between this clear and the export are
// re-marked and simply ride the next delta too). 0 ok, -1 unknown.
int edl_store_clear_dirty(void* handle, const char* name) {
  Table* table = static_cast<Store*>(handle)->find(name);
  if (table == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lock(table->mu);
  table->dirty_ids.clear();
  table->dead_ids.clear();
  return 0;
}

}  // extern "C"
