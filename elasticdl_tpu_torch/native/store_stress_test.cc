// Concurrency stress test for the embedding store, built with
// -fsanitize=thread (make tsan) and with -fsanitize=address,undefined
// (make asan): concurrent lookups (lazy row creation), gradient pushes,
// wire-blob applies, exports, dirty-row snapshots, drops and version
// bumps across threads and tables, the traffic a PS with an
// asynchronous checkpoint thread runs.
//
// Exit 0 + "STRESS-OK" iff no data race was reported (TSAN aborts the
// process on findings when TSAN_OPTIONS=halt_on_error=1).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" {
void* edl_store_create(uint64_t seed);
void edl_store_destroy(void* handle);
int edl_store_set_optimizer(void* handle, const char* type, double lr,
                            double momentum, double beta1, double beta2,
                            double epsilon);
int edl_store_create_table(void* handle, const char* name, int64_t dim,
                           float init_scale);
int edl_store_lookup(void* handle, const char* name, const int64_t* ids,
                     int64_t n, float* out);
int edl_store_push_gradients(void* handle, const char* name,
                             const int64_t* ids, const float* grads,
                             int64_t n, double lr_scale);
int64_t edl_store_version(void* handle);
void edl_store_bump_version(void* handle);
int64_t edl_store_export_full(void* handle, const char* name,
                              int64_t* out_ids, float* out_values,
                              int64_t* out_steps, int64_t capacity);
int edl_store_table_slots(void* handle, const char* name);
int edl_store_apply_blob(void* handle, const char* name,
                         const int64_t* ids, int64_t n, const void* grads,
                         int grad_dtype, double lr_scale, int dedup);
int edl_store_lookup_cast(void* handle, const char* name,
                          const int64_t* ids, int64_t n, void* out,
                          int out_dtype);
int edl_store_import_blob(void* handle, const char* name,
                          const int64_t* ids, int64_t n, const void* values,
                          int dtype, int shard_id, int shard_num);
int64_t edl_store_abi_version(void);
int64_t edl_store_drop_rows(void* handle, const char* name,
                            const int64_t* ids, int64_t n);
int64_t edl_store_export_dirty(void* handle, const char* name,
                               int64_t* out_ids, float* out_values,
                               int64_t* out_steps, int64_t* out_dead,
                               int64_t capacity, int64_t dead_capacity,
                               int64_t* out_dead_count, int clear);
int edl_store_clear_dirty(void* handle, const char* name);
}

namespace {
constexpr int kDim = 8;
constexpr int kThreads = 8;
constexpr int kIters = 400;
constexpr int kIdsPerOp = 16;
const char* kTables[2] = {"alpha", "beta"};

void worker(void* store, int tid) {
  int64_t ids[kIdsPerOp];
  float buffer[kIdsPerOp * kDim];
  float grads[kIdsPerOp * kDim];
  for (int i = 0; i < kIdsPerOp * kDim; ++i) grads[i] = 0.01f;
  uint64_t rng = 0x9e3779b97f4a7c15ull * (tid + 1);
  for (int iter = 0; iter < kIters; ++iter) {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    const char* table = kTables[(rng >> 33) & 1];
    for (int i = 0; i < kIdsPerOp; ++i) {
      ids[i] = (int64_t)((rng >> (i % 24)) % 512);
    }
    switch ((rng >> 20) % 4) {
      case 0:
      case 1:
        if (edl_store_lookup(store, table, ids, kIdsPerOp, buffer) != 0)
          std::abort();
        break;
      case 2:
        if (edl_store_push_gradients(store, table, ids, grads, kIdsPerOp,
                                     1.0f) != 0)
          std::abort();
        edl_store_bump_version(store);
        break;
      case 3: {
        int64_t count =
            edl_store_export_full(store, table, nullptr, nullptr, nullptr, 0);
        if (count < 0) std::abort();
        // row width follows the live optimizer's slot count — a
        // hardcoded width would heap-overflow if the optimizer under
        // stress ever changes
        const int slots = edl_store_table_slots(store, table);
        if (slots < 0) std::abort();
        std::vector<int64_t> out_ids(count + 64);
        std::vector<float> out_values((count + 64) * kDim * (1 + slots));
        std::vector<int64_t> out_steps(count + 64);
        if (edl_store_export_full(store, table, out_ids.data(),
                                  out_values.data(), out_steps.data(),
                                  count + 64) < 0)
          std::abort();
        break;
      }
    }
  }
}

// Interleave: the wire-blob fast paths (deserialize+dedup+
// apply, cast lookups, raw imports) hammered from many threads
// concurrently with the classic worker() traffic above — the apply
// fan-out (EDL_PS_APPLY_THREADS) runs exactly this shape in the
// servicer. Duplicate-heavy id streams on purpose: the dedup path's
// sort/segment-sum scratch is per-call, so only the table state is
// shared.
void blob_worker(void* store, int tid) {
  int64_t ids[kIdsPerOp];
  uint16_t half_grads[kIdsPerOp * kDim];
  float f32_grads[kIdsPerOp * kDim];
  uint8_t cast_out[kIdsPerOp * kDim * 4];
  for (int i = 0; i < kIdsPerOp * kDim; ++i) {
    half_grads[i] = 0x3c00;  // 1.0 in f16
    f32_grads[i] = 0.01f;
  }
  uint64_t rng = 0xda942042e4dd58b5ull * (tid + 3);
  for (int iter = 0; iter < kIters; ++iter) {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    const char* table = kTables[(rng >> 33) & 1];
    for (int i = 0; i < kIdsPerOp; ++i) {
      // % 64: dense duplicates, so dedup's segment sums really merge
      ids[i] = (int64_t)((rng >> (i % 24)) % 64);
    }
    switch ((rng >> 20) % 4) {
      case 0:
        if (edl_store_apply_blob(store, table, ids, kIdsPerOp, f32_grads,
                                 /*kF32=*/0, 1.0, /*dedup=*/1) != 0)
          std::abort();
        break;
      case 1:
        if (edl_store_apply_blob(store, table, ids, kIdsPerOp, half_grads,
                                 /*kF16=*/2, 0.5, /*dedup=*/1) != 0)
          std::abort();
        break;
      case 2:
        if (edl_store_lookup_cast(store, table, ids, kIdsPerOp, cast_out,
                                  /*kBF16=*/1) != 0)
          std::abort();
        break;
      case 3:
        if (edl_store_import_blob(store, table, ids, kIdsPerOp, f32_grads,
                                  /*kF32=*/0, 0, 0) != 0)
          std::abort();
        break;
    }
  }
}
// Interleave: the checkpoint thread's dirty snapshot-and-
// clear (plus lifecycle drops feeding the dead set) racing the push/
// import traffic above — exactly the off-RPC delta-save shape. The
// sizing probe + fill retry mirrors the Python binding's loop.
void dirty_worker(void* store, int tid) {
  int64_t ids[kIdsPerOp];
  uint64_t rng = 0xbf58476d1ce4e5b9ull * (tid + 11);
  for (int iter = 0; iter < kIters; ++iter) {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    const char* table = kTables[(rng >> 33) & 1];
    switch ((rng >> 20) % 3) {
      case 0: {
        for (int i = 0; i < kIdsPerOp; ++i) {
          ids[i] = (int64_t)((rng >> (i % 24)) % 512);
        }
        if (edl_store_drop_rows(store, table, ids, kIdsPerOp) < 0)
          std::abort();
        break;
      }
      case 1: {
        const int slots = edl_store_table_slots(store, table);
        if (slots < 0) std::abort();
        for (int attempt = 0; attempt < 8; ++attempt) {
          int64_t dead = 0;
          int64_t nd = edl_store_export_dirty(
              store, table, nullptr, nullptr, nullptr, nullptr, 0, 0,
              &dead, 0);
          if (nd < 0) std::abort();
          std::vector<int64_t> out_ids(nd + 64);
          std::vector<float> out_values((nd + 64) * kDim * (1 + slots));
          std::vector<int64_t> out_steps(nd + 64);
          std::vector<int64_t> out_dead(dead + 64);
          int64_t got = edl_store_export_dirty(
              store, table, out_ids.data(), out_values.data(),
              out_steps.data(), out_dead.data(), nd + 64, dead + 64,
              &dead, /*clear=*/1);
          if (got == -3) continue;  // grew past the slack; re-probe
          if (got < 0) std::abort();
          break;
        }
        break;
      }
      case 2:
        if (edl_store_clear_dirty(store, table) != 0) std::abort();
        break;
    }
  }
}
}  // namespace

int main() {
  if (edl_store_abi_version() < 2) return 4;
  void* store = edl_store_create(7);
  edl_store_set_optimizer(store, "adam", 0.01, 0.9, 0.9, 0.999, 1e-8);
  for (const char* table : kTables) {
    if (edl_store_create_table(store, table, kDim, 0.05f) != 0) return 2;
  }
  std::vector<std::thread> threads;
  // half classic push/pull/export traffic, half wire-blob traffic —
  // the mixed interleave is the state a UDS-fronted PS under
  // EDL_PS_APPLY_THREADS actually runs
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back(worker, store, t);
    threads.emplace_back(blob_worker, store, t);
    if (t < 2) threads.emplace_back(dirty_worker, store, t);
  }
  for (auto& t : threads) t.join();
  if (edl_store_version(store) <= 0) return 3;
  edl_store_destroy(store);
  std::printf("STRESS-OK\n");
  return 0;
}
