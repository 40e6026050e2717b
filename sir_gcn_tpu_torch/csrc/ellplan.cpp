// Native ELL plan builder — the C++ tier of the graph runtime.
//
// The reference delegates its graph preprocessing to DGL's C++ core
// (CSR materialization via graph.create_formats_(), batching via
// dgl.batch). This framework's equivalent hot host path is the ELL
// reduce-plan construction (ops/ell.py): chunking per-key edge runs and
// filling the budget-bucketed slot arrays. At ogbn-arxiv scale the NumPy
// implementation spends ~11s in Python loops over ~170k chunks; this
// translation unit does the same work in tens of milliseconds.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11).

#include <cstdint>
#include <cstring>

extern "C" {

// Phase A: chunk sorted-by-key items into runs of at most max_budget.
// gkeys: [m] item keys, sorted ascending (stable).
// Outputs (preallocated with capacity m): chunk_key / chunk_cnt /
// chunk_start. Returns the number of chunks.
int64_t ell_chunks(const int64_t* gkeys, int64_t m, int64_t max_budget,
                   int64_t* chunk_key, int64_t* chunk_cnt,
                   int64_t* chunk_start) {
  int64_t n_chunks = 0;
  int64_t i = 0;
  while (i < m) {
    int64_t k = gkeys[i];
    int64_t j = i;
    while (j < m && gkeys[j] == k) j++;
    for (int64_t off = i; off < j; off += max_budget) {
      int64_t cnt = j - off < max_budget ? j - off : max_budget;
      chunk_key[n_chunks] = k;
      chunk_cnt[n_chunks] = cnt;
      chunk_start[n_chunks] = off;
      n_chunks++;
    }
    i = j;
  }
  return n_chunks;
}

// Phase B: fill the bucketed slot arrays.
// order: [n_chunks] chunk indices grouped by budget (the caller sorts by
// budget); slot_base: [n_chunks] starting slot of each ordered chunk's
// row (slot_base[r] = sum of budgets of order[0..r)); budgets: per chunk.
// gids: the sorted-by-key item ids phase A indexed into.
void ell_fill_slots(const int64_t* gids, const int64_t* chunk_key,
                    const int64_t* chunk_cnt, const int64_t* chunk_start,
                    const int64_t* budgets, const int64_t* order,
                    const int64_t* slot_base, int64_t n_chunks,
                    int64_t* slot_item, float* slot_valid,
                    int64_t* slot_key) {
  for (int64_t r = 0; r < n_chunks; r++) {
    int64_t ci = order[r];
    int64_t base = slot_base[r];
    int64_t cnt = chunk_cnt[ci];
    int64_t budget = budgets[ci];
    int64_t start = chunk_start[ci];
    int64_t key = chunk_key[ci];
    for (int64_t s = 0; s < cnt; s++) {
      slot_item[base + s] = gids[start + s];
      slot_valid[base + s] = 1.0f;
      slot_key[base + s] = key;
    }
    for (int64_t s = cnt; s < budget; s++) {
      slot_item[base + s] = 0;
      slot_valid[base + s] = 0.0f;
      slot_key[base + s] = key;
    }
  }
}

}  // extern "C"
