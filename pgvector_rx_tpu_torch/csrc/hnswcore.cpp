// hnswcore: native host-side HNSW graph engine.
//
// The reference implements its entire runtime natively (Rust on pgrx);
// here the TPU compute path is JAX/XLA, and this module is the native
// implementation of the *host* graph runtime: sequential build, insert,
// and scan over an in-memory arena — the counterpart of the reference's
// pure algorithm layer (graph/mod.rs: search_layer Alg. 2,
// select_neighbors Alg. 4, find_element_neighbors Alg. 1,
// update_neighbor_connections) plus build-path duplicate folding
// (build.rs:474-510) and entry promotion (build.rs:523-528).
//
// Supports all four value kinds of the reference: dense f32 rows
// (vector/halfvec storage is f32 here; halfvec converts at the type
// layer), packed-bit rows as u32 words (bit: hamming/jaccard,
// bitvec.rs:97-132), and padded-CSR sparse rows (sparsevec merge-join
// distances, sparsevec.rs:875-1090).
//
// Semantics intentionally match pgvector_rx_tpu/graph/host.py item for
// item (including (distance, idx) tie-breaking) so the Python and native
// engines are interchangeable and cross-validated by tests.
//
// Exposed as a C ABI consumed via ctypes (pgvector_rx_tpu/native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

enum Metric { L2 = 0, IP = 1, COSINE = 2, L1 = 3, HAMMING = 4, JACCARD = 5 };
enum Kind { DENSE = 0, BIT = 1, SPARSE = 2 };

constexpr int32_t SP_PAD = INT32_MAX;  // sparse index padding (sorts last)

struct Cand {
    float d;
    int32_t idx;
};

// min-heap by (d, idx): nearest first, ties -> smaller idx (heapq parity)
struct NearerFirst {
    bool operator()(const Cand& a, const Cand& b) const {
        if (a.d != b.d) return a.d > b.d;
        return a.idx > b.idx;
    }
};
// max-heap by d, ties -> smaller idx on top (python (-d, idx) parity)
struct FartherFirst {
    bool operator()(const Cand& a, const Cand& b) const {
        if (a.d != b.d) return a.d < b.d;
        return a.idx > b.idx;
    }
};

struct Element {
    int32_t level = 0;
    bool deleted = false;
    // neighbors[layer] -> list of (d, idx), capacity lm
    std::vector<std::vector<Cand>> neighbors;
    std::vector<int64_t> tids;
};

// A reference to one value row of whatever kind the handle stores.
struct RowRef {
    const float* f = nullptr;     // dense
    const uint32_t* w = nullptr;  // bit words
    const int32_t* si = nullptr;  // sparse indices
    const float* sv = nullptr;    // sparse values
};

float sparse_dist(Metric metric, const int32_t* ai, const float* av,
                  const int32_t* bi, const float* bv, int P) {
    // two-pointer merge join over sorted index rows (SP_PAD sorts last);
    // parity: sparsevec.rs:875-1090 / graph/device.py _sparse_dist
    double dot = 0.0, a2 = 0.0, b2 = 0.0;
    float acc = 0.f;  // l2 / l1 accumulator (f32, matching reference)
    int i = 0, j = 0;
    while (i < P || j < P) {
        int32_t aidx = i < P ? ai[i] : SP_PAD;
        int32_t bidx = j < P ? bi[j] : SP_PAD;
        if (aidx == SP_PAD && bidx == SP_PAD) break;
        if (aidx == bidx) {
            float x = av[i], y = bv[j];
            dot += (double)x * y;
            a2 += (double)x * x;
            b2 += (double)y * y;
            if (metric == L2) {
                float t = x - y;
                acc += t * t;
            } else if (metric == L1) {
                acc += std::fabs(x - y);
            }
            i++;
            j++;
        } else if (aidx < bidx) {
            float x = av[i];
            a2 += (double)x * x;
            if (metric == L2) acc += x * x;
            else if (metric == L1) acc += std::fabs(x);
            i++;
        } else {
            float y = bv[j];
            b2 += (double)y * y;
            if (metric == L2) acc += y * y;
            else if (metric == L1) acc += std::fabs(y);
            j++;
        }
    }
    switch (metric) {
        case L2:
        case L1:
            return acc;
        case IP:
            return (float)-dot;
        case COSINE: {
            double denom = std::sqrt(a2 * b2);
            double sim = denom > 0.0 ? dot / denom : 0.0;
            if (sim > 1.0) sim = 1.0;
            if (sim < -1.0) sim = -1.0;
            return (float)(1.0 - sim);
        }
        default:
            return 0.f;
    }
}

struct Handle {
    Kind kind = DENSE;
    int dim;    // dense: floats/row; bit: u32 words/row; sparse: pairs/row
    int m;
    int efc;
    Metric metric;
    std::vector<float> values;    // dense rows [n, dim]
    std::vector<uint32_t> words;  // bit rows [n, dim]
    std::vector<int32_t> sp_idx;  // sparse index rows [n, dim]
    std::vector<float> sp_val;    // sparse value rows [n, dim]
    std::vector<Element> elements;
    int32_t entry = -1;
    // epoch-stamped visited set (no clearing between searches)
    std::vector<uint32_t> visit_mark;
    uint32_t visit_epoch = 0;
    // Memo of distances between stored rows, for the sparse kind only: its
    // merge join is ~50x a 128-d dense distance, and the neighbour-list
    // pruning (select_neighbors) scores the same pairs insert after insert
    // (~90% of a sparse build's distances). A direct-mapped table keyed by
    // the pair, sized to the rows; only rows below `memo_limit` (the id
    // being inserted) enter it, so the id that a rolled-back insert frees
    // never reads a stale entry. The sparse distance is symmetric bit for
    // bit, so a memoized pair is the number the merge would give: the
    // graph is the one without the memo.
    struct PairSlot {
        uint64_t key;
        float d;
    };
    std::vector<PairSlot> memo;
    int memo_shift = 64;
    int32_t memo_limit = 0;

    RowRef row(int32_t i) const {
        RowRef r;
        size_t off = (size_t)i * dim;
        switch (kind) {
            case DENSE:
                r.f = values.data() + off;
                break;
            case BIT:
                r.w = words.data() + off;
                break;
            case SPARSE:
                r.si = sp_idx.data() + off;
                r.sv = sp_val.data() + off;
                break;
        }
        return r;
    }

    size_t row_bytes() const {
        switch (kind) {
            case DENSE:
                return sizeof(float) * dim;
            case BIT:
                return sizeof(uint32_t) * dim;
            case SPARSE:
                return 0;  // handled specially (two arrays)
        }
        return 0;
    }

    bool rows_equal(int32_t a, int32_t b) const {
        size_t off_a = (size_t)a * dim, off_b = (size_t)b * dim;
        switch (kind) {
            case DENSE:
                return std::memcmp(values.data() + off_a, values.data() + off_b,
                                   row_bytes()) == 0;
            case BIT:
                return std::memcmp(words.data() + off_a, words.data() + off_b,
                                   row_bytes()) == 0;
            case SPARSE:
                return std::memcmp(sp_idx.data() + off_a, sp_idx.data() + off_b,
                                   sizeof(int32_t) * dim) == 0 &&
                       std::memcmp(sp_val.data() + off_a, sp_val.data() + off_b,
                                   sizeof(float) * dim) == 0;
        }
        return false;
    }

    float dist(const RowRef& a, const RowRef& b) const {
        switch (kind) {
            case DENSE: {
                float acc = 0.f;
                switch (metric) {
                    case L2:
                        for (int i = 0; i < dim; i++) {
                            float t = a.f[i] - b.f[i];
                            acc += t * t;
                        }
                        return acc;
                    case IP:
                        for (int i = 0; i < dim; i++) acc += a.f[i] * b.f[i];
                        return -acc;
                    case COSINE: {
                        for (int i = 0; i < dim; i++) acc += a.f[i] * b.f[i];
                        double s = acc;
                        if (s > 1.0) s = 1.0;
                        if (s < -1.0) s = -1.0;
                        return (float)(1.0 - s);
                    }
                    case L1:
                        for (int i = 0; i < dim; i++)
                            acc += std::fabs(a.f[i] - b.f[i]);
                        return acc;
                    default:
                        return acc;
                }
            }
            case BIT: {
                // bitvec.rs:97-132: hamming = popcount(xor); jaccard =
                // 1 - |A&B| / |A|B|, with 0/0 -> 1.0
                uint64_t x = 0, ab = 0, un = 0;
                for (int i = 0; i < dim; i++) {
                    x += (uint64_t)__builtin_popcount(a.w[i] ^ b.w[i]);
                    if (metric == JACCARD) {
                        ab += (uint64_t)__builtin_popcount(a.w[i] & b.w[i]);
                        un += (uint64_t)__builtin_popcount(a.w[i] | b.w[i]);
                    }
                }
                if (metric == HAMMING) return (float)x;
                if (ab == 0) return 1.0f;
                return (float)(1.0 - (double)ab / (double)un);
            }
            case SPARSE:
                return sparse_dist(metric, a.si, a.sv, b.si, b.sv, dim);
        }
        return 0.f;
    }

    // Rows [0, limit) may enter the memo; grows it to ~64 slots per row
    // (2^16 .. 2^23 slots), emptied when it grows. Sparse kind only.
    void memo_prepare(int32_t limit) {
        if (kind != SPARSE) return;
        int bits = 16;
        while (bits < 23 && (size_t(1) << bits) < size_t(64) * (limit + 1)) bits++;
        if (memo.size() < (size_t(1) << bits)) {
            memo.assign(size_t(1) << bits, PairSlot{~0ull, 0.f});
            memo_shift = 64 - bits;
        }
        memo_limit = limit;
    }

    // dist(row(a), row(b)), through the memo where both rows may enter it.
    float pair_dist(int32_t a, int32_t b) {
        if (a >= memo_limit || b >= memo_limit) return dist(row(a), row(b));
        const uint64_t key =
            ((uint64_t)std::min(a, b) << 32) | (uint32_t)std::max(a, b);
        PairSlot& s = memo[(key * 0x9E3779B97F4A7C15ull) >> memo_shift];
        if (s.key != key) s = PairSlot{key, dist(row(a), row(b))};
        return s.d;
    }
};

inline int layer_m(int m, int layer) { return layer == 0 ? 2 * m : m; }

// HNSW Algorithm 2 (graph/mod.rs:161-255 / host.py search_layer).
// `skip_count` (optional, length n_elements): elements in the set are
// traversed but do not count toward ef (host.py search_layer
// skip_count parity — the vacuum-repair search, insert.rs:1080-1110).
std::vector<Cand> search_layer(Handle* h, const RowRef& q,
                               const std::vector<Cand>& entry_points, int ef,
                               int layer, const uint8_t* skip_count = nullptr) {
    if (++h->visit_epoch == 0) {  // epoch wrap: reset marks
        std::fill(h->visit_mark.begin(), h->visit_mark.end(), 0u);
        h->visit_epoch = 1;
    }
    h->visit_mark.resize(h->elements.size(), 0u);
    const uint32_t epoch = h->visit_epoch;

    std::priority_queue<Cand, std::vector<Cand>, NearerFirst> candidates;
    std::priority_queue<Cand, std::vector<Cand>, FartherFirst> results;
    size_t w_len = 0;

    for (const Cand& ep : entry_points) {
        h->visit_mark[ep.idx] = epoch;
        candidates.push(ep);
        results.push(ep);
        if (!skip_count || !skip_count[ep.idx]) w_len++;
    }

    while (!candidates.empty()) {
        Cand c = candidates.top();
        candidates.pop();
        float f_dist = results.empty() ? INFINITY : results.top().d;
        if (c.d > f_dist) break;

        const Element& ce = h->elements[c.idx];
        if (ce.level < layer) continue;

        for (const Cand& nb : ce.neighbors[layer]) {
            int32_t ni = nb.idx;
            if (h->visit_mark[ni] == epoch) continue;
            h->visit_mark[ni] = epoch;
            const Element& ne = h->elements[ni];
            if (ne.deleted || ne.level < layer) continue;

            bool always_add = w_len < (size_t)ef;
            f_dist = results.empty() ? INFINITY : results.top().d;
            float ed = h->dist(q, h->row(ni));
            if (ed < f_dist || always_add) {
                Cand e{ed, ni};
                candidates.push(e);
                results.push(e);
                if (!skip_count || !skip_count[ni]) w_len++;
                if (w_len > (size_t)ef) {
                    results.pop();
                    w_len--;
                }
            }
        }
    }

    std::vector<Cand> out;
    out.reserve(w_len);
    while (!results.empty()) {
        out.push_back(results.top());
        results.pop();
    }
    // nearest first; ties by smaller idx (python sorted((d, idx)) parity
    // — heap pop order alone reverses tie order)
    std::sort(out.begin(), out.end(), [](const Cand& a, const Cand& b) {
        if (a.d != b.d) return a.d < b.d;
        return a.idx < b.idx;
    });
    return out;
}

// HNSW Algorithm 4 heuristic (graph/mod.rs:269-308)
std::vector<Cand> select_neighbors(Handle* h, const std::vector<Cand>& cands,
                                   int max_neighbors) {
    if ((int)cands.size() <= max_neighbors) return cands;
    std::vector<Cand> result, discarded;
    result.reserve(max_neighbors);
    for (const Cand& e : cands) {
        if ((int)result.size() >= max_neighbors) break;
        bool closer = true;
        for (const Cand& r : result) {
            if (h->pair_dist(e.idx, r.idx) <= e.d) {
                closer = false;
                break;
            }
        }
        if (closer)
            result.push_back(e);
        else
            discarded.push_back(e);
    }
    for (const Cand& d : discarded) {
        if ((int)result.size() >= max_neighbors) break;
        result.push_back(d);
    }
    return result;
}

// HNSW Algorithm 1 (graph/mod.rs:355-427)
void find_element_neighbors(Handle* h, int32_t new_idx, int32_t entry_idx) {
    RowRef q = h->row(new_idx);
    int new_level = h->elements[new_idx].level;
    int entry_level = h->elements[entry_idx].level;

    std::vector<Cand> ep{{h->dist(q, h->row(entry_idx)), entry_idx}};

    for (int lc = entry_level; lc > new_level; lc--) {
        auto w = search_layer(h, q, ep, 1, lc);
        if (!w.empty()) ep = {w[0]};
    }

    int start = std::min(new_level, entry_level);
    for (int lc = start; lc >= 0; lc--) {
        int lm = layer_m(h->m, lc);
        auto w = search_layer(h, q, ep, h->efc, lc);
        h->elements[new_idx].neighbors[lc] = select_neighbors(h, w, lm);
        ep = w;
    }
}

// Back-connections with pruning (graph/mod.rs:442-489)
void update_neighbor_connections(Handle* h, int32_t new_idx) {
    int new_level = h->elements[new_idx].level;
    for (int lc = new_level; lc >= 0; lc--) {
        int lm = layer_m(h->m, lc);
        auto snapshot = h->elements[new_idx].neighbors[lc];
        for (const Cand& hc : snapshot) {
            auto& nbrs = h->elements[hc.idx].neighbors[lc];
            Cand back{hc.d, new_idx};
            if ((int)nbrs.size() < lm) {
                nbrs.push_back(back);
            } else {
                std::vector<Cand> all = nbrs;
                all.push_back(back);
                std::sort(all.begin(), all.end(), [](const Cand& a, const Cand& b) {
                    if (a.d != b.d) return a.d < b.d;
                    return a.idx < b.idx;
                });
                nbrs = select_neighbors(h, all, lm);
            }
        }
    }
}

// Common insert body once the row is in the arena (kind-agnostic).
int32_t insert_common(Handle* h, int32_t idx, int level, int64_t tid) {
    h->memo_prepare(idx);
    Element e;
    e.level = level;
    e.neighbors.resize(level + 1);
    h->elements.push_back(std::move(e));

    auto rollback = [h, idx]() {
        h->elements.pop_back();
        switch (h->kind) {
            case DENSE:
                h->values.resize((size_t)idx * h->dim);
                break;
            case BIT:
                h->words.resize((size_t)idx * h->dim);
                break;
            case SPARSE:
                h->sp_idx.resize((size_t)idx * h->dim);
                h->sp_val.resize((size_t)idx * h->dim);
                break;
        }
    };

    if (h->entry < 0) {
        h->elements[idx].tids.push_back(tid);
        h->entry = idx;
        return idx;
    }

    find_element_neighbors(h, idx, h->entry);

    // duplicate folding: byte-equal zero-distance layer-0 neighbors
    // (build.rs:474-510)
    for (const Cand& nb : h->elements[idx].neighbors[0]) {
        if (nb.d != 0.0f) break;
        Element& dup = h->elements[nb.idx];
        if (!dup.deleted && !dup.tids.empty() && dup.tids.size() < 10 &&
            h->rows_equal(idx, nb.idx)) {
            dup.tids.push_back(tid);
            rollback();
            return -(nb.idx + 2);
        }
    }

    update_neighbor_connections(h, idx);
    h->elements[idx].tids.push_back(tid);
    if (h->elements[idx].level > h->elements[h->entry].level) h->entry = idx;
    return idx;
}

// Vacuum-repair search: find_element_neighbors with a skip set
// (host.py find_element_neighbors(skip=...) / insert.rs:1080-1110).
// Skipped elements are traversed but excluded from selection; the
// ground search widens to efc+1.
void find_element_neighbors_skip(Handle* h, int32_t idx, int32_t entry_idx,
                                 const uint8_t* skip) {
    RowRef q = h->row(idx);
    int new_level = h->elements[idx].level;
    int entry_level = h->elements[entry_idx].level;

    std::vector<Cand> ep{{h->dist(q, h->row(entry_idx)), entry_idx}};
    for (int lc = entry_level; lc > new_level; lc--) {
        auto w = search_layer(h, q, ep, 1, lc);
        if (!w.empty()) ep = {w[0]};
    }

    int ef = h->efc + 1;
    int start = std::min(new_level, entry_level);
    for (int lc = start; lc >= 0; lc--) {
        int lm = layer_m(h->m, lc);
        auto w = search_layer(h, q, ep, ef, lc, skip);
        std::vector<Cand> cands;
        cands.reserve(w.size());
        for (const Cand& c : w)
            if (!skip[c.idx]) cands.push_back(c);
        h->elements[idx].neighbors[lc] = select_neighbors(h, cands, lm);
        ep = w;
    }
}

// vacuum.rs:228-281 / vacuum.py _needs_updated: references a deleted
// element, or layer-0 list unfilled.
bool needs_updated(Handle* h, int32_t idx, const uint8_t* del) {
    const Element& e = h->elements[idx];
    for (const auto& layer_list : e.neighbors)
        for (const Cand& c : layer_list)
            if (del[c.idx]) return true;
    return (int)e.neighbors[0].size() < layer_m(h->m, 0);
}

}  // namespace

extern "C" {

void* hnsw_create(int dim, int m, int ef_construction, int metric) {
    Handle* h = new Handle();
    h->kind = DENSE;
    h->dim = dim;
    h->m = m;
    h->efc = ef_construction;
    h->metric = (Metric)metric;
    return h;
}

// Bit rows: `words` u32 words per row (hamming/jaccard).
void* hnsw_create_bit(int words, int m, int ef_construction, int metric) {
    Handle* h = new Handle();
    h->kind = BIT;
    h->dim = words;
    h->m = m;
    h->efc = ef_construction;
    h->metric = (Metric)metric;
    return h;
}

// Sparse rows: `budget` (index, value) pairs per row, indices sorted
// ascending and padded with INT32_MAX.
void* hnsw_create_sparse(int budget, int m, int ef_construction, int metric) {
    Handle* h = new Handle();
    h->kind = SPARSE;
    h->dim = budget;
    h->m = m;
    h->efc = ef_construction;
    h->metric = (Metric)metric;
    return h;
}

void hnsw_destroy(void* hp) { delete (Handle*)hp; }

// Insert one prepared row; returns the element idx, or -(dup_idx+2) when
// the tid was absorbed into an existing duplicate element
// (build.rs:474-510: byte-equal zero-distance layer-0 neighbor with room).
int32_t hnsw_insert(void* hp, const float* vec, int level, int64_t tid) {
    Handle* h = (Handle*)hp;
    int32_t idx = (int32_t)h->elements.size();
    h->values.insert(h->values.end(), vec, vec + h->dim);
    return insert_common(h, idx, level, tid);
}

int32_t hnsw_insert_bit(void* hp, const uint32_t* row, int level, int64_t tid) {
    Handle* h = (Handle*)hp;
    int32_t idx = (int32_t)h->elements.size();
    h->words.insert(h->words.end(), row, row + h->dim);
    return insert_common(h, idx, level, tid);
}

int32_t hnsw_insert_sparse(void* hp, const int32_t* idx_row, const float* val_row,
                           int level, int64_t tid) {
    Handle* h = (Handle*)hp;
    int32_t idx = (int32_t)h->elements.size();
    h->sp_idx.insert(h->sp_idx.end(), idx_row, idx_row + h->dim);
    h->sp_val.insert(h->sp_val.end(), val_row, val_row + h->dim);
    return insert_common(h, idx, level, tid);
}

int32_t hnsw_bulk_insert(void* hp, const float* vecs, const int* levels,
                         const int64_t* tids, int n) {
    Handle* h = (Handle*)hp;
    for (int i = 0; i < n; i++) {
        hnsw_insert(hp, vecs + (size_t)i * h->dim, levels[i], tids[i]);
    }
    return (int32_t)h->elements.size();
}

int32_t hnsw_bulk_insert_bit(void* hp, const uint32_t* rows, const int* levels,
                             const int64_t* tids, int n) {
    Handle* h = (Handle*)hp;
    for (int i = 0; i < n; i++) {
        hnsw_insert_bit(hp, rows + (size_t)i * h->dim, levels[i], tids[i]);
    }
    return (int32_t)h->elements.size();
}

int32_t hnsw_bulk_insert_sparse(void* hp, const int32_t* idx_rows,
                                const float* val_rows, const int* levels,
                                const int64_t* tids, int n) {
    Handle* h = (Handle*)hp;
    for (int i = 0; i < n; i++) {
        hnsw_insert_sparse(hp, idx_rows + (size_t)i * h->dim,
                           val_rows + (size_t)i * h->dim, levels[i], tids[i]);
    }
    return (int32_t)h->elements.size();
}

int32_t hnsw_n_elements(void* hp) {
    return (int32_t)((Handle*)hp)->elements.size();
}

int32_t hnsw_entry(void* hp) { return ((Handle*)hp)->entry; }

int32_t hnsw_element_level(void* hp, int32_t idx) {
    return ((Handle*)hp)->elements[idx].level;
}

int32_t hnsw_element_tids(void* hp, int32_t idx, int64_t* out, int cap) {
    Handle* h = (Handle*)hp;
    const auto& t = h->elements[idx].tids;
    int n = std::min((int)t.size(), cap);
    std::copy(t.begin(), t.begin() + n, out);
    return (int32_t)t.size();
}

int32_t hnsw_element_neighbors(void* hp, int32_t idx, int layer,
                               int32_t* out_ids, float* out_dists, int cap) {
    Handle* h = (Handle*)hp;
    const Element& e = h->elements[idx];
    if (layer > e.level) return 0;
    const auto& nb = e.neighbors[layer];
    int n = std::min((int)nb.size(), cap);
    for (int i = 0; i < n; i++) {
        out_ids[i] = nb[i].idx;
        out_dists[i] = nb[i].d;
    }
    return (int32_t)nb.size();
}

namespace {
// Algorithm 5 scan with a kind-generic query row.
int32_t search_impl(Handle* h, const RowRef& q, int ef, int32_t* out_ids,
                    float* out_dists) {
    if (h->entry < 0) return 0;
    const Element& ee = h->elements[h->entry];
    if (ee.deleted) return 0;

    std::vector<Cand> ep{{h->dist(q, h->row(h->entry)), h->entry}};
    for (int lc = ee.level; lc >= 1; lc--) {
        auto w = search_layer(h, q, ep, 1, lc);
        if (w.empty()) return 0;
        ep = {w[0]};
    }
    auto w = search_layer(h, q, ep, ef, 0);
    int n = std::min((int)w.size(), ef);
    for (int i = 0; i < n; i++) {
        out_ids[i] = w[i].idx;
        out_dists[i] = w[i].d;
    }
    return n;
}
}  // namespace

// Algorithm 5 scan: greedy descent + ef ground search; fills up to ef
// (element_id, order_distance) pairs, returns count.
int32_t hnsw_search(void* hp, const float* q, int ef, int32_t* out_ids,
                    float* out_dists) {
    Handle* h = (Handle*)hp;
    RowRef r;
    r.f = q;
    return search_impl(h, r, ef, out_ids, out_dists);
}

int32_t hnsw_search_bit(void* hp, const uint32_t* q, int ef, int32_t* out_ids,
                        float* out_dists) {
    Handle* h = (Handle*)hp;
    RowRef r;
    r.w = q;
    return search_impl(h, r, ef, out_ids, out_dists);
}

int32_t hnsw_search_sparse(void* hp, const int32_t* qi, const float* qv, int ef,
                           int32_t* out_ids, float* out_dists) {
    Handle* h = (Handle*)hp;
    RowRef r;
    r.si = qi;
    r.sv = qv;
    return search_impl(h, r, ef, out_ids, out_dists);
}

// ---------------------------------------------------------------------
// Arena load (reconstruct an existing index without re-inserting) +
// vacuum repair (ambulkdelete passes 2-3, vacuum.rs:288-803).
// ---------------------------------------------------------------------

// Bulk-load element metadata + value rows. `rows` layout depends on the
// handle kind: dense [n, dim] f32; bit [n, dim] u32 words (pass via
// rows_u32); sparse via rows_i32/rows_f32 [n, dim] each. `tids` is
// flattened [n, tid_stride] with per-element counts in `tid_counts`.
void hnsw_load(void* hp, const float* rows_f32, const uint32_t* rows_u32,
               const int32_t* rows_i32, const int32_t* levels,
               const uint8_t* deleted, const int64_t* tids,
               const int32_t* tid_counts, int tid_stride, int n) {
    Handle* h = (Handle*)hp;
    h->memo.clear();  // the rows change: no memoized pair holds
    h->memo_limit = 0;
    h->elements.clear();
    h->elements.reserve(n);
    switch (h->kind) {
        case DENSE:
            h->values.assign(rows_f32, rows_f32 + (size_t)n * h->dim);
            break;
        case BIT:
            h->words.assign(rows_u32, rows_u32 + (size_t)n * h->dim);
            break;
        case SPARSE:
            h->sp_idx.assign(rows_i32, rows_i32 + (size_t)n * h->dim);
            h->sp_val.assign(rows_f32, rows_f32 + (size_t)n * h->dim);
            break;
    }
    for (int i = 0; i < n; i++) {
        Element e;
        e.level = levels[i];
        e.deleted = deleted[i] != 0;
        e.neighbors.resize(e.level + 1);
        int tc = tid_counts[i];
        const int64_t* tp = tids + (size_t)i * tid_stride;
        e.tids.assign(tp, tp + tc);
        h->elements.push_back(std::move(e));
    }
    h->entry = -1;
}

// Bulk-load one layer's adjacency: ids/dists [n_rows, width] with -1 id
// padding; `first` is the first element id of the slab (layer > 0 rows
// are usually a compacted subset — callers pass element ids in `map`,
// or map == nullptr for the identity starting at `first`).
void hnsw_load_neighbors(void* hp, int layer, const int32_t* map, int32_t first,
                         const int32_t* ids, const float* dists, int n_rows,
                         int width) {
    Handle* h = (Handle*)hp;
    for (int r = 0; r < n_rows; r++) {
        int32_t el = map ? map[r] : first + r;
        Element& e = h->elements[el];
        if (layer > e.level) continue;
        auto& nb = e.neighbors[layer];
        nb.clear();
        for (int j = 0; j < width; j++) {
            int32_t id = ids[(size_t)r * width + j];
            if (id < 0) continue;
            nb.push_back({dists[(size_t)r * width + j], id});
        }
    }
}

void hnsw_set_entry(void* hp, int32_t entry) { ((Handle*)hp)->entry = entry; }

// Vacuum passes 2+3 for fully-dead elements `dels` (vacuum.py
// _repair_graph + _mark_deleted semantics, mirroring vacuum.rs:288-803):
// repair the highest survivor first (from the old entry), replace or
// repair the entry, re-find neighbors (skip = deleted ∪ self) for every
// live element that references a dead one or has an unfilled ground
// layer, then mark the dead (clear lists/tids, deleted=1) and drop
// stale forward references. Version bumps and slot free-lists stay on
// the caller's side. `repaired_out` (caller-allocated, capacity n)
// receives the ids whose neighbor lists changed; returns the count.
int32_t hnsw_vacuum(void* hp, const int32_t* dels, int nd,
                    int32_t* repaired_out) {
    Handle* h = (Handle*)hp;
    int32_t n = (int32_t)h->elements.size();
    std::vector<uint8_t> del(n, 0);
    for (int i = 0; i < nd; i++) del[dels[i]] = 1;

    int32_t highest = -1;
    int best_level = -1;
    for (int32_t i = 0; i < n; i++) {
        const Element& e = h->elements[i];
        if (e.deleted || del[i] || e.tids.empty()) continue;
        if (e.level > best_level) {
            highest = i;
            best_level = e.level;
        }
    }

    std::vector<uint8_t> skip = del;
    int32_t n_repaired = 0;
    auto repair = [&](int32_t idx, int32_t entry_idx) {
        if (entry_idx < 0) {
            Element& e = h->elements[idx];
            e.neighbors.assign(e.level + 1, {});
        } else {
            uint8_t saved = skip[idx];
            skip[idx] = 1;
            find_element_neighbors_skip(h, idx, entry_idx, skip.data());
            skip[idx] = saved;
        }
        if (repaired_out) repaired_out[n_repaired] = idx;
        n_repaired++;
    };

    if (highest >= 0 && needs_updated(h, highest, del.data()))
        repair(highest, h->entry);
    if (h->entry >= 0) {
        if (del[h->entry]) {
            h->entry = highest;  // may be -1 -> empty graph
        } else if (needs_updated(h, h->entry, del.data())) {
            repair(h->entry, highest >= 0 ? highest : h->entry);
        }
    }
    for (int32_t i = 0; i < n; i++) {
        const Element& e = h->elements[i];
        if (e.deleted || del[i] || i == h->entry || i == highest) continue;
        if (e.tids.empty()) continue;
        if (needs_updated(h, i, del.data())) repair(i, h->entry);
    }

    // mark pass + stale forward-reference cleanup
    for (int i = 0; i < nd; i++) {
        Element& e = h->elements[dels[i]];
        e.deleted = true;
        e.neighbors.assign(e.level + 1, {});
        e.tids.clear();
    }
    for (int32_t i = 0; i < n; i++) {
        Element& e = h->elements[i];
        if (e.deleted) continue;
        for (auto& layer_list : e.neighbors) {
            layer_list.erase(
                std::remove_if(layer_list.begin(), layer_list.end(),
                               [&](const Cand& c) { return del[c.idx]; }),
                layer_list.end());
        }
    }
    return n_repaired;
}

// ---------------------------------------------------------------------
// Flat serving export: fill the DeviceGraph array layout
// (graph/device.py DeviceGraph.from_index) in ONE call. The
// per-element accessor loop (hnsw_element_*) materializes Python
// objects per element — the >2M host-graph cliff; this export is the
// native-engine serving path that bypasses it entirely.
// ---------------------------------------------------------------------

// stats needed to size the export buffers: out[0]=n, out[1]=count of
// live level>=1 elements (upper rows), out[2]=max level over all
// elements, out[3]=total heap-TID count.
void hnsw_graph_stats(void* hp, int64_t* out) {
    Handle* h = (Handle*)hp;
    int64_t n = (int64_t)h->elements.size();
    int64_t n_up = 0, max_level = 0, total_tids = 0;
    for (const Element& e : h->elements) {
        if (e.level > max_level) max_level = e.level;
        if (!e.deleted && e.level >= 1) n_up++;
        total_tids += (int64_t)e.tids.size();
    }
    out[0] = n;
    out[1] = n_up;
    out[2] = max_level;
    out[3] = total_tids;
}

// Fill caller-allocated arrays (pre-filled by the caller: ids -1,
// trav 0, tid_count 0) with the serving layout. nb0 is [n+1, lm0]
// row-major; upper is [n_up, lmax*m] layer-major flat (layer lc's m
// slots at (lc-1)*m, matching build.rs:741-763's top-layer-first
// neighbor-tuple serialization read back layer-major); deleted
// elements keep level/tids but no adjacency and no upper row —
// exactly DeviceGraph.from_index's semantics.
void hnsw_export_flat(void* hp, int32_t lm0, int32_t lmax, int32_t m,
                      int32_t* nb0, int32_t* upper, int32_t* upper_slot,
                      int32_t* levels, uint8_t* trav, int32_t* emit_tid,
                      int32_t* tid_count, int64_t* tid_flat,
                      int64_t* tid_off) {
    Handle* h = (Handle*)hp;
    int n = (int)h->elements.size();
    int32_t u = 0;
    int64_t toff = 0;
    for (int i = 0; i < n; i++) {
        const Element& e = h->elements[i];
        levels[i] = e.level;
        trav[i] = e.deleted ? 0 : 1;
        tid_off[i] = toff;
        tid_count[i] = (int32_t)e.tids.size();
        if (!e.tids.empty()) emit_tid[i] = (int32_t)e.tids[0];
        for (int64_t t : e.tids) tid_flat[toff++] = t;
        if (e.deleted) continue;
        const auto& l0 = e.neighbors[0];
        int c0 = std::min((int)l0.size(), (int)lm0);
        for (int j = 0; j < c0; j++) nb0[(size_t)i * lm0 + j] = l0[j].idx;
        if (e.level >= 1) {
            upper_slot[i] = u;
            int lt = std::min(e.level, (int)lmax);
            for (int lc = 1; lc <= lt; lc++) {
                const auto& nl = e.neighbors[lc];
                int c = std::min((int)nl.size(), (int)m);
                int32_t* dst = upper + ((size_t)u * lmax + (lc - 1)) * m;
                for (int j = 0; j < c; j++) dst[j] = nl[j].idx;
            }
            u++;
        }
    }
    tid_off[n] = toff;
}

// Batch search convenience (OpenMP-free; callers thread if needed)
void hnsw_search_batch(void* hp, const float* queries, int bq, int ef,
                       int32_t* out_ids, float* out_dists) {
    Handle* h = (Handle*)hp;
    for (int b = 0; b < bq; b++) {
        int32_t* ids = out_ids + (size_t)b * ef;
        float* ds = out_dists + (size_t)b * ef;
        int n = hnsw_search(hp, queries + (size_t)b * h->dim, ef, ids, ds);
        for (int i = n; i < ef; i++) {
            ids[i] = -1;
            ds[i] = INFINITY;
        }
    }
}

}  // extern "C"
