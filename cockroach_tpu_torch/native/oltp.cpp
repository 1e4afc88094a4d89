// Native OLTP row plane: fixed-width MVCC version store with a
// primary-key index, serving point reads / ordered range scans /
// single-row write mirroring for the SQL engine's OLTP fast lane
// (exec/oltplane.py). The PyTorch port's own copy of
// cockroach_tpu/native/oltp.cpp, unchanged in its ABI; it runs on the
// host, never on the card.
//
// The hot tables' rows live in contiguous int64 column arrays with
// per-key version chains; ctypes calls release the GIL, an internal
// shared_mutex admits truly parallel readers, and visibility is the
// same MVCC window the columnstore uses (ts <= read_ts < del_ts).
//
// Scope: single-column int64 primary keys, int64-representable column
// values (INT/BOOL/DATE/TIMESTAMP/DECIMAL-scaled storage forms) with
// per-column validity. The Python side gates eligibility and sends
// everything else down the columnstore path.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <shared_mutex>
#include <vector>

namespace {

constexpr int64_t MAX_TS = INT64_MAX;

struct Table {
  int64_t ncols;
  // row-version storage (append-only)
  std::vector<int64_t> keys;
  std::vector<int64_t> ts;
  std::vector<int64_t> del_ts;
  std::vector<int64_t> prev;           // previous version index or -1
  std::vector<int64_t> vals;           // ncols per row, row-major
  std::vector<uint8_t> valid;          // ncols per row
  // key -> newest version index (even if deleted: chains serve
  // historical reads)
  std::map<int64_t, int64_t> index;
  std::shared_mutex mu;

  int64_t visible(int64_t head, int64_t read_ts) const {
    // walk the version chain newest-first for the version whose
    // [ts, del_ts) window contains read_ts
    for (int64_t i = head; i >= 0; i = prev[i]) {
      if (ts[i] <= read_ts) {
        return read_ts < del_ts[i] ? i : -1;
      }
    }
    return -1;
  }
};

}  // namespace

extern "C" {

void* oltp_create(int64_t ncols) {
  auto* t = new Table();
  t->ncols = ncols;
  return t;
}

void oltp_destroy(void* h) { delete static_cast<Table*>(h); }

int64_t oltp_nversions(void* h) {
  auto* t = static_cast<Table*>(h);
  std::shared_lock lk(t->mu);
  return (int64_t)t->keys.size();
}

// Bulk-load row versions. Rows MUST arrive sorted by (key, ts)
// ascending so same-key versions chain oldest->newest. cols is
// column-major (cols[c*n + i]); valid likewise.
void oltp_bulk(void* h, int64_t n, const int64_t* in_keys,
               const int64_t* in_ts, const int64_t* in_del,
               const int64_t* cols, const uint8_t* vld) {
  auto* t = static_cast<Table*>(h);
  std::unique_lock lk(t->mu);
  int64_t base = (int64_t)t->keys.size();
  t->keys.insert(t->keys.end(), in_keys, in_keys + n);
  t->ts.insert(t->ts.end(), in_ts, in_ts + n);
  t->del_ts.insert(t->del_ts.end(), in_del, in_del + n);
  t->prev.resize(base + n);
  t->vals.resize((base + n) * t->ncols);
  t->valid.resize((base + n) * t->ncols);
  for (int64_t i = 0; i < n; i++) {
    int64_t r = base + i;
    for (int64_t c = 0; c < t->ncols; c++) {
      t->vals[r * t->ncols + c] = cols[c * n + i];
      t->valid[r * t->ncols + c] = vld[c * n + i];
    }
    auto it = t->index.find(in_keys[i]);
    if (it == t->index.end()) {
      t->prev[r] = -1;
      t->index.emplace(in_keys[i], r);
    } else {
      t->prev[r] = it->second;
      it->second = r;
    }
  }
}

// Apply one committed put. Versions may arrive out of commit order
// (commit happens under kv latches; the mirror apply races after) —
// the new version is spliced into its chain by ts, inheriting the
// deletion window of whatever it supersedes. vals/valid length ncols.
int oltp_put(void* h, int64_t key, int64_t ts, const int64_t* vals,
             const uint8_t* vld) {
  auto* t = static_cast<Table*>(h);
  std::unique_lock lk(t->mu);
  int64_t r = (int64_t)t->keys.size();
  t->keys.push_back(key);
  t->ts.push_back(ts);
  t->del_ts.push_back(MAX_TS);
  t->prev.push_back(-1);
  t->vals.insert(t->vals.end(), vals, vals + t->ncols);
  t->valid.insert(t->valid.end(), vld, vld + t->ncols);
  auto it = t->index.find(key);
  if (it == t->index.end()) {
    t->index.emplace(key, r);
    return 0;
  }
  int64_t head = it->second;
  if (ts >= t->ts[head]) {
    // common case: newest version. Inherit the head's deletion
    // window (MAX when live; a tombstone above ts carries over).
    if (t->del_ts[head] > ts) {
      t->del_ts[r] = t->del_ts[head];
      t->del_ts[head] = ts;
    }
    t->prev[r] = head;
    it->second = r;
    return 0;
  }
  // out-of-order: splice between `older` and `newer` by ts
  int64_t newer = head, older = t->prev[head];
  while (older >= 0 && t->ts[older] > ts) {
    newer = older;
    older = t->prev[older];
  }
  int64_t newdel = t->ts[newer];
  if (older >= 0 && t->del_ts[older] > ts) {
    newdel = t->del_ts[older];
    t->del_ts[older] = ts;
  }
  t->del_ts[r] = newdel;
  t->prev[r] = older;
  t->prev[newer] = r;
  return 0;
}

// Apply one committed delete: tombstone the version visible at ts.
int oltp_del(void* h, int64_t key, int64_t ts) {
  auto* t = static_cast<Table*>(h);
  std::unique_lock lk(t->mu);
  auto it = t->index.find(key);
  if (it == t->index.end()) return 1;
  for (int64_t i = it->second; i >= 0; i = t->prev[i]) {
    if (t->ts[i] <= ts) {
      if (t->del_ts[i] > ts) t->del_ts[i] = ts;
      return 0;
    }
  }
  return 1;
}

// Does a live (undeleted) version of key exist as of read_ts?
int oltp_live(void* h, int64_t key, int64_t read_ts) {
  auto* t = static_cast<Table*>(h);
  std::shared_lock lk(t->mu);
  auto it = t->index.find(key);
  if (it == t->index.end()) return 0;
  return t->visible(it->second, read_ts) >= 0 ? 1 : 0;
}

// Point read: copy the visible version's columns into out_vals /
// out_valid (ncols each). Returns 1 if found, 0 if not.
int oltp_read(void* h, int64_t key, int64_t read_ts, int64_t* out_vals,
              uint8_t* out_valid) {
  auto* t = static_cast<Table*>(h);
  std::shared_lock lk(t->mu);
  auto it = t->index.find(key);
  if (it == t->index.end()) return 0;
  int64_t r = t->visible(it->second, read_ts);
  if (r < 0) return 0;
  std::memcpy(out_vals, &t->vals[r * t->ncols],
              sizeof(int64_t) * t->ncols);
  std::memcpy(out_valid, &t->valid[r * t->ncols], t->ncols);
  return 1;
}

// Fused multi-key probe (the batch window's gather): one shared-lock
// acquisition and one pass over a key vector instead of n oltp_read
// calls. out_vals/out_valid are row-major ncols per key slot;
// out_found[i] is 1 when key i has a visible version. Returns hits.
int64_t oltp_multiread(void* h, int64_t n, const int64_t* keys,
                       int64_t read_ts, int64_t* out_vals,
                       uint8_t* out_valid, uint8_t* out_found) {
  auto* t = static_cast<Table*>(h);
  std::shared_lock lk(t->mu);
  int64_t hits = 0;
  for (int64_t i = 0; i < n; i++) {
    out_found[i] = 0;
    auto it = t->index.find(keys[i]);
    if (it == t->index.end()) continue;
    int64_t r = t->visible(it->second, read_ts);
    if (r < 0) continue;
    std::memcpy(out_vals + i * t->ncols, &t->vals[r * t->ncols],
                sizeof(int64_t) * t->ncols);
    std::memcpy(out_valid + i * t->ncols, &t->valid[r * t->ncols],
                t->ncols);
    out_found[i] = 1;
    hits++;
  }
  return hits;
}

// Ordered range scan over live keys in [lo, hi] (bounds optional via
// has_*/strict flags), emitting up to `cap` visible rows in key
// order. Returns rows written; out_vals is row-major ncols per row.
int64_t oltp_scan(void* h, int64_t lo, int has_lo, int lo_strict,
                  int64_t hi, int has_hi, int hi_strict,
                  int64_t read_ts, int64_t cap, int64_t* out_keys,
                  int64_t* out_vals, uint8_t* out_valid) {
  auto* t = static_cast<Table*>(h);
  std::shared_lock lk(t->mu);
  auto it = has_lo ? (lo_strict ? t->index.upper_bound(lo)
                                : t->index.lower_bound(lo))
                   : t->index.begin();
  int64_t n = 0;
  for (; it != t->index.end() && n < cap; ++it) {
    if (has_hi) {
      if (hi_strict ? (it->first >= hi) : (it->first > hi)) break;
    }
    int64_t r = t->visible(it->second, read_ts);
    if (r < 0) continue;
    out_keys[n] = it->first;
    std::memcpy(out_vals + n * t->ncols, &t->vals[r * t->ncols],
                sizeof(int64_t) * t->ncols);
    std::memcpy(out_valid + n * t->ncols, &t->valid[r * t->ncols],
                t->ncols);
    n++;
  }
  return n;
}

}  // extern "C"
