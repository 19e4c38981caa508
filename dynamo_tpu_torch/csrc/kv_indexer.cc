// Native KV indexer: hash -> worker-ownership bitmap with prefix-overlap
// queries.  A copy of the JAX package's native/indexer.cc for the port:
// dynamo_tpu_torch/router/native_indexer.py builds it with the host C++
// compiler into dynamo_tpu_torch/_build/ at first use and binds it over
// ctypes.  C++ equivalent of the reference's Rust FlashIndexer
// (lib/kv-router/src/indexer/).
//
// Key insight shared with the Python indexer (router/indexer.py):
// PositionalLineageHashes chain their prefixes, so prefix matching is a flat
// front-to-back membership walk — no radix tree needed.  Ownership is a
// fixed-width bitset (1024 worker slots); events and queries are O(n blocks)
// with word-level bit ops.
//
// C ABI for ctypes; 128-bit hashes cross as interleaved (hi, lo) u64 pairs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kWords = 16;  // 16 * 64 = 1024 worker slots
constexpr int kMaxWorkers = kWords * 64;

struct Key {
  uint64_t hi, lo;
  bool operator==(const Key& o) const { return hi == o.hi && lo == o.lo; }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    // 128->64 mix (the input is already a BLAKE2 hash; cheap mixing is fine)
    return k.hi ^ (k.lo * 0x9E3779B97F4A7C15ull);
  }
};

struct Bits {
  uint64_t w[kWords] = {0};
  inline void set(int i) { w[i >> 6] |= 1ull << (i & 63); }
  inline void clear(int i) { w[i >> 6] &= ~(1ull << (i & 63)); }
  inline bool test(int i) const { return (w[i >> 6] >> (i & 63)) & 1; }
  inline bool any() const {
    for (int i = 0; i < kWords; i++)
      if (w[i]) return true;
    return false;
  }
};

struct Indexer {
  std::unordered_map<Key, Bits, KeyHash> owners;
  std::unordered_map<int64_t, int> worker_slot;
  int64_t slot_worker[kMaxWorkers];
  std::vector<std::vector<Key>> slot_keys;  // per-slot append log (lazy)
  std::vector<int64_t> slot_count;          // live block count per slot
  int next_slot = 0;

  Indexer() : slot_keys(kMaxWorkers), slot_count(kMaxWorkers, 0) {
    std::memset(slot_worker, 0, sizeof(slot_worker));
  }

  int slot_for(int64_t worker, bool create) {
    auto it = worker_slot.find(worker);
    if (it != worker_slot.end()) return it->second;
    if (!create || next_slot >= kMaxWorkers) return -1;
    int s = next_slot++;
    worker_slot.emplace(worker, s);
    slot_worker[s] = worker;
    return s;
  }

  void compact_slot(int s) {
    // slot_keys is an append-only log (removals don't prune it); rebuild it
    // from live ownership when dead/duplicate entries dominate, keeping
    // memory proportional to live blocks under store/evict churn
    std::vector<Key> live;
    live.reserve(slot_count[s]);
    for (const Key& k : slot_keys[s]) {
      auto it = owners.find(k);
      if (it != owners.end() && it->second.test(s)) live.push_back(k);
    }
    std::sort(live.begin(), live.end(), [](const Key& a, const Key& b) {
      return a.hi != b.hi ? a.hi < b.hi : a.lo < b.lo;
    });
    live.erase(std::unique(live.begin(), live.end()), live.end());
    slot_keys[s].swap(live);
  }

  void stored(int64_t worker, const uint64_t* h, int n) {
    int s = slot_for(worker, true);
    if (s < 0) return;
    for (int i = 0; i < n; i++) {
      Key k{h[2 * i], h[2 * i + 1]};
      Bits& b = owners[k];
      if (!b.test(s)) {
        b.set(s);
        slot_count[s]++;
        slot_keys[s].push_back(k);
      }
    }
    if (slot_keys[s].size() > 2 * static_cast<size_t>(slot_count[s]) + 1024)
      compact_slot(s);
  }

  void removed(int64_t worker, const uint64_t* h, int n) {
    int s = slot_for(worker, false);
    if (s < 0) return;
    for (int i = 0; i < n; i++) {
      Key k{h[2 * i], h[2 * i + 1]};
      auto it = owners.find(k);
      if (it == owners.end()) continue;
      if (it->second.test(s)) {
        it->second.clear(s);
        slot_count[s]--;
        if (!it->second.any()) owners.erase(it);
      }
    }
  }

  void drop_worker(int64_t worker) {
    int s = slot_for(worker, false);
    if (s < 0) return;
    for (const Key& k : slot_keys[s]) {
      auto it = owners.find(k);
      if (it != owners.end() && it->second.test(s)) {
        it->second.clear(s);
        if (!it->second.any()) owners.erase(it);
      }
    }
    slot_keys[s].clear();
    slot_count[s] = 0;
    // slot stays assigned to the worker id (cheap; ids are long-lived)
  }

  int find_matches(const uint64_t* h, int n, int64_t* out_workers,
                   int32_t* out_overlaps, int max_out) const {
    int count = 0;
    Bits active;
    bool have_active = false;
    int end = n;
    for (int i = 0; i < n; i++) {
      Key k{h[2 * i], h[2 * i + 1]};
      auto it = owners.find(k);
      if (it == owners.end()) {
        end = i;
        break;
      }
      const Bits& b = it->second;
      if (!have_active) {
        active = b;
        have_active = true;
      } else {
        bool any_left = false;
        for (int w = 0; w < kWords; w++) {
          uint64_t dropped = active.w[w] & ~b.w[w];
          while (dropped && count < max_out) {
            int bit = __builtin_ctzll(dropped);
            dropped &= dropped - 1;
            out_workers[count] = slot_worker[w * 64 + bit];
            out_overlaps[count] = i;
            count++;
          }
          active.w[w] &= b.w[w];
          any_left |= (active.w[w] != 0);
        }
        if (!any_left) {
          have_active = false;
          break;
        }
      }
    }
    if (have_active) {
      for (int w = 0; w < kWords && count < max_out; w++) {
        uint64_t bits = active.w[w];
        while (bits && count < max_out) {
          int bit = __builtin_ctzll(bits);
          bits &= bits - 1;
          out_workers[count] = slot_worker[w * 64 + bit];
          out_overlaps[count] = end;
          count++;
        }
      }
    }
    return count;
  }
};

}  // namespace

extern "C" {

void* kvi_new() { return new Indexer(); }
void kvi_free(void* p) { delete static_cast<Indexer*>(p); }

void kvi_apply_stored(void* p, int64_t worker, const uint64_t* hashes, int n) {
  static_cast<Indexer*>(p)->stored(worker, hashes, n);
}

void kvi_apply_removed(void* p, int64_t worker, const uint64_t* hashes, int n) {
  static_cast<Indexer*>(p)->removed(worker, hashes, n);
}

void kvi_remove_worker(void* p, int64_t worker) {
  static_cast<Indexer*>(p)->drop_worker(worker);
}

int kvi_find_matches(void* p, const uint64_t* hashes, int n,
                     int64_t* out_workers, int32_t* out_overlaps,
                     int max_out) {
  return static_cast<Indexer*>(p)->find_matches(hashes, n, out_workers,
                                                out_overlaps, max_out);
}

uint64_t kvi_num_blocks(void* p) {
  return static_cast<Indexer*>(p)->owners.size();
}

int64_t kvi_worker_block_count(void* p, int64_t worker) {
  Indexer* ix = static_cast<Indexer*>(p);
  int s = ix->slot_for(worker, false);
  return s < 0 ? 0 : ix->slot_count[s];
}

}  // extern "C"
