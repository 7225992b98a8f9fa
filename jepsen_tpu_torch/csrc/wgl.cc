// Native Wing-Gong-Lowe linearizability search.
//
// C++ twin of jepsen_tpu/checker/knossos/__init__.py's wgl() for the
// CAS-register model (the tiered router's only device-eligible model,
// and the model every per-key register sweep uses) and the mutex
// model (hazelcast-style lock workloads). The JVM reference runs this
// search in knossos (wgl.clj); here the Python engine stays the
// oracle for arbitrary models and this kernel takes the encoded fast
// path — same entry-list walk, same memo-cache
// semantics, byte-identical verdicts (tests/test_knossos.py pins the
// parity differentially, including the max_configs "unknown" cutoff,
// which requires the cache to grow through the SAME insertion sequence).
//
// Input is the already-interned event stream the device kernels
// consume (knossos/encode.py: rows of [kind, slot, f, a1, a2, known]
// with READ/WRITE/CAS/ACQUIRE/RELEASE = 0/1/2/3/4, INVOKE_EV/
// COMPLETE_EV = 0/1; info ops simply never complete — their slot
// stays occupied, which IS the return-at-infinity rule). Model
// semantics (models.py, state interned with nil = 0):
//   CASRegister (model 0):
//     write: always legal, state := a1
//     cas:   legal iff state == a1, state := a2
//     read:  known == 0 -> always legal; else legal iff state == a1
//   Mutex (model 1, state 0 = free, 1 = held):
//     acquire: legal iff state == 0, state := 1
//     release: legal iff state == 1, state := 0
//
// ABI:
//   int64_t jt_wgl_abi_version()   -> 2
//   void jt_wgl_run(const int32_t* events, int64_t n_events,
//                   int64_t max_configs, int64_t model, int64_t out[5])
//     out[0] verdict: 1 valid, 0 invalid, 2 unknown (cache exhausted)
//     out[1] op count
//     out[2] max depth reached (max simultaneously-linearized ops)
//     out[3] failing op id (the return the search died at), else -1
//     out[4] final cache size

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int32_t READ = 0, WRITE = 1, CAS = 2, ACQUIRE = 3, RELEASE = 4;
constexpr int32_t INVOKE_EV = 0, COMPLETE_EV = 1;

struct OpMeta {
  int32_t f, a1, a2, known;
};

struct Entry {
  bool is_call;
  int32_t op_id;
  int32_t match;  // entry index of the paired call/return, -1 if none
  int32_t prev, next;
};

struct Search {
  std::vector<OpMeta> ops;
  std::vector<Entry> entries;  // entry 0 is the head sentinel
  int32_t returns_total = 0;

  void build(const int32_t* ev, int64_t n_events) {
    entries.push_back({false, -1, -1, -1, -1});  // head
    std::vector<int32_t> slot_op(64, -1), slot_call(64, -1);
    int32_t tail = 0;
    auto append = [&](Entry e) {
      e.prev = tail;
      e.next = -1;
      int32_t idx = (int32_t)entries.size();
      entries[tail].next = idx;
      entries.push_back(e);
      tail = idx;
      return idx;
    };
    for (int64_t i = 0; i < n_events; ++i) {
      const int32_t* r = ev + i * 6;
      int32_t kind = r[0], slot = r[1];
      if (slot >= (int32_t)slot_op.size()) {
        slot_op.resize(slot + 1, -1);
        slot_call.resize(slot + 1, -1);
      }
      if (kind == INVOKE_EV) {
        int32_t id = (int32_t)ops.size();
        ops.push_back({r[2], r[3], r[4], r[5]});
        slot_op[slot] = id;
        slot_call[slot] = append({true, id, -1, -1, -1});
      } else if (kind == COMPLETE_EV) {
        int32_t call = slot_call[slot];
        if (call < 0) continue;
        int32_t id = slot_op[slot];
        int32_t ret = append({false, id, call, -1, -1});
        entries[call].match = ret;
        slot_call[slot] = -1;
        ++returns_total;
      }
    }
    // calls without returns (info / open at end) keep match = -1:
    // return at infinity, never required to linearize.
  }

  static bool step(int32_t state, const OpMeta& op, int32_t& out) {
    switch (op.f) {
      case WRITE:
        out = op.a1;
        return true;
      case CAS:
        if (state != op.a1) return false;
        out = op.a2;
        return true;
      case ACQUIRE:
        if (state != 0) return false;
        out = 1;
        return true;
      case RELEASE:
        if (state != 1) return false;
        out = 0;
        return true;
      default:  // READ
        if (op.known != 0 && state != op.a1) return false;
        out = state;
        return true;
    }
  }

  void run(int64_t max_configs, int64_t out[5]) {
    const int32_t n = (int32_t)ops.size();
    out[1] = n;
    out[3] = -1;
    if (n == 0) {
      out[0] = 1;
      out[2] = 0;
      out[4] = 0;
      return;
    }
    const int words = (n + 63) / 64;
    std::vector<uint64_t> mask(words, 0);
    int32_t state = 0;  // interned nil
    int32_t depth = 0, best_depth = 0;

    // memo cache keyed on (linearized set, state) — the same
    // insertion discipline as the Python engine so the max_configs
    // "unknown" cutoff fires at the identical point. Exact keys in an
    // open-addressing arena (no per-insert allocation, single hash):
    // a false-positive hit would wrongly prune a branch, so probes
    // compare the full key, never just a fingerprint.
    struct Cache {
      const int words;
      std::vector<uint64_t> arena;   // n_keys * (words + 1) packed keys
      std::vector<uint32_t> slots;   // offset+1 into arena, 0 = empty
      size_t count = 0;

      explicit Cache(int w) : words(w), slots(1024, 0) {
        arena.reserve(1024 * (w + 1));
      }
      static uint64_t mix(uint64_t h, uint64_t v) {
        // splitmix64-style: every input bit diffuses through the
        // whole word — config keys differ in single mask bits, and a
        // weak mixer clusters linear probing into long chains
        h ^= v;
        h *= 0xbf58476d1ce4e5b9ULL;
        h ^= h >> 27;
        h *= 0x94d049bb133111ebULL;
        h ^= h >> 31;
        return h;
      }
      uint64_t hash(const uint64_t* key) const {
        uint64_t h = 0x243f6a8885a308d3ULL;
        for (int i = 0; i <= words; ++i) h = mix(h, key[i]);
        return h;
      }
      bool full() const {
        // u32 arena offsets: past this, slot offsets would wrap and
        // lookups could alias — callers treat it as cache exhaustion
        return arena.size() + (size_t)words + 2 >= 0xffffffffull;
      }
      bool insert_if_absent(const uint64_t* key) {
        // returns true when the key was new (and inserted)
        if ((count + 1) * 4 >= slots.size() * 3) grow();
        size_t m = slots.size() - 1;
        size_t i = (size_t)hash(key) & m;
        while (true) {
          uint32_t off = slots[i];
          if (off == 0) {
            slots[i] = (uint32_t)(arena.size() + 1);
            arena.insert(arena.end(), key, key + words + 1);
            ++count;
            return true;
          }
          if (memcmp(&arena[off - 1], key,
                     (size_t)(words + 1) * 8) == 0)
            return false;
          i = (i + 1) & m;
        }
      }
      void grow() {
        std::vector<uint32_t> ns(slots.size() * 2, 0);
        size_t m = ns.size() - 1;
        for (uint32_t off : slots) {
          if (off == 0) continue;
          size_t i = (size_t)hash(&arena[off - 1]) & m;
          while (ns[i] != 0) i = (i + 1) & m;
          ns[i] = off;
        }
        slots.swap(ns);
      }
    };
    Cache cache(words);
    std::vector<uint64_t> keybuf((size_t)words + 1);
    auto load_key = [&](const std::vector<uint64_t>& m, int32_t s) {
      memcpy(keybuf.data(), m.data(), (size_t)words * 8);
      keybuf[words] = (uint64_t)(uint32_t)s;
      return keybuf.data();
    };
    cache.insert_if_absent(load_key(mask, state));

    struct Frame {
      int32_t entry;
      int32_t prev_state;
    };
    std::vector<Frame> stack;

    auto lift = [&](int32_t e) {
      entries[entries[e].prev].next = entries[e].next;
      if (entries[e].next >= 0) entries[entries[e].next].prev = entries[e].prev;
    };
    auto unlift = [&](int32_t e) {
      entries[entries[e].prev].next = e;
      if (entries[e].next >= 0) entries[entries[e].next].prev = e;
    };
    auto backtrack = [&](int32_t& entry_out) {
      Frame fr = stack.back();
      stack.pop_back();
      int32_t e2 = fr.entry;
      unlift(e2);
      if (entries[e2].match >= 0) {
        unlift(entries[e2].match);
        ++returns_left;
      }
      int32_t id = entries[e2].op_id;
      mask[id >> 6] &= ~(1ULL << (id & 63));
      --depth;
      state = fr.prev_state;
      entry_out = entries[e2].next;
    };

    int32_t entry = entries[0].next;
    returns_left = returns_total;
    while (returns_left > 0) {
      if (entry < 0) {
        // walked past every entry with returns remaining: guard branch
        // (mirrors the Python engine's defensive pop-or-break)
        if (stack.empty()) break;
        backtrack(entry);
        continue;
      }
      Entry& e = entries[entry];
      if (e.is_call) {
        int32_t s2;
        bool ok = step(state, ops[e.op_id], s2);
        bool fresh = false;
        if (ok) {
          uint64_t saved = mask[e.op_id >> 6];
          mask[e.op_id >> 6] |= 1ULL << (e.op_id & 63);
          const uint64_t* k = load_key(mask, s2);
          if ((int64_t)cache.count >= max_configs || cache.full()) {
            // mirror Python: the cutoff check precedes the insert, so
            // only a WOULD-BE-fresh key may trip it (keybuf is stable
            // and never aliases the arena, so k is safe to pass)
            bool would_insert = cache.insert_if_absent(k);
            if (would_insert) {
              out[0] = 2;  // unknown: config cache exhausted
              out[2] = best_depth;
              out[4] = (int64_t)cache.count - 1;
              return;
            }
            mask[e.op_id >> 6] = saved;
          } else {
            fresh = cache.insert_if_absent(k);
            if (!fresh) mask[e.op_id >> 6] = saved;
          }
        }
        if (fresh) {
          stack.push_back({entry, state});
          lift(entry);
          if (e.match >= 0) {
            lift(e.match);
            --returns_left;
          }
          state = s2;
          ++depth;
          if (depth > best_depth) best_depth = depth;
          entry = entries[0].next;
        } else {
          entry = e.next;
        }
      } else {
        // a completed op the search failed to linearize before its
        // return
        if (stack.empty()) {
          out[0] = 0;
          out[2] = best_depth;
          out[3] = e.op_id;
          out[4] = (int64_t)cache.count;
          return;
        }
        backtrack(entry);
      }
    }
    out[0] = 1;
    out[2] = best_depth;
    out[4] = (int64_t)cache.count;
  }

  int32_t returns_left = 0;
};

}  // namespace

extern "C" {

int64_t jt_wgl_abi_version() { return 2; }

void jt_wgl_run(const int32_t* events, int64_t n_events,
                int64_t max_configs, int64_t model, int64_t out[5]) {
  // `model` selects step semantics only through the f codes already
  // present in the event rows, so the search itself is model-blind;
  // the parameter exists to keep the ABI explicit about what the
  // encoder produced (0 = cas-register, 1 = mutex).
  (void)model;
  Search s;
  s.build(events, n_events);
  s.run(max_configs, out);
}

}  // extern "C"
