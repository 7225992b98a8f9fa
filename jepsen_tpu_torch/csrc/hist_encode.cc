// Native list-append history ingest: history.jsonl -> encoded tensors.
//
// The port's copy of the reference's native/hist_encode.cc, unchanged
// but for these header lines: built with g++ at first use by
// jepsen_tpu_torch/_build.py, so a sidecar either package writes is
// the same bytes (tests/test_torch_native_encode.py and
// tests/test_torch_sidecar.py hold it to the reference's build).
//
// This is the C++ fast path for jepsen_tpu/checker/elle/encode.py's
// encode_history() composed with store.load_history_dir(): one pass
// over the raw JSON bytes straight to the int32/int64 tensors the
// device kernels consume, skipping the Python dict materialization
// entirely. It plays the role the reference's history parser + Elle's
// list-append pre-processing play on the JVM (txn/src/jepsen/txn.clj,
// elle's list_append namespace) — the host-side tokenizer feeding the
// checker — but as the data-loader half of this repo's TPU pipeline:
// analyze-store sweeps are host-ingest bound (SURVEY.md §5.7), and on
// the single-core bench host a process pool cannot help, so the
// per-history constant factor is the whole game.
//
// PARITY CONTRACT (enforced by tests/test_native_encode.py's
// differential fuzz): for any history this module accepts, the emitted
// tensors (appends/reads/status/process/invoke_index/complete_index),
// n/n_keys/max_pos, and the anomaly NAME SEQUENCE (with counts, in
// note order) are byte-identical to the Python encoder's. Witness
// dicts are lean (ints, no op dicts) — the batch-sweep path already
// drops txn_ops (ingest.encode_run_dir lean=True). Anything this
// module cannot represent with those exact semantics (non-int mop
// values, bool/float keys — Python's 1 == True == 1.0 interning,
// big ints, exotic process values, malformed JSON) returns NULL and
// the caller falls back to the Python encoder, so the fast path can
// never be wrong, only inapplicable.
//
// Semantics replicated, in order (see encode.py / txn.py):
//   h.index        — indices are positional, file values ignored
//   bucket_txn_pairs — per-process invoke/completion pairing; stale
//                      invokes -> indeterminate; non-int processes and
//                      non-txn values never pend; unknown completion
//                      types consume silently; sort by invoke pos
//   writer_of      — first writer wins; duplicate-appends noted, the
//                      (key,value) joins multi_append (emits pos -1)
//   _check_internal — known/appended bookkeeping incl. the observed-
//                      value overwrite after a mismatch
//   duplicate-elements — per read mop of committed rows (all-int lists
//                      make Python's (type,x) re-check equal to set())
//   _longest_prefix_order — first strictly-longest wins ties;
//                      mismatches note incompatible-order, order kept
//   G1a / dirty-update / phantom-read — version-chain scan
//   emission       — key ids interned in emission order; append pos -1
//                      for unobserved/ambiguous; read pos -1 when the
//                      last element's version != len; G1b during read
//                      emission (writer_of + intermediate, w != row)
//
// ABI (ctypes, loaded by jepsen_tpu_torch/checker/elle/native_encode.py
// through _build.load; the reference's loader is jepsen_tpu/native_lib.py):
//   void*  jt_ha_encode_file(path)       NULL -> fall back to Python
//   void*  jt_wr_encode_file(path)       rw-register sibling (default
//                                        version-order flags only):
//                                        emits dependency-edge triples
//                                        (jt_ha_edges) instead of
//                                        append/read tensors
//   void   jt_ha_dims(h, int64 out[8])   n, n_keys, max_pos, n_app,
//                                        n_rd, n_anom, pre_json_len,
//                                        n_edges (wr)
//   const int32_t*  jt_ha_appends/reads/edges/status/process/kid_to_pre(h)
//   const int64_t*  jt_ha_invoke_index/complete_index(h)
//   const int64_t*  jt_ha_anomalies(h)   rows of (code, f0, f1, f2, f3)
//   const char*     jt_ha_pre_key_names_json(h)
//   void   jt_ha_free(h)
//
//   void*  jt_ks_split_file(path)        per-key split ids for
//                                        independent.subhistories:
//                                        NULL -> Python splitter
//   void   jt_ks_dims(h, int64 out[4])   n_ops, n_keys, names_json_len,
//                                        lifted
//   const int32_t*  jt_ks_key_ids(h)     per op line; -1 = un-lifted
//   const char*     jt_ks_key_names_json(h)
//   void   jt_ks_free(h)
//
// Anomaly rows (code, f0, f1, f2, f3):
//   1 duplicate-appends   (pre_key, value, row, 0)
//   2 internal            (row, pre_key, 0, 0)
//   3 duplicate-elements  (pre_key, row, 0, 0)
//   4 incompatible-order  (pre_key, b_row, 0, 0)
//   5 G1a                 (pre_key, value, failed_invoke_pos, row)
//      (row = reader row in wr mode; -1 in append mode, where the
//       reader is a version chain, not a row)
//   6 dirty-update        (pre_key, value, failed_invoke_pos, 0)
//   7 phantom-read        (pre_key, value, row, 0)  (row -1 in append)
//   8 G1b                 (pre_key, row, value, 0)  (value 0 in append)
//   9 duplicate-writes    (pre_key, value, row, 0)  (wr mode)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>
#include <memory>
#include <array>

#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------- values

enum VKind : uint8_t {
  VK_INT, VK_STR, VK_NULL, VK_ARR, VK_BAD
};

struct TVal {
  VKind kind = VK_BAD;
  int64_t i = 0;        // VK_INT
  int32_t sid = -1;     // VK_STR: interned string id (keys only)
  uint32_t off = 0, len = 0;  // VK_ARR: span in the int pool
};

struct Mop {
  bool is_read = false;   // mf == "r"     (append: anything else writes)
  bool is_w = false;      // mf == "w"     (wr: anything else reads)
  TVal key, val;
};

enum OpType : uint8_t { T_INVOKE, T_OK, T_FAIL, T_INFO, T_OTHER };

struct Op {
  OpType type = T_OTHER;
  int32_t proc_id = -1;    // interned process identity (pairing key)
  int64_t proc_int = -1;   // value when the process is an int, else -1
  bool proc_is_int = false;
  bool is_txn = false;
  bool list_nontxn = false;  // value was a list but not [x y z]* shaped
  bool bad_mops = false;     // txn-shaped but with types we can't encode;
                             // fatal only if this op's mops get USED
  uint32_t mop_off = 0, mop_len = 0;
  int32_t pos = 0;         // positional index (h.index semantics)
};

struct PairHash {
  size_t operator()(const std::pair<int32_t, int64_t>& p) const {
    uint64_t h = (uint64_t)(uint32_t)p.first * 0x9e3779b97f4a7c15ULL;
    h ^= (uint64_t)p.second + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return (size_t)h;
  }
};

struct TripleHash {
  size_t operator()(const std::tuple<int32_t, int64_t, int32_t>& t) const {
    uint64_t h = (uint64_t)(uint32_t)std::get<0>(t) * 0x9e3779b97f4a7c15ULL;
    h ^= (uint64_t)std::get<1>(t) + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    h ^= (uint64_t)(uint32_t)std::get<2>(t) * 0xc2b2ae3d27d4eb4fULL;
    return (size_t)h;
  }
};

// ---------------------------------------------------------------- parser

// Minimal JSON scanner for one line. Any deviation from what the
// Python path would accept with identical semantics sets `bail`
// (the whole encode then returns NULL -> Python fallback).
struct Parser {
  const char* p;
  const char* end;
  bool bail = false;

  // shared pools (owned by Encoder)
  std::vector<int64_t>* ipool;
  std::vector<std::string>* spool;          // decoded strings (scratch)

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
  }
  bool eat(char c) {
    ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  bool lit(const char* s) {
    size_t n = strlen(s);
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  // Skip a JSON string without materializing it. Assumes *p == '"'.
  bool skip_str() {
    ++p;
    while (p < end) {
      unsigned char c = *p;
      if (c == '"') { ++p; return true; }
      if (c < 0x20) return false;     // raw control char: json raises
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        char e = *p;
        if (e == 'u') {
          if (end - p < 5) return false;
          for (int i = 1; i <= 4; ++i) {
            char h = p[i];
            if (!((h >= '0' && h <= '9') || (h >= 'a' && h <= 'f') ||
                  (h >= 'A' && h <= 'F')))
              return false;
          }
          p += 5;
          // surrogate validity is re-checked on materializing paths;
          // skipped content only needs json-level well-formedness,
          // except a lone surrogate, which Python ACCEPTS (json uses
          // surrogatepass) — so nothing more to verify here
        } else if (e == '"' || e == '\\' || e == '/' || e == 'b' ||
                   e == 'f' || e == 'n' || e == 'r' || e == 't') {
          ++p;
        } else {
          return false;
        }
      } else {
        ++p;
      }
    }
    return false;
  }

  // Decode a JSON string into out. Assumes *p == '"'.
  bool str(std::string& out) {
    out.clear();
    ++p;  // opening quote
    while (p < end) {
      // bulk-copy the plain span up to the next quote/escape/control
      const char* s0 = p;
      while (p < end) {
        unsigned char c0 = *p;
        if (c0 == '"' || c0 == '\\' || c0 < 0x20) break;
        ++p;
      }
      if (p > s0) out.append(s0, (size_t)(p - s0));
      if (p >= end) break;
      unsigned char c = *p;
      if (c == '"') { ++p; return true; }
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (end - p < 4) return false;
            unsigned cp = 0;
            for (int i = 0; i < 4; ++i) {
              char h = *p++;
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else return false;
            }
            if (cp >= 0xD800 && cp <= 0xDBFF) {   // surrogate pair
              if (end - p < 6 || p[0] != '\\' || p[1] != 'u') return false;
              p += 2;
              unsigned lo = 0;
              for (int i = 0; i < 4; ++i) {
                char h = *p++;
                lo <<= 4;
                if (h >= '0' && h <= '9') lo |= h - '0';
                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                else return false;
              }
              if (lo < 0xDC00 || lo > 0xDFFF) return false;
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
              return false;  // lone low surrogate
            }
            // UTF-8 encode
            if (cp < 0x80) out += (char)cp;
            else if (cp < 0x800) {
              out += (char)(0xC0 | (cp >> 6));
              out += (char)(0x80 | (cp & 0x3F));
            } else if (cp < 0x10000) {
              out += (char)(0xE0 | (cp >> 12));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            } else {
              out += (char)(0xF0 | (cp >> 18));
              out += (char)(0x80 | ((cp >> 12) & 0x3F));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            }
            break;
          }
          default: return false;
        }
      } else {
        return false;  // raw control char: json.loads would raise
      }
    }
    return false;  // unterminated
  }

  // Parse an integer (no '.', 'e', leading zeros OK per json? json
  // forbids leading zeros — Python would raise; we return false and
  // bail, matching "Python raises" via fallback). Returns false for
  // floats/overflow: caller decides bail vs. skip.
  bool integer(int64_t& out, bool& is_float) {
    is_float = false;
    const char* s = p;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    if (p >= end || *p < '0' || *p > '9') { p = s; return false; }
    uint64_t v = 0;
    bool over = false;
    while (p < end && *p >= '0' && *p <= '9') {
      if (v > (UINT64_MAX - 9) / 10) over = true;
      v = v * 10 + (uint64_t)(*p - '0');
      ++p;
    }
    // json forbids leading zeros; Python json.loads would raise, so a
    // hard parse failure (-> fallback) keeps behavior identical
    if (p - s - (neg ? 1 : 0) > 1 && *(s + (neg ? 1 : 0)) == '0') {
      p = s;
      return false;
    }
    if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
      // float: consume it with the exact JSON number grammar
      // (frac = '.' digit+, exp = [eE][+-]? digit+). A malformed tail
      // ("1.", "1e+", "1.5e") makes json.loads raise, so it must be a
      // hard parse failure here, not a consumed float.
      if (*p == '.') {
        ++p;
        if (p >= end || *p < '0' || *p > '9') { p = s; return false; }
        while (p < end && *p >= '0' && *p <= '9') ++p;
      }
      if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        if (p < end && (*p == '+' || *p == '-')) ++p;
        if (p >= end || *p < '0' || *p > '9') { p = s; return false; }
        while (p < end && *p >= '0' && *p <= '9') ++p;
      }
      is_float = true;
      return false;
    }
    if (over) return false;
    if (neg) {
      if (v > (uint64_t)INT64_MAX + 1) return false;
      out = (v == (uint64_t)INT64_MAX + 1) ? INT64_MIN : -(int64_t)v;
    } else {
      if (v > (uint64_t)INT64_MAX) return false;
      out = (int64_t)v;
    }
    return true;
  }

  // Skip any JSON value (used for fields the encoder ignores).
  void skip() {
    ws();
    if (p >= end) { bail = true; return; }
    char c = *p;
    if (c == '"') {
      if (!skip_str()) bail = true;
    } else if (c == '{') {
      ++p;
      ws();
      if (eat('}')) return;
      while (true) {
        ws();
        if (p >= end || *p != '"') { bail = true; return; }
        if (!skip_str()) { bail = true; return; }
        if (!eat(':')) { bail = true; return; }
        skip();
        if (bail) return;
        if (eat(',')) continue;
        if (eat('}')) return;
        bail = true;
        return;
      }
    } else if (c == '[') {
      ++p;
      if (eat(']')) return;
      while (true) {
        skip();
        if (bail) return;
        if (eat(',')) continue;
        if (eat(']')) return;
        bail = true;
        return;
      }
    } else if (c == 't') {
      if (!lit("true")) bail = true;
    } else if (c == 'f') {
      if (!lit("false")) bail = true;
    } else if (c == 'n') {
      if (!lit("null")) bail = true;
    } else {
      int64_t dummy;
      bool is_f;
      if (!integer(dummy, is_f) && !is_f) bail = true;
    }
  }
};

// JSON-escape `s` (decoded UTF-8) into `js` so json.loads round-trips
// it to the identical Python str — shared by the encoder's pre-key
// table and the splitter's key table.
void append_json_string(std::string& js, const std::string& s) {
  js += '"';
  for (unsigned char c : s) {
    switch (c) {
      case '"': js += "\\\""; break;
      case '\\': js += "\\\\"; break;
      case '\b': js += "\\b"; break;
      case '\f': js += "\\f"; break;
      case '\n': js += "\\n"; break;
      case '\r': js += "\\r"; break;
      case '\t': js += "\\t"; break;
      default:
        if (c < 0x20) {
          char esc[8];
          snprintf(esc, sizeof esc, "\\u%04x", c);
          js += esc;
        } else {
          js += (char)c;
        }
    }
  }
  js += '"';
}

// ---------------------------------------------------------------- encoder

struct Handle {
  std::vector<int32_t> appends;        // (row, kid, pos) flattened
  std::vector<int32_t> edges;          // wr: (src, dst, type) flattened
  std::vector<int32_t> reads;
  std::vector<int32_t> status;
  std::vector<int32_t> process;
  std::vector<int64_t> invoke_index;
  std::vector<int64_t> complete_index;
  std::vector<int64_t> anomalies;      // (code, f0..f3) flattened
  std::vector<int32_t> kid_to_pre;
  std::string pre_names_json;
  int64_t n = 0, n_keys = 0, max_pos = 0;
  bool wr = false;                     // encode_wr() product
};

struct Encoder {
  // parse products
  std::vector<Op> ops;
  std::vector<Mop> mops;
  std::vector<int64_t> ipool;               // read-list elements
  std::vector<std::string> strs;            // interned key strings
  std::unordered_map<std::string, int32_t> str_ids;
  // pre-key interning (parse order): ints and strings, disjoint spaces
  std::unordered_map<int64_t, int32_t> ikey_ids;
  std::unordered_map<int32_t, int32_t> skey_ids;  // string id -> pre key
  std::vector<std::pair<bool, int64_t>> pre_keys; // (is_str, int | sid)
  // process interning
  std::unordered_map<int64_t, int32_t> iproc_ids;
  std::unordered_map<std::string, int32_t> sproc_ids;
  int32_t null_proc_id = -1;
  int32_t next_proc_id = 0;
  std::string scratch;                      // reused string decode buffers
  std::string scratch2;
  bool wr_mode = false;   // rw-register semantics (encode_wr) vs append

  bool bail = false;

  int32_t intern_key(const TVal& tv) {
    if (tv.kind == VK_INT) {
      auto it = ikey_ids.find(tv.i);
      if (it != ikey_ids.end()) return it->second;
      int32_t id = (int32_t)pre_keys.size();
      ikey_ids.emplace(tv.i, id);
      pre_keys.emplace_back(false, tv.i);
      return id;
    }
    auto it = skey_ids.find(tv.sid);
    if (it != skey_ids.end()) return it->second;
    int32_t id = (int32_t)pre_keys.size();
    skey_ids.emplace(tv.sid, id);
    pre_keys.emplace_back(true, (int64_t)tv.sid);
    return id;
  }

  // Parse one typed mop slot (mf / key / value position). `role`:
  // 0 = mf (string-or-anything; only "r" matters), 1 = key,
  // 2 = value. Fills tv. Returns:
  //   1  ok — tv valid, input consumed
  //   0  unrepresentable type — input consumed, element must bail if
  //      the value turns out txn-shaped (Python would process it with
  //      semantics we don't replicate: bool/float equality, None keys,
  //      string iteration, unhashable raises)
  //  -1  hard JSON error — whole parse fails (Python json raises too)
  int slot(Parser& ps, int role, TVal& tv, bool& is_r, bool& is_w_out) {
    ps.ws();
    if (ps.p >= ps.end) return -1;
    char c = *ps.p;
    if (c == '"') {
      std::string& s = scratch;
      if (!ps.str(s)) return -1;
      if (role == 0) {
        is_r = (s == "r");
        is_w_out = (s == "w");
        tv.kind = VK_NULL;  // only "r"/"w"-ness of mf matters
        return 1;
      }
      if (role == 1) {
        auto it = str_ids.find(s);
        int32_t sid;
        if (it != str_ids.end()) sid = it->second;
        else {
          sid = (int32_t)strs.size();
          str_ids.emplace(s, sid);
          strs.push_back(s);
        }
        tv.kind = VK_STR;
        tv.sid = sid;
        return 1;
      }
      return 0;  // string mop value: Python iterates its characters
    }
    if (c == '[') {
      if (role != 2) {
        ps.skip();
        if (ps.bail) return -1;
        if (role == 0) {          // list mf: any non-"r" value = write
          is_r = false;
          tv.kind = VK_NULL;
          return 1;
        }
        return 0;                 // list key: unhashable, Python raises
      }
      ++ps.p;
      uint32_t off = (uint32_t)ipool.size();
      if (ps.eat(']')) {
        tv.kind = VK_ARR;
        tv.off = off;
        tv.len = 0;
        return 1;
      }
      bool bad_elem = false;
      while (true) {
        ps.ws();
        int64_t v;
        bool is_f;
        if (ps.p < ps.end && ps.integer(v, is_f)) {
          ipool.push_back(v);
        } else if (ps.p < ps.end && is_f) {
          bad_elem = true;        // float element, consumed
        } else {
          // not a plain number: bool/null/str/nested — consume it
          ps.skip();
          if (ps.bail) return -1;
          bad_elem = true;
        }
        if (ps.eat(',')) continue;
        if (ps.eat(']')) break;
        return -1;
      }
      if (bad_elem) {
        ipool.resize(off);
        return 0;                 // non-plain-int read element
      }
      tv.kind = VK_ARR;
      tv.off = off;
      tv.len = (uint32_t)(ipool.size() - off);
      return 1;
    }
    if (c == 'n') {
      if (!ps.lit("null")) return -1;
      if (role == 1) return 0;    // None key: Python handles; we don't
      tv.kind = VK_NULL;
      if (role == 0) is_r = false;
      return 1;
    }
    if (c == 't' || c == 'f') {
      if (!(c == 't' ? ps.lit("true") : ps.lit("false"))) return -1;
      if (role == 0) { is_r = false; tv.kind = VK_NULL; return 1; }
      return 0;                   // bool key/value: True == 1 interning
    }
    if (c == '{') {
      ps.skip();
      if (ps.bail) return -1;
      if (role == 0) { is_r = false; tv.kind = VK_NULL; return 1; }
      return 0;                   // dict key/value
    }
    // number
    int64_t v;
    bool is_f;
    if (!ps.integer(v, is_f)) {
      if (is_f) {
        if (role == 0) { is_r = false; tv.kind = VK_NULL; return 1; }
        return 0;                 // float key/value, consumed
      }
      return -1;                  // malformed number (leading zero etc.)
    }
    if (role == 0) { is_r = false; tv.kind = VK_NULL; return 1; }
    tv.kind = VK_INT;
    tv.i = v;
    return 1;
  }

  // Parse the "value" member: either a txn (list of [mf k v]) or
  // anything else (non-txn: op never pends, content irrelevant).
  // Returns false on hard parse error.
  bool value_member(Parser& ps, Op& op) {
    op.is_txn = false;
    op.list_nontxn = false;
    op.mop_off = 0;
    op.mop_len = 0;
    ps.ws();
    if (ps.p >= ps.end) return false;
    if (*ps.p != '[') {   // not a list: not a txn, skip
      ps.skip();
      return !ps.bail;
    }
    ++ps.p;
    uint32_t m0 = (uint32_t)mops.size();
    uint32_t i0 = (uint32_t)ipool.size();
    bool shaped = true;       // all elements [x y z]?
    bool inner_bad = false;   // some len-3 element had bad inner types
    if (ps.eat(']')) {
      op.is_txn = true;       // [] vacuously satisfies is_txn_op
      op.mop_off = m0;
      return true;
    }
    while (true) {
      ps.ws();
      if (ps.p >= ps.end) return false;
      if (*ps.p != '[') {
        shaped = false;
        ps.skip();
        if (ps.bail) return false;
      } else {
        ++ps.p;
        Mop m;
        bool elem_bad = false;
        int arity = 0;
        ps.ws();
        if (!ps.eat(']')) {
          while (true) {
            if (arity < 3) {
              TVal tv;
              bool is_r = false, is_w = false;
              int rc = slot(ps, arity, tv, is_r, is_w);
              if (rc < 0) return false;
              if (rc == 0) elem_bad = true;
              else if (arity == 0) { m.is_read = is_r; m.is_w = is_w; }
              else if (arity == 1) m.key = tv;
              else m.val = tv;
            } else {
              ps.skip();          // slots past 3: arity breaks txn shape
              if (ps.bail) return false;
            }
            ++arity;
            if (ps.eat(',')) continue;
            if (ps.eat(']')) break;
            return false;
          }
        }
        if (arity != 3) {
          shaped = false;         // is_txn_op needs exactly [x y z]
        } else if (elem_bad) {
          inner_bad = true;
        } else {
          // semantic type gates (Python tolerates these shapes but
          // with object semantics the int64 maps can't replicate).
          // append: mf=="r" reads null-or-int-list, all else writes
          // ints. wr: mf=="w" writes ints, all else reads null-or-
          // scalar-int (INT64_MIN is this module's null sentinel, so
          // a literal INT64_MIN read value must also defer).
          if (wr_mode) {
            if (m.is_w) {
              if (m.val.kind != VK_INT || m.val.i == INT64_MIN)
                inner_bad = true;
            } else if (m.val.kind == VK_INT) {
              if (m.val.i == INT64_MIN) inner_bad = true;
            } else if (m.val.kind != VK_NULL) {
              inner_bad = true;
            }
          } else if (m.is_read) {
            if (m.val.kind != VK_NULL && m.val.kind != VK_ARR)
              inner_bad = true;
          } else if (m.val.kind != VK_INT) {
            inner_bad = true;
          }
          if (m.key.kind != VK_INT && m.key.kind != VK_STR)
            inner_bad = true;
          if (!inner_bad) mops.push_back(m);
        }
      }
      if (ps.eat(',')) continue;
      if (ps.eat(']')) break;
      return false;
    }
    if (!shaped) {
      // not a txn op: drop any tentatively collected mops/ints
      mops.resize(m0);
      ipool.resize(i0);
      op.list_nontxn = true;
      return true;
    }
    op.is_txn = true;
    // Bad inner types are fatal only when these mops are consumed — a
    // committed txn's INVOKE value (commonly ["append", k, null]
    // placeholders) is never read by the encoder, so defer the verdict
    // to row construction.
    op.bad_mops = inner_bad;
    op.mop_off = m0;
    op.mop_len = (uint32_t)(mops.size() - m0);
    return true;
  }

  bool parse_line(const char* s, const char* e, int32_t pos) {
    Parser ps;
    ps.p = s;
    ps.end = e;
    ps.ipool = &ipool;
    ps.spool = &strs;
    ps.ws();
    if (ps.p >= ps.end) return true;  // blank line
    if (*ps.p != '{') return false;   // non-object op: Python raises
    ++ps.p;
    Op op;
    op.pos = pos;
    op.proc_id = -2;  // "no process member" sentinel until resolved
    bool have_proc = false;
    ps.ws();
    if (!ps.eat('}')) {
      while (true) {
        ps.ws();
        if (ps.p >= ps.end || *ps.p != '"') return false;
        std::string& k = scratch;
        if (!ps.str(k)) return false;
        if (!ps.eat(':')) return false;
        if (k == "type") {
          ps.ws();
          if (ps.p < ps.end && *ps.p == '"') {
            std::string t;
            if (!ps.str(t)) return false;
            if (t == "invoke") op.type = T_INVOKE;
            else if (t == "ok") op.type = T_OK;
            else if (t == "fail") op.type = T_FAIL;
            else if (t == "info") op.type = T_INFO;
            else op.type = T_OTHER;
          } else {
            ps.skip();            // non-string type: acts like T_OTHER
            if (ps.bail) return false;
            op.type = T_OTHER;
          }
        } else if (k == "process") {
          have_proc = true;
          ps.ws();
          if (ps.p >= ps.end) return false;
          char c = *ps.p;
          if (c == '"') {
            std::string& s2 = scratch2;
            if (!ps.str(s2)) return false;
            auto it = sproc_ids.find(s2);
            if (it != sproc_ids.end()) op.proc_id = it->second;
            else {
              op.proc_id = next_proc_id++;
              sproc_ids.emplace(s2, op.proc_id);
            }
            op.proc_is_int = false;
          } else if (c == 'n') {
            if (!ps.lit("null")) return false;
            if (null_proc_id < 0) null_proc_id = next_proc_id++;
            op.proc_id = null_proc_id;
            op.proc_is_int = false;
          } else if (c == 't' || c == 'f') {
            bail = true;  // bool process: Python's True == 1 pairing
            return false;
          } else if (c == '-' || (c >= '0' && c <= '9')) {
            int64_t v;
            bool is_f;
            if (!ps.integer(v, is_f)) { bail = true; return false; }
            auto it = iproc_ids.find(v);
            if (it != iproc_ids.end()) op.proc_id = it->second;
            else {
              op.proc_id = next_proc_id++;
              iproc_ids.emplace(v, op.proc_id);
            }
            op.proc_is_int = true;
            op.proc_int = v;
          } else {
            bail = true;  // list/dict process: Python raises (unhashable)
            return false;
          }
        } else if (k == "value") {
          if (!value_member(ps, op)) return false;
        } else {
          ps.skip();
          if (ps.bail) return false;
        }
        if (ps.eat(',')) continue;
        if (ps.eat('}')) break;
        return false;
      }
    }
    ps.ws();
    if (ps.p != ps.end) return false;  // trailing garbage on the line
    if (!have_proc) {
      // o.get("process") is None: same pairing identity as explicit null
      if (null_proc_id < 0) null_proc_id = next_proc_id++;
      op.proc_id = null_proc_id;
    }
    // int32 overflow in the emitted process column would wrap; bail
    if (op.proc_is_int &&
        (op.proc_int > INT32_MAX || op.proc_int < INT32_MIN)) {
      bail = true;
      return false;
    }
    ops.push_back(op);
    return true;
  }

  // The Python loader is read_text().splitlines(): a strict UTF-8
  // decode, then splitting on the full Unicode line-break set, then a
  // ','-rejoin into one JSON array. Matching those semantics exactly
  // at the byte level is where divergence hides, so the fast path
  // narrows its domain instead: any file that is not valid strict
  // UTF-8, or that contains a line separator beyond \n / \r\n / \r
  // (\v \f \x1c \x1d \x1e U+0085 U+2028 U+2029 — on which splitlines
  // would split, possibly MID-STRING with the rejoin corrupting the
  // payload), falls back wholesale so Python can raise or mangle
  // identically.
  static bool utf8_valid_no_exotic_breaks(const unsigned char* b, size_t n) {
    size_t i = 0;
    while (i < n) {
      unsigned char c = b[i];
      if (c < 0x80) {
        if (c == 0x0B || c == 0x0C || c == 0x1C || c == 0x1D || c == 0x1E)
          return false;  // exotic 1-byte separator
        ++i;
      } else if ((c & 0xE0) == 0xC0) {
        if (c < 0xC2 || i + 1 >= n || (b[i + 1] & 0xC0) != 0x80)
          return false;  // overlong or truncated
        if (c == 0xC2 && b[i + 1] == 0x85) return false;  // U+0085 NEL
        i += 2;
      } else if ((c & 0xF0) == 0xE0) {
        if (i + 2 >= n || (b[i + 1] & 0xC0) != 0x80 ||
            (b[i + 2] & 0xC0) != 0x80)
          return false;
        unsigned cp = ((c & 0x0F) << 12) | ((b[i + 1] & 0x3F) << 6) |
                      (b[i + 2] & 0x3F);
        if (cp < 0x800) return false;                     // overlong
        if (cp >= 0xD800 && cp <= 0xDFFF) return false;   // surrogate
        if (cp == 0x2028 || cp == 0x2029) return false;   // LS / PS
        i += 3;
      } else if ((c & 0xF8) == 0xF0) {
        if (i + 3 >= n || (b[i + 1] & 0xC0) != 0x80 ||
            (b[i + 2] & 0xC0) != 0x80 || (b[i + 3] & 0xC0) != 0x80)
          return false;
        unsigned cp = ((c & 0x07) << 18) | ((b[i + 1] & 0x3F) << 12) |
                      ((b[i + 2] & 0x3F) << 6) | (b[i + 3] & 0x3F);
        if (cp < 0x10000 || cp > 0x10FFFF) return false;
        i += 4;
      } else {
        return false;
      }
    }
    return true;
  }

  bool parse_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz < 0) { fclose(f); return false; }
    std::string buf;
    buf.resize((size_t)sz);
    if (sz > 0 && fread(&buf[0], 1, (size_t)sz, f) != (size_t)sz) {
      fclose(f);
      return false;
    }
    fclose(f);
    if (!utf8_valid_no_exotic_breaks(
            (const unsigned char*)buf.data(), buf.size()))
      return false;
    ops.reserve((size_t)(sz / 96) + 8);
    mops.reserve((size_t)(sz / 48) + 8);
    ipool.reserve((size_t)(sz / 24) + 8);
    const char* s = buf.data();
    const char* e = s + buf.size();
    int32_t pos = 0;
    const char* line = s;
    // splitlines framing: '\n', '\r\n', lone '\r' all end a line
    for (const char* q = s; q <= e; ++q) {
      if (q == e || *q == '\n' || *q == '\r') {
        if (q > line) {
          // skip blank lines without consuming an index
          const char* t = line;
          while (t < q && (*t == ' ' || *t == '\t')) ++t;
          if (t < q) {
            if (!parse_line(line, q, pos)) return false;
            ++pos;
          }
        }
        if (q < e && *q == '\r' && q + 1 < e && q[1] == '\n') ++q;
        line = q + 1;
      }
    }
    return !bail;
  }

  // ---------------- shared encode plumbing -----------------------------
  // Both encoders (append and wr) consume identical pairing semantics,
  // anomaly-row framing, and pre-key-name serialization; one copy each
  // so a fix can never land on one mode only.

  struct Row { int32_t inv, comp; uint8_t status; };  // 0 OK, 1 INFO

  // bucket_txn_pairs + row construction; returns false -> fall back
  // (an op whose mops the encoder must consume is unrepresentable).
  bool pair_rows(std::vector<Row>& rows, std::vector<int32_t>& failed) {
    std::vector<std::pair<int32_t, int32_t>> committed;
    std::vector<int32_t> indeterminate;
    std::unordered_map<int32_t, int32_t> pending;
    for (int32_t i = 0; i < (int32_t)ops.size(); ++i) {
      const Op& o = ops[i];
      if (o.type == T_INVOKE) {
        auto it = pending.find(o.proc_id);
        if (it != pending.end()) {
          indeterminate.push_back(it->second);
          pending.erase(it);
        }
        if (o.proc_is_int && o.is_txn) pending[o.proc_id] = i;
        continue;
      }
      auto it = pending.find(o.proc_id);
      if (it == pending.end()) continue;
      int32_t inv = it->second;
      pending.erase(it);
      if (o.type == T_OK) committed.emplace_back(inv, i);
      else if (o.type == T_FAIL) failed.push_back(inv);
      else if (o.type == T_INFO) indeterminate.push_back(inv);
      // T_OTHER: consumed, bucketed nowhere
    }
    for (auto& kv : pending) indeterminate.push_back(kv.second);
    auto bypos = [&](int32_t a, int32_t b) {
      return ops[a].pos < ops[b].pos;
    };
    std::sort(committed.begin(), committed.end(),
              [&](auto& a, auto& b) {
                return ops[a.first].pos < ops[b.first].pos;
              });
    std::sort(indeterminate.begin(), indeterminate.end(), bypos);
    std::sort(failed.begin(), failed.end(), bypos);
    // Fallback gates on ops whose mops the encoder actually consumes:
    // committed rows read the COMPLETION op's value (non-txn-shaped
    // lists make Python's unpacking raise; untypable mops we can't
    // encode), indeterminate and failed rows read their invoke's.
    for (auto& c : committed)
      if (ops[c.second].list_nontxn || ops[c.second].bad_mops)
        return false;
    for (int32_t i : indeterminate)
      if (ops[i].bad_mops) return false;
    for (int32_t i : failed)
      if (ops[i].bad_mops) return false;
    rows.reserve(committed.size() + indeterminate.size());
    for (auto& c : committed) rows.push_back({c.first, c.second, 0});
    for (auto i : indeterminate) rows.push_back({i, i, 1});
    return true;
  }

  void note_row(Handle* h, int64_t code, int64_t f0, int64_t f1,
                int64_t f2, int64_t f3 = 0) {
    h->anomalies.push_back(code);
    h->anomalies.push_back(f0);
    h->anomalies.push_back(f1);
    h->anomalies.push_back(f2);
    h->anomalies.push_back(f3);
  }

  void serialize_pre_names(Handle* h) {
    std::string& js = h->pre_names_json;
    js += '[';
    for (size_t i2 = 0; i2 < pre_keys.size(); ++i2) {
      if (i2) js += ',';
      if (!pre_keys[i2].first)
        js += std::to_string(pre_keys[i2].second);
      else
        append_json_string(js, strs[(size_t)pre_keys[i2].second]);
    }
    js += ']';
  }

  // ---------------- encode (mirrors encode.py's encode_history) --------

  // small helper: row-ordered writes-by-key
  struct WbkEntry { int32_t key; uint32_t off, len; };

  Handle* encode() {
    std::vector<Row> rows;
    std::vector<int32_t> failed;
    if (!pair_rows(rows, failed)) return nullptr;
    const int32_t n = (int32_t)rows.size();

    auto h = std::make_unique<Handle>();
    h->n = n;

    // --- per-row wbk (writes_by_key), insertion-ordered --------------
    std::vector<WbkEntry> wbk;               // all rows, grouped
    std::vector<uint32_t> wbk_row_off(n + 1, 0);
    std::vector<int64_t> wbk_vals;           // grouped per entry
    {
      std::unordered_map<int32_t, uint32_t> slot;  // pre_key -> wbk idx
      std::vector<std::vector<int64_t>> tmp_vals;
      std::vector<int32_t> tmp_keys;
      for (int32_t r = 0; r < n; ++r) {
        slot.clear();
        tmp_vals.clear();
        tmp_keys.clear();
        const Op& src = ops[rows[r].status == 0 ? rows[r].comp : rows[r].inv];
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
          const Mop& mp = mops[m];
          if (mp.is_read) continue;
          int32_t pk = intern_key(mp.key);
          auto it = slot.find(pk);
          uint32_t idx;
          if (it == slot.end()) {
            idx = (uint32_t)tmp_keys.size();
            slot.emplace(pk, idx);
            tmp_keys.push_back(pk);
            tmp_vals.emplace_back();
          } else {
            idx = it->second;
          }
          tmp_vals[idx].push_back(mp.val.i);
        }
        wbk_row_off[r] = (uint32_t)wbk.size();
        for (uint32_t i2 = 0; i2 < tmp_keys.size(); ++i2) {
          WbkEntry e;
          e.key = tmp_keys[i2];
          e.off = (uint32_t)wbk_vals.size();
          e.len = (uint32_t)tmp_vals[i2].size();
          wbk_vals.insert(wbk_vals.end(), tmp_vals[i2].begin(),
                          tmp_vals[i2].end());
          wbk.push_back(e);
        }
      }
      wbk_row_off[n] = (uint32_t)wbk.size();
    }

    auto note = [&](int64_t code, int64_t f0, int64_t f1, int64_t f2,
                    int64_t f3 = 0) {
      note_row(h.get(), code, f0, f1, f2, f3);
    };

    // --- writer_of + duplicate-appends -------------------------------
    std::unordered_map<std::pair<int32_t, int64_t>, int32_t, PairHash>
        writer_of;
    std::unordered_set<std::pair<int32_t, int64_t>, PairHash> multi_append;
    writer_of.reserve(wbk_vals.size() * 2);
    for (int32_t r = 0; r < n; ++r) {
      for (uint32_t wi = wbk_row_off[r]; wi < wbk_row_off[r + 1]; ++wi) {
        const WbkEntry& e = wbk[wi];
        for (uint32_t vi = e.off; vi < e.off + e.len; ++vi) {
          auto key = std::make_pair(e.key, wbk_vals[vi]);
          auto it = writer_of.find(key);
          if (it != writer_of.end()) {
            note(1, e.key, wbk_vals[vi], r);  // duplicate-appends
            multi_append.insert(key);
          } else {
            writer_of.emplace(key, r);
          }
        }
      }
    }
    // failed writes: (key, value) -> failed invoke pos (last wins)
    std::unordered_map<std::pair<int32_t, int64_t>, int32_t, PairHash>
        failed_writes;
    {
      for (int32_t fi : failed) {
        const Op& src = ops[fi];
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
          const Mop& mp = mops[m];
          if (mp.is_read) continue;
          int32_t pk = intern_key(mp.key);
          failed_writes[std::make_pair(pk, mp.val.i)] = src.pos;
        }
      }
    }

    // --- internal check + read collection ----------------------------
    // reads_by_key in first-read order; values referenced by ipool span
    struct ReadRef { int32_t row; uint32_t off, len; };
    std::vector<int32_t> rbk_keys;            // first-read order
    std::vector<std::vector<ReadRef>> rbk;
    std::unordered_map<int32_t, int32_t> rbk_idx;
    {
      // known / appended: pre_key -> list (std::vector<int64_t>)
      std::unordered_map<int32_t, std::vector<int64_t>> known, appended;
      std::vector<int64_t> scratch;
      for (int32_t r = 0; r < n; ++r) {
        if (rows[r].status != 0) continue;
        const Op& src = ops[rows[r].comp];
        // _check_internal
        known.clear();
        appended.clear();
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
          const Mop& mp = mops[m];
          int32_t pk = intern_key(mp.key);
          if (mp.is_read) {
            if (mp.val.kind == VK_NULL) continue;
            auto ki = known.find(pk);
            if (ki != known.end()) {
              const std::vector<int64_t>& exp = ki->second;
              bool eq = exp.size() == mp.val.len;
              if (eq)
                for (uint32_t i2 = 0; i2 < mp.val.len; ++i2)
                  if (ipool[mp.val.off + i2] != exp[i2]) { eq = false; break; }
              if (!eq) note(2, r, pk, 0);      // internal
            } else {
              auto ai = appended.find(pk);
              if (ai != appended.end()) {
                // Python: v[len(v)-len(suffix):] != suffix (a shorter
                // v can never match — negative-start slices stay short)
                const std::vector<int64_t>& suf = ai->second;
                uint32_t vlen = mp.val.len;
                size_t slen = suf.size();
                size_t start = (vlen >= slen) ? (size_t)vlen - slen : 0;
                bool eq = ((size_t)vlen - start == slen);
                if (eq)
                  for (size_t i2 = 0; i2 < slen; ++i2)
                    if (ipool[mp.val.off + start + i2] != suf[i2]) {
                      eq = false;
                      break;
                    }
                if (!eq) note(2, r, pk, 0);    // internal (suffix form)
              }
            }
            // known[k] = observed v; appended.pop(k)
            std::vector<int64_t>& kv2 = known[pk];
            kv2.assign(ipool.begin() + mp.val.off,
                       ipool.begin() + mp.val.off + mp.val.len);
            appended.erase(pk);
          } else {
            auto ki = known.find(pk);
            if (ki != known.end()) ki->second.push_back(mp.val.i);
            else appended[pk].push_back(mp.val.i);
          }
        }
        // read collection + duplicate-elements
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
          const Mop& mp = mops[m];
          if (!mp.is_read || mp.val.kind == VK_NULL) continue;
          int32_t pk = intern_key(mp.key);
          auto it = rbk_idx.find(pk);
          int32_t idx;
          if (it == rbk_idx.end()) {
            idx = (int32_t)rbk_keys.size();
            rbk_idx.emplace(pk, idx);
            rbk_keys.push_back(pk);
            rbk.emplace_back();
          } else {
            idx = it->second;
          }
          rbk[idx].push_back({r, mp.val.off, mp.val.len});
          // duplicate elements (all-int lists: plain set semantics)
          scratch.assign(ipool.begin() + mp.val.off,
                         ipool.begin() + mp.val.off + mp.val.len);
          std::sort(scratch.begin(), scratch.end());
          for (size_t i2 = 1; i2 < scratch.size(); ++i2)
            if (scratch[i2] == scratch[i2 - 1]) {
              note(3, pk, r, 0);               // duplicate-elements
              break;
            }
        }
      }
    }

    // --- version orders ----------------------------------------------
    std::unordered_map<std::pair<int32_t, int64_t>, int32_t, PairHash>
        version_pos;
    struct Chain { int32_t key; uint32_t off, len; };
    std::vector<Chain> chains;  // first-read key order
    for (size_t ki = 0; ki < rbk_keys.size(); ++ki) {
      int32_t pk = rbk_keys[ki];
      const std::vector<ReadRef>& rds = rbk[ki];
      // longest: first strictly-longest
      uint32_t loff = 0, llen = 0;
      for (const ReadRef& rr : rds)
        if (rr.len > llen) { llen = rr.len; loff = rr.off; }
      for (const ReadRef& rr : rds) {
        bool pref = rr.len <= llen;
        if (pref)
          for (uint32_t i2 = 0; i2 < rr.len; ++i2)
            if (ipool[rr.off + i2] != ipool[loff + i2]) { pref = false; break; }
        if (!pref) note(4, pk, rr.row, 0);     // incompatible-order
      }
      chains.push_back({pk, loff, llen});
      for (uint32_t i2 = 0; i2 < llen; ++i2)
        version_pos[std::make_pair(pk, ipool[loff + i2])] = (int32_t)i2 + 1;
      if ((int64_t)llen > h->max_pos) h->max_pos = llen;
    }

    // --- G1a / dirty-update / phantom-read ---------------------------
    for (const Chain& c : chains) {
      for (uint32_t i2 = 0; i2 < c.len; ++i2) {
        int64_t v = ipool[c.off + i2];
        auto key = std::make_pair(c.key, v);
        if (writer_of.count(key)) continue;
        auto fit = failed_writes.find(key);
        if (fit != failed_writes.end()) {
          note(5, c.key, v, fit->second, -1);  // G1a (no reader row)
          if (i2 + 1 < c.len)
            note(6, c.key, v, fit->second);    // dirty-update
        } else {
          note(7, c.key, v, -1);               // phantom-read (no row)
        }
      }
    }

    // --- G1b precomputation: intermediate (key, val, row) ------------
    std::unordered_set<std::tuple<int32_t, int64_t, int32_t>, TripleHash>
        intermediate;
    for (int32_t r = 0; r < n; ++r)
      for (uint32_t wi = wbk_row_off[r]; wi < wbk_row_off[r + 1]; ++wi) {
        const WbkEntry& e = wbk[wi];
        for (uint32_t vi = e.off; vi + 1 < e.off + e.len; ++vi)
          intermediate.insert(std::make_tuple(e.key, wbk_vals[vi], r));
      }

    // --- emission ----------------------------------------------------
    std::unordered_map<int32_t, int32_t> kid_of;  // pre_key -> final kid
    auto kid = [&](int32_t pk) {
      auto it = kid_of.find(pk);
      if (it != kid_of.end()) return it->second;
      int32_t id = (int32_t)h->kid_to_pre.size();
      kid_of.emplace(pk, id);
      h->kid_to_pre.push_back(pk);
      return id;
    };
    h->appends.reserve(wbk_vals.size() * 3);
    for (int32_t r = 0; r < n; ++r) {
      for (uint32_t wi = wbk_row_off[r]; wi < wbk_row_off[r + 1]; ++wi) {
        const WbkEntry& e = wbk[wi];
        for (uint32_t vi = e.off; vi < e.off + e.len; ++vi) {
          auto key = std::make_pair(e.key, wbk_vals[vi]);
          int32_t pos = -1;
          auto it = version_pos.find(key);
          if (it != version_pos.end()) pos = it->second;
          if (multi_append.count(key)) pos = -1;
          h->appends.push_back(r);
          h->appends.push_back(kid(e.key));
          h->appends.push_back(pos);
        }
      }
      if (rows[r].status != 0) continue;
      // ext_reads: first access to a key being a read
      const Op& src = ops[rows[r].comp];
      // seen keys + ordered ext reads
      // (txn key counts are small: a vector scan is fine)
      std::vector<int32_t> seen;
      std::vector<std::pair<int32_t, const Mop*>> ext;
      for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
        const Mop& mp = mops[m];
        int32_t pk = intern_key(mp.key);
        bool was_seen = false;
        for (int32_t s2 : seen)
          if (s2 == pk) { was_seen = true; break; }
        if (mp.is_read && !was_seen) ext.emplace_back(pk, &mp);
        if (!was_seen) seen.push_back(pk);
      }
      for (auto& [pk, mp] : ext) {
        if (mp->val.kind == VK_NULL) continue;
        int32_t pos = (int32_t)mp->val.len;
        if (mp->val.len > 0) {
          int64_t last = ipool[mp->val.off + mp->val.len - 1];
          auto key = std::make_pair(pk, last);
          auto it = version_pos.find(key);
          if (it == version_pos.end() || it->second != pos) pos = -1;
          auto w = writer_of.find(key);
          if (w != writer_of.end() && w->second != r &&
              intermediate.count(std::make_tuple(pk, last, w->second)))
            note(8, pk, r, 0);                 // G1b
        }
        h->reads.push_back(r);
        h->reads.push_back(kid(pk));
        h->reads.push_back(pos);
      }
    }
    h->n_keys = (int64_t)h->kid_to_pre.size();

    // --- scalars ------------------------------------------------------
    h->status.resize(n);
    h->process.resize(n);
    h->invoke_index.resize(n);
    h->complete_index.resize(n);
    for (int32_t r = 0; r < n; ++r) {
      h->status[r] = rows[r].status;
      const Op& inv = ops[rows[r].inv];
      h->process[r] = inv.proc_is_int ? (int32_t)inv.proc_int : -1;
      h->invoke_index[r] = inv.pos;
      h->complete_index[r] = ops[rows[r].comp].pos;
    }

    serialize_pre_names(h.get());
    return h.release();
  }

  // ---------------- encode_wr (mirrors wr.py's encode_wr_history ------
  // with DEFAULT version-order flags: no wfr/sequential/linearizable
  // sources, so the per-key version graph is the star INIT -> written
  // values — always acyclic, no WW edges, and the final edge set is
  // sorted+deduped, making key iteration order immaterial) -------------

  static constexpr int64_t VNULL = INT64_MIN;   // null read sentinel
  static constexpr int64_t NEVER = int64_t(1) << 30;  // NEVER_COMPLETED

  Handle* encode_wr() {
    std::vector<Row> rows;
    std::vector<int32_t> failed;
    if (!pair_rows(rows, failed)) return nullptr;
    const int32_t n = (int32_t)rows.size();

    auto h = std::make_unique<Handle>();
    h->n = n;
    h->wr = true;
    auto note = [&](int64_t code, int64_t f0, int64_t f1, int64_t f2,
                    int64_t f3 = 0) {
      note_row(h.get(), code, f0, f1, f2, f3);
    };

    // --- writer index + intermediates + duplicate-writes -------------
    // writer_of is LAST-writer-wins here (wr.py:202 overwrites), unlike
    // the append encoder's first-wins.
    std::unordered_map<std::pair<int32_t, int64_t>, int32_t, PairHash>
        writer_of;
    // writers_by_key: key -> ordered (value -> row), last write wins
    std::unordered_map<int32_t,
                       std::unordered_map<int64_t, int32_t>> writers_by_key;
    std::unordered_set<std::tuple<int32_t, int64_t, int32_t>, TripleHash>
        intermediate;
    {
      std::unordered_map<int32_t, uint32_t> slot;
      std::vector<int32_t> tmp_keys;
      std::vector<std::vector<int64_t>> tmp_vals;
      for (int32_t r = 0; r < n; ++r) {
        slot.clear();
        tmp_keys.clear();
        tmp_vals.clear();
        const Op& src = ops[rows[r].status == 0 ? rows[r].comp
                                                : rows[r].inv];
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len;
             ++m) {
          const Mop& mp = mops[m];
          if (!mp.is_w) continue;
          int32_t pk = intern_key(mp.key);
          auto it = slot.find(pk);
          uint32_t idx;
          if (it == slot.end()) {
            idx = (uint32_t)tmp_keys.size();
            slot.emplace(pk, idx);
            tmp_keys.push_back(pk);
            tmp_vals.emplace_back();
          } else {
            idx = it->second;
          }
          tmp_vals[idx].push_back(mp.val.i);
        }
        for (uint32_t i2 = 0; i2 < tmp_keys.size(); ++i2) {
          int32_t pk = tmp_keys[i2];
          auto& vals = tmp_vals[i2];
          for (int64_t v : vals) {
            auto key = std::make_pair(pk, v);
            if (writer_of.count(key))
              note(9, pk, v, r);               // duplicate-writes
            writer_of[key] = r;
            writers_by_key[pk][v] = r;
          }
          for (size_t vi = 0; vi + 1 < vals.size(); ++vi)
            intermediate.insert(std::make_tuple(pk, vals[vi], r));
        }
      }
    }
    std::unordered_map<std::pair<int32_t, int64_t>, int32_t, PairHash>
        failed_writes;
    for (int32_t fi : failed) {
      const Op& src = ops[fi];
      for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len; ++m) {
        const Mop& mp = mops[m];
        if (!mp.is_w) continue;
        failed_writes[std::make_pair(intern_key(mp.key), mp.val.i)] =
            src.pos;
      }
    }

    // --- internal + external reads + G1a/phantom/G1b ------------------
    // readers_by_key: key -> value (VNULL for nil) -> reader rows
    std::unordered_map<int32_t,
        std::unordered_map<int64_t, std::vector<int32_t>>> readers_by_key;
    std::unordered_set<int32_t> keys_seen;
    for (auto& kv : writers_by_key) keys_seen.insert(kv.first);
    {
      std::unordered_map<int32_t, int64_t> state;   // _check_internal
      std::unordered_set<int32_t> written, exted;
      std::vector<std::pair<int32_t, int64_t>> ext;  // ordered ext reads
      for (int32_t r = 0; r < n; ++r) {
        if (rows[r].status != 0) continue;
        const Op& src = ops[rows[r].comp];
        state.clear();
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len;
             ++m) {
          const Mop& mp = mops[m];
          int32_t pk = intern_key(mp.key);
          int64_t v = mp.val.kind == VK_NULL ? VNULL : mp.val.i;
          if (mp.is_w) {
            state[pk] = v;
          } else {
            auto it = state.find(pk);
            if (it != state.end() && it->second != v)
              note(2, r, pk, 0);               // internal
            state[pk] = v;
          }
        }
        // ext_reads: first non-"w" access to a key not yet written
        written.clear();
        exted.clear();
        ext.clear();
        for (uint32_t m = src.mop_off; m < src.mop_off + src.mop_len;
             ++m) {
          const Mop& mp = mops[m];
          int32_t pk = intern_key(mp.key);
          if (mp.is_w) {
            written.insert(pk);
          } else if (!written.count(pk) && !exted.count(pk)) {
            exted.insert(pk);
            ext.emplace_back(pk, mp.val.kind == VK_NULL ? VNULL
                                                        : mp.val.i);
          }
        }
        for (auto& [pk, v] : ext) {
          readers_by_key[pk][v].push_back(r);
          keys_seen.insert(pk);
          if (v == VNULL) continue;
          auto key = std::make_pair(pk, v);
          auto w = writer_of.find(key);
          if (w == writer_of.end()) {
            auto fit = failed_writes.find(key);
            if (fit != failed_writes.end())
              note(5, pk, v, fit->second, r);  // G1a
            else
              note(7, pk, v, r);               // phantom-read
          } else if (w->second != r &&
                     intermediate.count(
                         std::make_tuple(pk, v, w->second))) {
            note(8, pk, r, v);                 // G1b
          }
        }
      }
    }
    h->n_keys = (int64_t)keys_seen.size();     // key_count

    // --- dependency edges (default flags: star version graph) ---------
    // WR: writer(v) -> each external reader of v.  RW: each reader of
    // nil -> every writer of the key.  No WW edges (INIT has no
    // writer).  Output = sorted unique triples, as sorted(set(edges)).
    std::vector<std::array<int32_t, 3>> ed;
    for (auto& [pk, by_val] : readers_by_key) {
      auto wit = writers_by_key.find(pk);
      for (auto& [v, rds] : by_val) {
        if (v == VNULL) {
          if (wit == writers_by_key.end()) continue;
          for (auto& [v2, w2] : wit->second)
            for (int32_t rd : rds)
              if (rd != w2)
                ed.push_back(std::array<int32_t, 3>{rd, w2, 2});  // RW
        } else {
          if (wit == writers_by_key.end()) continue;
          auto w = wit->second.find(v);
          if (w == wit->second.end()) continue;
          for (int32_t rd : rds)
            if (rd != w->second)
              ed.push_back(std::array<int32_t, 3>{w->second, rd, 1});  // WR
        }
      }
    }
    std::sort(ed.begin(), ed.end());
    ed.erase(std::unique(ed.begin(), ed.end()), ed.end());
    h->edges.reserve(ed.size() * 3);
    for (auto& e : ed) {
      h->edges.push_back(e[0]);
      h->edges.push_back(e[1]);
      h->edges.push_back(e[2]);
    }

    // --- scalars (complete_index carries the effective transform) -----
    h->status.resize(n);
    h->process.resize(n);
    h->invoke_index.resize(n);
    h->complete_index.resize(n);
    for (int32_t r = 0; r < n; ++r) {
      h->status[r] = rows[r].status;
      const Op& inv = ops[rows[r].inv];
      h->process[r] = inv.proc_is_int ? (int32_t)inv.proc_int : -1;
      h->invoke_index[r] = inv.pos;
      h->complete_index[r] =
          rows[r].status == 1 ? NEVER + r : ops[rows[r].comp].pos;
    }

    serialize_pre_names(h.get());
    return h.release();
  }
};

// ------------------------------------------------------------- key split
//
// Per-op [key value] split ids for jepsen_tpu/independent.py's
// store-wide register sweeps (the jt_ks_* ABI): one pass over
// history.jsonl emits, for every op line, the id of the key its lifted
// value belongs to (-1 for un-lifted ops) plus the interned key table
// in first-seen order — replicating relift_history's lift heuristic
// and subhistories' key ordering exactly, so Python can build the
// per-key subhistories from the op dicts it already loaded without the
// per-op relift/is_tuple walk. Anything whose lift or key-equality
// semantics the int64/string interning can't replicate (float / bool /
// null / compound first elements on a lifted op — Python's 1 == True
// == 1.0 — oversized ints, malformed JSON, exotic line breaks)
// returns NULL and the caller falls back to the pure-Python splitter,
// so this path can never be wrong, only inapplicable.

struct SplitHandle {
  std::vector<int32_t> key_ids;    // per op line; -1 = un-lifted
  std::string key_names_json;      // first-seen order
  int64_t n_keys = 0;
  int64_t lifted = 0;              // did the relift heuristic fire?
};

struct Splitter {
  struct SOp {
    uint8_t key_kind = 0;       // 0 none, 1 int, 2 str, 3 unrepresentable
    int64_t key_i = 0;
    int32_t key_sid = -1;
    bool has_value = false;     // "value" present and non-null
    bool is_list = false;       // value is a JSON array
    bool is_pair = false;       // ... of exactly 2 elements
    bool is_nemesis = false;    // process == "nemesis"
    bool is_ok = false;         // type == "ok"
    bool is_read = false;       // f == "read"
  };
  std::vector<SOp> sops;
  std::vector<std::string> strs;                   // interned key strings
  std::unordered_map<std::string, int32_t> str_ids;
  std::vector<int64_t> ipool;                      // Parser scratch
  std::string scratch, scratch2;

  // value member: records shape (null / list / pair) and the first
  // element as the candidate key. Returns false on hard JSON error.
  bool value_member(Parser& ps, SOp& op) {
    op.has_value = op.is_list = op.is_pair = false;
    op.key_kind = 0;
    ps.ws();
    if (ps.p >= ps.end) return false;
    char c = *ps.p;
    if (c == 'n') {
      // null: o.get("value") is None — no value, never lifts
      return ps.lit("null");
    }
    if (c != '[') {             // scalar / dict / bool / string value
      op.has_value = true;
      ps.skip();
      return !ps.bail;
    }
    ++ps.p;
    op.has_value = true;
    op.is_list = true;
    int n_elems = 0;
    ps.ws();
    if (ps.eat(']')) return true;
    while (true) {
      ps.ws();
      if (ps.p >= ps.end) return false;
      if (n_elems == 0) {
        char c0 = *ps.p;
        if (c0 == '"') {
          std::string& s2 = scratch2;
          if (!ps.str(s2)) return false;
          auto it = str_ids.find(s2);
          if (it != str_ids.end()) op.key_sid = it->second;
          else {
            op.key_sid = (int32_t)strs.size();
            str_ids.emplace(s2, op.key_sid);
            strs.push_back(s2);
          }
          op.key_kind = 2;
        } else if (c0 == '-' || (c0 >= '0' && c0 <= '9')) {
          int64_t v;
          bool is_f;
          if (ps.integer(v, is_f)) {
            op.key_kind = 1;
            op.key_i = v;
          } else if (is_f) {
            op.key_kind = 3;    // float key: Python 1.0 == 1 interning
          } else {
            return false;       // malformed number / int64 overflow
          }
        } else {
          op.key_kind = 3;      // bool / null / list / dict key
          ps.skip();
          if (ps.bail) return false;
        }
      } else {
        ps.skip();              // element count is all that matters
        if (ps.bail) return false;
      }
      ++n_elems;
      if (ps.eat(',')) continue;
      if (ps.eat(']')) break;
      return false;
    }
    op.is_pair = (n_elems == 2);
    return true;
  }

  bool parse_line(const char* s, const char* e) {
    Parser ps;
    ps.p = s;
    ps.end = e;
    ps.ipool = &ipool;
    ps.spool = &strs;
    ps.ws();
    if (ps.p >= ps.end) return true;  // blank
    if (*ps.p != '{') return false;
    ++ps.p;
    SOp op;
    ps.ws();
    if (!ps.eat('}')) {
      while (true) {
        ps.ws();
        if (ps.p >= ps.end || *ps.p != '"') return false;
        std::string& k = scratch;
        if (!ps.str(k)) return false;
        if (!ps.eat(':')) return false;
        ps.ws();
        if (ps.p >= ps.end) return false;
        if (k == "type" || k == "f" || k == "process") {
          if (*ps.p == '"') {
            std::string& v = scratch2;
            if (!ps.str(v)) return false;
            if (k == "type") op.is_ok = (v == "ok");
            else if (k == "f") op.is_read = (v == "read");
            else op.is_nemesis = (v == "nemesis");
          } else {
            // non-string member: never equals the string it's tested
            // against (duplicate members: json.loads keeps the last,
            // so reset rather than keep an earlier string's verdict)
            ps.skip();
            if (ps.bail) return false;
            if (k == "type") op.is_ok = false;
            else if (k == "f") op.is_read = false;
            else op.is_nemesis = false;
          }
        } else if (k == "value") {
          if (!value_member(ps, op)) return false;
        } else {
          ps.skip();
          if (ps.bail) return false;
        }
        if (ps.eat(',')) continue;
        if (ps.eat('}')) break;
        return false;
      }
    }
    ps.ws();
    if (ps.p != ps.end) return false;  // trailing garbage on the line
    sops.push_back(op);
    return true;
  }

  bool parse_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz < 0) { fclose(f); return false; }
    std::string buf;
    buf.resize((size_t)sz);
    if (sz > 0 && fread(&buf[0], 1, (size_t)sz, f) != (size_t)sz) {
      fclose(f);
      return false;
    }
    fclose(f);
    if (!Encoder::utf8_valid_no_exotic_breaks(
            (const unsigned char*)buf.data(), buf.size()))
      return false;
    sops.reserve((size_t)(sz / 96) + 8);
    const char* s = buf.data();
    const char* e = s + buf.size();
    const char* line = s;
    // identical framing to Encoder::parse_file / load_history_dir:
    // '\n', '\r\n', lone '\r' end a line; blank lines consume no index
    for (const char* q = s; q <= e; ++q) {
      if (q == e || *q == '\n' || *q == '\r') {
        if (q > line) {
          const char* t = line;
          while (t < q && (*t == ' ' || *t == '\t')) ++t;
          if (t < q && !parse_line(line, q)) return false;
        }
        if (q < e && *q == '\r' && q + 1 < e && q[1] == '\n') ++q;
        line = q + 1;
      }
    }
    return true;
  }

  SplitHandle* split() {
    // relift_history's heuristic, applied to the raw JSON shapes:
    // every non-null client (non-nemesis) value must be a 2-element
    // list, at least one must exist, and some client ok-read must
    // carry a list value — otherwise nothing lifts and every op is
    // un-lifted (subhistories then returns {}).
    bool any_val = false, all_pairs = true, any_okread = false;
    for (const SOp& o : sops) {
      if (o.is_nemesis) continue;
      if (o.has_value) {
        any_val = true;
        if (!o.is_pair) all_pairs = false;
      }
      if (o.is_ok && o.is_read && o.is_list) any_okread = true;
    }
    const bool lifted = any_val && all_pairs && any_okread;
    auto h = std::make_unique<SplitHandle>();
    h->key_ids.assign(sops.size(), -1);
    h->lifted = lifted ? 1 : 0;
    h->key_names_json = "[]";
    if (!lifted) return h.release();
    std::unordered_map<int64_t, int32_t> ikeys;
    std::unordered_map<int32_t, int32_t> skeys;
    std::vector<std::pair<bool, int64_t>> keys;  // (is_str, int | sid)
    for (size_t i = 0; i < sops.size(); ++i) {
      const SOp& o = sops[i];
      if (o.is_nemesis || !o.is_pair) continue;
      int32_t id;
      if (o.key_kind == 1) {
        auto it = ikeys.find(o.key_i);
        if (it != ikeys.end()) id = it->second;
        else {
          id = (int32_t)keys.size();
          ikeys.emplace(o.key_i, id);
          keys.emplace_back(false, o.key_i);
        }
      } else if (o.key_kind == 2) {
        auto it = skeys.find(o.key_sid);
        if (it != skeys.end()) id = it->second;
        else {
          id = (int32_t)keys.size();
          skeys.emplace(o.key_sid, id);
          keys.emplace_back(true, (int64_t)o.key_sid);
        }
      } else {
        return nullptr;  // unrepresentable key on a lifted op
      }
      h->key_ids[i] = id;
    }
    h->n_keys = (int64_t)keys.size();
    std::string& js = h->key_names_json;
    js.clear();
    js += '[';
    for (size_t i = 0; i < keys.size(); ++i) {
      if (i) js += ',';
      if (!keys[i].first) js += std::to_string(keys[i].second);
      else append_json_string(js, strs[(size_t)keys[i].second]);
    }
    js += ']';
    return h.release();
  }
};

}  // namespace

// ------------------------------------------------- encoded.v1 sidecar
//
// Flat persistent cache of one encode (jepsen_tpu/store.py's
// save_encoded/load_encoded layout): magic "JTENC01\n", int64 LE
// header length, JSON header, zero pad to 64, then each tensor raw at
// the 64-aligned offset its header entry records (relative to
// align64(16 + header_len)). The key is the history file's
// (size, mtime_ns, xxh64 over first+last 64KiB) — identical to the
// Python side's bounded_file_xxh64, so either writer's sidecar
// validates under either reader. Anomalies are stored as raw
// (code,f0..f3) rows + the pre-key name table; the Python loader
// rebuilds lean witnesses with the same _witness mapping the
// in-process native path uses, so cache-loaded and freshly-encoded
// anomalies are identical by construction.

static constexpr uint64_t XP1 = 0x9E3779B185EBCA87ULL;
static constexpr uint64_t XP2 = 0xC2B2AE3D27D4EB4FULL;
static constexpr uint64_t XP3 = 0x165667B19E3779F9ULL;
static constexpr uint64_t XP4 = 0x85EBCA77C2B2AE63ULL;
static constexpr uint64_t XP5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t xrotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t xread64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;   // little-endian hosts only (same as the tensor ABI)
}

static inline uint64_t xread32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed,
             v4 = seed - XP1;
    const uint8_t* lim = end - 32;
    do {
      v1 = xrotl(v1 + xread64(p) * XP2, 31) * XP1; p += 8;
      v2 = xrotl(v2 + xread64(p) * XP2, 31) * XP1; p += 8;
      v3 = xrotl(v3 + xread64(p) * XP2, 31) * XP1; p += 8;
      v4 = xrotl(v4 + xread64(p) * XP2, 31) * XP1; p += 8;
    } while (p <= lim);
    h = xrotl(v1, 1) + xrotl(v2, 7) + xrotl(v3, 12) + xrotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4})
      h = (h ^ (xrotl(v * XP2, 31) * XP1)) * XP1 + XP4;
  } else {
    h = seed + XP5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= xrotl(xread64(p) * XP2, 31) * XP1;
    h = xrotl(h, 27) * XP1 + XP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= xread32(p) * XP1;
    h = xrotl(h, 23) * XP2 + XP3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * XP5;
    h = xrotl(h, 11) * XP1;
  }
  h ^= h >> 33; h *= XP2;
  h ^= h >> 29; h *= XP3;
  h ^= h >> 32;
  return h;
}

static constexpr int64_t HASH_SPAN = 64 * 1024;  // store.py's _HASH_SPAN

// (size, mtime_ns, bounded xxh64) of one file; false if unreadable.
static bool file_cache_key(const char* path, int64_t& size,
                           int64_t& mtime_ns, uint64_t& hash) {
  struct stat st;
  if (stat(path, &st) != 0) return false;
  size = (int64_t)st.st_size;
  mtime_ns = (int64_t)st.st_mtim.tv_sec * 1000000000LL
      + (int64_t)st.st_mtim.tv_nsec;
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> buf;
  bool ok = true;
  if (size <= 2 * HASH_SPAN) {
    buf.resize((size_t)size);
    ok = size == 0 || fread(buf.data(), 1, (size_t)size, f)
        == (size_t)size;
  } else {
    buf.resize((size_t)(2 * HASH_SPAN));
    ok = fread(buf.data(), 1, (size_t)HASH_SPAN, f)
        == (size_t)HASH_SPAN
        && fseek(f, (long)(size - HASH_SPAN), SEEK_SET) == 0
        && fread(buf.data() + HASH_SPAN, 1, (size_t)HASH_SPAN, f)
        == (size_t)HASH_SPAN;
  }
  fclose(f);
  if (!ok) return false;
  hash = xxh64(buf.data(), buf.size(), 0);
  return true;
}

static inline int64_t align64(int64_t n) { return (n + 63) & ~63LL; }

struct SidecarArray {
  const char* name;
  const void* data;
  int64_t rows, cols;      // cols 0 => 1-D [rows]
  int elem;                // bytes per element (4 or 8)
};

static void sc_entry(std::string& js, const SidecarArray& a,
                     int64_t off) {
  js += '"'; js += a.name; js += "\":[";
  js += std::to_string(off);
  js += ",[";
  js += std::to_string(a.rows);
  if (a.cols) { js += ','; js += std::to_string(a.cols); }
  js += "],\"";
  js += a.elem == 4 ? "<i4" : "<i8";
  js += "\"]";
}

// Dispatch-padding multiples — MUST match store.py's _PAD_TXNS /
// _PAD_MINOR (themselves mirrors of kernels.BatchShape.plan).
static constexpr int64_t PAD_TXNS = 128;
static constexpr int64_t PAD_MINOR = 8;
static constexpr int64_t SC_NEVER = int64_t(1) << 30;  // NEVER_COMPLETED

static inline int64_t pad_up(int64_t x, int64_t m) {
  int64_t p = ((x + m - 1) / m) * m;
  return p < m ? m : p;
}

static bool write_sidecar(Handle* h, const char* hist_path,
                          const char* out_path, int64_t version) {
  int64_t size, mtime_ns;
  uint64_t hash;
  if (h->wr) version = 1;   // wr has no dispatch-shaped format
  if (!file_cache_key(hist_path, size, mtime_ns, hash)) return false;
  const char* base = strrchr(hist_path, '/');
  base = base ? base + 1 : hist_path;

  // v2 (append): the device-facing tensors persisted PRE-PADDED to the
  // singleton bucket geometry (store.py's dispatch_pad_plan), dead
  // triples/process rows filled -1, dead index rows 0, plus the two
  // int32 dispatch tensors pack_batch would otherwise compute per
  // sweep (invoke keys, EFFECTIVE completion keys). The lean arrays
  // the Python loader slices out of them stay byte-identical to v1's.
  int64_t t_pad = pad_up(h->n, PAD_TXNS);
  int64_t a_pad = pad_up((int64_t)(h->appends.size() / 3), PAD_MINOR);
  int64_t r_pad = pad_up((int64_t)(h->reads.size() / 3), PAD_MINOR);
  std::vector<int32_t> appends_p, reads_p, process_p, d_invoke,
      d_complete;
  if (version == 2) {
    appends_p.assign((size_t)(a_pad * 3), -1);
    std::copy(h->appends.begin(), h->appends.end(), appends_p.begin());
    reads_p.assign((size_t)(r_pad * 3), -1);
    std::copy(h->reads.begin(), h->reads.end(), reads_p.begin());
    process_p.assign((size_t)t_pad, -1);
    std::copy(h->process.begin(), h->process.end(), process_p.begin());
    d_invoke.assign((size_t)t_pad, 0);
    d_complete.assign((size_t)t_pad, 0);
    for (int64_t r = 0; r < h->n; ++r) {
      d_invoke[(size_t)r] = (int32_t)h->invoke_index[(size_t)r];
      d_complete[(size_t)r] = (int32_t)(
          h->status[(size_t)r] == 1 ? SC_NEVER + r
                                    : h->complete_index[(size_t)r]);
    }
  }

  std::vector<SidecarArray> arrays;
  if (h->wr) {
    arrays.push_back({"edges", h->edges.data(),
                      (int64_t)(h->edges.size() / 3), 3, 4});
  } else if (version == 2) {
    arrays.push_back({"appends", appends_p.data(), a_pad, 3, 4});
    arrays.push_back({"reads", reads_p.data(), r_pad, 3, 4});
  } else {
    arrays.push_back({"appends", h->appends.data(),
                      (int64_t)(h->appends.size() / 3), 3, 4});
    arrays.push_back({"reads", h->reads.data(),
                      (int64_t)(h->reads.size() / 3), 3, 4});
  }
  arrays.push_back({"status", h->status.data(),
                    (int64_t)h->status.size(), 0, 4});
  if (version == 2)
    arrays.push_back({"process", process_p.data(), t_pad, 0, 4});
  else
    arrays.push_back({"process", h->process.data(),
                      (int64_t)h->process.size(), 0, 4});
  arrays.push_back({"invoke_index", h->invoke_index.data(),
                    (int64_t)h->invoke_index.size(), 0, 8});
  arrays.push_back({"complete_index", h->complete_index.data(),
                    (int64_t)h->complete_index.size(), 0, 8});
  if (version == 2) {
    arrays.push_back({"d_invoke", d_invoke.data(), t_pad, 0, 4});
    arrays.push_back({"d_complete", d_complete.data(), t_pad, 0, 4});
  }
  arrays.push_back({"anom", h->anomalies.data(),
                    (int64_t)(h->anomalies.size() / 5), 5, 8});
  if (!h->wr)
    arrays.push_back({"kid_to_pre", h->kid_to_pre.data(),
                      (int64_t)h->kid_to_pre.size(), 0, 4});

  std::vector<int64_t> offs(arrays.size());
  int64_t off = 0;
  for (size_t i = 0; i < arrays.size(); ++i) {
    off = align64(off);
    offs[i] = off;
    off += arrays[i].rows * (arrays[i].cols ? arrays[i].cols : 1)
        * arrays[i].elem;
  }

  char keybuf[17];
  snprintf(keybuf, sizeof keybuf, "%016llx",
           (unsigned long long)hash);
  std::string js = "{\"v\":";
  js += std::to_string(version);
  js += ",\"checker\":\"";
  js += h->wr ? "wr" : "append";
  js += "\",\"src\":";
  append_json_string(js, std::string(base));
  js += ",\"key\":{\"size\":";
  js += std::to_string(size);
  js += ",\"mtime_ns\":";
  js += std::to_string(mtime_ns);
  js += ",\"xxh64\":\"";
  js += keybuf;
  js += "\"},\"arrays\":{";
  for (size_t i = 0; i < arrays.size(); ++i) {
    if (i) js += ',';
    sc_entry(js, arrays[i], offs[i]);
  }
  js += "},\"pre_names\":";
  js += h->pre_names_json.empty() ? "[]" : h->pre_names_json;
  js += ",\"n\":";
  js += std::to_string(h->n);
  if (h->wr) {
    js += ",\"key_count\":";
    js += std::to_string(h->n_keys);
  } else {
    js += ",\"n_keys\":";
    js += std::to_string(h->n_keys);
    js += ",\"max_pos\":";
    js += std::to_string(h->max_pos);
  }
  if (version == 2) {
    js += ",\"pad\":{\"n_txns\":";
    js += std::to_string(t_pad);
    js += ",\"n_appends\":";
    js += std::to_string(a_pad);
    js += ",\"n_reads\":";
    js += std::to_string(r_pad);
    js += ",\"n_keys\":";
    js += std::to_string(pad_up(h->n_keys, PAD_MINOR));
    js += ",\"max_pos\":";
    js += std::to_string(pad_up(h->max_pos, PAD_MINOR));
    js += "},\"lens\":{\"appends\":";
    js += std::to_string((int64_t)(h->appends.size() / 3));
    js += ",\"reads\":";
    js += std::to_string((int64_t)(h->reads.size() / 3));
    js += '}';
  }
  js += '}';

  const char MAGIC[8] = {'J', 'T', 'E', 'N', 'C', '0',
                         version == 2 ? '2' : '1', '\n'};
  int64_t hlen = (int64_t)js.size();
  int64_t data_start = align64(16 + hlen);

  std::string tmp = std::string(out_path) + ".tmp."
      + std::to_string((long long)getpid());
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return false;
  static const char zeros[64] = {0};
  bool ok = fwrite(MAGIC, 1, 8, f) == 8
      && fwrite(&hlen, 8, 1, f) == 1
      && fwrite(js.data(), 1, js.size(), f) == js.size()
      && fwrite(zeros, 1, (size_t)(data_start - 16 - hlen), f)
      == (size_t)(data_start - 16 - hlen);
  int64_t pos = 0;
  for (size_t i = 0; ok && i < arrays.size(); ++i) {
    int64_t aligned = align64(pos);
    if (aligned > pos)
      ok = fwrite(zeros, 1, (size_t)(aligned - pos), f)
          == (size_t)(aligned - pos);
    int64_t nbytes = arrays[i].rows
        * (arrays[i].cols ? arrays[i].cols : 1) * arrays[i].elem;
    if (ok && nbytes)
      ok = fwrite(arrays[i].data, 1, (size_t)nbytes, f)
          == (size_t)nbytes;
    pos = aligned + nbytes;
  }
  ok = (fclose(f) == 0) && ok;
  if (!ok) { remove(tmp.c_str()); return false; }
  if (rename(tmp.c_str(), out_path) != 0) {
    remove(tmp.c_str());
    return false;
  }
  if (version == 2) {
    // retire the run's v1 sidecar, mirroring the Python writer: two
    // sidecars answering the same key doubles the invalidation
    // surface for no benefit
    std::string v1(out_path);
    size_t pos = v1.rfind(".v2.bin");
    if (pos != std::string::npos) {
      v1.replace(pos, 7, ".v1.bin");
      remove(v1.c_str());
    }
  }
  return true;
}

extern "C" {

int64_t jt_ha_abi_version() { return 5; }

uint64_t jt_xxh64_buf(const uint8_t* p, int64_t n, uint64_t seed) {
  return xxh64(p, (size_t)n, seed);
}

// Write the encoded sidecar for `hp` straight from the handle's
// buffers (no Python round-trip); 1 on success, 0 on any failure.
// ABI v5: `version` selects the layout — 1 = lean arrays, 2 =
// dispatch-shaped (append only; wr silently writes v1, matching the
// Python side's sidecar_version()).
int64_t jt_ha_write_sidecar(void* hp, const char* hist_path,
                            const char* out_path, int64_t version) {
  return write_sidecar((Handle*)hp, hist_path, out_path,
                       version == 2 ? 2 : 1) ? 1 : 0;
}

void* jt_ha_encode_file(const char* path) {
  Encoder enc;
  if (!enc.parse_file(path)) return nullptr;
  if (enc.bail) return nullptr;
  return enc.encode();
}

void* jt_wr_encode_file(const char* path) {
  Encoder enc;
  enc.wr_mode = true;
  if (!enc.parse_file(path)) return nullptr;
  if (enc.bail) return nullptr;
  return enc.encode_wr();
}

void jt_ha_dims(void* hp, int64_t out[8]) {
  Handle* h = (Handle*)hp;
  out[0] = h->n;
  out[1] = h->n_keys;
  out[2] = h->max_pos;
  out[3] = (int64_t)(h->appends.size() / 3);
  out[4] = (int64_t)(h->reads.size() / 3);
  out[5] = (int64_t)(h->anomalies.size() / 5);
  out[6] = (int64_t)h->pre_names_json.size();
  out[7] = (int64_t)(h->edges.size() / 3);
}

const int32_t* jt_ha_appends(void* hp) { return ((Handle*)hp)->appends.data(); }
const int32_t* jt_ha_edges(void* hp) { return ((Handle*)hp)->edges.data(); }
const int32_t* jt_ha_reads(void* hp) { return ((Handle*)hp)->reads.data(); }
const int32_t* jt_ha_status(void* hp) { return ((Handle*)hp)->status.data(); }
const int32_t* jt_ha_process(void* hp) { return ((Handle*)hp)->process.data(); }
const int32_t* jt_ha_kid_to_pre(void* hp) {
  return ((Handle*)hp)->kid_to_pre.data();
}
const int64_t* jt_ha_invoke_index(void* hp) {
  return ((Handle*)hp)->invoke_index.data();
}
const int64_t* jt_ha_complete_index(void* hp) {
  return ((Handle*)hp)->complete_index.data();
}
const int64_t* jt_ha_anomalies(void* hp) {
  return ((Handle*)hp)->anomalies.data();
}
const char* jt_ha_pre_key_names_json(void* hp) {
  return ((Handle*)hp)->pre_names_json.c_str();
}

void jt_ha_free(void* hp) { delete (Handle*)hp; }

// -- per-key split (jt_ks_*) ---------------------------------------------

void* jt_ks_split_file(const char* path) {
  Splitter sp;
  if (!sp.parse_file(path)) return nullptr;
  return sp.split();   // may itself be NULL (unrepresentable key)
}

void jt_ks_dims(void* hp, int64_t out[4]) {
  SplitHandle* h = (SplitHandle*)hp;
  out[0] = (int64_t)h->key_ids.size();   // n ops
  out[1] = h->n_keys;
  out[2] = (int64_t)h->key_names_json.size();
  out[3] = h->lifted;
}

const int32_t* jt_ks_key_ids(void* hp) {
  return ((SplitHandle*)hp)->key_ids.data();
}

const char* jt_ks_key_names_json(void* hp) {
  return ((SplitHandle*)hp)->key_names_json.c_str();
}

void jt_ks_free(void* hp) { delete (SplitHandle*)hp; }

}  // extern "C"
