// Native columnar JSONL event scanner, COO group-by and cooccurrence top-N:
// the port's host library (predictionio_tpu_torch/utils/native.py loads it;
// ops/_build.py builds it with g++ on first use). A copy of the JAX
// package's native/pio_scan.cpp with one deliberate change: pio_scan_file
// stops at a last line without its '\n', a row another writer is still
// appending, as the port's python scan (data/storage/jsonl.py) does.
//
// Role: the bulk-ingest hot path of training feeds — the predictionio_tpu
// analog of the reference's JVM-side storage scan layer (JdbcRDD /
// TableInputFormat partitions feeding Spark). Scans an events JSONL file
// (one wire-format event object per line), filters by event name, and
// dictionary-encodes entity/target ids into dense int32 columns with a
// float32 rating column — the exact layout `PEvents.to_columnar` produces —
// at C++ speed, without materializing Python objects per row.
//
// Exposed C ABI (ctypes):
//   pio_scan_file(path, event_names_csv, rating_key) -> handle
//   accessor functions to copy out columns / vocabularies
//   pio_scan_free(handle)
//
// The parser is specialized for the event wire format: a flat JSON object
// whose relevant keys ("event", "entityId", "targetEntityId", "eventTime",
// "properties") sit at the top level. It handles string escapes and nested
// objects/arrays inside "properties" correctly by brace matching with
// string-state tracking.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Columns {
  std::vector<int32_t> entity_ids;
  std::vector<int32_t> target_ids;
  std::vector<int32_t> event_codes;
  std::vector<double> timestamps;
  std::vector<float> ratings;
  std::vector<std::string> entity_vocab;
  std::vector<std::string> target_vocab;
  std::vector<std::string> event_vocab;
  std::vector<std::string> row_ids;  // per-row event id ("" when absent)
  std::string error;
};

// Raw parsed row, interned against full (pre-compaction) vocabularies.
struct RawRow {
  int32_t entity;
  int32_t target;  // -1 = absent
  int32_t event;
  double ts;
  float rating;
  bool passes;  // filter verdict of the LATEST version of this row
  std::string id;
};

// --- minimal JSON helpers (specialized, no external deps) -----------------

// Find the value start for "key" at the TOP level of the object starting at
// `line`. Returns nullptr if absent. `end` bounds the scan (nullptr = until
// NUL), enabling lookups scoped to a nested object's extent.
const char* find_top_level_value(const char* line, const char* key,
                                 const char* end = nullptr) {
  size_t keylen = strlen(key);
  int depth = 0;
  bool in_str = false;
  const char* p = line;
  while (*p && (!end || p < end)) {
    char c = *p;
    if (in_str) {
      if (c == '\\' && p[1]) { p += 2; continue; }
      if (c == '"') in_str = false;
      ++p;
      continue;
    }
    switch (c) {
      case '"': {
        if (depth == 1) {
          // possible key
          const char* kstart = p + 1;
          const char* q = kstart;
          bool esc = false;
          while (*q && (esc || *q != '"')) { esc = (!esc && *q == '\\'); ++q; }
          if (*q == '"') {
            size_t klen = q - kstart;
            const char* after = q + 1;
            while (*after == ' ' || *after == '\t') ++after;
            if (*after == ':' && klen == keylen && strncmp(kstart, key, keylen) == 0) {
              ++after;
              while (*after == ' ' || *after == '\t') ++after;
              return after;
            }
            p = q + 1;
            continue;
          }
        }
        in_str = true;
        ++p;
        continue;
      }
      case '{': case '[': ++depth; break;
      case '}': case ']': --depth; break;
      default: break;
    }
    ++p;
  }
  return nullptr;
}

// Return the pointer one past the matching close of the object/array at `p`
// (which must point at '{' or '['), or nullptr on malformed input.
const char* object_end(const char* p) {
  if (*p != '{' && *p != '[') return nullptr;
  int depth = 0;
  bool in_str = false;
  while (*p) {
    char c = *p;
    if (in_str) {
      if (c == '\\' && p[1]) { p += 2; continue; }
      if (c == '"') in_str = false;
    } else if (c == '"') {
      in_str = true;
    } else if (c == '{' || c == '[') {
      ++depth;
    } else if (c == '}' || c == ']') {
      --depth;
      if (depth == 0) return p + 1;
    }
    ++p;
  }
  return nullptr;
}

// 4 hex digits at p -> value, or -1 when invalid/truncated (also the
// bounds check: a NUL inside the window fails the digit test, so a line
// ending mid-escape can never walk the cursor past the buffer).
int hex4(const char* p) {
  int v = 0;
  for (int i = 0; i < 4; ++i) {
    char c = p[i];
    int d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else return -1;
    v = (v << 4) | d;
  }
  return v;
}

void append_utf8(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Parse a JSON string value at `p` into out; returns true on success.
// \uXXXX escapes are DECODED to UTF-8 (incl. surrogate pairs): the JSONL
// writer uses json.dumps' default ensure_ascii=True, so every non-ASCII id
// is stored escaped, and the python read path (json.loads) decodes it —
// keeping the escape verbatim made the two scan paths intern different
// vocab strings for the same id. Lone surrogates fail the parse (treated
// as a malformed value, like any truncated escape).
bool parse_string(const char* p, std::string* out) {
  if (*p != '"') return false;
  ++p;
  out->clear();
  while (*p && *p != '"') {
    if (*p == '\\' && p[1]) {
      ++p;
      switch (*p) {
        case 'n': out->push_back('\n'); break;
        case 't': out->push_back('\t'); break;
        case 'r': out->push_back('\r'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'u': {
          int v = hex4(p + 1);
          if (v < 0) return false;
          uint32_t cp = static_cast<uint32_t>(v);
          p += 4;  // at the last hex digit; the trailing ++p advances past
          if (cp >= 0xD800 && cp <= 0xDBFF) {
            // high surrogate: a \uXXXX low surrogate must follow
            if (p[1] != '\\' || p[2] != 'u') return false;
            int lo = hex4(p + 3);
            if (lo < 0xDC00 || lo > 0xDFFF) return false;
            cp = 0x10000 + ((cp - 0xD800) << 10) +
                 (static_cast<uint32_t>(lo) - 0xDC00);
            p += 6;
          } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
            return false;  // lone low surrogate
          }
          append_utf8(out, cp);
          break;
        }
        default: out->push_back(*p); break;
      }
      ++p;
    } else {
      out->push_back(*p);
      ++p;
    }
  }
  return *p == '"';
}

// ISO8601 -> epoch seconds (UTC). Handles "YYYY-MM-DDTHH:MM:SS(.mmm)?(Z|+HH:MM)".
double parse_iso8601(const std::string& s) {
  int y, mo, d, h, mi;
  double sec = 0;
  if (s.size() < 19) return 0.0;
  if (sscanf(s.c_str(), "%d-%d-%dT%d:%d:%lf", &y, &mo, &d, &h, &mi, &sec) != 6)
    return 0.0;
  // days since epoch (civil algorithm)
  int yy = y - (mo <= 2);
  int era = (yy >= 0 ? yy : yy - 399) / 400;
  unsigned yoe = static_cast<unsigned>(yy - era * 400);
  unsigned doy = (153 * (mo + (mo > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  long days = era * 146097L + static_cast<long>(doe) - 719468L;
  double ts = days * 86400.0 + h * 3600.0 + mi * 60.0 + sec;
  // timezone suffix: "+HH:MM", compact "+HHMM", or bare "+HH" — python's
  // fromisoformat accepts all three, so the native parse must agree (the
  // %d:%d sscanf read "+0530" as 530 HOURS)
  size_t zpos = s.find_last_of("Z+-");
  if (zpos != std::string::npos && zpos >= 19 && s[zpos] != 'Z') {
    const char* z = s.c_str() + zpos + 1;
    int oh = 0, om = 0, osec = 0;
    if (strchr(z, ':')) {
      // colon form must be exactly HH:MM or HH:MM:SS (2-digit fields) —
      // fromisoformat rejects "+5:30"/"+05:3", and sscanf would happily
      // parse them; agree with the python path (malformed row)
      size_t zlen = strlen(z);
      if (zlen != 5 && zlen != 8) return 0.0;
      for (size_t i = 0; i < zlen; ++i) {
        bool want_colon = (i == 2 || i == 5);
        if (want_colon ? z[i] != ':'
                       : !isdigit(static_cast<unsigned char>(z[i])))
          return 0.0;
      }
      sscanf(z, "%d:%d:%d", &oh, &om, &osec);  // ":SS" optional
    } else {
      // compact form must be exactly HH, HHMM or HHMMSS, all digits —
      // python's fromisoformat accepts those three and rejects e.g.
      // "+530", which atoi would otherwise read as 530 HOURS; agree with
      // the python path by treating anything else as a malformed row
      size_t zlen = strlen(z);
      if (zlen != 2 && zlen != 4 && zlen != 6) return 0.0;
      for (size_t i = 0; i < zlen; ++i)
        if (!isdigit(static_cast<unsigned char>(z[i]))) return 0.0;
      long v = atol(z);
      if (zlen == 6) { oh = v / 10000; om = (v / 100) % 100; osec = v % 100; }
      else if (zlen == 4) { oh = v / 100; om = v % 100; }
      else oh = v;
    }
    double off = oh * 3600.0 + om * 60.0 + osec;
    ts += (s[zpos] == '-') ? off : -off;
  }
  return ts;
}

int32_t encode(const std::string& v,
               std::unordered_map<std::string, int32_t>* index,
               std::vector<std::string>* vocab) {
  auto it = index->find(v);
  if (it != index->end()) return it->second;
  int32_t id = static_cast<int32_t>(vocab->size());
  index->emplace(v, id);
  vocab->push_back(v);
  return id;
}

// Dense-matrix cooccurrence accumulation + top-N select, shared by the
// uint16 (user count < 65535, half the cache traffic) and int32 widths.
// Input contract and output layout documented at pio_cooccur_topn below.
template <typename CT>
static int32_t cooccur_accumulate(const int32_t* __restrict users,
                                  const int32_t* __restrict items,
                                  int64_t nnz, int32_t n_items, int32_t top_n,
                                  int32_t* __restrict out_items,
                                  int32_t* __restrict out_counts) {
  // calloc, not a zero-filled vector: the kernel hands back zero pages
  // without touching ~27-54MB (ML-1M vocab) up front — first-touch
  // faults amortize into the accumulation pass
  CT* C = static_cast<CT*>(
      calloc(static_cast<size_t>(n_items) * n_items, sizeof(CT)));
  if (C == nullptr) return 3;
  int64_t pos = 0;
  while (pos < nnz) {
    const int32_t u = users[pos];
    int64_t end = pos;
    while (end < nnz && users[end] == u) ++end;
    for (int64_t a = pos; a < end; ++a) {
      CT* __restrict row = C + static_cast<size_t>(items[a]) * n_items;
      for (int64_t b = pos; b < end; ++b) row[items[b]]++;
    }
    pos = end;
  }
  // zero the diagonal (item self-count) once so the hot select loop below
  // needs no per-iteration j==i test
  for (int32_t i = 0; i < n_items; ++i)
    C[static_cast<size_t>(i) * n_items + i] = 0;
  for (int32_t i = 0; i < n_items; ++i) {
    const CT* row = C + static_cast<size_t>(i) * n_items;
    int32_t* oi = out_items + static_cast<size_t>(i) * top_n;
    int32_t* oc = out_counts + static_cast<size_t>(i) * top_n;
    for (int32_t k = 0; k < top_n; ++k) { oi[k] = -1; oc[k] = 0; }
    int32_t filled = 0;
    for (int32_t j = 0; j < n_items; ++j) {
      const int32_t c = static_cast<int32_t>(row[j]);
      if (c <= 0) continue;
      // scanning j ascending + strict comparisons keep equal counts in
      // item-ascending order (the lexsort tie-break)
      if (filled == top_n && c <= oc[top_n - 1]) continue;
      int32_t k = (filled < top_n) ? filled : top_n - 1;
      while (k > 0 && oc[k - 1] < c) {
        oc[k] = oc[k - 1];
        oi[k] = oi[k - 1];
        --k;
      }
      oc[k] = c;
      oi[k] = j;
      if (filled < top_n) ++filled;
    }
  }
  free(C);
  return 0;
}

}  // namespace

extern "C" {

void* pio_scan_file(const char* path, const char* event_names_csv,
                    const char* rating_key, const char* entity_type,
                    const char* target_entity_type) {
  auto* cols = new Columns();
  FILE* f = fopen(path, "rb");
  if (!f) {
    cols->error = "cannot open file";
    return cols;
  }
  // parse event-name filter
  std::unordered_map<std::string, bool> allowed;
  bool filter = event_names_csv && *event_names_csv;
  if (filter) {
    std::string csv(event_names_csv), cur;
    for (char c : csv) {
      if (c == ',') { if (!cur.empty()) allowed[cur] = true; cur.clear(); }
      else cur.push_back(c);
    }
    if (!cur.empty()) allowed[cur] = true;
  }
  // Pass 1: parse EVERY line into raw rows interned against full vocabs;
  // dedup by event id (later line wins, even if the later version fails the
  // filter — matching the backend's upsert-then-filter semantics).
  std::vector<RawRow> rows;
  std::vector<std::string> full_ent, full_tgt, full_ev;
  std::unordered_map<std::string, int32_t> ent_index, tgt_index, ev_index;
  std::unordered_map<std::string, size_t> row_by_id;
  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  std::string sval;
  while ((len = getline(&line, &cap, f)) != -1) {
    // a last line without its newline is still being appended: not read yet
    if (line[len - 1] != '\n') break;
    if (line[0] != '{') continue;
    const char* ev = find_top_level_value(line, "event");
    if (!ev || !parse_string(ev, &sval)) continue;
    std::string event_name = sval;
    const char* ent = find_top_level_value(line, "entityId");
    if (!ent || !parse_string(ent, &sval)) continue;
    std::string entity = sval;

    RawRow row;
    row.passes = !filter || allowed.find(event_name) != allowed.end();
    if (row.passes && entity_type && *entity_type) {
      const char* et = find_top_level_value(line, "entityType");
      row.passes = et && parse_string(et, &sval) && sval == entity_type;
    }
    if (row.passes && target_entity_type && *target_entity_type) {
      const char* tt = find_top_level_value(line, "targetEntityType");
      row.passes = tt && parse_string(tt, &sval) && sval == target_entity_type;
    }
    std::string target;
    bool has_target = false;
    const char* tgt = find_top_level_value(line, "targetEntityId");
    if (tgt && parse_string(tgt, &sval)) { target = sval; has_target = true; }
    row.ts = 0.0;
    const char* t = find_top_level_value(line, "eventTime");
    if (t && parse_string(t, &sval)) row.ts = parse_iso8601(sval);
    // rating: top-level key of the properties OBJECT only (bounded scan)
    row.rating = __builtin_nanf("");
    const char* props = find_top_level_value(line, "properties");
    if (props && *props == '{') {
      const char* pend = object_end(props);
      const char* rv = pend ? find_top_level_value(
          props, rating_key ? rating_key : "rating", pend) : nullptr;
      if (rv) {
        char* endp = nullptr;
        double v = strtod(rv, &endp);
        if (endp != rv) row.rating = static_cast<float>(v);
      }
    }
    const char* eid = find_top_level_value(line, "eventId");
    row.id = (eid && parse_string(eid, &sval)) ? sval : "";

    row.event = encode(event_name, &ev_index, &full_ev);
    row.entity = encode(entity, &ent_index, &full_ent);
    row.target = has_target ? encode(target, &tgt_index, &full_tgt) : -1;

    // id-less rows share the "" key on purpose: the backend's dedup map is
    // keyed on `event_id or ""`, so every id-less line collapses into one
    // last-wins record there — the native path must produce the same row set
    auto it = row_by_id.find(row.id);
    if (it != row_by_id.end()) {
      rows[it->second] = std::move(row);  // upsert in place
      continue;
    }
    row_by_id.emplace(row.id, rows.size());
    rows.push_back(std::move(row));
  }
  free(line);
  fclose(f);

  // Pass 2: keep filter-passing rows, stable-sort by eventTime (matching
  // the python path, which reads via time-ordered find), and re-encode
  // vocabularies in first-use order of the OUTPUT rows for exact parity.
  std::vector<size_t> order;
  order.reserve(rows.size());
  for (size_t i = 0; i < rows.size(); ++i)
    if (rows[i].passes) order.push_back(i);
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return rows[a].ts < rows[b].ts;
  });
  std::vector<int32_t> ent_map(full_ent.size(), -1),
      tgt_map(full_tgt.size(), -1), ev_map(full_ev.size(), -1);
  cols->entity_ids.reserve(order.size());
  for (size_t i : order) {
    const RawRow& r = rows[i];
    int32_t& em = ent_map[r.entity];
    if (em < 0) {
      em = static_cast<int32_t>(cols->entity_vocab.size());
      cols->entity_vocab.push_back(full_ent[r.entity]);
    }
    int32_t tm = -1;
    if (r.target >= 0) {
      int32_t& slot = tgt_map[r.target];
      if (slot < 0) {
        slot = static_cast<int32_t>(cols->target_vocab.size());
        cols->target_vocab.push_back(full_tgt[r.target]);
      }
      tm = slot;
    }
    int32_t& vm = ev_map[r.event];
    if (vm < 0) {
      vm = static_cast<int32_t>(cols->event_vocab.size());
      cols->event_vocab.push_back(full_ev[r.event]);
    }
    cols->entity_ids.push_back(em);
    cols->target_ids.push_back(tm);
    cols->event_codes.push_back(vm);
    cols->timestamps.push_back(r.ts);
    cols->ratings.push_back(r.rating);
    cols->row_ids.push_back(r.id);
  }
  return cols;
}

int64_t pio_scan_num_rows(void* h) {
  return static_cast<Columns*>(h)->entity_ids.size();
}
const char* pio_scan_error(void* h) {
  return static_cast<Columns*>(h)->error.c_str();
}
void pio_scan_copy_int32(void* h, int which, int32_t* out) {
  auto* c = static_cast<Columns*>(h);
  const std::vector<int32_t>* src =
      which == 0 ? &c->entity_ids : which == 1 ? &c->target_ids : &c->event_codes;
  memcpy(out, src->data(), src->size() * sizeof(int32_t));
}
void pio_scan_copy_f64(void* h, double* out) {
  auto* c = static_cast<Columns*>(h);
  memcpy(out, c->timestamps.data(), c->timestamps.size() * sizeof(double));
}
void pio_scan_copy_f32(void* h, float* out) {
  auto* c = static_cast<Columns*>(h);
  memcpy(out, c->ratings.data(), c->ratings.size() * sizeof(float));
}
int64_t pio_scan_vocab_size(void* h, int which) {
  auto* c = static_cast<Columns*>(h);
  const std::vector<std::string>* v =
      which == 0 ? &c->entity_vocab : which == 1 ? &c->target_vocab : &c->event_vocab;
  return v->size();
}
const char* pio_scan_vocab_get(void* h, int which, int64_t i) {
  auto* c = static_cast<Columns*>(h);
  const std::vector<std::string>* v =
      which == 0 ? &c->entity_vocab : which == 1 ? &c->target_vocab : &c->event_vocab;
  return (*v)[i].c_str();
}
const char* pio_scan_row_id(void* h, int64_t i) {
  return static_cast<Columns*>(h)->row_ids[i].c_str();
}
// Batched row-id export: one FFI call for lengths, one for the concatenated
// bytes (a pio_scan_row_id call + decode PER ROW was a 20M-iteration python
// loop that rivaled the whole C++ scan). Length-prefixing is separator-free,
// so ids may contain any byte.
int64_t pio_scan_ids_total_bytes(void* h) {
  auto* c = static_cast<Columns*>(h);
  int64_t total = 0;
  for (const auto& s : c->row_ids) total += static_cast<int64_t>(s.size());
  return total;
}
void pio_scan_copy_ids(void* h, int32_t* lengths, char* buf) {
  auto* c = static_cast<Columns*>(h);
  char* out = buf;
  for (size_t i = 0; i < c->row_ids.size(); ++i) {
    const std::string& s = c->row_ids[i];
    lengths[i] = static_cast<int32_t>(s.size());
    memcpy(out, s.data(), s.size());
    out += s.size();
  }
}
void pio_scan_free(void* h) { delete static_cast<Columns*>(h); }

// --- COO group-by for the ALS train feed ----------------------------------
//
// Stable counting sort of a COO rating list by entity id: the host half of
// the ALS ingest pipeline (ops/als.py). Replaces numpy's O(n log n)
// single-threaded stable argsort with one O(n) histogram pass + one O(n) scatter
// pass over native arrays. The device rebuilds everything else (opposite-
// side ordering, block tables) from this grouped form, so this is the ONLY
// host-side work in the train ingest.
//
// Caller contract: deg_out zeroed, sized n_entities; every rows[j] must be
// in [0, n_entities) (the Python wrapper validates them and raises
// otherwise). Returns 0 on success.

int32_t pio_coo_group(const int32_t* rows, const int32_t* cols,
                      const float* vals, int64_t n, int32_t n_entities,
                      int32_t* cols_out, float* vals_out, int32_t* deg_out) {
  for (int64_t j = 0; j < n; ++j) {
    int32_t e = rows[j];
    if (e < 0 || e >= n_entities) return 1;
    deg_out[e]++;
  }
  std::vector<int64_t> cursor(static_cast<size_t>(n_entities));
  int64_t acc = 0;
  for (int32_t e = 0; e < n_entities; ++e) {
    cursor[e] = acc;
    acc += deg_out[e];
  }
  for (int64_t j = 0; j < n; ++j) {
    int64_t p = cursor[rows[j]]++;
    cols_out[p] = cols[j];
    vals_out[p] = vals[j];
  }
  return 0;
}

// Similar-product cooccurrence build (ref CooccurrenceAlgorithm.scala:30-90:
// the Spark self-join over per-user distinct item sets). Input is the
// DISTINCT (user, item) list sorted by user (the Python wrapper dedups +
// groups with one np.unique over 1-D codes); per user-run the dense count
// matrix row C[i] (n_items int32 = fits L1 for ML-scale vocabs) takes the
// pair increments, then a per-row insertion select keeps the top_n by
// (count desc, item asc) — the exact order of the scipy/lexsort fallback in
// ops/cooccurrence.py, which stays as the oracle. out_items padded with -1.
// Returns 0 on success; 2 (the dense matrix past 2^28 cells) sends the caller
// to the scipy path, any other nonzero code is an error it raises.
int32_t pio_cooccur_topn(const int32_t* __restrict users,
                         const int32_t* __restrict items,
                         int64_t nnz, int32_t n_items, int32_t top_n,
                         int32_t* __restrict out_items,
                         int32_t* __restrict out_counts) {
  if (n_items <= 0 || top_n <= 0) return 1;
  // dense count matrix: past 2^28 cells the caller takes the scipy path
  if (static_cast<int64_t>(n_items) * n_items > (1LL << 28)) return 2;
  int32_t max_user = -1;
  for (int64_t j = 0; j < nnz; ++j) {
    if (items[j] < 0 || items[j] >= n_items) return 4;
    if (users[j] > max_user) max_user = users[j];
  }
  // a cooccurrence count is at most the user count; when that fits uint16
  // the half-width matrix halves the cache traffic of both hot passes
  if (max_user < 65535)
    return cooccur_accumulate<uint16_t>(users, items, nnz, n_items, top_n,
                                        out_items, out_counts);
  return cooccur_accumulate<int32_t>(users, items, nnz, n_items, top_n,
                                     out_items, out_counts);
}

}  // extern "C"
