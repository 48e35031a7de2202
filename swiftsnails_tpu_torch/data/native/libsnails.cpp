// libsnails — native data-pipeline core for swiftsnails_tpu.
//
// TPU-native re-implementation of the reference's host-side hot path
// (C++11 header-only utils, survey §2.1):
//   * LineFileReader / scan_file_by_line (src/utils/string.h, file.h:11-33)
//       -> buffered whole-file tokenizer (vocab_build / encode)
//   * TextBuffer::get_math number parsing (src/utils/Buffer.h:240-324)
//       -> strtol-at-cursor CTR record parser (read_ctr)
//   * google dense_hash_map vocab (src/utils/hashmap.h)
//       -> std::unordered_map with reserved buckets
//   * queue_with_capacity bounded queue + poison-value shutdown
//       (src/utils/queue.h:100-108) -> Prefetcher ring (mutex+condvar,
//       producer thread, explicit close)
//   * MurmurHash3 finalizer (src/utils/HashFunction.h:17-25) -> murmur64
//
// Exposed as a plain C ABI for ctypes (no pybind11). All buffers are
// caller-owned numpy allocations unless documented otherwise.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------- murmur ---

// Exact HashFunction.h:17-25 finalizer.
static inline uint64_t fmix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

extern "C" void ssn_murmur64(const uint64_t* in, uint64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = fmix64(in[i]);
}

extern "C" void ssn_hash_row(const uint32_t* keys, int64_t n, uint64_t capacity,
                  int64_t* rows) {
  for (int64_t i = 0; i < n; ++i)
    rows[i] = (int64_t)(fmix64((uint64_t)keys[i]) % capacity);
}

// ----------------------------------------------------------------- vocab ---

struct Vocab {
  std::vector<std::string> words;
  std::vector<int64_t> counts;
  std::unordered_map<std::string, int32_t> index;
};

static bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)size);
  size_t got = size ? std::fread(&(*out)[0], 1, (size_t)size, f) : 0;
  std::fclose(f);
  out->resize(got);
  return true;
}

static inline bool is_space(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

// Tokenize `data` in place, calling fn(ptr, len) per token.
template <typename Fn>
static void for_tokens(const std::string& data, Fn fn) {
  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    const char* start = p;
    while (p < end && !is_space(*p)) ++p;
    if (p > start) fn(start, (size_t)(p - start));
  }
}

// Shared ordering contract (identical to Vocab.from_counter): freq desc,
// then lexicographic, min-count filtered, truncated to max_size.
static Vocab* make_vocab(std::unordered_map<std::string, int64_t>& counter,
                         int min_count, int max_size) {
  std::vector<std::pair<std::string, int64_t>> items;
  items.reserve(counter.size());
  for (auto& kv : counter)
    if (kv.second >= min_count) items.emplace_back(kv.first, kv.second);
  std::sort(items.begin(), items.end(), [](const auto& a, const auto& b) {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;
  });
  if (max_size > 0 && (int)items.size() > max_size) items.resize(max_size);
  Vocab* v = new Vocab();
  v->words.reserve(items.size());
  v->counts.reserve(items.size());
  v->index.reserve(items.size());
  for (size_t i = 0; i < items.size(); ++i) {
    v->words.push_back(items[i].first);
    v->counts.push_back(items[i].second);
    v->index.emplace(items[i].first, (int32_t)i);
  }
  return v;
}

extern "C" void* ssn_vocab_build(const char* path, int min_count, int max_size) {
  std::string data;
  if (!read_file(path, &data)) return nullptr;
  std::unordered_map<std::string, int64_t> counter;
  counter.reserve(1 << 20);
  for_tokens(data, [&](const char* s, size_t len) {
    counter[std::string(s, len)] += 1;
  });
  return make_vocab(counter, min_count, max_size);
}

extern "C" int64_t ssn_vocab_size(void* h) { return h ? (int64_t)((Vocab*)h)->words.size() : -1; }

extern "C" void ssn_vocab_counts(void* h, int64_t* out) {
  Vocab* v = (Vocab*)h;
  std::memcpy(out, v->counts.data(), v->counts.size() * sizeof(int64_t));
}

extern "C" int ssn_vocab_word(void* h, int64_t idx, char* buf, int buflen) {
  Vocab* v = (Vocab*)h;
  if (idx < 0 || idx >= (int64_t)v->words.size()) return -1;
  const std::string& w = v->words[(size_t)idx];
  if ((int)w.size() + 1 > buflen) return -(int)w.size() - 1;
  std::memcpy(buf, w.data(), w.size());
  buf[w.size()] = 0;
  return (int)w.size();
}

extern "C" void ssn_vocab_free(void* h) { delete (Vocab*)h; }

// Encode corpus file -> int32 ids (OOV dropped). Returns count, or -needed if
// `cap` too small (call once with cap=0 to size), or -1 on IO error.
extern "C" int64_t ssn_encode(void* h, const char* path, int32_t* out, int64_t cap) {
  Vocab* v = (Vocab*)h;
  std::string data;
  if (!read_file(path, &data)) return -1;
  int64_t n = 0;
  bool overflow = false;
  for_tokens(data, [&](const char* s, size_t len) {
    auto it = v->index.find(std::string(s, len));
    if (it != v->index.end()) {
      if (out && n < cap) out[n] = it->second;
      else overflow = true;
      ++n;
    }
  });
  if (out && overflow) return -n;  // caller's buffer was too small
  return n;
}

// ------------------------------------------------------------ streaming ---
//
// Bounded-memory file ingestion (scan_file_by_line / LineFileReader parity,
// src/utils/file.h:11-33): a fixed read buffer + a carry for the token or
// line straddling the buffer edge. RSS stays O(buffer + chunk) regardless of
// file size — the whole-file read_file() paths above are kept for small
// inputs; these streams are what the 1TB-scale configs feed from.

// defined in the ctr section below; shared with the streaming reader
static bool parse_ctr_line(const char* q, const char* line_end, int num_fields,
                           float* label_out, int32_t* feats);

namespace {
constexpr size_t kStreamBuf = 1 << 20;  // 1 MiB read buffer

struct TokenStream {
  FILE* f = nullptr;
  const Vocab* vocab = nullptr;  // borrowed; owner must outlive the stream
  std::string buf;               // read buffer
  std::string carry;             // partial token at buffer edge
  size_t pos = 0;                // cursor into buf
  bool eof = false;
  int64_t abs_base = 0;  // file offset of buf[0]
  int64_t end = 0;       // byte-range shard limit (0 = whole file): a token
                         // belongs to this shard iff it STARTS before `end`
                         // (Hadoop split semantics; run_worker.sh parity)

  bool fill() {  // refill buf from file; false at EOF
    if (eof) return false;
    abs_base += (int64_t)buf.size();
    buf.resize(kStreamBuf);
    size_t got = std::fread(&buf[0], 1, kStreamBuf, f);
    buf.resize(got);
    pos = 0;
    if (got == 0) eof = true;
    return got > 0;
  }
};

struct CtrStream {
  FILE* f = nullptr;
  int num_fields = 0;
  std::string buf;
  std::string carry;  // partial line at buffer edge
  size_t pos = 0;
  bool eof = false;
  int64_t abs_base = 0;  // file offset of buf[0]
  int64_t end = 0;       // byte-range limit: a line belongs to the span its
                         // first byte falls in (Hadoop TextInputFormat)
};
}  // namespace

// Open a (byte_start, byte_end) span; 0,0 = whole file. A token straddling
// byte_start belongs to the PREVIOUS shard (skipped here); a token starting
// before byte_end is read to completion even past byte_end.
extern "C" void* ssn_stream_open(void* vocab_h, const char* path,
                                 int64_t byte_start, int64_t byte_end) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  TokenStream* s = new TokenStream();
  s->f = f;
  s->vocab = (const Vocab*)vocab_h;
  s->end = byte_end;
  if (byte_start > 0) {
    // Hadoop convention: a token starting EXACTLY at byte_start is ours iff
    // the previous byte is whitespace; otherwise we're mid-token and the
    // owner is the previous shard — skip to the first whitespace.
    std::fseek(f, (long)(byte_start - 1), SEEK_SET);
    int prev = std::fgetc(f);
    s->abs_base = byte_start;
    if (prev != EOF && !is_space((char)prev)) {
      for (;;) {
        if (!s->fill()) break;
        size_t i = 0;
        while (i < s->buf.size() && !is_space(s->buf[i])) ++i;
        if (i < s->buf.size()) { s->pos = i; break; }
        s->pos = s->buf.size();
      }
    }
  }
  return s;
}

// Fill out with up to cap encoded ids (OOV dropped). Returns count written;
// 0 = end of file. Bounded memory: one read buffer + one partial token.
extern "C" int64_t ssn_stream_next(void* h, int32_t* out, int64_t cap) {
  TokenStream* s = (TokenStream*)h;
  int64_t n = 0;
  while (n < cap) {
    if (s->pos >= s->buf.size()) {
      if (!s->fill()) break;
    }
    const char* base = s->buf.data();
    size_t size = s->buf.size();
    while (s->pos < size && n < cap) {
      // skip spaces; a pending carry token ends at the first space
      if (is_space(base[s->pos])) {
        if (!s->carry.empty()) {
          auto it = s->vocab->index.find(s->carry);
          if (it != s->vocab->index.end()) out[n++] = it->second;
          s->carry.clear();
          if (n >= cap) { ++s->pos; break; }
        }
        ++s->pos;
        continue;
      }
      // a NEW token starting at/after the shard's byte_end belongs to the
      // next shard (a carried token started before it — finish that one)
      if (s->end > 0 && s->carry.empty() &&
          s->abs_base + (int64_t)s->pos >= s->end) {
        s->eof = true;
        break;
      }
      size_t start = s->pos;
      while (s->pos < size && !is_space(base[s->pos])) ++s->pos;
      if (s->pos >= size) {  // token may continue in the next buffer
        s->carry.append(base + start, s->pos - start);
        break;
      }
      if (!s->carry.empty()) {
        s->carry.append(base + start, s->pos - start);
        auto it = s->vocab->index.find(s->carry);
        if (it != s->vocab->index.end()) out[n++] = it->second;
        s->carry.clear();
      } else {
        auto it = s->vocab->index.find(std::string(base + start, s->pos - start));
        if (it != s->vocab->index.end()) out[n++] = it->second;
      }
    }
    if (s->eof) break;
  }
  if (s->eof && !s->carry.empty() && n < cap) {  // final unterminated token
    auto it = s->vocab->index.find(s->carry);
    if (it != s->vocab->index.end()) out[n++] = it->second;
    s->carry.clear();
  }
  return n;
}

extern "C" void ssn_stream_close(void* h) {
  TokenStream* s = (TokenStream*)h;
  if (s->f) std::fclose(s->f);
  delete s;
}

// Streaming vocab build: same ordering contract as ssn_vocab_build, bounded
// memory (counter is O(vocab), read buffer is fixed).
extern "C" void* ssn_vocab_build_stream(const char* path, int min_count,
                                        int max_size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::unordered_map<std::string, int64_t> counter;
  counter.reserve(1 << 20);
  std::string buf;
  std::string carry;
  for (;;) {
    buf.resize(kStreamBuf);
    size_t got = std::fread(&buf[0], 1, kStreamBuf, f);
    buf.resize(got);
    if (got == 0) break;
    size_t pos = 0;
    while (pos < got) {
      if (is_space(buf[pos])) {
        if (!carry.empty()) { counter[carry] += 1; carry.clear(); }
        ++pos;
        continue;
      }
      size_t start = pos;
      while (pos < got && !is_space(buf[pos])) ++pos;
      if (pos >= got) { carry.append(buf, start, pos - start); break; }
      if (!carry.empty()) {
        carry.append(buf, start, pos - start);
        counter[carry] += 1;
        carry.clear();
      } else {
        counter[std::string(buf, start, pos - start)] += 1;
      }
    }
  }
  if (!carry.empty()) counter[carry] += 1;
  std::fclose(f);
  return make_vocab(counter, min_count, max_size);
}

extern "C" void* ssn_ctr_stream_open(const char* path, int num_fields,
                                     int64_t byte_start, int64_t byte_end) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  CtrStream* s = new CtrStream();
  s->f = f;
  s->num_fields = num_fields;
  s->end = byte_end;
  if (byte_start > 0) {
    // a line starting exactly at byte_start is ours iff the previous byte
    // is '\n'; otherwise discard the partial line (previous shard's)
    std::fseek(f, (long)(byte_start - 1), SEEK_SET);
    int prev = std::fgetc(f);
    int64_t skipped = 0;
    if (prev != EOF && prev != '\n') {
      int ch;
      while ((ch = std::fgetc(f)) != EOF) {
        ++skipped;
        if (ch == '\n') break;
      }
    }
    s->abs_base = byte_start + skipped;
  }
  return s;
}

// Fill up to max_rows parsed rows (parse_ctr_line is shared with the
// whole-file ssn_read_ctr above). Returns rows written; 0 = EOF.
extern "C" int64_t ssn_ctr_stream_next(void* h, float* labels_out,
                                       int32_t* feats_out, int64_t max_rows) {
  CtrStream* s = (CtrStream*)h;
  int64_t row = 0;
  while (row < max_rows) {
    if (s->pos >= s->buf.size()) {
      if (s->eof) break;
      s->abs_base += (int64_t)s->buf.size();
      s->buf.resize(kStreamBuf);
      size_t got = std::fread(&s->buf[0], 1, kStreamBuf, s->f);
      s->buf.resize(got);
      s->pos = 0;
      if (got == 0) { s->eof = true; break; }
    }
    // a NEW line starting at/after the span's byte_end belongs to the next
    // shard (a carried line started before it and is finished normally)
    if (s->end > 0 && s->carry.empty() &&
        s->abs_base + (int64_t)s->pos >= s->end) {
      s->eof = true;
      break;
    }
    const char* base = s->buf.data();
    const char* end = base + s->buf.size();
    const char* p = base + s->pos;
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) {  // partial line: carry to the next buffer
      s->carry.append(p, (size_t)(end - p));
      s->pos = s->buf.size();
      continue;
    }
    if (!s->carry.empty()) {
      s->carry.append(p, (size_t)(line_end - p));
      if (parse_ctr_line(s->carry.data(), s->carry.data() + s->carry.size(),
                         s->num_fields, labels_out + row,
                         feats_out + row * s->num_fields))
        ++row;
      s->carry.clear();
    } else if (parse_ctr_line(p, line_end, s->num_fields, labels_out + row,
                              feats_out + row * s->num_fields)) {
      ++row;
    }
    s->pos = (size_t)(line_end - base) + 1;
  }
  if (s->eof && !s->carry.empty() && row < max_rows) {  // final line, no \n
    if (parse_ctr_line(s->carry.data(), s->carry.data() + s->carry.size(),
                       s->num_fields, labels_out + row,
                       feats_out + row * s->num_fields))
      ++row;
    s->carry.clear();
  }
  return row;
}

extern "C" void ssn_ctr_stream_close(void* h) {
  CtrStream* s = (CtrStream*)h;
  if (s->f) std::fclose(s->f);
  delete s;
}

// ------------------------------------------------------------- skip-gram ---

// splitmix64: deterministic, matches nothing external — seeds the pair RNG.
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Stateless splitmix64 draw at stream position i: identical output to
// advancing a splitmix64 stream i+1 times, but random-access — every
// position's draw is computable independently, so pair/window generation
// parallelizes (and shards of a corpus can be processed in any order)
// without changing the generated pair set for a given seed.
static inline uint64_t splitmix64_at(uint64_t seed, int64_t i) {
  uint64_t z = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(i + 1);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// b ~ U(1, window) for center position i (word2vec dynamic window).
static inline int draw_b(uint64_t seed, int64_t i, int window, int dynamic) {
  if (!dynamic) return window;
  return (int)(splitmix64_at(seed ^ 0xdeadbeefcafef00dULL, i) %
               (uint64_t)window) + 1;
}

// Worker count for the parallel producers: hardware cores, env-overridable.
// On a 1-core host everything stays sequential (threads would only add
// contention); on real TPU-host CPUs (dozens of cores) the generation and
// batch-assembly fan out.
static int default_workers() {
  const char* env = std::getenv("SSN_NATIVE_THREADS");
  if (env && *env) {
    int v = std::atoi(env);
    if (v > 0) return v;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw > 0 ? (int)(hw > 16 ? 16 : hw) : 1;
}

// Run fn(shard_lo, shard_hi) over [0, n) in contiguous shards across the
// worker pool; sequential when one worker (or tiny n).
template <typename F>
static void parallel_spans(int64_t n, int nworkers, F fn) {
  if (nworkers <= 1 || n < (1 << 16)) {
    fn((int64_t)0, n);
    return;
  }
  int64_t shard = (n + nworkers - 1) / nworkers;
  std::vector<std::thread> ts;
  for (int w = 0; w < nworkers; ++w) {
    int64_t lo = w * shard, hi = std::min(n, lo + shard);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// Dynamic-window pair generation (word2vec b ~ U(1, window)).
// Returns npairs; if out arrays are null, only counts. Per-position draws
// (splitmix64_at) make the pair set independent of sharding, so the count
// and fill passes parallelize over contiguous spans.
extern "C" int64_t ssn_skipgram_pairs(const int32_t* ids, int64_t n, int window,
                           uint64_t seed, int dynamic, int32_t* centers,
                           int32_t* contexts, int64_t cap) {
  if (n <= 0) return 0;  // empty chunk (e.g. fully subsampled away)
  int nw = default_workers();
  // pass 1: pairs per span (exact prefix offsets for the parallel fill)
  int64_t shard = nw <= 1 ? n : (n + nw - 1) / nw;
  if (shard <= 0) shard = 1;
  int nshards = (int)((n + shard - 1) / shard);
  std::vector<int64_t> span_pairs((size_t)std::max(nshards, 1), 0);
  parallel_spans(n, nw, [&](int64_t lo, int64_t hi) {
    int64_t k = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int b = draw_b(seed, i, window, dynamic);
      int64_t lo_j = i - b < 0 ? 0 : i - b;
      int64_t hi_j = i + b >= n ? n - 1 : i + b;
      k += (hi_j - lo_j);  // minus the center itself: (hi-lo+1) - 1
    }
    span_pairs[(size_t)(lo / shard)] = k;
  });
  int64_t total = 0;
  for (int64_t c : span_pairs) total += c;
  if (!centers) return total;
  if (total > cap) return -total;  // undersized buffer
  std::vector<int64_t> offs((size_t)nshards, 0);
  for (int s = 1; s < nshards; ++s)
    offs[(size_t)s] = offs[(size_t)s - 1] + span_pairs[(size_t)s - 1];
  parallel_spans(n, nw, [&](int64_t lo, int64_t hi) {
    int64_t k = offs[(size_t)(lo / shard)];
    for (int64_t i = lo; i < hi; ++i) {
      int b = draw_b(seed, i, window, dynamic);
      int64_t lo_j = i - b < 0 ? 0 : i - b;
      int64_t hi_j = i + b >= n ? n - 1 : i + b;
      int32_t ci = ids[i];
      for (int64_t j = lo_j; j <= hi_j; ++j) {
        if (j == i) continue;
        centers[k] = ci;
        contexts[k] = ids[j];
        ++k;
      }
    }
  });
  return total;
}

// Center-major windows: contexts[i, slot] for slot offsets [-w..-1, 1..w],
// -1 where out of range or beyond the drawn b ~ U(1, window). SAME b draw
// (draw_b at position i) as ssn_skipgram_pairs for a given seed, so the
// flat and grouped schemas generate the identical pair set (the invariant
// the Python twins keep via _dynamic_window_valid). Parallel over spans.
extern "C" int64_t ssn_skipgram_windows(const int32_t* ids, int64_t n,
                                        int window, uint64_t seed, int dynamic,
                                        int32_t* ctxs /* [n, 2*window] */) {
  const int cw = 2 * window;
  parallel_spans(n, default_workers(), [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int b = draw_b(seed, i, window, dynamic);
      int32_t* row = ctxs + i * cw;
      for (int o = -window; o <= window; ++o) {
        if (o == 0) continue;
        int slot = o < 0 ? o + window : o + window - 1;
        int64_t j = i + o;
        int ab = o < 0 ? -o : o;
        row[slot] = (j >= 0 && j < n && ab <= b) ? ids[j] : -1;
      }
    }
  });
  return n;
}

// Frequent-word subsampling: keep w with p = sqrt(t/f) + t/f (word2vec).
// Writes kept ids to out, returns kept count. The keep draw is per-position
// (splitmix64_at), so the kept set is independent of sharding: count +
// compact passes parallelize over spans with exact prefix offsets.
extern "C" int64_t ssn_subsample(const int32_t* ids, int64_t n, const int64_t* counts,
                      int64_t vocab, double total, double threshold,
                      uint64_t seed, int32_t* out) {
  if (n <= 0) return 0;  // empty chunk
  if (threshold <= 0) {
    std::memcpy(out, ids, (size_t)n * sizeof(int32_t));
    return n;
  }
  const uint64_t s = seed ^ 0x12345678abcdefULL;
  const double inv = 1.0 / 9007199254740992.0;  // 2^-53
  // precompute per-id keep probability once (vocab << n): the sqrt/div per
  // TOKEN was the old loop's cost; per-id it amortizes across the corpus
  std::vector<float> keep_p((size_t)vocab);
  parallel_spans(vocab, default_workers(), [&](int64_t lo, int64_t hi) {
    for (int64_t v = lo; v < hi; ++v) {
      double f = (double)counts[v] / total;
      keep_p[(size_t)v] =
          (float)std::min(1.0, std::sqrt(threshold / f) + threshold / f);
    }
  });
  int nw = default_workers();
  int64_t shard = nw <= 1 ? n : (n + nw - 1) / nw;
  if (shard <= 0) shard = 1;
  int nshards = (int)((n + shard - 1) / shard);
  std::vector<int64_t> span_kept((size_t)std::max(nshards, 1), 0);
  auto kept_at = [&](int64_t i) -> bool {
    int32_t id = ids[i];
    float keep = (id >= 0 && id < vocab) ? keep_p[(size_t)id] : 1.0f;
    double u = (double)(splitmix64_at(s, i) >> 11) * inv;
    return u < keep;
  };
  parallel_spans(n, nw, [&](int64_t lo, int64_t hi) {
    int64_t k = 0;
    for (int64_t i = lo; i < hi; ++i) k += kept_at(i);
    span_kept[(size_t)(lo / shard)] = k;
  });
  std::vector<int64_t> offs((size_t)nshards, 0);
  for (int sI = 1; sI < nshards; ++sI)
    offs[(size_t)sI] = offs[(size_t)sI - 1] + span_kept[(size_t)sI - 1];
  parallel_spans(n, nw, [&](int64_t lo, int64_t hi) {
    int64_t k = offs[(size_t)(lo / shard)];
    for (int64_t i = lo; i < hi; ++i)
      if (kept_at(i)) out[k++] = ids[i];
  });
  int64_t totalk = 0;
  for (int64_t c : span_kept) totalk += c;
  return totalk;
}

// ------------------------------------------------------------------- ctr ---

// Parse one complete "label f0 f1 ..." line (TextBuffer::get_math parity,
// PAD = -1) into the given row slots. Shared by the whole-file reader and
// the streaming reader so the two can never drift. Returns false for
// blank/garbage-label lines (row skipped, strtod-failure semantics).
static bool parse_ctr_line(const char* q, const char* line_end, int num_fields,
                           float* label_out, int32_t* feats) {
  while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
  if (q >= line_end) return false;
  char* next = nullptr;
  double label = std::strtod(q, &next);
  if (next == q) return false;
  if (label_out) {
    *label_out = (float)label;
    for (int fidx = 0; fidx < num_fields; ++fidx) feats[fidx] = -1;
    const char* cur = next;
    for (int fidx = 0; fidx < num_fields && cur < line_end; ++fidx) {
      while (cur < line_end && (*cur == ' ' || *cur == '\t')) ++cur;
      if (cur >= line_end) break;
      char* after = nullptr;
      long v = std::strtol(cur, &after, 10);
      if (after == cur) break;
      // "field:id" form — take the id after ':'
      if (after < line_end && *after == ':') {
        cur = after + 1;
        v = std::strtol(cur, &after, 10);
        if (after == cur) break;
      }
      feats[fidx] = (int32_t)v;
      cur = after;
    }
  }
  return true;
}

// Parse "label f0 f1 ..." lines. Returns row count; sizes only when outputs
// are null.
extern "C" int64_t ssn_read_ctr(const char* path, int num_fields, float* labels_out,
                     int32_t* feats_out, int64_t max_rows) {
  std::string data;
  if (!read_file(path, &data)) return -1;
  const char* p = data.data();
  const char* end = p + data.size();
  int64_t row = 0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    // validate first (label-only parse): blank/garbage lines after the last
    // valid row must NOT trip the overflow check
    if (parse_ctr_line(p, line_end, num_fields, nullptr, nullptr)) {
      if (labels_out) {
        if (row >= max_rows) return -row;
        parse_ctr_line(p, line_end, num_fields, labels_out + row,
                       feats_out + row * num_fields);
      }
      ++row;
    }
    p = line_end + 1;
  }
  return row;
}

// --------------------------------------------------------- sgns baseline ---
//
// Compiled single-node SGNS worker loop for bench.py's CPU baseline: the
// reference's worker hot path was C++ (app layer absent from the snapshot;
// contract at src/core/framework/SwiftWorker.h:88-124), so the "8-node CPU
// parameter server" baseline must be calibrated from compiled code, not
// numpy (np.add.at is 10-50x slower than a C loop and would inflate
// vs_baseline). Shape follows the classic word2vec.c hot loop: sigmoid
// lookup table, unigram^0.75 negative table, per-pair gather -> sigmoid ->
// scatter-update.

namespace {
constexpr int kExpTableSize = 1000;
constexpr float kMaxExp = 6.0f;

struct NegTable {
  std::vector<int32_t> table;
};
}  // namespace

extern "C" void* ssn_neg_table_build(const int64_t* counts, int64_t vocab,
                                     int64_t table_size) {
  if (vocab <= 0 || table_size <= 0) return nullptr;
  NegTable* t = new NegTable();
  t->table.resize((size_t)table_size);
  double total = 0.0;
  for (int64_t i = 0; i < vocab; ++i) total += std::pow((double)counts[i], 0.75);
  int64_t w = 0;
  double cum = std::pow((double)counts[0], 0.75) / total;
  for (int64_t a = 0; a < table_size; ++a) {
    t->table[(size_t)a] = (int32_t)w;
    if ((double)(a + 1) / (double)table_size > cum && w < vocab - 1) {
      ++w;
      cum += std::pow((double)counts[w], 0.75) / total;
    }
  }
  return t;
}

extern "C" void ssn_neg_table_free(void* h) { delete (NegTable*)h; }

// Train over n (center, context) pairs with `negatives` samples each.
// Returns elapsed seconds (monotonic, excludes table setup).
extern "C" double ssn_sgns_train(float* syn0, float* syn1, int dim,
                                 const int32_t* centers, const int32_t* contexts,
                                 int64_t n, int negatives, float lr,
                                 void* neg_table_h, uint64_t seed) {
  NegTable* nt = (NegTable*)neg_table_h;
  const int64_t tsize = (int64_t)nt->table.size();
  // precomputed sigmoid over [-kMaxExp, kMaxExp)
  std::vector<float> exp_table((size_t)kExpTableSize);
  for (int i = 0; i < kExpTableSize; ++i) {
    float x = ((float)i / kExpTableSize * 2.0f - 1.0f) * kMaxExp;
    float e = std::exp(x);
    exp_table[(size_t)i] = e / (e + 1.0f);
  }
  std::vector<float> neu1e((size_t)dim);
  uint64_t s = seed ^ 0xabcdef0123456789ULL;
  auto t0 = std::chrono::steady_clock::now();
  for (int64_t p = 0; p < n; ++p) {
    float* v = syn0 + (int64_t)centers[p] * dim;
    std::memset(neu1e.data(), 0, (size_t)dim * sizeof(float));
    for (int d = 0; d <= negatives; ++d) {
      int32_t target;
      float label;
      if (d == 0) {
        target = contexts[p];
        label = 1.0f;
      } else {
        target = nt->table[(size_t)(splitmix64(s) % (uint64_t)tsize)];
        if (target == contexts[p]) continue;
        label = 0.0f;
      }
      float* u = syn1 + (int64_t)target * dim;
      float f = 0.0f;
      for (int c = 0; c < dim; ++c) f += v[c] * u[c];
      float g;
      if (f > kMaxExp) g = (label - 1.0f) * lr;
      else if (f < -kMaxExp) g = label * lr;
      else
        g = (label -
             exp_table[(size_t)(int)((f + kMaxExp) *
                                     (kExpTableSize / kMaxExp / 2.0f))]) *
            lr;
      for (int c = 0; c < dim; ++c) neu1e[c] += g * u[c];
      for (int c = 0; c < dim; ++c) u[c] += g * v[c];
    }
    for (int c = 0; c < dim; ++c) v[c] += neu1e[c];
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double>(t1 - t0).count();
}

// -------------------------------------------------------------- prefetch ---

// Fisher-Yates with splitmix64 draws + Lemire multiply-shift bounded
// mapping: ~3x std::shuffle (which pays a division per element in
// uniform_int_distribution). Bias is O(2^-64) per draw — irrelevant for
// batch ordering.
template <typename T>
static void fy_shuffle(T* a, int64_t n, uint64_t seed) {
  uint64_t s = seed ^ 0x5bf0363546536b1dULL;
  // a second rng cursor runs LA steps ahead issuing prefetches for the
  // random swap targets (the swaps themselves are DRAM-miss-bound on big
  // arrays); the draw sequence of the actual swaps is unchanged
  constexpr int LA = 12;
  uint64_t s_pre = s;
  int64_t i_pre = n - 1;
  for (int k = 0; k < LA && i_pre > 0; ++k, --i_pre) {
    uint64_t r = splitmix64(s_pre);
    __builtin_prefetch(
        a + (int64_t)(((unsigned __int128)r * (uint64_t)(i_pre + 1)) >> 64),
        1, 0);
  }
  for (int64_t i = n - 1; i > 0; --i) {
    if (i_pre > 0) {
      uint64_t r = splitmix64(s_pre);
      __builtin_prefetch(
          a + (int64_t)(((unsigned __int128)r * (uint64_t)(i_pre + 1)) >> 64),
          1, 0);
      --i_pre;
    }
    uint64_t r = splitmix64(s);
    int64_t j = (int64_t)(((unsigned __int128)r * (uint64_t)(i + 1)) >> 64);
    T t = a[i];
    a[i] = a[j];
    a[j] = t;
  }
}

// Bounded-queue shuffled-batch producer (queue_with_capacity parity:
// capacity-bounded, blocking push/pop, explicit end_input poison).
struct Prefetcher {
  // pairs stored INTERLEAVED [c0,x0,c1,x1,...]: the shuffled gather is the
  // producer's cost and is cache-miss-bound — one 8-byte access per pair
  // instead of two 4-byte accesses into arrays ~n*4 bytes apart
  std::vector<int32_t> cx;
  int64_t n = 0;
  int64_t batch;
  int epochs;
  uint64_t seed;
  size_t capacity;

  std::deque<std::vector<int32_t>> queue;  // interleaved [c0,x0,c1,x1,...]
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  bool done = false, closed = false;
  std::thread worker;

  void produce() {
    int64_t nb = n / batch;
    // 32-bit order indices: the Fisher-Yates pass and the gather's index
    // reads are cache-miss-bound, so halving the index footprint matters
    // (pair counts < 2^31 by the open() guard)
    std::vector<uint32_t> order((size_t)n);
    const uint32_t* ord = order.data();
    for (int e = 0; e < epochs; ++e) {
      for (int64_t i = 0; i < n; ++i) order[(size_t)i] = (uint32_t)i;
      fy_shuffle(order.data(), n, seed + (uint64_t)e);
      for (int64_t bi = 0; bi < nb; ++bi) {
        std::vector<int32_t> item((size_t)(2 * batch));
        // memcpy (not int64_t* punning — strict aliasing) still compiles to
        // one 8-byte load/store per pair; the gather is random-access over
        // the whole pair array, so prefetch a few iterations ahead to
        // overlap the DRAM misses
        const uint32_t* o = ord + bi * batch;
        for (int64_t j = 0; j < batch; ++j) {
          if (j + 8 < batch)
            __builtin_prefetch(cx.data() + 2 * (int64_t)o[j + 8], 0, 0);
          std::memcpy(item.data() + 2 * j, cx.data() + 2 * (int64_t)o[j],
                      2 * sizeof(int32_t));
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < capacity || closed; });
        if (closed) return;
        queue.push_back(std::move(item));
        cv_pop.notify_one();
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_pop.notify_all();
  }
};

extern "C" void* ssn_prefetch_open(const int32_t* centers, const int32_t* contexts,
                        int64_t n, int64_t batch, int epochs, int capacity,
                        uint64_t seed) {
  if (n <= 0 || batch <= 0 || batch > n) return nullptr;
  if (n >= (int64_t)1 << 31) return nullptr;  // pair counts < 2^31 (uint32 shuffle indices)
  Prefetcher* p = new Prefetcher();
  p->n = n;
  p->cx.resize((size_t)(2 * n));
  for (int64_t i = 0; i < n; ++i) {
    p->cx[(size_t)(2 * i)] = centers[i];
    p->cx[(size_t)(2 * i + 1)] = contexts[i];
  }
  p->batch = batch;
  p->epochs = epochs;
  p->seed = seed;
  p->capacity = (size_t)(capacity > 0 ? capacity : 4);
  p->worker = std::thread([p] { p->produce(); });
  return p;
}

// 1 = batch written; 0 = end of input (reference poison value semantics).
extern "C" int ssn_prefetch_next(void* h, int32_t* centers_out, int32_t* contexts_out) {
  Prefetcher* p = (Prefetcher*)h;
  std::vector<int32_t> item;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] { return !p->queue.empty() || p->done; });
    if (p->queue.empty()) return 0;
    item = std::move(p->queue.front());
    p->queue.pop_front();
    p->cv_push.notify_one();
  }
  for (int64_t j = 0; j < p->batch; ++j) {
    centers_out[j] = item[(size_t)(2 * j)];
    contexts_out[j] = item[(size_t)(2 * j + 1)];
  }
  return 1;
}

extern "C" void ssn_prefetch_close(void* h) {
  Prefetcher* p = (Prefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->closed = true;
    p->cv_push.notify_all();
    p->cv_pop.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

// ----------------------------------------------- window batch producer ---
//
// Center-major batch producer for the grouped/dedup kernels: shuffles
// BLOCKS of `block` consecutive windows (block = 1 -> plain row shuffle)
// and assembles {centers [batch], contexts [batch, cw]} items on a pool of
// worker threads behind a bounded ORDER-PRESERVING ticket ring, so the
// batch sequence is deterministic in (seed, epochs) regardless of worker
// count. Block mode copies whole contiguous spans (memcpy per block) — the
// assembly cost the Python batch_stream paid per-row in numpy. Bounded
// queue + poison-free end: queue_with_capacity parity
// (src/utils/queue.h:100-108), like the pair Prefetcher above.
struct WinPrefetcher {
  // BORROWED buffers (the Python wrapper keeps the arrays alive for the
  // handle's lifetime): a [n, 2w] window array is the chunk's dominant
  // allocation — copying it would double peak memory per chunk
  const int32_t* c = nullptr;   // [n]
  const int32_t* x = nullptr;   // [n, cw] flattened
  int cw = 0;
  int64_t batch = 0, block = 1;
  int64_t nblocks = 0, blocks_per_batch = 0, batches_per_epoch = 0;
  int64_t total_batches = 0;
  std::vector<int64_t> order;  // [epochs * nblocks] block schedule
  size_t capacity = 4;

  std::vector<std::vector<int32_t>> slots;  // ticket ring
  std::vector<int64_t> slot_ticket;         // -1 = empty
  std::atomic<int64_t> next_ticket{0};
  int64_t consumed = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool closed = false;
  std::vector<std::thread> workers;

  void work() {
    for (;;) {
      int64_t t = next_ticket.fetch_add(1);
      if (t >= total_batches) break;
      std::vector<int32_t> item((size_t)(batch * (1 + cw)));
      int32_t* co = item.data();
      int32_t* xo = item.data() + batch;
      const int64_t* ord = order.data() +
                           (t / batches_per_epoch) * nblocks +
                           (t % batches_per_epoch) * blocks_per_batch;
      for (int64_t bi = 0; bi < blocks_per_batch; ++bi) {
        int64_t src = ord[bi] * block;
        std::memcpy(co + bi * block, c + src,
                    (size_t)block * sizeof(int32_t));
        std::memcpy(xo + bi * block * cw, x + src * cw,
                    (size_t)(block * cw) * sizeof(int32_t));
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] {
        return closed || t - consumed < (int64_t)capacity;
      });
      if (closed) return;
      size_t s = (size_t)(t % (int64_t)capacity);
      slots[s] = std::move(item);
      slot_ticket[s] = t;
      cv_ready.notify_all();
    }
  }
};

extern "C" void* ssn_win_prefetch_open(const int32_t* centers,
                                       const int32_t* ctxs, int64_t n, int cw,
                                       int64_t batch, int64_t block, int epochs,
                                       int capacity, int nworkers,
                                       uint64_t seed) {
  if (n <= 0 || cw <= 0 || batch <= 0 || batch > n || epochs <= 0)
    return nullptr;
  if (block <= 0) block = 1;
  if (batch % block) return nullptr;  // kernel blocks must tile batches
  WinPrefetcher* p = new WinPrefetcher();
  p->c = centers;
  p->x = ctxs;
  p->cw = cw;
  p->batch = batch;
  p->block = block;
  p->nblocks = n / block;
  p->blocks_per_batch = batch / block;
  p->batches_per_epoch = p->nblocks / p->blocks_per_batch;
  p->total_batches = (int64_t)epochs * p->batches_per_epoch;
  if (p->total_batches <= 0) {
    delete p;
    return nullptr;
  }
  p->capacity = (size_t)(capacity > 0 ? capacity : 4);
  p->slots.resize(p->capacity);
  p->slot_ticket.assign(p->capacity, -1);
  p->order.resize((size_t)((int64_t)epochs * p->nblocks));
  for (int e = 0; e < epochs; ++e) {
    int64_t* o = p->order.data() + (int64_t)e * p->nblocks;
    for (int64_t i = 0; i < p->nblocks; ++i) o[i] = i;
    fy_shuffle(o, p->nblocks, seed + (uint64_t)e);
  }
  int nw = nworkers > 0 ? nworkers : default_workers();
  if ((int64_t)nw > p->total_batches) nw = (int)p->total_batches;
  for (int w = 0; w < nw; ++w)
    p->workers.emplace_back([p] { p->work(); });
  return p;
}

// 1 = batch written; 0 = end of input (poison-free shutdown semantics).
extern "C" int ssn_win_prefetch_next(void* h, int32_t* centers_out,
                                     int32_t* ctxs_out) {
  WinPrefetcher* p = (WinPrefetcher*)h;
  std::vector<int32_t> item;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->consumed >= p->total_batches) return 0;
    size_t s = (size_t)(p->consumed % (int64_t)p->capacity);
    p->cv_ready.wait(lk, [&] {
      return p->closed || p->slot_ticket[s] == p->consumed;
    });
    if (p->closed) return 0;
    item = std::move(p->slots[s]);
    p->slot_ticket[s] = -1;
    ++p->consumed;
    p->cv_free.notify_all();
  }
  std::memcpy(centers_out, item.data(), (size_t)p->batch * sizeof(int32_t));
  std::memcpy(ctxs_out, item.data() + p->batch,
              (size_t)(p->batch * p->cw) * sizeof(int32_t));
  return 1;
}

extern "C" void ssn_win_prefetch_close(void* h) {
  WinPrefetcher* p = (WinPrefetcher*)h;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->closed = true;
    p->cv_ready.notify_all();
    p->cv_free.notify_all();
  }
  for (auto& w : p->workers)
    if (w.joinable()) w.join();
  delete p;
}


// ---------------------------------------------------------------- tiered ---
// Host-side hot loops of the tiered parameter store (tiered/store.py). Both
// run per step on the _Prefetcher producer/consumer threads; ctypes releases
// the GIL for the duration of the call, so the other thread keeps moving.

// Master-row ids -> cache-slot-space ids (TieredTable.remap). slot_of maps
// unit -> slot (-1 = non-resident); group > 1 packs G logical rows per cache
// unit (packed-small tiles). Returns the number of non-resident hits; out is
// fully written either way so the caller can raise with context.
extern "C" int64_t ssn_tier_remap(const int64_t* slot_of, const int32_t* rows,
                                  int64_t n, int64_t group, int32_t* out) {
  int64_t bad = 0;
  if (group > 1) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t r = (int64_t)rows[i];
      int64_t s = slot_of[r / group];
      if (s < 0) ++bad;
      out[i] = (int32_t)(s * group + r % group);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      int64_t s = slot_of[(int64_t)rows[i]];
      if (s < 0) ++bad;
      out[i] = (int32_t)s;
    }
  }
  return bad;
}

// CLOCK hand sweep with pinned-slot masking (TieredTable._allocate eviction
// loop, bit-exact): skip pinned slots, halve nonzero reference counters as
// the hand passes (hot rows survive O(log ref) sweeps), take zero-ref slots
// as victims and pin them so one sweep never picks a slot twice. Mutates
// ref and pinned in place, writes n victim slots to out, returns the new
// hand position. The caller guarantees n reachable victims exist (the
// working-set-vs-budget check in ensure()), matching the Python loop's
// termination contract.
extern "C" int64_t ssn_tier_clock_sweep(uint8_t* ref, uint8_t* pinned,
                                        int64_t budget, int64_t hand,
                                        int64_t n, int64_t* out) {
  int64_t k = 0;
  while (k < n) {
    int64_t h = hand;
    hand = (hand + 1) % budget;
    if (pinned[h]) continue;
    if (ref[h] > 0) {
      ref[h] >>= 1;
      continue;
    }
    out[k++] = h;
    pinned[h] = 1;
  }
  return hand;
}
