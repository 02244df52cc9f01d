// The port's native reader: an OpenMP text parser, a chunked reader and a
// value -> bin encoder, bound to Python with ctypes (native.py).
//
// The port's own copy of src/native/lgbm_native.cpp, with its entry points
// and their C signatures, held to one contract: on every file it accepts,
// its float64 matrix is bitwise the one the port's numpy parser
// (io/parser.py) gives, with NaN in the same places.  Where the two could
// differ the reader refuses the file (a non-zero code, -1 from the chunk
// reader) and the numpy parser answers, so it accepts less than the numpy
// parser does:
//
// * a number is a plain decimal, [+-]?(d+(.d*)?|.d+)([eE][+-]?d+)?, at most
//   kMaxToken bytes: glibc's strtod and Python's float round it correctly,
//   so both give the same double.  Hex floats, inf, nan(...), digit
//   underscores and leading or trailing blanks inside a field (which
//   strtod and float treat differently) are refused;
// * an empty field and the NA tokens of io/parser.py's NA_TOKENS are NaN
//   (the positive quiet NaN the numpy parser writes);
// * the separator is the numpy parser's: ',' for csv; a tab when the first
//   data row holds one (two tabs make an empty field); else runs of blanks
//   and tabs.  A row with more fields than the first data row is refused,
//   a shorter one padded with NaN;
// * lines end at '\n' with an optional '\r' before it; a line of blanks
//   and tabs is skipped; the header is the first physical line.  Any other
//   byte (a control character, a lone '\r', which Python reads as a line
//   end, non-ASCII) is refused wherever it lands;
// * LibSVM: "label idx:value ..." with a plain decimal label and values and
//   indices of decimal digits; the label goes to column 0.  qid tokens are
//   refused.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr size_t kMaxToken = 127;   // longer numbers are refused
constexpr long kMaxIndexDigits = 9;  // LibSVM feature indices < 1e9
int g_threads = 0;                   // 0: the OpenMP default

int Threads() {
#ifdef _OPENMP
  return g_threads > 0 ? g_threads : omp_get_max_threads();
#else
  return 1;
#endif
}

// A whole regular file in memory, NUL-terminated.
bool ReadFile(const char* path, std::vector<char>* out) {
  FILE* fp = std::fopen(path, "rb");
  if (fp == nullptr) return false;
  if (std::fseek(fp, 0, SEEK_END) != 0) {
    std::fclose(fp);
    return false;
  }
  long size = std::ftell(fp);
  if (size < 0) {  // not seekable (a FIFO): the numpy parser reads it
    std::fclose(fp);
    return false;
  }
  std::fseek(fp, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(out->data(), 1, static_cast<size_t>(size), fp);
  std::fclose(fp);
  if (got != static_cast<size_t>(size)) return false;
  (*out)[got] = '\0';
  return true;
}

inline bool IsBlank(char c) { return c == ' ' || c == '\t'; }
inline bool IsDigit(char c) { return c >= '0' && c <= '9'; }

// [s, e) with its trailing '\r' dropped.
inline const char* LineEnd(const char* s, const char* e) {
  return (e > s && e[-1] == '\r') ? e - 1 : e;
}

bool IsBlankLine(const char* s, const char* e) {
  for (const char* p = s; p < e; ++p)
    if (!IsBlank(*p)) return false;
  return true;
}

// The end of the header line (the first physical line) in [s, e), past its
// '\n'; nullptr when it holds a lone '\r', which Python ends a line at.
const char* SkipHeader(const char* s, const char* e) {
  const char* nl = static_cast<const char*>(std::memchr(s, '\n', e - s));
  const char* end = nl ? nl : e;
  for (const char* p = s; p < LineEnd(s, end); ++p)
    if (*p == '\r') return nullptr;
  return nl ? nl + 1 : e;
}

// Each non-blank line of [s, e) as (begin, end) offsets from base.
void SplitLines(const char* base, const char* s, const char* e,
                std::vector<std::pair<size_t, size_t>>* lines) {
  const char* p = s;
  while (p < e) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', e - p));
    const char* end = nl ? nl : e;
    const char* le = LineEnd(p, end);
    if (!IsBlankLine(p, le)) lines->emplace_back(p - base, le - base);
    p = nl ? nl + 1 : e;
  }
}

bool IsNaToken(const char* p, const char* end) {
  static const char* kNa[] = {
      "NA",   "N/A", "NaN",  "nan",  "NULL", "null", "None", "n/a",
      "<NA>", "#NA", "#N/A", "-NaN", "-nan", "NaT",
  };
  size_t len = static_cast<size_t>(end - p);
  for (const char* na : kNa)
    if (std::strlen(na) == len && std::strncmp(p, na, len) == 0) return true;
  return false;
}

// True when [p, e) is a plain decimal (the grammar above).
bool IsPlainDecimal(const char* p, const char* e) {
  if (p < e && (*p == '+' || *p == '-')) ++p;
  long int_digits = 0, frac_digits = 0;
  while (p < e && IsDigit(*p)) ++p, ++int_digits;
  if (p < e && *p == '.') {
    ++p;
    while (p < e && IsDigit(*p)) ++p, ++frac_digits;
  }
  if (int_digits + frac_digits == 0) return false;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < e && (*p == '+' || *p == '-')) ++p;
    long exp_digits = 0;
    while (p < e && IsDigit(*p)) ++p, ++exp_digits;
    if (exp_digits == 0) return false;
  }
  return p == e;
}

// A plain decimal [p, e) -> *out; false when it is not one.
bool ParseNumber(const char* p, const char* e, double* out) {
  size_t len = static_cast<size_t>(e - p);
  if (len == 0 || len > kMaxToken || !IsPlainDecimal(p, e)) return false;
  char buf[kMaxToken + 1];
  std::memcpy(buf, p, len);
  buf[len] = '\0';
  char* q = nullptr;
  *out = std::strtod(buf, &q);
  return q == buf + len;
}

// One delimited field: empty or an NA token -> NaN, else a plain decimal.
inline bool ParseField(const char* p, const char* e, double* out) {
  if (p == e || IsNaToken(p, e)) {
    *out = NAN;
    return true;
  }
  return ParseNumber(p, e, out);
}

// The fields of a separated line, as io/parser.py's _split counts them.
long CountFields(const char* s, const char* end, char sep) {
  long cnt = 0;
  if (sep == ' ') {
    const char* p = s;
    while (p < end) {
      while (p < end && IsBlank(*p)) ++p;
      if (p >= end) break;
      ++cnt;
      while (p < end && !IsBlank(*p)) ++p;
    }
    return cnt;
  }
  cnt = 1;
  for (const char* p = s; p < end; ++p)
    if (*p == sep) ++cnt;
  return cnt;
}

// ',' for csv (fmt 1); else a tab when the first data row holds one, else
// ' ' (runs of blanks and tabs).
char Separator(const char* s, const char* e, int fmt) {
  if (fmt == 1) return ',';
  return std::memchr(s, '\t', e - s) ? '\t' : ' ';
}

// One data line into row[0..cols); false when the numpy parser could read
// it otherwise (a bad field, more fields than cols).
bool ParseDelimited(const char* s, const char* end, char sep, double* row,
                    long cols) {
  long j = 0;
  const char* p = s;
  if (sep == ' ') {
    while (true) {
      while (p < end && IsBlank(*p)) ++p;
      if (p >= end) break;
      const char* f = p;
      while (p < end && !IsBlank(*p)) ++p;
      if (j >= cols || !ParseField(f, p, &row[j])) return false;
      ++j;
    }
  } else {
    while (true) {
      const char* f = p;
      while (p < end && *p != sep) ++p;
      if (j >= cols || !ParseField(f, p, &row[j])) return false;
      ++j;
      if (p >= end) break;
      ++p;  // past the separator: another field follows, maybe empty
    }
  }
  while (j < cols) row[j++] = NAN;  // short rows pad with NaN
  return true;
}

// Parse lines[0..n) of buf into data (row-major [n, cols]) in parallel.
bool ParseRows(const char* buf,
               const std::vector<std::pair<size_t, size_t>>& lines, long n,
               char sep, long cols, double* data) {
  int bad = 0;
#pragma omp parallel for schedule(static) num_threads(Threads()) \
    reduction(| : bad)
  for (long i = 0; i < n; ++i) {
    if (!ParseDelimited(buf + lines[i].first, buf + lines[i].second, sep,
                        data + i * cols, cols))
      bad |= 1;
  }
  return bad == 0;
}

}  // namespace

extern "C" {

void lgbm_free(void* p) { std::free(p); }

int lgbm_num_threads() { return Threads(); }

// Threads of every parallel loop below (<= 0: the OpenMP default).
void lgbm_set_num_threads(int n) { g_threads = n; }

// The format of the first non-blank data line among the first two:
// 3 = libsvm (every token after the first an idx:value pair), 1 = csv (a
// comma and no tab), 2 = tab or blank separated; -1 when unreadable.
int lgbm_detect_format(const char* path, int skip_header) {
  FILE* fp = std::fopen(path, "rb");
  if (fp == nullptr) return -1;
  std::vector<std::vector<char>> head;
  int want = skip_header ? 3 : 2, c = 0;
  head.emplace_back();
  while (static_cast<int>(head.size()) <= want && (c = std::fgetc(fp)) != EOF) {
    if (c == '\n')
      head.emplace_back();
    else
      head.back().push_back(static_cast<char>(c));
  }
  std::fclose(fp);
  for (size_t k = skip_header ? 1 : 0;
       k < head.size() && static_cast<int>(k) < want; ++k) {
    const char* s = head[k].data();
    const char* e = LineEnd(s, s + head[k].size());
    bool any_token = false, all_colon = true, has_tab = false,
         has_comma = false;
    int token_i = 0;
    const char* p = s;
    while (p < e) {
      while (p < e && (*p == ' ' || *p == '\t' || *p == ',')) {
        has_tab |= *p == '\t';
        has_comma |= *p == ',';
        ++p;
      }
      if (p >= e) break;
      const char* tok = p;
      while (p < e && *p != ' ' && *p != '\t' && *p != ',') ++p;
      if (token_i++ > 0) {
        any_token = true;
        if (!std::memchr(tok, ':', p - tok)) all_colon = false;
      }
    }
    if (token_i == 0) continue;  // a blank line
    if (any_token && all_colon) return 3;
    if (has_tab) return 2;
    return has_comma ? 1 : 2;
  }
  return 1;
}

// A csv (fmt 1) or tab / blank separated (fmt 2) file -> a row-major
// float64 matrix in *out_data (free with lgbm_free).  0 on success (0 rows
// and 0 columns for a file without data lines); 1 unreadable, 3 no fields,
// 4 out of memory, 5 a line or byte refused (see the contract above).
int lgbm_parse_delimited(const char* path, int fmt, int skip_header,
                         double** out_data, long* out_rows, long* out_cols) {
  std::vector<char> buf;
  if (!ReadFile(path, &buf)) return 1;
  const char* s = buf.data();
  const char* e = s + buf.size() - 1;
  if (skip_header && (s = SkipHeader(s, e)) == nullptr) return 5;
  std::vector<std::pair<size_t, size_t>> lines;
  SplitLines(buf.data(), s, e, &lines);
  long n = static_cast<long>(lines.size());
  *out_data = nullptr;
  *out_rows = *out_cols = 0;
  if (n == 0) return 0;
  const char* f0 = buf.data() + lines[0].first;
  const char* f1 = buf.data() + lines[0].second;
  char sep = Separator(f0, f1, fmt);
  long cols = CountFields(f0, f1, sep);
  if (cols <= 0) return 3;
  double* data = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<size_t>(n) * cols));
  if (data == nullptr) return 4;
  if (!ParseRows(buf.data(), lines, n, sep, cols, data)) {
    std::free(data);
    return 5;
  }
  *out_data = data;
  *out_rows = n;
  *out_cols = cols;
  return 0;
}

// A LibSVM file -> a dense row-major matrix, the label in column 0 and
// feature j in column j + 1; codes as lgbm_parse_delimited's.
int lgbm_parse_libsvm(const char* path, int skip_header, double** out_data,
                      long* out_rows, long* out_cols) {
  std::vector<char> buf;
  if (!ReadFile(path, &buf)) return 1;
  const char* s = buf.data();
  const char* e = s + buf.size() - 1;
  if (skip_header && (s = SkipHeader(s, e)) == nullptr) return 5;
  std::vector<std::pair<size_t, size_t>> lines;
  SplitLines(buf.data(), s, e, &lines);
  long n = static_cast<long>(lines.size());
  *out_data = nullptr;
  *out_rows = *out_cols = 0;
  if (n == 0) return 0;

  // pass 1: every token checked, the largest feature index
  long max_idx = -1;
  int bad = 0;
#pragma omp parallel for schedule(static) num_threads(Threads()) \
    reduction(max : max_idx) reduction(| : bad)
  for (long i = 0; i < n; ++i) {
    const char* p = buf.data() + lines[i].first;
    const char* end = buf.data() + lines[i].second;
    bool first = true;
    while (p < end) {
      while (p < end && IsBlank(*p)) ++p;
      if (p >= end) break;
      const char* tok = p;
      while (p < end && !IsBlank(*p)) ++p;
      double v;
      if (first) {
        if (!ParseNumber(tok, p, &v)) bad |= 1;
        first = false;
        continue;
      }
      const char* colon =
          static_cast<const char*>(std::memchr(tok, ':', p - tok));
      long digits = colon ? colon - tok : 0;
      bool ok = digits > 0 && digits <= kMaxIndexDigits &&
                ParseNumber(colon + 1, p, &v);
      for (const char* q = tok; ok && q < colon; ++q) ok = IsDigit(*q);
      if (!ok) {
        bad |= 1;
        continue;
      }
      long idx = std::strtol(tok, nullptr, 10);
      if (idx > max_idx) max_idx = idx;
    }
  }
  if (bad) return 5;
  long cols = max_idx + 2;
  double* data = static_cast<double*>(
      std::calloc(static_cast<size_t>(n) * cols, sizeof(double)));
  if (data == nullptr) return 4;

  // pass 2: fill the rows (a repeated index keeps its last value)
#pragma omp parallel for schedule(static) num_threads(Threads())
  for (long i = 0; i < n; ++i) {
    const char* p = buf.data() + lines[i].first;
    const char* end = buf.data() + lines[i].second;
    double* row = data + i * cols;
    bool first = true;
    while (p < end) {
      while (p < end && IsBlank(*p)) ++p;
      if (p >= end) break;
      const char* tok = p;
      while (p < end && !IsBlank(*p)) ++p;
      if (first) {
        ParseNumber(tok, p, &row[0]);
        first = false;
        continue;
      }
      const char* colon =
          static_cast<const char*>(std::memchr(tok, ':', p - tok));
      ParseNumber(colon + 1, p, &row[std::strtol(tok, nullptr, 10) + 1]);
    }
  }
  *out_data = data;
  *out_rows = n;
  *out_cols = cols;
  return 0;
}

// Values -> bins by binary search over each numerical feature's upper
// bounds (BinMapper.value_to_bin: NaN as 0.0, the first bound >= the
// value, at most the last bin).  X is row-major [n, f_total]; col_idx[j]
// names feature j's column; bounds holds every feature's bounds, feature j
// at [bound_offsets[j], bound_offsets[j + 1]).  out is row-major
// [n, n_used], uint8 or (out_is_u16) uint16.
void lgbm_value_to_bin(const double* X, long n, long f_total,
                       const long* col_idx, long n_used,
                       const double* bounds, const long* bound_offsets,
                       void* out, int out_is_u16) {
  uint8_t* out8 = static_cast<uint8_t*>(out);
  uint16_t* out16 = static_cast<uint16_t*>(out);
#pragma omp parallel for schedule(static) num_threads(Threads())
  for (long i = 0; i < n; ++i) {
    const double* row = X + i * f_total;
    for (long j = 0; j < n_used; ++j) {
      double v = row[col_idx[j]];
      if (std::isnan(v)) v = 0.0;
      const double* b = bounds + bound_offsets[j];
      long lo = 0, hi = bound_offsets[j + 1] - bound_offsets[j] - 1;
      while (lo < hi) {
        long mid = (lo + hi) >> 1;
        if (b[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (out_is_u16)
        out16[i * n_used + j] = static_cast<uint16_t>(lo);
      else
        out8[i * n_used + j] = static_cast<uint8_t>(lo);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// The chunked reader (two-round loading and the batch tier): a block of
// the file at a time, so memory is one block and the caller's chunk.

namespace {

constexpr size_t kBlockBytes = 4 << 20;

struct ChunkReader {
  FILE* fp = nullptr;
  char sep = ',';
  long cols = 0;
  bool eof = false;
  std::vector<char> carry;  // text not handed out yet
};

constexpr size_t kNone = static_cast<size_t>(-1);

// The index of the first '\n' in v at or after from, or kNone.
size_t FindNl(const std::vector<char>& v, size_t from) {
  if (from >= v.size()) return kNone;
  const void* p = std::memchr(v.data() + from, '\n', v.size() - from);
  return p ? static_cast<const char*>(p) - v.data() : kNone;
}

// Append one block of the file to r->carry; false at the end of the file.
bool ReadBlock(ChunkReader* r) {
  size_t off = r->carry.size();
  r->carry.resize(off + kBlockBytes);
  size_t got = std::fread(r->carry.data() + off, 1, kBlockBytes, r->fp);
  r->carry.resize(off + got);
  if (got == 0) r->eof = true;
  return got > 0;
}

}  // namespace

extern "C" {

// Open a csv (fmt 1) or tab / blank separated (fmt 2) file; *out_cols gets
// the first data row's fields (0 for a file without data lines).  nullptr
// when the file cannot be read or its header holds a lone '\r'.
void* lgbm_chunk_open(const char* path, int fmt, int skip_header,
                      long* out_cols) {
  FILE* fp = std::fopen(path, "rb");
  if (fp == nullptr) return nullptr;
  ChunkReader* r = new ChunkReader();
  r->fp = fp;
  if (skip_header) {
    while (FindNl(r->carry, 0) == kNone && ReadBlock(r)) {
    }
    const char* s = r->carry.data();
    const char* after = SkipHeader(s, s + r->carry.size());
    if (after == nullptr) {
      std::fclose(fp);
      delete r;
      return nullptr;
    }
    r->carry.erase(r->carry.begin(), r->carry.begin() + (after - s));
  }
  // the first non-blank line sets the separator and the width
  size_t start = 0;
  while (true) {
    size_t nl = FindNl(r->carry, start);
    if (nl == kNone && !r->eof) {
      ReadBlock(r);
      continue;
    }
    const char* s = r->carry.data();
    const char* le = LineEnd(s + start, s + (nl == kNone ? r->carry.size()
                                                          : nl));
    if (!IsBlankLine(s + start, le)) {
      r->sep = Separator(s + start, le, fmt);
      r->cols = CountFields(s + start, le, r->sep);
      break;
    }
    if (nl == kNone) break;  // no data line
    start = nl + 1;
  }
  *out_cols = r->cols;
  return r;
}

// Up to max_rows data rows into out (row-major [max_rows, cols]): the rows
// parsed, 0 at the end of the file, -1 when a row is refused (nothing is
// consumed then).
long lgbm_chunk_next(void* handle, double* out, long max_rows) {
  ChunkReader* r = static_cast<ChunkReader*>(handle);
  if (r->cols == 0) return 0;
  std::vector<std::pair<size_t, size_t>> lines;
  size_t scan = 0;      // carry bytes scanned for lines
  size_t consumed = 0;  // bytes up to the last line's '\n'
  while (static_cast<long>(lines.size()) < max_rows) {
    size_t nl = FindNl(r->carry, scan);
    if (nl == kNone && !r->eof) {
      ReadBlock(r);
      continue;
    }
    size_t end = nl == kNone ? r->carry.size() : nl;
    if (end == scan && nl == kNone) break;  // the end of the file
    const char* s = r->carry.data();
    const char* le = LineEnd(s + scan, s + end);
    if (!IsBlankLine(s + scan, le)) lines.emplace_back(scan, le - s);
    consumed = scan = nl == kNone ? end : nl + 1;
  }
  long n = static_cast<long>(lines.size());
  if (n > 0 && !ParseRows(r->carry.data(), lines, n, r->sep, r->cols, out))
    return -1;
  r->carry.erase(r->carry.begin(), r->carry.begin() + consumed);
  return n;
}

void lgbm_chunk_close(void* handle) {
  ChunkReader* r = static_cast<ChunkReader*>(handle);
  if (r->fp) std::fclose(r->fp);
  delete r;
}

}  // extern "C"
