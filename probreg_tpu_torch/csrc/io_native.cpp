// The port's native point-cloud loader: PLY / PCD readers, voxel
// downsampling, a threaded batch loader and a Morton (Z-order) sort.
//
// Counterpart of probreg_tpu/cc/io_native.cpp, behind a plain C interface
// (no Python or numpy headers) and loaded with ctypes, which releases the
// interpreter lock for the length of every call. Host code, built by
// ops/_build.py with the host C++ compiler (C++17, IEEE arithmetic: no
// -ffast-math and no contraction into FMAs, so every result below has the
// numpy version's bits).
//
// What each entry computes, and the bits it keeps:
// * probreg_read_cloud: x/y/z as float64 from a PLY (ascii, binary little-
//   or big-endian, any extra scalar properties, CRLF headers, end_header
//   matched only as a whole line) or a PCD (ascii or binary) file. Ascii
//   numbers are parsed with correct rounding, as Python's float() parses them.
// * probreg_voxel_down_sample: (N, 3) float64 -> the mean of each occupied
//   voxel, keys floor((p - min) / voxel) as numpy computes them, one
//   float64 sum a voxel in input order divided by the count, the voxels in
//   lexicographic key order (numpy: np.unique of the keys, np.add.at).
// * probreg_voxel_count_f64 / _f32: the number of occupied voxels, the keys
//   computed in the points' own precision (as numpy computes them for a
//   float32 array and a Python float voxel).
// * probreg_read_batch: many files read (and downsampled) on a pool of
//   std::threads, outputs in input order, the first failing file reported.
// * probreg_morton_order: the stable Z-order permutation of (N, 2|3)
//   float32 points, with ops/spatial.morton_code's quantization and codes.
//
// Grouping: a voxel's keys are packed into one integer in row order and,
// with the point's index below them in one 64-bit word, sorted by a stable
// LSD radix sort, so each voxel's points stay in input order; grids too
// large for that sort rows with std::stable_sort. Variable-size outputs are
// malloc'ed here and released by probreg_free.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// Status codes of the C entries: 0 success, > 0 the errno of a file that
// could not be opened or read, kFormat a malformed or unsupported file,
// kFailed anything else (the message says what).
constexpr int kFormat = -1;
constexpr int kFailed = -2;

struct Failure {
  int code;
  std::string msg;
};

bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

std::vector<std::string> split(const char* s, const char* e) {
  std::vector<std::string> out;
  while (s < e) {
    while (s < e && is_space(*s)) ++s;
    const char* t = s;
    while (t < e && !is_space(*t)) ++t;
    if (t > s) out.emplace_back(s, t);
    s = t;
  }
  return out;
}

std::string read_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) throw Failure{errno ? errno : EIO, "cannot open " + path};
  std::string buf;
  char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    buf.append(chunk, got);
  const bool bad = std::ferror(f) != 0;
  std::fclose(f);
  if (bad) throw Failure{EIO, "cannot read " + path};
  return buf;
}

int64_t parse_int(const std::string& tok, const char* what) {
  char* end = nullptr;
  errno = 0;
  const long long v = std::strtoll(tok.c_str(), &end, 10);
  if (tok.empty() || *end != '\0' || errno != 0)
    throw Failure{kFormat, std::string("bad ") + what + " '" + tok + "'"};
  return v;
}

// Whitespace-separated numbers of an ascii body. from_chars rounds
// correctly, as Python's float() and strtod do; a leading '+' (which
// float() takes) is skipped, and a value out of range goes through strtod,
// which gives float()'s inf or 0.
struct AsciiBody {
  const char* p;
  const char* e;

  double next() {
    while (p < e && is_space(*p)) ++p;
    if (p == e) throw Failure{kFormat, "ascii body ends early"};
    const char* t = p;
    while (t < e && !is_space(*t)) ++t;
    const char* s = p + (*p == '+' && t - p > 1 && p[1] != '-' && p[1] != '+');
    double v;
    const auto r = std::from_chars(s, t, v);
    if (r.ec == std::errc::result_out_of_range && r.ptr == t) {
      const std::string tok(p, t);
      v = std::strtod(tok.c_str(), nullptr);
    } else if (r.ec != std::errc() || r.ptr != t) {
      throw Failure{kFormat, "not a number: '" + std::string(p, t) + "'"};
    }
    p = t;
    return v;
  }
};

// One scalar field of a binary record: bytes, 'f' float / 'i' int / 'u'
// unsigned, byte order.
struct Field {
  int size;
  char kind;
};

double read_scalar(const char* p, Field fd, bool big_endian) {
  unsigned char b[8];
  std::memcpy(b, p, fd.size);
  if (big_endian) std::reverse(b, b + fd.size);
  if (fd.kind == 'f') {
    if (fd.size == 4) {
      float v;
      std::memcpy(&v, b, 4);
      return v;
    }
    double v;
    std::memcpy(&v, b, 8);
    return v;
  }
  uint64_t u = 0;
  std::memcpy(&u, b, fd.size);  // little-endian host
  if (fd.kind == 'u') return static_cast<double>(u);
  const int shift = 64 - 8 * fd.size;
  return static_cast<double>(static_cast<int64_t>(u << shift) >> shift);
}

bool ply_type(const std::string& t, Field& fd) {
  static const struct {
    const char* name;
    Field fd;
  } kTypes[] = {{"float", {4, 'f'}},  {"float32", {4, 'f'}},
                {"float64", {8, 'f'}}, {"double", {8, 'f'}},
                {"uchar", {1, 'u'}},  {"uint8", {1, 'u'}},
                {"char", {1, 'i'}},   {"int8", {1, 'i'}},
                {"short", {2, 'i'}},  {"int16", {2, 'i'}},
                {"ushort", {2, 'u'}}, {"uint16", {2, 'u'}},
                {"int", {4, 'i'}},    {"int32", {4, 'i'}},
                {"uint", {4, 'u'}},   {"uint32", {4, 'u'}}};
  for (const auto& k : kTypes)
    if (t == k.name) {
      fd = k.fd;
      return true;
    }
  return false;
}

// A header line is the terminator only when it is exactly "end_header",
// then optional blanks and one optional '\r' (a comment that contains the
// word does not end the header).
bool is_end_header(const char* s, const char* e) {
  static const char kTok[] = "end_header";
  const size_t n = sizeof(kTok) - 1;
  if (static_cast<size_t>(e - s) < n || std::memcmp(s, kTok, n) != 0)
    return false;
  if (e > s + n && e[-1] == '\r') --e;
  for (const char* p = s + n; p < e; ++p)
    if (*p != ' ' && *p != '\t') return false;
  return true;
}

void read_ply(const std::string& path, std::vector<double>& xyz) {
  const std::string raw = read_file(path);
  const char* data = raw.data();
  const size_t size = raw.size();
  struct Prop {
    std::string name;
    Field fd;
  };
  std::string format;
  bool first_element = true, vertex = false, has_list = false;
  int64_t count = -1;
  std::vector<Prop> props;
  size_t pos = 0, body = std::string::npos;
  while (pos < size) {
    const char* nl = static_cast<const char*>(
        std::memchr(data + pos, '\n', size - pos));
    const size_t end = nl ? static_cast<size_t>(nl - data) : size;
    if (is_end_header(data + pos, data + end)) {
      body = end + 1;
      break;
    }
    const auto tok = split(data + pos, data + end);
    pos = end + 1;
    if (tok.empty()) continue;
    if (tok[0] == "format" && tok.size() > 1) {
      format = tok[1];
    } else if (tok[0] == "element" && tok.size() > 2) {
      vertex = first_element && tok[1] == "vertex";
      if (vertex) count = parse_int(tok[2], "vertex count");
      if (first_element && !vertex)
        throw Failure{kFormat, "PLY without leading vertex element"};
      first_element = false;
    } else if (tok[0] == "property" && vertex && tok.size() > 2) {
      if (tok[1] == "list") {
        has_list = true;
        continue;
      }
      Field fd;
      if (!ply_type(tok[1], fd))
        throw Failure{kFormat, "unknown PLY type " + tok[1]};
      props.push_back({tok.back(), fd});
    }
  }
  if (body == std::string::npos)
    throw Failure{kFormat, "not a PLY file: " + path};
  if (count < 0) throw Failure{kFormat, "PLY without leading vertex element"};
  if (has_list)
    throw Failure{kFormat, "list property in vertex element unsupported"};
  int col[3] = {-1, -1, -1};
  for (int k = 0; k < 3; ++k) {
    const char* want = k == 0 ? "x" : (k == 1 ? "y" : "z");
    for (size_t j = 0; j < props.size() && col[k] < 0; ++j)
      if (props[j].name == want) col[k] = static_cast<int>(j);
    if (col[k] < 0) throw Failure{kFormat, "PLY lacks x/y/z"};
  }
  body = std::min(body, size);
  xyz.assign(static_cast<size_t>(count) * 3, 0.0);
  if (format == "ascii") {
    AsciiBody in{data + body, data + size};
    std::vector<double> row(props.size());
    for (int64_t i = 0; i < count; ++i) {
      for (auto& v : row) v = in.next();
      for (int k = 0; k < 3; ++k) xyz[i * 3 + k] = row[col[k]];
    }
    return;
  }
  // As the numpy reader: anything but binary_little_endian is big-endian.
  const bool big = format != "binary_little_endian";
  size_t stride = 0;
  std::vector<size_t> off(props.size());
  for (size_t j = 0; j < props.size(); ++j) {
    off[j] = stride;
    stride += props[j].fd.size;
  }
  if (static_cast<size_t>(count) * stride > size - body)
    throw Failure{kFormat, "truncated PLY body"};
  const char* rec = data + body;
  for (int64_t i = 0; i < count; ++i, rec += stride)
    for (int k = 0; k < 3; ++k)
      xyz[i * 3 + k] = read_scalar(rec + off[col[k]], props[col[k]].fd, big);
}

void read_pcd(const std::string& path, std::vector<double>& xyz) {
  const std::string raw = read_file(path);
  const char* data = raw.data();
  const size_t size = raw.size();
  std::vector<std::string> fields, sizes, types, counts;
  std::string kind, points;
  size_t pos = 0, body = std::string::npos;
  while (pos < size) {
    const char* nl = static_cast<const char*>(
        std::memchr(data + pos, '\n', size - pos));
    if (!nl) break;  // the DATA line ends with a newline
    const size_t end = static_cast<size_t>(nl - data);
    auto tok = split(data + pos, data + end);
    pos = end + 1;
    if (tok.empty()) continue;
    const std::string key = tok[0];
    tok.erase(tok.begin());
    if (key == "DATA" && !tok.empty()) {
      kind = tok[0];
      body = pos;
      break;
    }
    if (key == "FIELDS" && fields.empty()) fields = tok;
    if (key == "SIZE" && sizes.empty()) sizes = tok;
    if (key == "TYPE" && types.empty()) types = tok;
    if (key == "COUNT" && counts.empty()) counts = tok;
    if (key == "POINTS" && points.empty() && !tok.empty()) points = tok[0];
  }
  if (body == std::string::npos)
    throw Failure{kFormat, "not a PCD file: " + path};
  if (fields.empty() || sizes.empty() || types.empty() || points.empty())
    throw Failure{kFormat, "not a PCD file (missing FIELDS, SIZE, TYPE or "
                           "POINTS): " + path};
  const int64_t n = parse_int(points, "POINTS");
  const size_t nf = fields.size();
  std::vector<int64_t> cnt(nf, 1);
  if (!counts.empty()) {
    if (counts.size() != nf) throw Failure{kFormat, "COUNT per field"};
    for (size_t j = 0; j < nf; ++j) cnt[j] = parse_int(counts[j], "COUNT");
  }
  // The last field of each name wins, as in a dict built in field order.
  int col[3] = {-1, -1, -1};
  for (size_t j = 0; j < nf; ++j)
    for (int k = 0; k < 3; ++k)
      if (fields[j] == (k == 0 ? "x" : (k == 1 ? "y" : "z")))
        col[k] = static_cast<int>(j);
  if (col[0] < 0 || col[1] < 0 || col[2] < 0)
    throw Failure{kFormat, "PCD lacks x/y/z"};
  xyz.assign(static_cast<size_t>(n) * 3, 0.0);
  if (kind == "ascii") {
    int64_t ncols = 0;
    std::vector<int64_t> first(nf);
    for (size_t j = 0; j < nf; ++j) {
      first[j] = ncols;
      ncols += cnt[j];
    }
    AsciiBody in{data + body, data + size};
    std::vector<double> row(ncols);
    for (int64_t i = 0; i < n; ++i) {
      for (auto& v : row) v = in.next();
      for (int k = 0; k < 3; ++k) xyz[i * 3 + k] = row[first[col[k]]];
    }
    return;
  }
  if (kind != "binary")
    throw Failure{kFormat, "unsupported PCD DATA kind: " + kind};
  if (sizes.size() != nf || types.size() != nf)
    throw Failure{kFormat, "SIZE and TYPE per field"};
  size_t stride = 0;
  std::vector<size_t> off(nf);
  std::vector<Field> fd(nf);
  for (size_t j = 0; j < nf; ++j) {
    const int64_t s = parse_int(sizes[j], "SIZE");
    const std::string& t = types[j];
    const char k = t == "F" ? 'f' : (t == "I" ? 'i' : (t == "U" ? 'u' : 0));
    const bool ok = k == 'f' ? (s == 4 || s == 8)
                             : (s == 1 || s == 2 || s == 4 || s == 8);
    if (!k || !ok)
      throw Failure{kFormat, "unsupported PCD field " + t + sizes[j]};
    fd[j] = {static_cast<int>(s), k};
    off[j] = stride;
    stride += static_cast<size_t>(s * cnt[j]);
  }
  if (static_cast<size_t>(n) * stride > size - body)
    throw Failure{kFormat, "truncated PCD body"};
  const char* rec = data + body;
  for (int64_t i = 0; i < n; ++i, rec += stride)
    for (int k = 0; k < 3; ++k)
      xyz[i * 3 + k] = read_scalar(rec + off[col[k]], fd[col[k]], false);
}

void read_cloud(const std::string& path, int kind, std::vector<double>& xyz) {
  if (kind == 0) {
    const size_t dot = path.rfind('.');
    std::string ext = dot == std::string::npos ? "" : path.substr(dot);
    for (auto& c : ext) c = static_cast<char>(std::tolower(c));
    kind = ext == ".ply" ? 1 : (ext == ".pcd" ? 2 : 0);
    if (!kind)
      throw Failure{kFormat, "unsupported point cloud format: " + path};
  }
  if (kind == 1)
    read_ply(path, xyz);
  else
    read_pcd(path, xyz);
}

// ------------------------------------------------------------- threads

// Threads for a pass over n points: one per 2^15 points, at most one per
// core. Results never depend on the count.
int auto_threads(int64_t n) {
  const int64_t hw =
      std::max<int64_t>(1, std::thread::hardware_concurrency());
  return static_cast<int>(std::max<int64_t>(1, std::min(hw, n >> 15)));
}

// f(t, begin, end) for the `threads` contiguous chunks of [0, n), chunk 0
// on the calling thread (and any chunk no thread could be started for).
// f must not throw.
template <typename F>
void parallel_for(int threads, int64_t n, F&& f) {
  auto chunk = [&](int t) { f(t, n * t / threads, n * (t + 1) / threads); };
  std::vector<std::thread> pool;
  int t = 1;
  try {
    for (; t < threads; ++t) pool.emplace_back(chunk, t);
  } catch (const std::system_error&) {
  }
  for (int u = t; u < threads; ++u) chunk(u);
  chunk(0);
  for (auto& th : pool) th.join();
}

// ----------------------------------------------------------- voxel grouping

// Stable LSD radix sort of 64-bit words by their bits [lo, lo + bits),
// kDigit bits a pass; a pass whose digit is the same in every word is
// skipped. Each thread histograms and then scatters its own contiguous
// chunk, the chunks' slots of a bucket in chunk order, so the order is the
// one-thread order. Words carry a point index in their low bits, so each
// equal key keeps its points in input order.
void radix_sort(std::vector<uint64_t>& w, int lo, int bits, int threads) {
  constexpr int kDigit = 11;
  constexpr size_t kBuckets = size_t{1} << kDigit;
  const int64_t n = static_cast<int64_t>(w.size());
  std::vector<uint64_t> w2(n);
  std::vector<size_t> h(threads * kBuckets);
  for (int shift = lo; shift < lo + bits; shift += kDigit) {
    auto digit = [shift](uint64_t x) { return (x >> shift) & (kBuckets - 1); };
    std::fill(h.begin(), h.end(), 0);
    parallel_for(threads, n, [&](int t, int64_t i0, int64_t i1) {
      size_t* ht = h.data() + t * kBuckets;
      for (int64_t i = i0; i < i1; ++i) ++ht[digit(w[i])];
    });
    bool one_bucket = false;
    size_t run = 0;
    for (size_t b = 0; b < kBuckets; ++b) {
      const size_t at = run;
      for (int t = 0; t < threads; ++t) {
        const size_t c = h[t * kBuckets + b];
        h[t * kBuckets + b] = run;
        run += c;
      }
      one_bucket = one_bucket || run - at == static_cast<size_t>(n);
    }
    if (one_bucket) continue;
    parallel_for(threads, n, [&](int t, int64_t i0, int64_t i1) {
      size_t* ht = h.data() + t * kBuckets;
      for (int64_t i = i0; i < i1; ++i) w2[ht[digit(w[i])]++] = w[i];
    });
    w.swap(w2);
  }
}

int bit_width(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

// Per-axis minimum and maximum of (n, d) points.
template <typename T>
void bounds(const T* p, int64_t n, int d, int threads, T* lo, T* hi) {
  std::vector<T> tl(static_cast<size_t>(threads) * d),
      th(static_cast<size_t>(threads) * d);
  parallel_for(threads, n, [&](int t, int64_t i0, int64_t i1) {
    for (int k = 0; k < d; ++k) {
      T mn = p[k], mx = mn;  // any point's: a chunk may be empty
      for (int64_t i = i0; i < i1; ++i) {
        mn = std::min(mn, p[i * d + k]);
        mx = std::max(mx, p[i * d + k]);
      }
      tl[t * d + k] = mn;
      th[t * d + k] = mx;
    }
  });
  for (int k = 0; k < d; ++k) {
    lo[k] = tl[k];
    hi[k] = th[k];
    for (int t = 1; t < threads; ++t) {
      lo[k] = std::min(lo[k], tl[t * d + k]);
      hi[k] = std::max(hi[k], th[t * d + k]);
    }
  }
}

// The points' voxels: `order` lists the point indices grouped by voxel,
// the voxels in lexicographic key order and each voxel's points in input
// order; `start` holds each voxel's first position in `order` and, last,
// the point count.
struct Voxels {
  std::vector<uint32_t> order;
  std::vector<size_t> start;
};

// Keys floor((p - lo) / v) in T, as numpy computes them: p - lo >= 0, so
// the truncating conversion is the floor, and the largest key of an axis
// is the key of its largest coordinate (each step rounds monotonically).
template <typename T>
Voxels group_voxels(const T* p, int64_t n, int d, double voxel_size,
                    int threads) {
  if (!(voxel_size > 0.0))
    throw Failure{kFormat, "voxel_size must be positive"};
  if (static_cast<uint64_t>(n) > UINT32_MAX)
    throw Failure{kFailed, "more than 2^32 points"};
  Voxels g;
  if (n <= 0) {
    g.start.push_back(0);
    return g;
  }
  std::vector<T> lo(d), hi(d);
  bounds(p, n, d, threads, lo.data(), hi.data());
  const T v = static_cast<T>(voxel_size);
  auto key = [&](int64_t i, int k) {
    return static_cast<uint64_t>(
        static_cast<int64_t>((p[i * d + k] - lo[k]) / v));
  };
  // The grid's cells, exactly; 0 when the keys and a point index do not
  // fit one 64-bit word together.
  std::vector<uint64_t> span(d);
  const int ibits = bit_width(static_cast<uint64_t>(n - 1));
  uint64_t cells = 1;
  for (int k = 0; k < d; ++k) {
    span[k] =
        static_cast<uint64_t>(static_cast<int64_t>((hi[k] - lo[k]) / v)) + 1;
    if (cells && (__builtin_mul_overflow(cells, span[k], &cells) ||
                  bit_width(cells - 1) + ibits > 64))
      cells = 0;
  }
  g.order.resize(n);
  if (cells) {
    std::vector<uint64_t> w(n);
    parallel_for(threads, n, [&](int, int64_t i0, int64_t i1) {
      for (int64_t i = i0; i < i1; ++i) {
        uint64_t f = key(i, 0);
        for (int k = 1; k < d; ++k) f = f * span[k] + key(i, k);
        w[i] = (f << ibits) | static_cast<uint64_t>(i);
      }
    });
    radix_sort(w, ibits, bit_width(cells - 1), threads);
    // Voxel starts: each thread counts those in its chunk, then writes
    // them from the chunks' running total.
    const uint64_t imask = ibits ? ~uint64_t{0} >> (64 - ibits) : 0;
    auto first = [&](int64_t j) {
      return j == 0 || (w[j] >> ibits) != (w[j - 1] >> ibits);
    };
    std::vector<size_t> at(threads + 1, 0);
    parallel_for(threads, n, [&](int t, int64_t j0, int64_t j1) {
      for (int64_t j = j0; j < j1; ++j) {
        g.order[j] = static_cast<uint32_t>(w[j] & imask);
        at[t + 1] += first(j);
      }
    });
    for (int t = 0; t < threads; ++t) at[t + 1] += at[t];
    g.start.resize(at[threads]);
    parallel_for(threads, n, [&](int t, int64_t j0, int64_t j1) {
      size_t v = at[t];
      for (int64_t j = j0; j < j1; ++j)
        if (first(j)) g.start[v++] = static_cast<size_t>(j);
    });
  } else {
    std::vector<uint64_t> keys(static_cast<size_t>(n) * d);
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < d; ++k) keys[i * d + k] = key(i, k);
    for (int64_t i = 0; i < n; ++i) g.order[i] = static_cast<uint32_t>(i);
    const uint64_t* kk = keys.data();
    auto row_less = [kk, d](uint32_t a, uint32_t b) {
      return std::lexicographical_compare(kk + int64_t{a} * d,
                                          kk + int64_t{a} * d + d,
                                          kk + int64_t{b} * d,
                                          kk + int64_t{b} * d + d);
    };
    std::stable_sort(g.order.begin(), g.order.end(), row_less);
    for (int64_t j = 0; j < n; ++j)
      if (j == 0 || row_less(g.order[j - 1], g.order[j]))
        g.start.push_back(j);
  }
  g.start.push_back(static_cast<size_t>(n));
  return g;
}

void voxel_down_sample(const double* p, int64_t n, double voxel_size,
                       int threads, std::vector<double>& out) {
  const Voxels g = group_voxels(p, n, 3, voxel_size, threads);
  const int64_t nv = static_cast<int64_t>(g.start.size()) - 1;
  out.assign(nv * 3, 0.0);
  parallel_for(threads, nv, [&](int, int64_t v0, int64_t v1) {
    for (int64_t v = v0; v < v1; ++v) {
      double s[3] = {0.0, 0.0, 0.0};
      for (size_t j = g.start[v]; j < g.start[v + 1]; ++j) {
        const double* q = p + static_cast<size_t>(g.order[j]) * 3;
        s[0] += q[0];
        s[1] += q[1];
        s[2] += q[2];
      }
      const double c = static_cast<double>(g.start[v + 1] - g.start[v]);
      for (int k = 0; k < 3; ++k) out[v * 3 + k] = s[k] / c;
    }
  });
}

// ---------------------------------------------------------------- Morton

uint32_t spread3(uint32_t x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

uint32_t spread2(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// Codes of at most 30 bits, sorted with their indices packed into one
// 64-bit word (code << 32 | index).
void morton_order(const float* p, int64_t n, int d, int64_t* order) {
  if (n <= 0) return;
  if (static_cast<uint64_t>(n) > UINT32_MAX)
    throw Failure{kFailed, "more than 2^32 points"};
  const int threads = auto_threads(n);
  const int bits = d >= 3 ? 10 : 15;
  const float scale = static_cast<float>((1 << bits) - 1);
  float lo[3], hi[3], span[3];
  bounds(p, n, d, threads, lo, hi);
  for (int k = 0; k < d; ++k) {
    const float s = hi[k] - lo[k];
    span[k] = s < 1.17549435e-38f ? 1.17549435e-38f : s;  // finfo.tiny
  }
  std::vector<uint64_t> w(n);
  parallel_for(threads, n, [&](int, int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      uint32_t q[3] = {0, 0, 0};
      for (int k = 0; k < d; ++k) {
        float t = (p[i * d + k] - lo[k]) / span[k] * scale;
        t = t < 0.0f ? 0.0f : (t > scale ? scale : t);
        q[k] = static_cast<uint32_t>(static_cast<int32_t>(t));
      }
      const uint32_t code = d == 2 ? spread2(q[0]) | (spread2(q[1]) << 1)
                                   : spread3(q[0]) | (spread3(q[1]) << 1) |
                                         (spread3(q[2]) << 2);
      w[i] = (static_cast<uint64_t>(code) << 32) | static_cast<uint64_t>(i);
    }
  });
  radix_sort(w, 32, 30, threads);
  parallel_for(threads, n, [&](int, int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i)
      order[i] = static_cast<int64_t>(w[i] & 0xFFFFFFFFu);
  });
}

// ------------------------------------------------------------ C boundary

int report(const Failure& f, char* err, int64_t errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, f.msg.c_str(), static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = '\0';
  }
  return f.code;
}

template <typename Fn>
int guarded(char* err, int64_t errlen, Fn&& fn) {
  try {
    fn();
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::exception& e) {
    return report(Failure{kFailed, e.what()}, err, errlen);
  }
}

// A malloc'ed copy of `v` (nullptr when empty), for the caller to free.
double* release(const std::vector<double>& v) {
  if (v.empty()) return nullptr;
  auto* out = static_cast<double*>(std::malloc(v.size() * sizeof(double)));
  if (!out) throw std::bad_alloc();
  std::memcpy(out, v.data(), v.size() * sizeof(double));
  return out;
}

}  // namespace

extern "C" {

// kind: 0 by the extension (.ply / .pcd), 1 PLY, 2 PCD. *out holds
// *n x 3 doubles (nullptr when *n is 0).
int probreg_read_cloud(const char* path, int kind, double** out, int64_t* n,
                       char* err, int64_t errlen) {
  *out = nullptr;
  *n = 0;
  return guarded(err, errlen, [&] {
    std::vector<double> xyz;
    read_cloud(path, kind, xyz);
    *out = release(xyz);
    *n = static_cast<int64_t>(xyz.size() / 3);
  });
}

int probreg_voxel_down_sample(const double* p, int64_t n, double voxel,
                              double** out, int64_t* nout, char* err,
                              int64_t errlen) {
  *out = nullptr;
  *nout = 0;
  return guarded(err, errlen, [&] {
    std::vector<double> v;
    voxel_down_sample(p, n, voxel, auto_threads(n), v);
    *out = release(v);
    *nout = static_cast<int64_t>(v.size() / 3);
  });
}

int probreg_voxel_count_f64(const double* p, int64_t n, int64_t d,
                            double voxel, int64_t* count, char* err,
                            int64_t errlen) {
  return guarded(err, errlen, [&] {
    *count = static_cast<int64_t>(
        group_voxels(p, n, static_cast<int>(d), voxel, auto_threads(n))
            .start.size() -
        1);
  });
}

int probreg_voxel_count_f32(const float* p, int64_t n, int64_t d,
                            double voxel, int64_t* count, char* err,
                            int64_t errlen) {
  return guarded(err, errlen, [&] {
    *count = static_cast<int64_t>(
        group_voxels(p, n, static_cast<int>(d), voxel, auto_threads(n))
            .start.size() -
        1);
  });
}

// Reads paths[0..n) on `threads` std::threads (<= 0: min(n, hardware
// concurrency)), each cloud voxel-downsampled when voxel > 0. On success
// outs[i] / counts[i] hold cloud i (n_i x 3 doubles). On failure nothing
// is left allocated and *failed is the first failing file's index.
int probreg_read_batch(const char* const* paths, int64_t n, double voxel,
                       int64_t threads, double** outs, int64_t* counts,
                       int64_t* failed, char* err, int64_t errlen) {
  *failed = -1;
  for (int64_t i = 0; i < n; ++i) {
    outs[i] = nullptr;
    counts[i] = 0;
  }
  std::vector<Failure> fails(n, Failure{0, ""});
  std::atomic<int64_t> next(0);
  auto worker = [&] {
    for (int64_t i; (i = next.fetch_add(1)) < n;) {
      try {
        std::vector<double> xyz;
        read_cloud(paths[i], 0, xyz);
        if (voxel > 0.0 && !xyz.empty()) {
          std::vector<double> ds;
          // One thread a file: the pool already spans the cores.
          voxel_down_sample(xyz.data(), static_cast<int64_t>(xyz.size() / 3),
                            voxel, 1, ds);
          xyz.swap(ds);
        }
        outs[i] = release(xyz);
        counts[i] = static_cast<int64_t>(xyz.size() / 3);
      } catch (const Failure& f) {
        fails[i] = f;
      } catch (const std::exception& e) {
        fails[i] = Failure{kFailed, e.what()};
      }
    }
  };
  const int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
  const int64_t nt = threads > 0 ? threads : std::min<int64_t>(n, hw);
  std::vector<std::thread> pool;
  try {
    for (int64_t t = 1; t < nt && t < n; ++t) pool.emplace_back(worker);
  } catch (const std::system_error&) {
    // Fewer threads: the calling thread still reads every file left.
  }
  worker();
  for (auto& t : pool) t.join();
  int code = 0;
  for (int64_t i = 0; i < n && code == 0; ++i)
    if (fails[i].code != 0) {
      *failed = i;
      code = report(fails[i], err, errlen);
    }
  if (code != 0)
    for (int64_t i = 0; i < n; ++i) {
      std::free(outs[i]);
      outs[i] = nullptr;
      counts[i] = 0;
    }
  return code;
}

// order[0..n) receives the permutation (int64).
int probreg_morton_order(const float* p, int64_t n, int64_t d,
                         int64_t* order, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    if (d != 2 && d != 3) throw Failure{kFormat, "expected (N, 2|3) array"};
    morton_order(p, n, static_cast<int>(d), order);
  });
}

void probreg_free(void* p) { std::free(p); }

}  // extern "C"
