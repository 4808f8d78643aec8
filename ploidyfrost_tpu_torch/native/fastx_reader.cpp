// Copied from ploidyfrost_tpu/native/fastx_reader.cpp.
// Native FASTA/FASTQ batch loader.
//
// TPU-native replacement for the reference's host-side read streaming
// (bifrost/src/kseq.h, bifrost/src/FASTX_Parser.cpp, File_Parser.hpp):
// streams (optionally gzipped) FASTX records, encodes bases to the shared
// 2-bit code alphabet (A=0 C=1 G=2 T=3, 4=N/pad — bifrost/src/Common.hpp:34),
// and fills caller-provided fixed-shape [batch_reads, max_len] uint8 arrays
// that feed the device k-mer pipeline. Long reads are tiled into windows
// overlapping by k-1 bases so no k-mer is lost at a seam; windows shorter
// than k are dropped (they contain no k-mer).
//
// Exposed as a plain C ABI for ctypes binding (ploidyfrost_tpu/native/
// __init__.py compiles + loads this; no pybind11 in this image). Semantics
// are kept identical to the pure-Python fallback
// ploidyfrost_tpu/io/fastx.py::read_batches_py, which doubles as the test
// oracle (tests/test_native.py).
//
// Contract notes:
//  * pfx_next_batch fills the tail of every row it writes (and every row
//    past the returned count) with the invalid code 4 itself, so a binding
//    that reuses one buffer across batches can never leak stale bases from
//    longer prior rows into shorter rows.
//  * a gzread error mid-file fails the CURRENT record (pfx_next_batch
//    returns -1) instead of silently emitting the truncated sequence.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kInvalid = 4;

struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, kInvalid, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
  }
};
const CodeTable kCodes;

struct Reader {
  gzFile f = nullptr;
  int fmt = 0;  // 0 = undetected, 1 = fasta, 2 = fastq
  std::string err;

  // chunked input buffer
  std::vector<uint8_t> buf;
  size_t pos = 0, len = 0;
  bool in_eof = false;

  // current record being windowed (already base-encoded)
  std::vector<uint8_t> seq;
  size_t win_start = 0;
  bool have_seq = false;
  bool done = false;

  // optional quality trimming (Trimmomatic cascade, io/trim.py
  // semantics); qual collects raw quality bytes per FASTQ record
  bool trim_on = false;
  int t_lead = 0, t_trail = 0, t_win = 0, t_winq = 0, t_minlen = 0;
  std::vector<uint8_t> qual;

  // reusable line assembly
  std::vector<uint8_t> line;
};

// LEADING/TRAILING/SLIDINGWINDOW/MINLEN on the current record,
// mirroring io/trim.trim_read exactly (phred33; window mean test
// sum < wq*w is the exact integer form of the float mean < wq).
void apply_trim(Reader* r) {
  const long n = (long)std::min(r->seq.size(), r->qual.size());
  long lo = 0, hi = n;
  const uint8_t* q = r->qual.data();
  if (r->t_lead > 0) {
    long g = lo;
    while (g < hi && (int)q[g] - 33 < r->t_lead) ++g;
    lo = g;
  }
  if (r->t_trail > 0 && hi > lo) {
    long g = hi - 1;
    while (g >= lo && (int)q[g] - 33 < r->t_trail) --g;
    hi = g + 1;
  }
  const int w = r->t_win;
  if (w > 0) {
    if (hi - lo < w) {
      hi = lo;  // shorter than the window: dropped outright
    } else {
      const long m = hi - lo;
      long sum = 0;
      for (long i = 0; i < w; ++i) sum += (int)q[lo + i] - 33;
      long cut = -1;
      for (long st = 0; st + w <= m; ++st) {
        if (st)
          sum += ((int)q[lo + st + w - 1] - 33) - ((int)q[lo + st - 1] - 33);
        if (sum < (long)r->t_winq * w) {
          cut = st;
          break;
        }
      }
      if (cut >= 0) {
        // extend through individually-good bases at the cut point
        while (cut < m && (int)q[lo + cut] - 33 >= r->t_winq) ++cut;
        hi = lo + cut;
      }
    }
  }
  if (hi - lo < (long)r->t_minlen) {
    r->seq.clear();
    return;
  }
  if (lo > 0) memmove(r->seq.data(), r->seq.data() + lo, (size_t)(hi - lo));
  r->seq.resize((size_t)(hi - lo));
}

bool fill(Reader* r) {
  if (r->in_eof) return false;
  int n = gzread(r->f, r->buf.data(), (unsigned)r->buf.size());
  if (n <= 0) {
    r->in_eof = true;
    // a TRUNCATED gz stream surfaces as n == 0 with Z_BUF_ERROR (not a
    // negative return) — check gzerror on every short read
    int zerr = 0;
    const char* msg = gzerror(r->f, &zerr);
    if (n < 0 || (zerr != Z_OK && zerr != Z_STREAM_END)) {
      r->err = msg && *msg ? msg : "gzread error";
    }
    return false;
  }
  r->pos = 0;
  r->len = (size_t)n;
  return true;
}

// Read one line (without trailing \n / \r) into r->line. Returns false at EOF
// with an empty line. A gz error surfaces via r->err (checked by callers
// before the assembled record is used).
bool read_line(Reader* r) {
  r->line.clear();
  for (;;) {
    if (r->pos >= r->len && !fill(r)) break;
    const uint8_t* b = r->buf.data();
    size_t i = r->pos;
    const uint8_t* nl =
        (const uint8_t*)memchr(b + i, '\n', r->len - i);
    if (nl) {
      size_t end = (size_t)(nl - b);
      r->line.insert(r->line.end(), b + i, b + end);
      r->pos = end + 1;
      break;
    }
    r->line.insert(r->line.end(), b + i, b + r->len);
    r->pos = r->len;
  }
  while (!r->line.empty() &&
         (r->line.back() == '\r' || r->line.back() == ' ' ||
          r->line.back() == '\t')) {
    r->line.pop_back();
  }
  return !(r->line.empty() && r->in_eof && r->pos >= r->len);
}

void encode_append(std::vector<uint8_t>* out, const std::vector<uint8_t>& in) {
  size_t n = in.size(), base = out->size();
  out->resize(base + n);
  uint8_t* dst = out->data() + base;
  const uint8_t* src = in.data();
  for (size_t i = 0; i < n; ++i) dst[i] = kCodes.t[src[i]];
}

// FASTQ record body after the header line, kseq-style: sequence lines
// accumulate until the '+' separator, quality lines until they cover
// the sequence length — multi-line FASTQ parses identically to the
// Python reader (io/fastx._iter_fastq; bifrost/src/kseq.h semantics).
void read_fastq_body(Reader* r) {
  size_t seq_chars = 0;
  r->qual.clear();
  for (;;) {
    if (!read_line(r)) {
      r->done = true;
      return;
    }
    if (!r->line.empty() && r->line[0] == '+') break;
    seq_chars += r->line.size();
    encode_append(&r->seq, r->line);
  }
  size_t q = 0;
  while (q < seq_chars) {
    if (!read_line(r)) {
      r->done = true;
      return;
    }
    q += r->line.size();
    if (r->trim_on)
      r->qual.insert(r->qual.end(), r->line.begin(), r->line.end());
  }
}

// Advance to the next record; fills r->seq (encoded) and resets windowing.
// Returns false when the file is exhausted or an IO error was hit (r->err).
// Empty-sequence records are skipped ITERATIVELY (a file of millions of
// bare '>hdr' lines must not grow the stack).
bool next_record(Reader* r) {
  for (;;) {
    r->seq.clear();
    r->win_start = 0;
    if (r->done) return false;

    if (r->fmt == 0) {
      // detect format from the first non-empty line
      for (;;) {
        if (!read_line(r)) {
          r->done = true;
          return false;
        }
        if (r->line.empty()) continue;
        if (r->line[0] == '>') {
          r->fmt = 1;
          break;
        }
        if (r->line[0] == '@') {
          r->fmt = 2;
          break;
        }
        r->err = "unrecognized FASTX format";
        r->done = true;
        return false;
      }
      if (r->fmt == 2) {
        // FASTQ: the detected line is the first header
        read_fastq_body(r);
        if (!r->err.empty()) {  // fail the truncated record, not the next one
          r->done = true;
          return false;
        }
        if (r->trim_on) apply_trim(r);
        if (r->seq.empty()) continue;
        r->have_seq = true;
        return true;
      }
      // FASTA: fall through with header consumed
    }

    if (r->fmt == 1) {
      // FASTA: concatenate lines until the next '>' header or EOF
      for (;;) {
        if (!read_line(r)) {
          r->done = true;
          break;
        }
        if (!r->line.empty() && r->line[0] == '>') break;
        encode_append(&r->seq, r->line);
      }
      if (!r->err.empty()) {
        r->done = true;
        return false;
      }
      if (r->seq.empty()) {
        if (r->done) return false;
        continue;
      }
      r->have_seq = true;
      return true;
    }

    // FASTQ steady state: scan forward to the next '@'/'>' record
    // marker (kseq semantics, bifrost/src/kseq.h) — blank separator
    // lines (e.g. the unconsumed empty quality of a zero-length read)
    // and junk lines are skipped, not treated as headers — then the
    // kseq-style multi-line body
    for (;;) {
      if (!read_line(r)) {
        r->done = true;
        return false;
      }
      if (!r->line.empty() && (r->line[0] == '@' || r->line[0] == '>')) break;
    }
    read_fastq_body(r);
    if (!r->err.empty()) {
      r->done = true;
      return false;
    }
    if (r->trim_on) apply_trim(r);
    if (r->seq.empty()) {
      if (r->done) return false;
      continue;
    }
    r->have_seq = true;
    return true;
  }
}

}  // namespace

extern "C" {

// enable the quality-trimming cascade for subsequent records
void pfx_set_trim(void* h, int leading, int trailing, int window,
                  int window_q, int minlen) {
  Reader* r = (Reader*)h;
  r->trim_on = true;
  r->t_lead = leading;
  r->t_trail = trailing;
  r->t_win = window;
  r->t_winq = window_q;
  r->t_minlen = minlen;
}

void* pfx_open(const char* path) {
  Reader* r = new Reader();
  r->f = gzopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  gzbuffer(r->f, 1 << 20);
  r->buf.resize(1 << 20);
  return r;
}

// Fill rows [start_row, batch_reads) of `out` (shape [batch_reads, max_len]).
// Every row written has its tail (and every row at index >= the returned
// count has its entirety) set to the invalid code 4 by this function — the
// caller does NOT need to pre-fill the buffer. Returns the total number of
// filled rows; sets *eof = 1 when the file is exhausted. Returns -1 on a
// format/IO error (message via pfx_error).
long pfx_next_batch(void* h, uint8_t* out, long batch_reads, long max_len,
                    long k, long start_row, int* eof) {
  Reader* r = (Reader*)h;
  *eof = 0;
  long rows = start_row;
  const long step = max_len - (k - 1);
  if (step <= 0 || k <= 0) {
    r->err = "max_len must be >= k";
    return -1;
  }
  while (rows < batch_reads) {
    if (!r->have_seq) {
      if (!next_record(r)) {
        if (!r->err.empty()) return -1;
        *eof = 1;
        // invalidate every unwritten row so stale data never leaks
        memset(out + (size_t)rows * max_len, kInvalid,
               (size_t)(batch_reads - rows) * (size_t)max_len);
        return rows;
      }
    }
    const long n = (long)r->seq.size();
    // mirror the Python windowing: starts in range(0, max(n-k+1, 1), step),
    // break when the remaining chunk is shorter than k
    const long limit = n - k + 1 > 1 ? n - k + 1 : 1;
    while (rows < batch_reads && (long)r->win_start < limit) {
      long chunk = n - (long)r->win_start;
      if (chunk > max_len) chunk = max_len;
      if (chunk < k) break;
      uint8_t* row = out + (size_t)rows * max_len;
      memcpy(row, r->seq.data() + r->win_start, (size_t)chunk);
      if (chunk < max_len)
        memset(row + chunk, kInvalid, (size_t)(max_len - chunk));
      ++rows;
      r->win_start += (size_t)step;
    }
    if ((long)r->win_start >= limit || n - (long)r->win_start < k) {
      r->have_seq = false;
    }
  }
  return rows;
}

const char* pfx_error(void* h) {
  Reader* r = (Reader*)h;
  return r->err.c_str();
}

void pfx_close(void* h) {
  Reader* r = (Reader*)h;
  if (r->f) gzclose(r->f);
  delete r;
}

}  // extern "C"
