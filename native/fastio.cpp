// fastio: memory-mapped, multithreaded FASTQ/FASTA parsing + 2-bit packing.
//
// Native runtime component of the framework (SURVEY.md §2 native-
// component ledger: "FASTA/FASTQ parsing -> host-side streaming parser
// feeding packed device batches").  The reference parses single-threaded
// with std::getline (src/data_io.cpp:47-117, src/main.cpp:107-151); this
// implementation keeps its exact record semantics:
//   - FASTQ: any line starting '@' opens a record; the next three lines
//     are sequence / '+' separator / quality (src/main.cpp:121-127);
//     duplicate read IDs (full header after '@') keep the LAST record
//     (unordered_map overwrite, src/main.cpp:150),
//   - validation: uppercase A/C/G/T only (src/data_io.cpp:17-34),
//   - reads shorter than min_len (= max k) are dropped (src/main.cpp:136-138),
// but scans a memory map and packs base codes (A=0,C=1,G=2,T=3) into the
// caller's fixed-shape [N, pad_len] uint8 array with a worker pool.
//
// C ABI (ctypes-friendly), two-phase:
//   fastq_open_scan()  -> parse + dedup + filter, return handle & counts
//   fastq_pack()       -> fill caller-allocated codes/lengths (threaded)
//   fastq_get_ids()    -> optional concatenated id buffer + offsets
//   fastq_close()      -> release
// FASTA equivalents mirror load_fasta (src/data_io.cpp:47-80): ID = header
// token before first ' ', multi-line sequences, first-duplicate-wins,
// every record validated (reference quirk Q2 fixed, SURVEY.md §7.1).

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Record {
  const char* seq;
  int64_t seq_len;
  const char* id;
  int64_t id_len;
};

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool valid = false;
  std::vector<char> owned;  // inflated gzip content (mmap unused then)
  bool ok() const { return valid; }
};

// Inflate a whole gzip byte range (multi-member streams included, e.g.
// bgzip output) into `out`.  Returns false on corrupt input.
bool inflate_gzip(const char* src, size_t n, std::vector<char>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(src));
  zs.avail_in = static_cast<uInt>(n);
  out.reserve(n * 4);
  std::vector<char> buf(1 << 20);
  for (;;) {
    zs.next_out = reinterpret_cast<Bytef*>(buf.data());
    zs.avail_out = static_cast<uInt>(buf.size());
    int rc = inflate(&zs, Z_NO_FLUSH);
    size_t produced = buf.size() - zs.avail_out;
    if (produced) out.insert(out.end(), buf.data(), buf.data() + produced);
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) break;      // done
      if (inflateReset(&zs) != Z_OK) {  // next gzip member
        inflateEnd(&zs);
        return false;
      }
      continue;
    }
    if (rc != Z_OK) {
      inflateEnd(&zs);
      return false;
    }
  }
  inflateEnd(&zs);
  return true;
}

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.size = static_cast<size_t>(st.st_size);
  if (m.size == 0) {
    m.valid = true;  // empty file: nothing to map, nothing to parse
    return m;
  }
  void* p = ::mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  ::madvise(p, m.size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  m.valid = true;
  if (m.size >= 2 && static_cast<uint8_t>(m.data[0]) == 0x1f &&
      static_cast<uint8_t>(m.data[1]) == 0x8b) {
    // gzip: inflate into an owned buffer and parse that instead (the
    // Python line-loop fallback at 50M-read scale would dominate
    // end-to-end time on weak hosts).
    std::vector<char> out;
    bool ok = inflate_gzip(m.data, m.size, out);
    ::munmap(const_cast<char*>(m.data), m.size);
    ::close(m.fd);
    m.fd = -1;
    if (!ok) {
      m.data = nullptr;
      m.size = 0;
      m.valid = false;
      return m;
    }
    m.owned = std::move(out);
    m.data = m.owned.data();
    m.size = m.owned.size();
  }
  return m;
}

void unmap_file(Mapped& m) {
  if (m.owned.empty() && m.data && m.size)
    ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.owned.clear();
  m.owned.shrink_to_fit();
  m.data = nullptr;
  m.fd = -1;
}

// Base code LUT: A=0 C=1 G=2 T=3, 255 invalid (uppercase only, like the
// reference's valid_char table).
struct Lut {
  uint8_t v[256];
  Lut() {
    memset(v, 255, sizeof(v));
    v[uint8_t('A')] = 0;
    v[uint8_t('C')] = 1;
    v[uint8_t('G')] = 2;
    v[uint8_t('T')] = 3;
  }
};
const Lut kLut;

struct FastqHandle {
  Mapped map;
  std::vector<Record> records;  // post-dedup, post-filter, file order
  int64_t n_seen = 0;           // records parsed (pre-filter)
  int64_t n_invalid = 0;        // dropped: bad chars or too short
  int64_t max_len = 0;
};

// FNV-1a 64 over the id bytes (ids are short; quality matters less than
// per-byte cost).
inline uint64_t fnv1a(const char* s, int64_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

inline std::string_view next_line(const char* data, size_t size, size_t& pos) {
  if (pos >= size) return {};
  size_t start = pos;
  const char* nl = static_cast<const char*>(memchr(data + pos, '\n', size - pos));
  size_t end = nl ? static_cast<size_t>(nl - data) : size;
  pos = end + 1;
  return std::string_view(data + start, end - start);
}

bool validate_seq(const char* s, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (kLut.v[static_cast<uint8_t>(s[i])] == 255) return false;
  }
  return true;
}

int pack_threaded(const Record* records, int64_t n, int64_t pad_len,
                  uint8_t* codes, int32_t* lengths, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const Record& r = records[i];
      uint8_t* out = codes + i * pad_len;
      const char* s = r.seq;
      int64_t len = r.seq_len < pad_len ? r.seq_len : pad_len;
      for (int64_t j = 0; j < len; ++j) out[j] = kLut.v[static_cast<uint8_t>(s[j])];
      if (len < pad_len) memset(out + len, 0, static_cast<size_t>(pad_len - len));
      lengths[i] = static_cast<int32_t>(len);
    }
  };
  if (n_threads == 1 || n < 4096) {
    worker(0, n);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

// 2-bit variant: 4 base codes per byte, little-endian within the byte
// (base j -> byte j>>2, bits (j&3)*2).  Row stride = pad_len/4 bytes
// (pad_len must be a multiple of 4).  Quarters the host->device traffic
// of the streaming feed, with the device unpacking via two vector ops
// (io/packing.unpack_codes2).
int pack_threaded2(const Record* records, int64_t n, int64_t pad_len,
                   uint8_t* codes2, int32_t* lengths, int n_threads) {
  if (pad_len % 4 != 0) return -2;
  const int64_t stride = pad_len / 4;
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const Record& r = records[i];
      uint8_t* out = codes2 + i * stride;
      const char* s = r.seq;
      int64_t len = r.seq_len < pad_len ? r.seq_len : pad_len;
      memset(out, 0, static_cast<size_t>(stride));
      for (int64_t j = 0; j < len; ++j) {
        out[j >> 2] = static_cast<uint8_t>(
            out[j >> 2] |
            (kLut.v[static_cast<uint8_t>(s[j])] << ((j & 3) * 2)));
      }
      lengths[i] = static_cast<int32_t>(len);
    }
  };
  if (n_threads == 1 || n < 4096) {
    worker(0, n);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Align to the first record header at or after `pos`: a line starting
// '@' whose line-after-next starts '+' — the same probe the Python
// byte-range parser uses (io/fastq.py _align_to_record) to disambiguate
// quality lines that begin with '@'.
size_t align_to_record(const char* data, size_t size, size_t pos) {
  if (pos > 0) {
    const char* nl =
        static_cast<const char*>(memchr(data + pos, '\n', size - pos));
    if (!nl) return size;
    pos = static_cast<size_t>(nl - data) + 1;
  }
  while (pos < size) {
    size_t line_start = pos;
    std::string_view line = next_line(data, size, pos);
    if (!line.empty() && line[0] == '@') {
      size_t probe = pos;
      (void)next_line(data, size, probe);  // sequence
      std::string_view plus = next_line(data, size, probe);
      if (!plus.empty() && plus[0] == '+') return line_start;
    }
  }
  return size;
}

// Parse every record whose HEADER line starts in [begin, end); record
// bodies may extend past `end`.  Same per-record semantics as the
// sequential loop (any '@' line opens a record; validation + min_len
// filter before the record is kept).
void parse_range(const char* data, size_t size, size_t begin, size_t end,
                 int64_t min_len, std::vector<Record>& out,
                 std::vector<uint64_t>& out_hash, int64_t* n_seen,
                 int64_t* n_invalid) {
  size_t pos = begin;
  while (pos < end) {
    std::string_view line = next_line(data, size, pos);
    if (line.empty() || line[0] != '@') continue;
    std::string_view id = line.substr(1);
    std::string_view seq = next_line(data, size, pos);
    (void)next_line(data, size, pos);  // '+'
    (void)next_line(data, size, pos);  // quality
    (*n_seen)++;
    if (static_cast<int64_t>(seq.size()) < min_len ||
        !validate_seq(seq.data(), static_cast<int64_t>(seq.size()))) {
      (*n_invalid)++;
      // Reference inserts only VALID reads into the map, so an invalid
      // duplicate never clobbers an earlier valid record.
      continue;
    }
    out.push_back(Record{seq.data(), static_cast<int64_t>(seq.size()),
                         id.data(), static_cast<int64_t>(id.size())});
    out_hash.push_back(fnv1a(id.data(), static_cast<int64_t>(id.size())));
  }
}

// Duplicate-ID resolution over the file-ordered record array, matching
// the sequential map semantics exactly: a duplicate keeps the FIRST
// occurrence's position but the LAST occurrence's content
// (recs[first] = last; reference src/main.cpp:150 unordered_map
// overwrite).  Partitioned by id-hash so P threads dedup concurrently
// with open-address tables; returns true if any duplicate was found.
bool dedup_records(const std::vector<Record>& recs,
                   const std::vector<uint64_t>& hash, int n_threads,
                   std::vector<int64_t>& winner, std::vector<uint8_t>& drop) {
  const int64_t n = static_cast<int64_t>(recs.size());
  winner.assign(n, -1);
  drop.assign(n, 0);
  if (n == 0) return false;
  const int P = n_threads < 1 ? 1 : (n_threads > 8 ? 8 : n_threads);
  std::vector<uint8_t> any_dup(static_cast<size_t>(P), 0);
  auto part_worker = [&](int p) {
    // Open-address table for ids with hash % P == p; value = first
    // index.  Sized from this partition's ACTUAL entry count (one cheap
    // counting pass) at 2x load headroom, so the probe loop always has
    // empty slots regardless of id-hash skew across partitions.
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i)
      if (static_cast<int>(hash[i] % static_cast<uint64_t>(P)) == p) count++;
    uint64_t c2 = 64;
    while (c2 < static_cast<uint64_t>(count) * 2) c2 <<= 1;
    std::vector<int64_t> slots(c2, -1);
    const uint64_t mask = c2 - 1;
    for (int64_t i = 0; i < n; ++i) {
      if (static_cast<int>(hash[i] % static_cast<uint64_t>(P)) != p) continue;
      uint64_t s = (hash[i] >> 16) & mask;
      for (;;) {
        int64_t j = slots[s];
        if (j < 0) {
          slots[s] = i;
          break;
        }
        if (hash[j] == hash[i] && recs[j].id_len == recs[i].id_len &&
            memcmp(recs[j].id, recs[i].id,
                   static_cast<size_t>(recs[i].id_len)) == 0) {
          winner[j] = i;  // later occurrence's content wins
          drop[i] = 1;
          any_dup[static_cast<size_t>(p)] = 1;
          break;
        }
        s = (s + 1) & mask;
      }
    }
  };
  if (P == 1) {
    part_worker(0);
  } else {
    std::vector<std::thread> pool;
    for (int p = 0; p < P; ++p) pool.emplace_back(part_worker, p);
    for (auto& th : pool) th.join();
  }
  for (uint8_t a : any_dup)
    if (a) return true;
  return false;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- FASTQ ---

// Parse + validate + length-filter + last-wins dedup.  Returns handle or
// null.  Outputs: n_valid records, n_seen, n_invalid, max kept length.
// n_threads <= 0 selects automatically (parallel scan for big files).
void* fastq_open_scan_mt(const char* path, int64_t min_len, int n_threads,
                         int64_t* n_valid, int64_t* n_seen,
                         int64_t* n_invalid, int64_t* max_len) {
  auto* h = new FastqHandle();
  h->map = map_file(path);
  if (!h->map.ok()) {
    delete h;
    return nullptr;
  }
  const char* data = h->map.data;
  const size_t size = h->map.size;
  int T = n_threads;
  if (T <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    T = size >= (32u << 20) ? static_cast<int>(hw ? hw : 1) : 1;
  }
  if (T > 1 && size / static_cast<size_t>(T) < 4096) T = 1;

  std::vector<Record> recs;
  std::vector<uint64_t> hashes;
  if (T == 1) {
    parse_range(data, size, 0, size, min_len, recs, hashes, &h->n_seen,
                &h->n_invalid);
  } else {
    std::vector<std::vector<Record>> trecs(static_cast<size_t>(T));
    std::vector<std::vector<uint64_t>> thash(static_cast<size_t>(T));
    std::vector<int64_t> tseen(static_cast<size_t>(T), 0);
    std::vector<int64_t> tinv(static_cast<size_t>(T), 0);
    std::vector<size_t> bounds(static_cast<size_t>(T) + 1);
    bounds[0] = 0;  // file start IS a record boundary by construction
    for (int t = 1; t < T; ++t)
      bounds[static_cast<size_t>(t)] =
          align_to_record(data, size, size * static_cast<size_t>(t) /
                                          static_cast<size_t>(T));
    bounds[static_cast<size_t>(T)] = size;
    std::vector<std::thread> pool;
    for (int t = 0; t < T; ++t) {
      pool.emplace_back([&, t]() {
        parse_range(data, size, bounds[static_cast<size_t>(t)],
                    bounds[static_cast<size_t>(t) + 1], min_len,
                    trecs[static_cast<size_t>(t)],
                    thash[static_cast<size_t>(t)],
                    &tseen[static_cast<size_t>(t)],
                    &tinv[static_cast<size_t>(t)]);
      });
    }
    for (auto& th : pool) th.join();
    size_t total = 0;
    for (auto& v : trecs) total += v.size();
    recs.reserve(total);
    hashes.reserve(total);
    for (int t = 0; t < T; ++t) {  // thread order == file order
      auto& v = trecs[static_cast<size_t>(t)];
      auto& hv = thash[static_cast<size_t>(t)];
      recs.insert(recs.end(), v.begin(), v.end());
      hashes.insert(hashes.end(), hv.begin(), hv.end());
      h->n_seen += tseen[static_cast<size_t>(t)];
      h->n_invalid += tinv[static_cast<size_t>(t)];
    }
  }

  std::vector<int64_t> winner;
  std::vector<uint8_t> drop;
  if (dedup_records(recs, hashes, T, winner, drop)) {
    std::vector<Record> out;
    out.reserve(recs.size());
    for (int64_t i = 0; i < static_cast<int64_t>(recs.size()); ++i) {
      if (drop[static_cast<size_t>(i)]) continue;
      int64_t w = i;
      // Chase to the LAST occurrence (a winner may itself have been
      // superseded by a later duplicate).
      while (winner[static_cast<size_t>(w)] >= 0)
        w = winner[static_cast<size_t>(w)];
      out.push_back(recs[static_cast<size_t>(w)]);
    }
    recs = std::move(out);
  }

  for (const Record& r : recs)
    if (r.seq_len > h->max_len) h->max_len = r.seq_len;
  h->records = std::move(recs);
  *n_valid = static_cast<int64_t>(h->records.size());
  *n_seen = h->n_seen;
  *n_invalid = h->n_invalid;
  *max_len = h->max_len;
  return h;
}

void* fastq_open_scan(const char* path, int64_t min_len, int64_t* n_valid,
                      int64_t* n_seen, int64_t* n_invalid, int64_t* max_len) {
  return fastq_open_scan_mt(path, min_len, 0, n_valid, n_seen, n_invalid,
                            max_len);
}

// Fill caller-allocated codes [n_valid, pad_len] and lengths [n_valid].
int fastq_pack(void* handle, int64_t pad_len, uint8_t* codes, int32_t* lengths,
               int n_threads) {
  auto* h = static_cast<FastqHandle*>(handle);
  if (!h) return -1;
  return pack_threaded(h->records.data(),
                       static_cast<int64_t>(h->records.size()), pad_len, codes,
                       lengths, n_threads);
}

// Pack only records [start, start+count) — the chunked feed for the
// streaming quant path: the host packs chunk c+1 while the device is
// still matching chunk c (dedup/filter already happened globally in
// fastq_open_scan, so chunk boundaries cannot change record semantics).
int fastq_pack_range(void* handle, int64_t start, int64_t count,
                     int64_t pad_len, uint8_t* codes, int32_t* lengths,
                     int n_threads) {
  auto* h = static_cast<FastqHandle*>(handle);
  if (!h || start < 0 || count < 0 ||
      start + count > static_cast<int64_t>(h->records.size()))
    return -1;
  return pack_threaded(h->records.data() + start, count, pad_len, codes,
                       lengths, n_threads);
}

// 2-bit-packed range packing (see pack_threaded2): codes2 has row
// stride pad_len/4 bytes; pad_len must be a multiple of 4.
int fastq_pack_range2(void* handle, int64_t start, int64_t count,
                      int64_t pad_len, uint8_t* codes2, int32_t* lengths,
                      int n_threads) {
  auto* h = static_cast<FastqHandle*>(handle);
  if (!h || start < 0 || count < 0 ||
      start + count > static_cast<int64_t>(h->records.size()))
    return -1;
  return pack_threaded2(h->records.data() + start, count, pad_len, codes2,
                        lengths, n_threads);
}

// Total bytes needed for the concatenated id buffer.
int64_t fastq_ids_size(void* handle) {
  auto* h = static_cast<FastqHandle*>(handle);
  int64_t total = 0;
  for (const Record& r : h->records) total += r.id_len;
  return total;
}

// Fill ids buffer + offsets [n_valid + 1].
int fastq_get_ids(void* handle, char* buf, int64_t* offsets) {
  auto* h = static_cast<FastqHandle*>(handle);
  int64_t off = 0;
  int64_t i = 0;
  for (const Record& r : h->records) {
    offsets[i++] = off;
    memcpy(buf + off, r.id, static_cast<size_t>(r.id_len));
    off += r.id_len;
  }
  offsets[i] = off;
  return 0;
}

void fastq_close(void* handle) {
  auto* h = static_cast<FastqHandle*>(handle);
  if (!h) return;
  unmap_file(h->map);
  delete h;
}

// ---------------------------------------------------------------- FASTA ---

struct FastaHandle {
  Mapped map;
  std::vector<std::string> names;
  std::vector<std::string> seqs;  // concatenated multi-line sequences
  int64_t n_invalid = 0;
};

void* fasta_open_scan(const char* path, int64_t* n_records, int64_t* n_invalid) {
  auto* h = new FastaHandle();
  h->map = map_file(path);
  if (!h->map.ok()) {
    delete h;
    return nullptr;
  }
  const char* data = h->map.data;
  const size_t size = h->map.size;
  size_t pos = 0;
  // Keys must OWN their storage: views into h->names dangle when the
  // vector reallocates (strings move).
  std::unordered_map<std::string, int64_t> by_id;
  std::string cur_id;
  std::string cur_seq;
  auto flush = [&]() {
    if (cur_id.empty()) return;
    if (!validate_seq(cur_seq.data(), static_cast<int64_t>(cur_seq.size()))) {
      h->n_invalid++;
      return;
    }
    if (by_id.find(cur_id) != by_id.end()) return;  // first wins
    by_id.emplace(cur_id, 1);
    h->names.push_back(cur_id);
    h->seqs.push_back(cur_seq);
  };
  while (pos < size) {
    std::string_view line = next_line(data, size, pos);
    if (line.empty()) continue;
    if (line[0] == '>') {
      flush();
      std::string_view rest = line.substr(1);
      size_t sp = rest.find(' ');
      cur_id.assign(sp == std::string_view::npos ? rest : rest.substr(0, sp));
      cur_seq.clear();
    } else {
      cur_seq.append(line.data(), line.size());
    }
  }
  flush();
  *n_records = static_cast<int64_t>(h->names.size());
  *n_invalid = h->n_invalid;
  return h;
}

int64_t fasta_seq_len(void* handle, int64_t i) {
  auto* h = static_cast<FastaHandle*>(handle);
  return static_cast<int64_t>(h->seqs[i].size());
}

int64_t fasta_name_len(void* handle, int64_t i) {
  auto* h = static_cast<FastaHandle*>(handle);
  return static_cast<int64_t>(h->names[i].size());
}

int fasta_get(void* handle, int64_t i, char* name_buf, char* seq_buf) {
  auto* h = static_cast<FastaHandle*>(handle);
  memcpy(name_buf, h->names[i].data(), h->names[i].size());
  memcpy(seq_buf, h->seqs[i].data(), h->seqs[i].size());
  return 0;
}

void fasta_close(void* handle) {
  auto* h = static_cast<FastaHandle*>(handle);
  if (!h) return;
  unmap_file(h->map);
  delete h;
}

}  // extern "C"
