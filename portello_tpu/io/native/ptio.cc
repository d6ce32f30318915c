// ptio: native BGZF/BAM codec for portello-tpu.
//
// Replaces the role htslib (C) plays in the reference stack
// (reference Cargo.toml:20 via rust-htslib): BGZF block inflate for indexed
// BAM reads, bulk record scanning, and pool-threaded BGZF deflate for BAM
// output (the reference gives htslib max(1, threads/2) compression threads,
// read_alignment_scanner.rs:589).
//
// Exposed as a C ABI consumed by ctypes (portello_tpu/io/native_codec.py).
// Build: g++ -O3 -std=c++17 -shared -fPIC ptio.cc -o ptio.so -lz -lpthread

#include <zlib.h>

// libdeflate: the same accelerated codec htslib links for BGZF when
// available (2-3x zlib on both directions + PCLMUL crc32).  Falls back to
// zlib when the header or library is absent (-DPTIO_NO_LIBDEFLATE).
#if !defined(PTIO_NO_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define PTIO_HAVE_LIBDEFLATE 1
#endif

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Watchdog condvar wait: identical blocking semantics, but after each 120 s
// without the predicate it logs WHERE it is stuck plus a caller-supplied
// state line, then keeps waiting.  Converts any future lost-wakeup /
// deadlock into a self-diagnosing stderr report
// instead of a silent hang.  PTPU_WATCHDOG_SECS overrides the period
// (test harnesses shorten it to capture diagnoses quickly).
inline int wd_secs() {
  static int v = [] {
    const char* e = getenv("PTPU_WATCHDOG_SECS");
    int n = e ? atoi(e) : 120;
    return n > 0 ? n : 120;
  }();
  return v;
}

template <typename Pred, typename Dump>
void wd_wait(std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
             const char* site, Pred pred, Dump dump) {
  int rounds = 0;
  while (!cv.wait_for(lk, std::chrono::seconds(wd_secs()), pred)) {
    ++rounds;
    fprintf(stderr, "[ptscan-watchdog] '%s' blocked %ds: %s\n", site,
            rounds * wd_secs(), dump().c_str());
    fflush(stderr);
  }
}

constexpr uint8_t kEofMarker[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

struct DecodedBlock {
  std::vector<uint8_t> data;
  uint32_t csize = 0;
};

struct Reader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  // current virtual position
  size_t coffset = 0;
  uint32_t uoffset = 0;
  // cached inflated block
  size_t block_coffset = SIZE_MAX;
  uint32_t block_csize = 0;
  std::vector<uint8_t> block;
  std::string error;
  // Async parallel readahead (sequential scans; BGZF blocks are
  // independent): a persistent worker pool inflates blocks AHEAD of the
  // cursor into ra_cache while the consumer keeps scanning — the old
  // fork-join batch stalled the consumer for every ~4 MB window and paid
  // thread spawn/join per batch.
  int n_threads = 1;
  std::unordered_map<size_t, DecodedBlock> ra_cache;   // decoded, not taken
  std::vector<std::thread> ra_pool;
  std::mutex ra_mu;
  std::condition_variable ra_work_cv, ra_done_cv;
  std::deque<std::pair<size_t, uint32_t>> ra_todo;     // (coffset, bsize)
  std::unordered_set<size_t> ra_pending;               // queued or decoding
  bool ra_closing = false;
  size_t ra_next = 0;  // next coffset not yet scheduled
  // Push mode (direct CRAM streaming, no temp-BAM transcode): an external
  // producer thread pushes UNCOMPRESSED BAM bytes through a bounded queue
  // and reader_read drains it; the mmap/BGZF machinery above is unused.
  // The producer must have exited before ptio_reader_close runs.
  bool push_mode = false;
  std::deque<std::vector<uint8_t>> push_q;
  size_t push_front_off = 0;  // consumed bytes of push_q.front()
  size_t push_buffered = 0;
  size_t push_cap = 64ull << 20;
  bool push_eof = false;
  bool push_closed = false;  // producer-side failure or consumer abort
  std::mutex push_mu;
  std::condition_variable push_cv_data, push_cv_space;
};

// Parse a BGZF block header at coffset; returns BSIZE or 0 with *err set.
uint32_t block_bsize(const Reader* r, size_t coffset, std::string* err) {
  if (coffset + 18 > r->size) {
    *err = "truncated BGZF block header";
    return 0;
  }
  const uint8_t* p = r->data + coffset;
  if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4)) {
    *err = "not a BGZF block";
    return 0;
  }
  uint16_t xlen;
  std::memcpy(&xlen, p + 10, 2);
  // the extra field must be fully mapped BEFORE scanning it: a truncated
  // tail with garbage xlen would walk up to 64KB past the mapping (SIGBUS
  // on a page boundary, inside a readahead worker)
  if (coffset + 12 + (size_t)xlen > r->size) {
    *err = "truncated BGZF block header";
    return 0;
  }
  uint32_t bsize = 0;
  size_t xs = 12, xend = 12 + xlen;
  while (xs + 4 <= xend) {
    uint16_t slen;
    std::memcpy(&slen, p + xs + 2, 2);
    if (p[xs] == 'B' && p[xs + 1] == 'C' && slen == 2) {
      uint16_t bs;
      std::memcpy(&bs, p + xs + 4, 2);
      bsize = static_cast<uint32_t>(bs) + 1;
    }
    xs += 4 + slen;
  }
  // bsize must cover header (12+xlen), some deflate payload, and the
  // 8-byte CRC/ISIZE trailer — otherwise avail_in below would underflow
  if (bsize < 12 + (uint32_t)xlen + 8 || coffset + bsize > r->size) {
    *err = "BGZF block missing/invalid BSIZE";
    return 0;
  }
  return bsize;
}

// Inflate the block at coffset (pure function of the mmap; thread-safe).
bool inflate_block(const Reader* r, size_t coffset, uint32_t bsize,
                   std::vector<uint8_t>* out, std::string* err) {
  const uint8_t* p = r->data + coffset;
  uint16_t xlen;
  std::memcpy(&xlen, p + 10, 2);
  uint32_t isize;
  std::memcpy(&isize, p + bsize - 4, 4);
  if (isize > 65536) {  // BGZF spec: uncompressed block size <= 64 KiB
    *err = "BGZF block ISIZE exceeds the 64 KiB spec limit";
    return false;
  }
  out->resize(isize);
  if (isize > 0) {
#ifdef PTIO_HAVE_LIBDEFLATE
    static thread_local libdeflate_decompressor* dec =
        libdeflate_alloc_decompressor();
    size_t actual = 0;
    if (libdeflate_deflate_decompress(dec, p + 12 + xlen,
                                      bsize - 12 - xlen - 8, out->data(),
                                      isize, &actual) != LIBDEFLATE_SUCCESS ||
        actual != isize) {
      *err = "BGZF inflate failed";
      return false;
    }
#else
    z_stream zs{};
    zs.next_in = const_cast<Bytef*>(p + 12 + xlen);
    zs.avail_in = bsize - 12 - xlen - 8;
    zs.next_out = out->data();
    zs.avail_out = isize;
    if (inflateInit2(&zs, -15) != Z_OK) {
      *err = "inflateInit2 failed";
      return false;
    }
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END || zs.total_out != isize) {
      *err = "BGZF inflate failed";
      return false;
    }
#endif
  }
  return true;
}

constexpr size_t kRaDepth = 256;  // prefetched blocks in flight (~16 MB raw)

// Queue undecoded blocks ahead of `from` until kRaDepth are in flight.
// Header scanning (block_bsize) is trivial next to inflate; a block whose
// header fails to parse stays unscheduled and surfaces its precise error
// when the cursor reaches it.
void ra_schedule(Reader* r, size_t from) {
  std::string err;
  bool added = false;
  {
    std::lock_guard<std::mutex> lk(r->ra_mu);
    if (r->ra_next < from) r->ra_next = from;
    // stale entries (left behind by seeks) are bounded by the depth cap
    if (r->ra_cache.size() > 4 * kRaDepth) r->ra_cache.clear();
    size_t ahead = r->ra_cache.size() + r->ra_pending.size();
    while (ahead < kRaDepth && r->ra_next < r->size) {
      size_t c = r->ra_next;
      uint32_t bs;
      auto it = r->ra_cache.find(c);
      if (it != r->ra_cache.end()) {
        bs = it->second.csize;
      } else {
        bs = block_bsize(r, c, &err);
        if (bs == 0) break;
        if (!r->ra_pending.count(c)) {
          r->ra_pending.insert(c);
          r->ra_todo.push_back({c, bs});
          ++ahead;
          added = true;
        }
      }
      r->ra_next = c + bs;
    }
  }
  if (added) r->ra_work_cv.notify_all();
}

void ra_worker(Reader* r) {
  for (;;) {
    std::pair<size_t, uint32_t> job;
    {
      std::unique_lock<std::mutex> lk(r->ra_mu);
      r->ra_work_cv.wait(
          lk, [&] { return !r->ra_todo.empty() || r->ra_closing; });
      if (r->ra_closing) return;
      job = r->ra_todo.front();
      r->ra_todo.pop_front();
    }
    DecodedBlock db;
    db.csize = job.second;
    std::string e;
    if (!inflate_block(r, job.first, job.second, &db.data, &e))
      db.csize = 0;  // marker: leave uncached; consumer decodes inline
    {
      std::lock_guard<std::mutex> lk(r->ra_mu);
      r->ra_pending.erase(job.first);
      if (db.csize) r->ra_cache.emplace(job.first, std::move(db));
    }
    r->ra_done_cv.notify_all();
  }
}

// Inflate one BGZF block at coffset; returns false on error.
bool load_block(Reader* r, size_t coffset) {
  if (coffset == r->block_coffset) return true;
  if (!r->ra_pool.empty()) {
    bool taken = false;
    {
      std::unique_lock<std::mutex> lk(r->ra_mu);
      for (;;) {
        auto it = r->ra_cache.find(coffset);
        if (it != r->ra_cache.end()) {
          r->block = std::move(it->second.data);
          r->block_csize = it->second.csize;
          r->block_coffset = coffset;
          r->ra_cache.erase(it);
          taken = true;
          break;
        }
        if (!r->ra_pending.count(coffset)) break;  // decode failed or seek
        wd_wait(r->ra_done_cv, lk, "load_block ra",
                [&] {
                  return r->ra_cache.count(coffset) ||
                         !r->ra_pending.count(coffset);
                },
                [&] {
                  char b[120];
                  snprintf(b, sizeof b,
                           "coffset=%zu todo=%zu pending=%zu cache=%zu",
                           coffset, r->ra_todo.size(), r->ra_pending.size(),
                           r->ra_cache.size());
                  return std::string(b);
                });
      }
    }
    if (taken) {
      ra_schedule(r, coffset + r->block_csize);
      return true;
    }
    // cold start / post-seek miss: decode inline, then prime the pipeline
  }
  uint32_t bsize = block_bsize(r, coffset, &r->error);
  if (bsize == 0) return false;
  if (!inflate_block(r, coffset, bsize, &r->block, &r->error)) return false;
  r->block_coffset = coffset;
  r->block_csize = bsize;
  if (!r->ra_pool.empty()) ra_schedule(r, coffset + bsize);
  return true;
}

// Push-mode drain: block until data, EOF, or close.  A close mid-stream
// surfaces as a short read, which the BAM framing loop upgrades to a
// "truncated record" error unless it lands exactly on a record boundary —
// the Python side therefore re-raises the producer's own exception after
// the scan to avoid any silent-truncation window.
size_t push_read(Reader* r, uint8_t* out, size_t n) {
  size_t got = 0;
  std::unique_lock<std::mutex> lk(r->push_mu);
  while (n > 0) {
    wd_wait(r->push_cv_data, lk, "push_read data",
            [&] {
              return !r->push_q.empty() || r->push_eof || r->push_closed;
            },
            [&] {
              char b[120];
              snprintf(b, sizeof b, "buffered=%zu eof=%d closed=%d",
                       r->push_buffered, (int)r->push_eof,
                       (int)r->push_closed);
              return std::string(b);
            });
    if (r->push_q.empty()) break;
    std::vector<uint8_t>& front = r->push_q.front();
    size_t take = front.size() - r->push_front_off;
    if (take > n) take = n;
    std::memcpy(out + got, front.data() + r->push_front_off, take);
    r->push_front_off += take;
    got += take;
    n -= take;
    if (r->push_front_off == front.size()) {
      r->push_buffered -= front.size();
      r->push_q.pop_front();
      r->push_front_off = 0;
      r->push_cv_space.notify_all();
    }
  }
  return got;
}

// Read exactly n bytes from the cursor; returns bytes read (short at EOF).
size_t reader_read(Reader* r, uint8_t* out, size_t n) {
  if (r->push_mode) return push_read(r, out, n);
  size_t got = 0;
  while (n > 0) {
    if (r->coffset >= r->size) break;
    if (!load_block(r, r->coffset)) break;
    if (r->uoffset >= r->block.size()) {
      r->coffset += r->block_csize;
      r->uoffset = 0;
      continue;
    }
    size_t take = r->block.size() - r->uoffset;
    if (take > n) take = n;
    std::memcpy(out + got, r->block.data() + r->uoffset, take);
    r->uoffset += static_cast<uint32_t>(take);
    got += take;
    n -= take;
  }
  return got;
}

// ---------------------------------------------------------------------------
// Writer with pool-threaded block compression.
// ---------------------------------------------------------------------------

struct Job {
  std::vector<uint8_t> raw;        // uncompressed payload (<= 0xff00)
  std::vector<uint8_t> out;        // finished BGZF block
  bool done = false;
};

struct Writer {
  FILE* f = nullptr;
  int level = 6;
  int n_threads = 1;
  size_t max_inflight = 64;  // blocks (~64 KB raw each) queued to the pool
  std::vector<std::thread> pool;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<Job*> todo;
  std::deque<Job*> inflight;       // in write order
  bool closing = false;
  bool io_closing = false;
  std::condition_variable cv_space;
  std::thread io;                  // ordered fwrite drain (pooled mode)
  std::vector<uint8_t> pending;    // uncompressed tail < block size
  std::string error;
};

// Persistent per-caller deflate state: deflateInit2 allocates + clears
// ~270 KB of window/hash state, which is real CPU when paid per 64 KB
// block; the context reuses it (deflateReset / persistent libdeflate
// compressor).
struct DeflateCtx {
#ifdef PTIO_HAVE_LIBDEFLATE
  libdeflate_compressor* c = nullptr;
  ~DeflateCtx() {
    if (c) libdeflate_free_compressor(c);
  }
#else
  z_stream zs{};
  bool init = false;
#endif
  int level = -1;
  std::vector<uint8_t> cdata;
};

void compress_block_ctx(DeflateCtx* ctx, int level,
                        const std::vector<uint8_t>& raw,
                        std::vector<uint8_t>* out) {
  size_t clen;
  uint32_t crc;
#ifdef PTIO_HAVE_LIBDEFLATE
  if (!ctx->c || ctx->level != level) {
    // one caller thread may feed writers at different levels (e.g. the
    // level-0 stdout writer + a level-6 file writer)
    if (ctx->c) libdeflate_free_compressor(ctx->c);
    ctx->c = libdeflate_alloc_compressor(level);
    ctx->level = level;
  }
  size_t bound = libdeflate_deflate_compress_bound(ctx->c, raw.size());
  if (ctx->cdata.size() < bound) ctx->cdata.resize(bound);
  clen = libdeflate_deflate_compress(ctx->c, raw.data(), raw.size(),
                                     ctx->cdata.data(), ctx->cdata.size());
  crc = libdeflate_crc32(0, raw.data(), raw.size());
#else
  uLong bound = compressBound(raw.size()) + 64;
  if (ctx->init && ctx->level != level) {
    deflateEnd(&ctx->zs);
    ctx->init = false;
  }
  if (!ctx->init) {
    deflateInit2(&ctx->zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
    ctx->init = true;
    ctx->level = level;
  } else {
    deflateReset(&ctx->zs);
  }
  if (ctx->cdata.size() < bound) ctx->cdata.resize(bound);
  z_stream& zs = ctx->zs;
  zs.next_in = const_cast<Bytef*>(raw.data());
  zs.avail_in = raw.size();
  zs.next_out = ctx->cdata.data();
  zs.avail_out = ctx->cdata.size();
  deflate(&zs, Z_FINISH);
  clen = zs.total_out;
  crc = crc32(0, raw.data(), raw.size());
#endif
  std::vector<uint8_t>& cdata = ctx->cdata;
  uint32_t bsize = static_cast<uint32_t>(clen) + 26;
  out->resize(18 + clen + 8);
  uint8_t* p = out->data();
  const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0};
  std::memcpy(p, hdr, 12);
  p[12] = 'B';
  p[13] = 'C';
  p[14] = 2;
  p[15] = 0;
  uint16_t bs16 = static_cast<uint16_t>(bsize - 1);
  std::memcpy(p + 16, &bs16, 2);
  std::memcpy(p + 18, cdata.data(), clen);
  uint32_t isize = raw.size();
  std::memcpy(p + 18 + clen, &crc, 4);
  std::memcpy(p + 18 + clen + 4, &isize, 4);
}

void worker_main(Writer* w) {
  for (;;) {
    Job* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_work.wait(lk, [&] { return !w->todo.empty() || w->closing; });
      if (w->todo.empty()) return;
      job = w->todo.front();
      w->todo.pop_front();
    }
    static thread_local DeflateCtx ctx;
    compress_block_ctx(&ctx, w->level, job->raw, &job->out);
    {
      std::lock_guard<std::mutex> lk(w->mu);
      job->done = true;
    }
    w->cv_done.notify_all();
  }
}

// Drain finished jobs at the front of the in-flight queue to the file.
// Dedicated IO thread: drains finished jobs in write order and fwrites
// them, so the submitting thread (the scanner's finisher) never pays for
// file writes or completed-prefix bookkeeping — only honest backpressure
// when the deflate pool is the true bottleneck (the inflight cap).
void io_main(Writer* w) {
  for (;;) {
    Job* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_done.wait(lk, [&] {
        return (!w->inflight.empty() && w->inflight.front()->done) ||
               (w->io_closing && w->inflight.empty());
      });
      if (w->inflight.empty()) return;
      job = w->inflight.front();
      w->inflight.pop_front();
    }
    if (fwrite(job->out.data(), 1, job->out.size(), w->f) !=
        job->out.size()) {
      std::lock_guard<std::mutex> lk(w->mu);
      if (w->error.empty()) w->error = "write failed";
    }
    delete job;
    w->cv_space.notify_all();
  }
}

void writer_submit(Writer* w, std::vector<uint8_t>&& raw) {
  Job* job = new Job();
  job->raw = std::move(raw);
  if (w->n_threads <= 1) {
    static thread_local DeflateCtx ctx;
    compress_block_ctx(&ctx, w->level, job->raw, &job->out);
    if (fwrite(job->out.data(), 1, job->out.size(), w->f) != job->out.size())
      w->error = "write failed";
    delete job;
    return;
  }
  {
    // Bound memory BEFORE enqueueing: at most max_inflight blocks
    // (~64 KB raw each) queued to the pool + IO thread.
    std::unique_lock<std::mutex> lk(w->mu);
    wd_wait(w->cv_space, lk, "writer_submit space",
            [&] { return w->inflight.size() < w->max_inflight; },
            [&] {
              char b[160];
              snprintf(b, sizeof b,
                       "inflight=%zu todo=%zu front_done=%d closing=%d "
                       "err='%s'",
                       w->inflight.size(), w->todo.size(),
                       w->inflight.empty() ? -1
                                           : (int)w->inflight.front()->done,
                       (int)w->closing, w->error.c_str());
              return std::string(b);
            });
    w->todo.push_back(job);
    w->inflight.push_back(job);
  }
  w->cv_work.notify_one();
}

}  // namespace

extern "C" {

// --- reader ---------------------------------------------------------------

void* ptio_reader_open(const char* path) {
  Reader* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->size = st.st_size;
  if (r->size > 0) {
    r->data = static_cast<const uint8_t*>(
        mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0));
    if (r->data == MAP_FAILED) {
      close(r->fd);
      delete r;
      return nullptr;
    }
  }
  return r;
}

void ptio_reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (!r->ra_pool.empty()) {
    {
      std::lock_guard<std::mutex> lk(r->ra_mu);
      r->ra_closing = true;
    }
    r->ra_work_cv.notify_all();
    for (auto& t : r->ra_pool) t.join();
  }
  if (r->data && r->size) munmap(const_cast<uint8_t*>(r->data), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

long long ptio_read(void* h, uint8_t* out, long long n) {
  return reader_read(static_cast<Reader*>(h), out, n);
}

// Open a push-mode reader: bytes arrive via ptio_reader_push instead of a
// file.  cap_bytes bounds producer run-ahead (<=0 keeps the 64 MB default).
void* ptio_reader_open_push(long long cap_bytes) {
  Reader* r = new Reader();
  r->push_mode = true;
  if (cap_bytes > 0) r->push_cap = static_cast<size_t>(cap_bytes);
  return r;
}

// Blocking bounded push; returns 0, or -1 once the stream is closed.
int ptio_reader_push(void* h, const uint8_t* data, long long n) {
  Reader* r = static_cast<Reader*>(h);
  if (!r->push_mode || n < 0) return -1;
  std::unique_lock<std::mutex> lk(r->push_mu);
  wd_wait(r->push_cv_space, lk, "push space",
          [&] { return r->push_buffered < r->push_cap || r->push_closed; },
          [&] {
            char b[96];
            snprintf(b, sizeof b, "buffered=%zu cap=%zu eof=%d",
                     r->push_buffered, r->push_cap, (int)r->push_eof);
            return std::string(b);
          });
  if (r->push_closed || r->push_eof) return -1;
  r->push_q.emplace_back(data, data + n);
  r->push_buffered += static_cast<size_t>(n);
  lk.unlock();
  r->push_cv_data.notify_all();
  return 0;
}

void ptio_reader_push_eof(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->push_mu);
    r->push_eof = true;
  }
  r->push_cv_data.notify_all();
}

// Abort the stream from either side: wakes a blocked producer (push
// returns -1) and makes the consumer see EOF at the current point.
void ptio_reader_push_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->push_mu);
    r->push_closed = true;
    r->push_q.clear();
    r->push_buffered = 0;
    r->push_front_off = 0;
  }
  r->push_cv_data.notify_all();
  r->push_cv_space.notify_all();
}

// Enable parallel BGZF readahead decode with n worker threads (1 = serial).
void ptio_reader_set_threads(void* h, int n) {
  Reader* r = static_cast<Reader*>(h);
  if (r->push_mode) return;  // no BGZF to inflate ahead
  r->n_threads = n < 1 ? 1 : n;
  if (r->n_threads > 1 && r->ra_pool.empty()) {
    for (int i = 0; i < r->n_threads; ++i)
      r->ra_pool.emplace_back(ra_worker, r);
  }
}

void ptio_seek_voffset(void* h, unsigned long long voffset) {
  Reader* r = static_cast<Reader*>(h);
  r->coffset = voffset >> 16;
  r->uoffset = voffset & 0xffff;
}

unsigned long long ptio_tell_voffset(void* h) {
  Reader* r = static_cast<Reader*>(h);
  // htslib normalizes an exhausted block to (next_block << 16 | 0):
  // without this, a spec-max 65536-byte block would overflow the uoffset
  // bits into coffset, and voffsets recorded at exact block boundaries
  // (index chunk ends) would disagree with htslib-built indexes.
  if (r->coffset == r->block_coffset && !r->block.empty() &&
      r->uoffset >= r->block.size())
    return static_cast<unsigned long long>(r->coffset + r->block_csize) << 16;
  return (static_cast<unsigned long long>(r->coffset) << 16) | r->uoffset;
}

// Bulk record scan: fill out_buf with consecutive size-prefixed BAM records
// ([i32 size][payload])...  Stops when the buffer is full, max_records is
// reached, the virtual offset reaches limit_voffset (0 = none), or EOF.
// Returns the number of records; *n_bytes gets the bytes written.
long long ptio_read_records(void* h, uint8_t* out_buf, long long buf_cap,
                            long long max_records,
                            unsigned long long limit_voffset,
                            long long* n_bytes) {
  Reader* r = static_cast<Reader*>(h);
  long long count = 0;
  long long used = 0;
  while (count < max_records) {
    unsigned long long v = ptio_tell_voffset(h);
    if (limit_voffset && v >= limit_voffset) break;
    uint8_t szb[4];
    // Peek: save position to rewind if the record doesn't fit.
    size_t save_co = r->coffset;
    uint32_t save_uo = r->uoffset;
    if (reader_read(r, szb, 4) < 4) break;
    int32_t bsz;
    std::memcpy(&bsz, szb, 4);
    if (bsz < 32) {
      // corrupt size field: rewinding and returning 0 would read as a clean
      // EOF upstream, silently dropping the rest of the file
      r->coffset = save_co;
      r->uoffset = save_uo;
      return -1;
    }
    if (used + 4 + bsz > buf_cap) {
      r->coffset = save_co;
      r->uoffset = save_uo;
      if (count == 0) {
        // first record exceeds the caller's buffer: report the required
        // capacity so the caller can grow and retry (never a silent stop)
        *n_bytes = 4 + (long long)bsz;
        return -2;
      }
      break;
    }
    std::memcpy(out_buf + used, szb, 4);
    if (reader_read(r, out_buf + used + 4, bsz) < static_cast<size_t>(bsz)) {
      r->coffset = save_co;
      r->uoffset = save_uo;
      break;
    }
    used += 4 + bsz;
    ++count;
  }
  *n_bytes = used;
  return count;
}

int ptio_check_eof(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  if (sz < 28) {
    fclose(f);
    return 0;
  }
  uint8_t buf[28];
  fseek(f, sz - 28, SEEK_SET);
  size_t got = fread(buf, 1, 28, f);
  fclose(f);
  return got == 28 && std::memcmp(buf, kEofMarker, 28) == 0;
}

// --- writer ---------------------------------------------------------------

void* ptio_writer_open(const char* path, int level, int n_threads) {
  Writer* w = new Writer();
  w->f = (std::strcmp(path, "-") == 0) ? stdout : fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->level = level;
  w->n_threads = n_threads < 1 ? 1 : n_threads;
  // deep enough that encode bursts never stall on a momentarily-busy pool
  // (~16 MB raw at 256: deflate is the dominant host cost and the producer
  // must be able to run ahead through device-compute windows)
  w->max_inflight = std::max<size_t>(256, 32 * w->n_threads);
  if (w->n_threads > 1) {
    for (int i = 0; i < w->n_threads; ++i)
      w->pool.emplace_back(worker_main, w);
    w->io = std::thread(io_main, w);
  }
  return w;
}

void ptio_write(void* h, const uint8_t* data, long long n) {
  // Single-copy carve: full blocks go straight from the caller's buffer
  // into job storage (the old append + front-erase + block-copy walked
  // every output byte three times); only the <1-block tail is buffered.
  Writer* w = static_cast<Writer*>(h);
  constexpr size_t kBlock = 0xff00;
  size_t off = 0;
  if (!w->pending.empty()) {
    size_t take = std::min<size_t>(kBlock - w->pending.size(), (size_t)n);
    w->pending.insert(w->pending.end(), data, data + take);
    off = take;
    if (w->pending.size() == kBlock) {
      writer_submit(w, std::move(w->pending));
      w->pending.clear();
    }
  }
  while ((size_t)n - off >= kBlock) {
    writer_submit(w, std::vector<uint8_t>(data + off, data + off + kBlock));
    off += kBlock;
  }
  w->pending.insert(w->pending.end(), data + off, data + n);
}

int ptio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  if (!w->pending.empty()) {
    writer_submit(w, std::move(w->pending));
    w->pending.clear();
  }
  if (w->n_threads > 1) {
    {
      std::lock_guard<std::mutex> lk(w->mu);
      w->closing = true;
    }
    w->cv_work.notify_all();
    for (auto& t : w->pool) t.join();
    {
      std::lock_guard<std::mutex> lk(w->mu);
      w->io_closing = true;
    }
    w->cv_done.notify_all();
    w->io.join();
  }
  fwrite(kEofMarker, 1, 28, w->f);
  fflush(w->f);
  int ok = w->error.empty() ? 1 : 0;
  if (w->f != stdout) fclose(w->f);
  delete w;
  return ok;
}

}  // extern "C"
