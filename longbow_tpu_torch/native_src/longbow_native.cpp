// longbow_native: host-side native runtime pieces.
//
// The reference keeps its WAL hot path in optimized Go with CRC32
// framing and double-buffered flushing (reference:
// storage/batched_wal.go:188-423, encodeWALEntryHeader :423). Python's
// serving edge needs the same integrity/framing work off the
// interpreter: this library provides CRC32C (Castagnoli,
// slicing-by-8), WAL frame encode, and a full-file scan/verify that
// returns entry offsets without copying payloads. Built with plain
// g++ -O3 -shared; loaded via ctypes (no pybind11 in this image).
#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
    const uint32_t POLY = 0x82f63b78u;  // CRC-32C (Castagnoli), reflected
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? POLY : 0);
        crc32c_table[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = crc32c_table[0][i];
        for (int s = 1; s < 8; s++) {
            crc = crc32c_table[0][crc & 0xff] ^ (crc >> 8);
            crc32c_table[s][i] = crc;
        }
    }
    crc32c_init_done = true;
}

// CRC32C with slicing-by-8 (~1 byte/cycle scalar; SSE4.2 hardware CRC
// would be faster but this must run on any host the wheel lands on).
uint32_t lb_crc32c(const uint8_t* data, uint64_t len, uint32_t seed) {
    if (!crc32c_init_done) crc32c_init();
    uint32_t crc = ~seed;
    while (len >= 8) {
        uint64_t chunk;
        memcpy(&chunk, data, 8);
        crc ^= (uint32_t)chunk;
        uint32_t hi = (uint32_t)(chunk >> 32);
        crc = crc32c_table[7][crc & 0xff] ^
              crc32c_table[6][(crc >> 8) & 0xff] ^
              crc32c_table[5][(crc >> 16) & 0xff] ^
              crc32c_table[4][crc >> 24] ^
              crc32c_table[3][hi & 0xff] ^
              crc32c_table[2][(hi >> 8) & 0xff] ^
              crc32c_table[1][(hi >> 16) & 0xff] ^
              crc32c_table[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    while (len--) crc = crc32c_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
    return ~crc;
}

// WAL frame layout (little-endian), after the reference's entry format
// [CRC32][Seq][TS][NameLen][RecLen][Name][ArrowIPC]
// (reference: batched_wal.go:423):
//   u32 crc32c   over everything after this field
//   u64 seq
//   f64 ts
//   u16 name_len
//   u8  kind      (0 = record batch IPC, 1 = op JSON)
//   u32 payload_len
//   name bytes, payload bytes
static const uint64_t HDR = 4 + 8 + 8 + 2 + 1 + 4;

uint64_t lb_wal_frame_size(uint16_t name_len, uint32_t payload_len) {
    return HDR + name_len + payload_len;
}

// Writes one frame into out (caller sizes it with lb_wal_frame_size).
uint64_t lb_wal_encode(
    uint8_t* out, uint64_t seq, double ts, const uint8_t* name,
    uint16_t name_len, uint8_t kind, const uint8_t* payload,
    uint32_t payload_len) {
    uint8_t* p = out + 4;
    memcpy(p, &seq, 8); p += 8;
    memcpy(p, &ts, 8); p += 8;
    memcpy(p, &name_len, 2); p += 2;
    *p++ = kind;
    memcpy(p, &payload_len, 4); p += 4;
    memcpy(p, name, name_len); p += name_len;
    memcpy(p, payload, payload_len); p += payload_len;
    uint64_t total = (uint64_t)(p - out);
    uint32_t crc = lb_crc32c(out + 4, total - 4, 0);
    memcpy(out, &crc, 4);
    return total;
}

// Scans a WAL buffer; fills offsets[] with the start of each valid
// frame. Returns the number of valid frames. Stops at the first
// corrupt frame (fail-fast, like the reference's CRC-verified replay,
// engine.go:160-220); *valid_bytes gets the clean prefix length.
int64_t lb_wal_scan(
    const uint8_t* buf, uint64_t len, uint64_t* offsets,
    int64_t max_entries, uint64_t* valid_bytes) {
    if (!crc32c_init_done) crc32c_init();
    uint64_t pos = 0;
    int64_t count = 0;
    while (pos + HDR <= len && count < max_entries) {
        uint32_t stored_crc;
        memcpy(&stored_crc, buf + pos, 4);
        uint16_t name_len;
        memcpy(&name_len, buf + pos + 4 + 8 + 8, 2);
        uint32_t payload_len;
        memcpy(&payload_len, buf + pos + 4 + 8 + 8 + 2 + 1, 4);
        uint64_t frame = HDR + name_len + payload_len;
        if (pos + frame > len) break;  // truncated tail
        uint32_t crc = lb_crc32c(buf + pos + 4, frame - 4, 0);
        if (crc != stored_crc) break;  // corrupt: fail fast
        offsets[count++] = pos;
        pos += frame;
    }
    *valid_bytes = pos;
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------
// io_uring WAL backend (reference: UringBackend wal_backend_linux.go:
// 15-125 — async batched writes + fsync off the caller's thread).
// Raw syscalls, no liburing dependency; callers fall back to buffered
// pwrite when setup fails (old kernel, seccomp).
#ifdef __linux__
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <sys/stat.h>
#include <unistd.h>
#include <fcntl.h>
#include <cstdlib>
#include <cerrno>

namespace {

struct LbUring {
    int ring_fd = -1;
    int file_fd = -1;
    unsigned sq_entries = 0;
    void* sq_ptr = nullptr; size_t sq_size = 0;
    void* cq_ptr = nullptr; size_t cq_size = 0;  // may alias sq_ptr
    io_uring_sqe* sqes = nullptr; size_t sqes_size = 0;
    unsigned* sq_head = nullptr;
    unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    unsigned* cq_head = nullptr;
    unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    uint64_t offset = 0;     // append position
    unsigned inflight = 0;   // submitted, not yet reaped
    int64_t io_errors = 0;
};

int uring_setup_sys(unsigned entries, io_uring_params* p) {
    return (int)syscall(SYS_io_uring_setup, entries, p);
}
int uring_enter_sys(int fd, unsigned to_submit, unsigned min_complete,
                    unsigned flags) {
    return (int)syscall(SYS_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

// reap every available completion; frees the write buffers.
// A write buffer's first 8 bytes hold the requested length so a SHORT
// write (res >= 0 but < requested — silent WAL corruption otherwise)
// counts as an IO error exactly like res < 0.
void uring_reap(LbUring* u) {
    unsigned head = __atomic_load_n(u->cq_head, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
        io_uring_cqe* cqe = &u->cqes[head & *u->cq_mask];
        if (cqe->user_data) {
            void* buf = (void*)(uintptr_t)cqe->user_data;
            uint64_t want;
            memcpy(&want, buf, 8);
            if (cqe->res < 0 || (uint64_t)cqe->res != want)
                u->io_errors++;
            free(buf);
        } else if (cqe->res < 0) {
            u->io_errors++;
        }
        head++;
        if (u->inflight) u->inflight--;
    }
    __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
}

io_uring_sqe* uring_next_sqe(LbUring* u) {
    // loop until a slot frees: a single wait+reap pass is not
    // guaranteed to open one, and overwriting a not-yet-consumed SQE
    // would drop a WAL write on the floor
    for (;;) {
        unsigned head = __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
        unsigned tail = *u->sq_tail;
        if (tail - head < u->sq_entries) break;
        int rc = uring_enter_sys(u->ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
        uring_reap(u);
        if (rc < 0 && errno != EINTR) break;  // ring wedged: best effort
    }
    unsigned idx = (*u->sq_tail) & *u->sq_mask;
    io_uring_sqe* sqe = &u->sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    u->sq_array[idx] = idx;
    return sqe;
}

void uring_submit(LbUring* u) {
    __atomic_store_n(u->sq_tail, *u->sq_tail + 1, __ATOMIC_RELEASE);
    uring_enter_sys(u->ring_fd, 1, 0, 0);
    u->inflight++;
}

}  // namespace

// -> handle (>0) or 0 on failure
extern "C" uint64_t lb_uring_open(const char* path, uint32_t entries) {
    LbUring* u = new LbUring();
    io_uring_params p;
    memset(&p, 0, sizeof(p));
    u->ring_fd = uring_setup_sys(entries ? entries : 64, &p);
    if (u->ring_fd < 0) { delete u; return 0; }
    u->sq_entries = p.sq_entries;
    u->sq_size = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    u->cq_size = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    bool single = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single && u->cq_size > u->sq_size) u->sq_size = u->cq_size;
    u->sq_ptr = mmap(nullptr, u->sq_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, u->ring_fd,
                     IORING_OFF_SQ_RING);
    if (u->sq_ptr == MAP_FAILED) { close(u->ring_fd); delete u; return 0; }
    if (single) {
        u->cq_ptr = u->sq_ptr;
    } else {
        u->cq_ptr = mmap(nullptr, u->cq_size, PROT_READ | PROT_WRITE,
                         MAP_SHARED | MAP_POPULATE, u->ring_fd,
                         IORING_OFF_CQ_RING);
        if (u->cq_ptr == MAP_FAILED) { close(u->ring_fd); delete u; return 0; }
    }
    u->sqes_size = p.sq_entries * sizeof(io_uring_sqe);
    u->sqes = (io_uring_sqe*)mmap(nullptr, u->sqes_size,
                                  PROT_READ | PROT_WRITE,
                                  MAP_SHARED | MAP_POPULATE, u->ring_fd,
                                  IORING_OFF_SQES);
    if (u->sqes == MAP_FAILED) { close(u->ring_fd); delete u; return 0; }
    char* sq = (char*)u->sq_ptr;
    char* cq = (char*)u->cq_ptr;
    u->sq_head = (unsigned*)(sq + p.sq_off.head);
    u->sq_tail = (unsigned*)(sq + p.sq_off.tail);
    u->sq_mask = (unsigned*)(sq + p.sq_off.ring_mask);
    u->sq_array = (unsigned*)(sq + p.sq_off.array);
    u->cq_head = (unsigned*)(cq + p.cq_off.head);
    u->cq_tail = (unsigned*)(cq + p.cq_off.tail);
    u->cq_mask = (unsigned*)(cq + p.cq_off.ring_mask);
    u->cqes = (io_uring_cqe*)(cq + p.cq_off.cqes);

    u->file_fd = open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (u->file_fd < 0) { close(u->ring_fd); delete u; return 0; }
    struct stat st;
    if (fstat(u->file_fd, &st) == 0) u->offset = (uint64_t)st.st_size;
    return (uint64_t)(uintptr_t)u;
}

// async append: copies buf, submits, returns new file size (or -1)
extern "C" int64_t lb_uring_write(uint64_t h, const uint8_t* buf, uint64_t len) {
    LbUring* u = (LbUring*)(uintptr_t)h;
    if (!u || u->file_fd < 0) return -1;
    uring_reap(u);  // opportunistic buffer recycling
    // buffer layout: [u64 requested_len][payload] — reap compares the
    // completion's res against requested_len to catch short writes
    void* copy = malloc(len + 8);
    if (!copy) return -1;
    memcpy(copy, &len, 8);
    memcpy((char*)copy + 8, buf, len);
    io_uring_sqe* sqe = uring_next_sqe(u);
    sqe->opcode = IORING_OP_WRITE;
    sqe->fd = u->file_fd;
    sqe->addr = (uint64_t)(uintptr_t)copy + 8;
    sqe->len = (uint32_t)len;
    sqe->off = u->offset;
    // DRAIN orders this append after everything already queued.
    // Buffered appends usually execute inline at submit, but one
    // punted to an io-wq worker (dirty-page throttling under exactly
    // the heavy-ingest load a WAL sees) could complete AFTER a later
    // append — with O_APPEND the frames would land in the file out of
    // order, and replay applies file order. IOSQE_IO_LINK can't give
    // this guarantee (chains don't span submission boundaries; we
    // submit one SQE at a time).
    sqe->flags = IOSQE_IO_DRAIN;
    sqe->user_data = (uint64_t)(uintptr_t)copy;
    uring_submit(u);
    u->offset += len;
    return (int64_t)u->offset;
}

// barrier: fdatasync AFTER all prior writes complete; waits for
// everything in flight. -> 0 ok, -1 on any IO error so far
extern "C" int64_t lb_uring_fsync(uint64_t h) {
    LbUring* u = (LbUring*)(uintptr_t)h;
    if (!u || u->file_fd < 0) return -1;
    io_uring_sqe* sqe = uring_next_sqe(u);
    sqe->opcode = IORING_OP_FSYNC;
    sqe->fd = u->file_fd;
    sqe->fsync_flags = IORING_FSYNC_DATASYNC;
    sqe->flags = IOSQE_IO_DRAIN;  // run only after queued writes
    uring_submit(u);
    while (u->inflight) {
        int rc = uring_enter_sys(u->ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
        if (rc < 0 && errno != EINTR) { u->io_errors++; break; }
        uring_reap(u);
    }
    return u->io_errors ? -1 : 0;
}

extern "C" int64_t lb_uring_size(uint64_t h) {
    LbUring* u = (LbUring*)(uintptr_t)h;
    return u ? (int64_t)u->offset : -1;
}

extern "C" int64_t lb_uring_truncate(uint64_t h) {
    LbUring* u = (LbUring*)(uintptr_t)h;
    if (!u || u->file_fd < 0) return -1;
    lb_uring_fsync(h);
    if (ftruncate(u->file_fd, 0) != 0) return -1;
    u->offset = 0;
    return 0;
}

extern "C" void lb_uring_close(uint64_t h) {
    LbUring* u = (LbUring*)(uintptr_t)h;
    if (!u) return;
    lb_uring_fsync(h);
    if (u->file_fd >= 0) close(u->file_fd);
    if (u->ring_fd >= 0) close(u->ring_fd);
    delete u;
}
#else  // !__linux__
extern "C" uint64_t lb_uring_open(const char*, uint32_t) { return 0; }
extern "C" int64_t lb_uring_write(uint64_t, const uint8_t*, uint64_t) { return -1; }
extern "C" int64_t lb_uring_fsync(uint64_t) { return -1; }
extern "C" int64_t lb_uring_size(uint64_t) { return -1; }
extern "C" int64_t lb_uring_truncate(uint64_t) { return -1; }
extern "C" void lb_uring_close(uint64_t) {}
#endif

// ---------------------------------------------------------------------
// Fast JSON numeric-array parser for search tickets.
//
// The reference keeps ticket parsing off its GC with a hand-rolled
// zero-allocation scanner (reference: query/zero_alloc_parser.go:
// 47-640). Here the equivalent hot cost is CPython float parsing: a
// single 384-d query vector costs ~134us under json.loads (~7.5k
// tickets/s ceiling on one core). parse_ticket excises the "vector"/
// "vectors" numeric span, this routine parses it straight into a
// float32 buffer, and stdlib json handles only the small remainder.
//
// Accepts a flat array of numbers or one level of nesting (a batch of
// vectors). Returns the float count, -1 on anything unexpected (the
// caller falls back to stdlib json), -2 on out-buffer overflow.
// *rows = inner-array count (0 for a flat array); *consumed = bytes
// through the matching close bracket.
#include <cstdlib>

// Hand-rolled JSON-number -> f32 (reference's zero-alloc parser also
// hand-parses floats, zero_alloc_parser.go:284-420). glibc strtof
// measured ~100ns/float (39us for one 384-d vector — most of the
// ticket budget); mantissa*pow10 in double is ~10ns and exact to well
// below f32 ulp (f32 needs 24 mantissa bits; double gives 53).
// Numbers outside the pow10 table (|exp|>307) defer to strtof.
static double lb_pow10_tbl[616];  // 10^-308 .. 10^307
static bool lb_pow10_init_done = false;

static void lb_pow10_init() {
    for (int e = -308; e <= 307; e++) {
        double v = 1.0;
        double b = (e < 0) ? 0.1 : 10.0;
        int n = (e < 0) ? -e : e;
        // exact enough: build from pow() to avoid cumulative error
        v = __builtin_pow(10.0, (double)e);
        (void)b; (void)n;
        lb_pow10_tbl[e + 308] = v;
    }
    lb_pow10_init_done = true;
}

// Parses one JSON number at p (p < end guaranteed by caller's byte
// check). Returns the char past the number, or nullptr on malformed.
static inline const char* lb_parse_num(
    const char* p, const char* end, float* outv
) {
    const char* start = p;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; p++; }
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    uint64_t mant = 0;
    int exp10 = 0;
    int digs = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digs < 19) { mant = mant * 10 + (uint64_t)(*p - '0'); digs++; }
        else exp10++;  // beyond 19 digits: drop, bump exponent
        p++;
    }
    if (p < end && *p == '.') {
        p++;
        if (p >= end || *p < '0' || *p > '9') return nullptr;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digs < 19) {
                mant = mant * 10 + (uint64_t)(*p - '0');
                digs++; exp10--;
            }
            p++;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        p++;
        bool eneg = false;
        if (p < end && (*p == '+' || *p == '-')) { eneg = (*p == '-'); p++; }
        if (p >= end || *p < '0' || *p > '9') return nullptr;
        int ev = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            if (ev < 100000) ev = ev * 10 + (*p - '0');
            p++;
        }
        exp10 += eneg ? -ev : ev;
    }
    if (exp10 < -308 || exp10 > 307) {
        // extreme exponent: strtof decides (subnormal/overflow edge)
        char* e2 = nullptr;
        float v = strtof(start, &e2);
        if (e2 != p) return nullptr;  // strtof must agree on the extent
        if (v == __builtin_inff() || v == -__builtin_inff())
            return nullptr;  // overflow: stdlib fallback handles it
        *outv = v;
        return p;
    }
    double d = (double)mant * lb_pow10_tbl[exp10 + 308];
    *outv = (float)(neg ? -d : d);
    return p;
}

extern "C" int64_t lb_json_f32(
    const char* buf, uint64_t len, float* out, int64_t max_out,
    int64_t* rows, uint64_t* consumed
) {
    if (len == 0 || buf[0] != '[') return -1;
    if (!lb_pow10_init_done) lb_pow10_init();
    const char* end = buf + len;
    uint64_t i = 0;
    int64_t n = 0, nrows = 0;
    int depth = 0;
    // structural state: stdlib-grade strictness so the fast path never
    // ACCEPTS what json.loads rejects (`[1,,2]`, `[1 2]`, `[1,]`) and
    // never silently mis-shapes a RAGGED batch ([[1,2,3],[4]] has
    // n % nrows == 0 yet reshapes to garbage — every inner array must
    // have the first one's length)
    int64_t row_start = 0, row_len = -1;
    bool expect_value = false;  // just consumed '[' or ','
    bool saw_elem[3] = {false, false, false};
    bool top_has_num = false;
    while (i < len) {
        char c = buf[i];
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
            i++;
        } else if (c == '[') {
            if (depth > 0 && !expect_value) return -1;
            if (depth == 1 && top_has_num) return -1;  // [1,[...]]
            if (++depth > 2) return -1;
            if (depth == 2) { nrows++; row_start = n; }
            saw_elem[depth] = false;
            expect_value = true;
            i++;
        } else if (c == ']') {
            if (expect_value && saw_elem[depth]) return -1;  // [1,]
            if (depth == 2) {
                int64_t rl = n - row_start;
                if (row_len < 0) row_len = rl;
                else if (rl != row_len) return -1;  // ragged batch
            }
            if (--depth < 0) return -1;
            saw_elem[depth] = true;  // closed array is parent's element
            expect_value = false;
            i++;
            if (depth == 0) {
                *rows = nrows;
                *consumed = i;
                return n;
            }
        } else if (c == ',') {
            if (expect_value || !saw_elem[depth]) return -1;
            expect_value = true;
            i++;
        } else {
            // a JSON number; NaN/Infinity literals or overflow fail
            // here and the whole ticket falls back to stdlib json
            if (saw_elem[depth] && !expect_value) return -1;  // [1 2]
            if (depth == 1 && nrows > 0) return -1;  // [[1],2]
            float v;
            const char* np_ = lb_parse_num(buf + i, end, &v);
            if (np_ == nullptr) return -1;
            if (n >= max_out) return -2;
            out[n++] = v;
            if (depth == 1) top_has_num = true;
            saw_elem[depth] = true;
            expect_value = false;
            i = (uint64_t)(np_ - buf);
        }
    }
    return -1;  // ran off the end before the close bracket
}

// Single-pass f32 -> bf16-bits conversion (round-to-nearest-even,
// matching XLA's device cast). The numpy expression for this allocated
// ~5 corpus-sized temporaries and profiled at 45% of the ingest apply
// thread (memory-bandwidth bound); this is one read + one half-width
// write, auto-vectorized, and releases the GIL for the duration.
// Inverse single-pass expansion (scan serving hot path: decoding the
// bf16-bits mirror to wire f32 via numpy allocated two block-sized
// temporaries — astype(u32) then <<16 — per scan).
extern "C" void lb_bf16_to_f32(
    const uint16_t* src, uint32_t* dst, uint64_t n
) {
    for (uint64_t i = 0; i < n; i++) {
        dst[i] = ((uint32_t)src[i]) << 16;
    }
}

extern "C" void lb_f32_to_bf16(
    const uint32_t* src, uint16_t* dst, uint64_t n
) {
    for (uint64_t i = 0; i < n; i++) {
        uint32_t u = src[i];
        // NaN must stay NaN: the bare RNE add would carry a small-
        // payload NaN's mantissa into the exponent and emit Inf. XLA
        // (Eigen float_to_bfloat16_rtne) canonicalizes NaN to
        // sign|0x7FC0 — match it exactly. Branchless select keeps the
        // loop auto-vectorizable.
        uint16_t rne = (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
        bool is_nan = ((u & 0x7F800000u) == 0x7F800000u)
                      && ((u & 0x007FFFFFu) != 0u);
        uint16_t qnan = (uint16_t)(((u >> 16) & 0x8000u) | 0x7FC0u);
        dst[i] = is_nan ? qnan : rne;
    }
}
