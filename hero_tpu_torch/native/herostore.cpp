// libherostore — native record-store I/O for hero_tpu.
//
// Replaces the reference's LMDB + lz4 C dependencies (HERO
// data/data.py:18-24,70-74) with one small library:
//   - mmap'd zero-copy reads of data.bin payloads,
//   - batched gather reads (GIL released on the Python side via ctypes),
//   - LZ4 block compress/decompress (self-contained implementation of the
//     public LZ4 block format) for compressed feature stores.
//
// Exposed through ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

extern "C" {

struct StoreHandle {
    int fd;
    uint8_t* base;
    uint64_t size;
};

void* hs_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    auto* h = new StoreHandle();
    h->fd = fd;
    h->size = static_cast<uint64_t>(st.st_size);
    if (h->size == 0) {
        h->base = nullptr;
        return h;
    }
    void* p = mmap(nullptr, h->size, PROT_READ, MAP_SHARED, fd, 0);
    if (p == MAP_FAILED) { ::close(fd); delete h; return nullptr; }
    h->base = static_cast<uint8_t*>(p);
    madvise(p, h->size, MADV_WILLNEED);
    return h;
}

void hs_close(void* handle) {
    auto* h = static_cast<StoreHandle*>(handle);
    if (!h) return;
    if (h->base) munmap(h->base, h->size);
    ::close(h->fd);
    delete h;
}

// Copy one record into out (caller allocates).  Returns bytes copied or -1.
int64_t hs_read(void* handle, uint64_t offset, uint64_t length,
                uint8_t* out) {
    auto* h = static_cast<StoreHandle*>(handle);
    // overflow-safe: offset + length may wrap on hostile index data
    if (!h || offset > h->size || length > h->size - offset) return -1;
    memcpy(out, h->base + offset, length);
    return static_cast<int64_t>(length);
}

// Gather n records into one contiguous out buffer; out_offsets[i] gives the
// start of record i in out.  Returns total bytes or -1.
int64_t hs_read_many(void* handle, int64_t n, const uint64_t* offsets,
                     const uint64_t* lengths, uint8_t* out,
                     uint64_t* out_offsets) {
    auto* h = static_cast<StoreHandle*>(handle);
    if (!h) return -1;
    uint64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        if (offsets[i] > h->size || lengths[i] > h->size - offsets[i])
            return -1;
        memcpy(out + pos, h->base + offsets[i], lengths[i]);
        out_offsets[i] = pos;
        pos += lengths[i];
    }
    return static_cast<int64_t>(pos);
}

// ---------------------------------------------------------------------------
// LZ4 block format (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md)
// ---------------------------------------------------------------------------

// Decompress an LZ4 block into dst (dst_cap must equal the original size).
// Returns decompressed size or -1 on malformed input.
int64_t hs_lz4_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                          int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                lit += s;
            } while (s == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last literals, no match
        // match
        if (ip + 2 > iend) return -1;
        uint16_t off = static_cast<uint16_t>(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 0x0F);
        if (mlen == 15) {
            uint8_t s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                mlen += s;
            } while (s == 255);
        }
        mlen += 4;
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - off;
        for (int64_t i = 0; i < mlen; i++) op[i] = match[i];  // overlapping
        op += mlen;
    }
    return op - dst;
}

// Greedy hash-table LZ4 block compressor.  dst_cap should be
// src_len + src_len/255 + 16.  Returns compressed size or -1.
int64_t hs_lz4_compress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                        int64_t dst_cap) {
    const int HASH_LOG = 16;
    const int64_t MIN_MATCH = 4;
    const int64_t MFLIMIT = 12;   // last 12 bytes must be literals
    std::vector<int64_t> table(1 << HASH_LOG, -1);
    auto hash = [](uint32_t v) {
        return (v * 2654435761u) >> (32 - HASH_LOG);
    };
    auto read32 = [](const uint8_t* p) {
        uint32_t v;
        memcpy(&v, p, 4);
        return v;
    };

    const uint8_t* ip = src;
    const uint8_t* anchor = src;
    const uint8_t* iend = src + src_len;
    const uint8_t* mflimit = iend - MFLIMIT;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;

    auto emit = [&](const uint8_t* lit_start, int64_t lit_len,
                    int64_t match_off, int64_t match_len) -> bool {
        // token
        if (op >= oend) return false;
        uint8_t* token = op++;
        int64_t l = lit_len;
        *token = (l >= 15 ? 15 : static_cast<uint8_t>(l)) << 4;
        if (l >= 15) {
            l -= 15;
            while (l >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                l -= 255;
            }
            if (op >= oend) return false;
            *op++ = static_cast<uint8_t>(l);
        }
        if (op + lit_len > oend) return false;
        memcpy(op, lit_start, lit_len);
        op += lit_len;
        if (match_len < 0) return true;  // final literals
        if (op + 2 > oend) return false;
        *op++ = static_cast<uint8_t>(match_off & 0xFF);
        *op++ = static_cast<uint8_t>(match_off >> 8);
        int64_t m = match_len - MIN_MATCH;
        *token |= (m >= 15 ? 15 : static_cast<uint8_t>(m));
        if (m >= 15) {
            m -= 15;
            while (m >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                m -= 255;
            }
            if (op >= oend) return false;
            *op++ = static_cast<uint8_t>(m);
        }
        return true;
    };

    if (src_len >= MFLIMIT + 1) {
        while (ip < mflimit) {
            uint32_t seq = read32(ip);
            uint32_t hsh = hash(seq);
            int64_t cand = table[hsh];
            table[hsh] = ip - src;
            if (cand >= 0 && (ip - src) - cand <= 0xFFFF
                    && read32(src + cand) == seq) {
                // extend match
                const uint8_t* match = src + cand;
                const uint8_t* mip = ip + MIN_MATCH;
                const uint8_t* mm = match + MIN_MATCH;
                while (mip < mflimit && *mip == *mm) { mip++; mm++; }
                int64_t mlen = mip - ip;
                if (!emit(anchor, ip - anchor, ip - match, mlen))
                    return -1;
                ip += mlen;
                anchor = ip;
            } else {
                ip++;
            }
        }
    }
    if (!emit(anchor, iend - anchor, 0, -1)) return -1;
    return op - dst;
}

}  // extern "C"
