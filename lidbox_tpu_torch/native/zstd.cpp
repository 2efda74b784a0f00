// A Zstandard frame decoder (RFC 8878) and the CRC-32C checksum, for
// reading Orbax checkpoints (host code, not a device kernel).
//
// Orbax writes its arrays as zarr chunks compressed with zstd, inside an
// OCDBT store whose B+tree nodes are zstd frames too, and every OCDBT file
// ends in a CRC-32C. The card's machine has no zstd library for Python, so
// train/orbax.py reads both through this file. Decoding only: the port
// writes its own checkpoints uncompressed.
//
// Covered: raw, RLE and compressed blocks; raw, RLE, Huffman (1 and 4
// streams) and treeless literals, with Huffman weights direct or
// FSE-coded; sequences with predefined, RLE, FSE-coded and repeated
// tables; the repeat-offset history; skippable frames; the optional
// content checksum (XXH64), which is verified. Dictionaries are not
// (Orbax uses none): a frame that names one is refused.
//
// C ABI (see lidbox_tpu_torch/native/zstd.py):
//   zs_decompress  decode every frame of a buffer into a new buffer
//   zs_error       the message of a negative return code
//   zs_crc32c      CRC-32C (Castagnoli) of a buffer
//   zs_free        free a buffer allocated by this library
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zstd.cpp -o ../_build/libzstd.so
// (done at first use by native/zstd.py)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

enum Err {
    OK = 0,
    E_TRUNCATED = -1,
    E_MAGIC = -2,
    E_RESERVED = -3,
    E_DICTIONARY = -4,
    E_CORRUPT = -5,
    E_CHECKSUM = -6,
    E_SIZE = -7,
    E_ALLOC = -8,
};

struct Fail { int code; };
[[noreturn]] void fail(int code) { throw Fail{code}; }
inline void need(bool ok, int code = E_CORRUPT) { if (!ok) fail(code); }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) {
    uint32_t v; std::memcpy(&v, p, 4); return v;  // little-endian hosts
}
inline uint64_t rd64(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
    return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t h, uint64_t v) {
    return (h ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, rd64(p)); v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16)); v4 = xround(v4, rd64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) { h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3; p += 4; }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------- bits
// A backward bit stream (RFC 8878 section 4.1): read from the end towards
// the start, just below the 1 bit that marks the end of the last byte.
// Bits read past the start are zeros; overflow() tells that it happened.
struct BackBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;  // bits left to read (the next bits are [pos - k, pos))
    BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
        need(len > 0 && src[len - 1] != 0);
        pos = int64_t(len - 1) * 8 + highbit(src[len - 1]);
    }
    // the k (<= 56) bits below pos, without consuming them
    uint64_t peek(int k) const {
        if (k == 0) return 0;
        int64_t lo = pos - k;
        if (lo >= 0 && size_t(lo / 8) + 8 <= n) {
            uint64_t w = rd64(p + lo / 8) >> (lo % 8);
            return w & ((uint64_t(1) << k) - 1);
        }
        uint64_t v = 0;  // near either end: bit by bit
        for (int64_t b = pos - 1; b >= lo; --b) {
            v <<= 1;
            if (b >= 0) v |= (p[b / 8] >> (b % 8)) & 1;
        }
        return v;
    }
    uint64_t read(int k) { uint64_t v = peek(k); pos -= k; return v; }
    void skip(int k) { pos -= k; }
    bool overflow() const { return pos < 0; }
    bool done() const { return pos == 0; }
};

// ---------------------------------------------------------------- FSE
struct FseCell { uint16_t symbol; uint8_t bits; uint16_t base; };

struct FseTable {
    int log = 0;
    std::vector<FseCell> cells;
};

// Normalized counts (RFC 8878 section 4.1.1); returns the bytes read.
size_t read_counts(const uint8_t* src, size_t len, int max_log, int max_symbol,
                   std::vector<int>& norm, int& log) {
    size_t bitpos = 0;
    auto bits = [&](int k) -> uint32_t {  // forward, little-endian, no consume
        uint64_t v = 0;
        size_t byte = bitpos / 8;
        for (int i = 0; i < 8 && byte + i < len; ++i)
            v |= uint64_t(src[byte + i]) << (8 * i);
        return uint32_t((v >> (bitpos % 8)) & ((uint64_t(1) << k) - 1));
    };
    need(len > 0, E_TRUNCATED);
    log = int(bits(4)) + 5;
    bitpos += 4;
    need(log <= max_log);
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
    int symbol = 0;
    norm.assign(max_symbol + 1, 0);
    bool previous0 = false;
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous0) {
            int n0 = symbol;
            for (;;) {
                uint32_t r = bits(2);
                bitpos += 2;
                n0 += r;
                if (r != 3) break;
            }
            need(n0 <= max_symbol + 1);
            while (symbol < n0) norm[symbol++] = 0;
            if (symbol > max_symbol) break;
        }
        int max = 2 * threshold - 1 - remaining;
        int count;
        uint32_t low = bits(nbits);
        if (int(low & (threshold - 1)) < max) {
            count = low & (threshold - 1);
            bitpos += nbits - 1;
        } else {
            count = low & (2 * threshold - 1);
            if (count >= threshold) count -= max;
            bitpos += nbits;
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = count;
        previous0 = count == 0;
        while (remaining < threshold) { --nbits; threshold >>= 1; }
        need((bitpos + 7) / 8 <= len, E_TRUNCATED);
    }
    need(remaining == 1);
    norm.resize(symbol);
    return (bitpos + 7) / 8;
}

void build_fse(const std::vector<int>& norm, int log, FseTable& t) {
    int size = 1 << log;
    t.log = log;
    t.cells.assign(size, FseCell{0, 0, 0});
    std::vector<uint32_t> next(norm.size());
    int high = size - 1;
    for (size_t s = 0; s < norm.size(); ++s) {
        if (norm[s] == -1) {
            t.cells[high--].symbol = uint16_t(s);
            next[s] = 1;
        } else {
            next[s] = uint32_t(norm[s]);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (size_t s = 0; s < norm.size(); ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            t.cells[pos].symbol = uint16_t(s);
            do { pos = (pos + step) & mask; } while (pos > high);
        }
    }
    need(pos == 0);
    for (int u = 0; u < size; ++u) {
        uint32_t sym = t.cells[u].symbol;
        uint32_t state = next[sym]++;
        int nb = log - highbit(state);
        t.cells[u].bits = uint8_t(nb);
        t.cells[u].base = uint16_t((state << nb) - size);
    }
}

void rle_fse(int symbol, FseTable& t) {
    t.log = 0;
    t.cells.assign(1, FseCell{uint16_t(symbol), 0, 0});
}

struct FseState {
    const FseTable* t;
    uint32_t state;
    void init(BackBits& br, const FseTable& table) {
        t = &table;
        state = uint32_t(br.read(table.log));
    }
    uint32_t symbol() const { return t->cells[state].symbol; }
    void update(BackBits& br) {
        const FseCell& c = t->cells[state];
        state = c.base + uint32_t(br.read(c.bits));
    }
};

// ---------------------------------------------------------------- Huffman
struct HufTable {
    int max_bits = 0;
    std::vector<uint8_t> symbol, bits;  // 1 << max_bits entries
    bool valid = false;
};

// Huffman tree description (RFC 8878 section 4.2.1); returns bytes read.
size_t read_huffman(const uint8_t* src, size_t len, HufTable& h) {
    need(len >= 1, E_TRUNCATED);
    int header = src[0];
    std::vector<uint8_t> w;
    size_t used;
    if (header >= 128) {
        int count = header - 127;
        used = 1 + (count + 1) / 2;
        need(used <= len, E_TRUNCATED);
        for (int i = 0; i < count; ++i) {
            uint8_t b = src[1 + i / 2];
            w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
        }
    } else {
        used = 1 + header;
        need(used <= len && header > 0, E_TRUNCATED);
        std::vector<int> norm;
        int log;
        size_t hdr = read_counts(src + 1, header, 6, 255, norm, log);
        need(hdr < size_t(header));
        FseTable t;
        build_fse(norm, log, t);
        BackBits br(src + 1 + hdr, header - hdr);
        FseState s1, s2;
        s1.init(br, t);
        s2.init(br, t);
        for (;;) {  // as FSE_decompress: two interleaved states
            need(w.size() < 255);
            w.push_back(uint8_t(s1.symbol()));
            s1.update(br);
            if (br.overflow()) { w.push_back(uint8_t(s2.symbol())); break; }
            need(w.size() < 255);
            w.push_back(uint8_t(s2.symbol()));
            s2.update(br);
            if (br.overflow()) { w.push_back(uint8_t(s1.symbol())); break; }
        }
        need(w.size() <= 255);
    }
    uint32_t total = 0;
    for (uint8_t x : w) {
        need(x <= 11);
        if (x) total += uint32_t(1) << (x - 1);
    }
    need(total > 0);
    int max_bits = highbit(total) + 1;
    uint32_t rest = (uint32_t(1) << max_bits) - total;
    need(rest && (rest & (rest - 1)) == 0);
    w.push_back(uint8_t(highbit(rest) + 1));
    need(max_bits <= 11);
    // canonical codes: the longest codes (weight 1) take the lowest ranks
    std::vector<uint32_t> rank(13, 0);
    for (uint8_t x : w) rank[x]++;
    uint32_t next = 0;
    for (int x = 1; x <= max_bits; ++x) {
        uint32_t cur = next;
        next += rank[x] << (x - 1);
        rank[x] = cur;
    }
    need(next == (uint32_t(1) << max_bits));
    h.max_bits = max_bits;
    h.symbol.assign(size_t(1) << max_bits, 0);
    h.bits.assign(size_t(1) << max_bits, 0);
    for (size_t s = 0; s < w.size(); ++s) {
        if (!w[s]) continue;
        uint32_t n = (uint32_t(1) << w[s]) >> 1;
        for (uint32_t i = rank[w[s]]; i < rank[w[s]] + n; ++i) {
            h.symbol[i] = uint8_t(s);
            h.bits[i] = uint8_t(max_bits + 1 - w[s]);
        }
        rank[w[s]] += n;
    }
    h.valid = true;
    return used;
}

void huffman_stream(const HufTable& h, const uint8_t* src, size_t len,
                    uint8_t* out, size_t count) {
    BackBits br(src, len);
    for (size_t i = 0; i < count; ++i) {
        uint32_t idx = uint32_t(br.peek(h.max_bits));
        out[i] = h.symbol[idx];
        br.skip(h.bits[idx]);
    }
    need(br.done());
}

// ---------------------------------------------------------------- sequences
const int LL_BASE[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                         16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                         1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                         13, 14, 15, 16};
const int ML_BASE[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                         18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                         31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67,
                         83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                         32771, 65539};
const int ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                         12, 13, 14, 15, 16};
const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                            2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                            -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                            -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
    HufTable huf;
    FseTable ll, of, ml;
    bool ll_ok = false, of_ok = false, ml_ok = false;
    uint32_t rep[3] = {1, 4, 8};
};

// One table of a sequences section; returns the bytes read.
size_t read_table(int mode, const uint8_t* src, size_t len, const int* def,
                  int def_count, int def_log, int max_log, int max_symbol,
                  FseTable& t, bool& ok) {
    switch (mode) {
    case 0: {
        std::vector<int> norm(def, def + def_count);
        build_fse(norm, def_log, t);
        ok = true;
        return 0;
    }
    case 1:
        need(len >= 1, E_TRUNCATED);
        need(src[0] <= max_symbol);
        rle_fse(src[0], t);
        ok = true;
        return 1;
    case 2: {
        std::vector<int> norm;
        int log;
        size_t used = read_counts(src, len, max_log, max_symbol, norm, log);
        build_fse(norm, log, t);
        ok = true;
        return used;
    }
    default:
        need(ok);  // repeat: the previous block's table
        return 0;
    }
}

// A compressed block; out holds the frame's content from index start on.
void compressed_block(Frame& f, const uint8_t* src, size_t len,
                      std::vector<uint8_t>& out, size_t start,
                      size_t block_max) {
    // literals section
    need(len >= 1, E_TRUNCATED);
    int ltype = src[0] & 3, lsf = (src[0] >> 2) & 3;
    size_t regen, csize = 0, hdr;
    int streams = 1;
    if (ltype < 2) {
        if (lsf == 0 || lsf == 2) { hdr = 1; regen = src[0] >> 3; }
        else if (lsf == 1) { need(len >= 2, E_TRUNCATED); hdr = 2; regen = rd16(src) >> 4; }
        else { need(len >= 3, E_TRUNCATED); hdr = 3; regen = rd24(src) >> 4; }
    } else {
        streams = lsf == 0 ? 1 : 4;
        int nb = lsf < 2 ? 10 : (lsf == 2 ? 14 : 18);
        hdr = lsf < 2 ? 3 : (lsf == 2 ? 4 : 5);
        need(len >= hdr, E_TRUNCATED);
        uint64_t v = 0;
        for (size_t i = 0; i < hdr; ++i) v |= uint64_t(src[i]) << (8 * i);
        v >>= 4;
        regen = v & ((uint64_t(1) << nb) - 1);
        csize = (v >> nb) & ((uint64_t(1) << nb) - 1);
    }
    need(regen <= block_max);
    std::vector<uint8_t> lit(regen);
    const uint8_t* p = src + hdr;
    size_t left = len - hdr;
    if (ltype == 0) {
        need(left >= regen, E_TRUNCATED);
        if (regen) std::memcpy(lit.data(), p, regen);
        p += regen; left -= regen;
    } else if (ltype == 1) {
        need(left >= 1, E_TRUNCATED);
        if (regen) std::memset(lit.data(), p[0], regen);
        p += 1; left -= 1;
    } else {
        need(left >= csize, E_TRUNCATED);
        const uint8_t* q = p;
        size_t qn = csize;
        if (ltype == 2) {
            size_t used = read_huffman(q, qn, f.huf);
            q += used; qn -= used;
        } else {
            need(f.huf.valid);  // treeless: the previous Huffman table
        }
        if (streams == 1) {
            huffman_stream(f.huf, q, qn, lit.data(), regen);
        } else {
            need(qn >= 6, E_TRUNCATED);
            size_t s[4] = {rd16(q), rd16(q + 2), rd16(q + 4), 0};
            need(s[0] + s[1] + s[2] + 6 <= qn);
            s[3] = qn - 6 - s[0] - s[1] - s[2];
            size_t part = (regen + 3) / 4;
            need(regen >= 3 * part);
            const uint8_t* r = q + 6;
            for (int i = 0; i < 4; ++i) {
                size_t cnt = i < 3 ? part : regen - 3 * part;
                huffman_stream(f.huf, r, s[i], lit.data() + i * part, cnt);
                r += s[i];
            }
        }
        p += csize; left -= csize;
    }

    // sequences section
    need(left >= 1, E_TRUNCATED);
    size_t nseq;
    if (p[0] < 128) { nseq = p[0]; p += 1; left -= 1; }
    else if (p[0] < 255) { need(left >= 2, E_TRUNCATED); nseq = ((p[0] - 128) << 8) + p[1]; p += 2; left -= 2; }
    else { need(left >= 3, E_TRUNCATED); nseq = p[1] + (p[2] << 8) + 0x7F00; p += 3; left -= 3; }
    if (nseq == 0) {
        need(left == 0);
        out.insert(out.end(), lit.begin(), lit.end());
        return;
    }
    need(left >= 1, E_TRUNCATED);
    int modes = p[0];
    need((modes & 3) == 0, E_RESERVED);
    p += 1; left -= 1;
    size_t used = read_table(modes >> 6, p, left, LL_DEFAULT, 36, 6, 9, 35, f.ll, f.ll_ok);
    p += used; left -= used;
    used = read_table((modes >> 4) & 3, p, left, OF_DEFAULT, 29, 5, 8, 31, f.of, f.of_ok);
    p += used; left -= used;
    used = read_table((modes >> 2) & 3, p, left, ML_DEFAULT, 53, 6, 9, 52, f.ml, f.ml_ok);
    p += used; left -= used;

    BackBits br(p, left);
    FseState ll, of, ml;
    ll.init(br, f.ll);
    of.init(br, f.of);
    ml.init(br, f.ml);
    size_t lpos = 0;
    for (size_t i = 0; i < nseq; ++i) {
        uint32_t ofc = of.symbol(), mlc = ml.symbol(), llc = ll.symbol();
        need(ofc <= 31 && mlc <= 52 && llc <= 35);
        uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
        uint64_t mlen = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
        uint64_t llen = LL_BASE[llc] + br.read(LL_BITS[llc]);
        uint64_t offset;
        if (ofv > 3) {
            offset = ofv - 3;
            f.rep[2] = f.rep[1]; f.rep[1] = f.rep[0]; f.rep[0] = uint32_t(offset);
        } else {
            int idx = int(ofv) - 1 + (llen == 0 ? 1 : 0);
            if (idx == 0) {
                offset = f.rep[0];
            } else {
                offset = idx == 3 ? uint64_t(f.rep[0]) - 1 : f.rep[idx];
                need(offset > 0);
                if (idx != 1) f.rep[2] = f.rep[1];
                f.rep[1] = f.rep[0];
                f.rep[0] = uint32_t(offset);
            }
        }
        if (i + 1 < nseq) {
            ll.update(br);
            ml.update(br);
            of.update(br);
        }
        need(!br.overflow());
        need(lpos + llen <= regen);
        out.insert(out.end(), lit.begin() + lpos, lit.begin() + lpos + llen);
        lpos += llen;
        size_t o = out.size();
        need(offset <= o - start);
        out.resize(o + mlen);
        uint8_t* d = out.data() + o;
        if (offset >= mlen) std::memcpy(d, d - offset, mlen);
        else for (uint64_t k = 0; k < mlen; ++k) d[k] = d[k - offset];
    }
    need(br.done());
    out.insert(out.end(), lit.begin() + lpos, lit.end());
}

// One frame at src; appends its content to out, returns the bytes read.
size_t frame(const uint8_t* src, size_t len, std::vector<uint8_t>& out) {
    need(len >= 4, E_TRUNCATED);
    uint32_t magic = rd32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        need(len >= 8, E_TRUNCATED);
        size_t size = rd32(src + 4);
        need(8 + size <= len, E_TRUNCATED);
        return 8 + size;
    }
    need(magic == 0xFD2FB528u, E_MAGIC);
    need(len >= 5, E_TRUNCATED);
    int fhd = src[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    need((fhd & 8) == 0, E_RESERVED);
    size_t pos = 5;
    uint64_t window = 0;
    if (!single) {
        need(len > pos, E_TRUNCATED);
        int wd = src[pos++];
        int exponent = wd >> 3, mantissa = wd & 7;
        uint64_t base = uint64_t(1) << (10 + exponent);
        window = base + (base / 8) * mantissa;
    }
    static const int DICT_SIZE[4] = {0, 1, 2, 4};
    need(len >= pos + DICT_SIZE[dict_flag], E_TRUNCATED);
    uint32_t dict = 0;
    for (int i = 0; i < DICT_SIZE[dict_flag]; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
    pos += DICT_SIZE[dict_flag];
    need(dict == 0, E_DICTIONARY);
    int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
    need(len >= pos + fcs_size, E_TRUNCATED);
    uint64_t content = 0;
    bool known = fcs_size > 0;
    for (int i = 0; i < fcs_size; ++i) content |= uint64_t(src[pos + i]) << (8 * i);
    if (fcs_size == 2) content += 256;
    pos += fcs_size;
    if (single) window = content;
    size_t block_max = window < (128u << 10) ? size_t(window) : (128u << 10);
    if (block_max == 0) block_max = 1;  // an empty single-segment frame
    size_t start = out.size();
    if (known) {
        need(content < (uint64_t(1) << 40), E_SIZE);
        out.reserve(start + content);
    }
    Frame f;
    for (;;) {
        need(len >= pos + 3, E_TRUNCATED);
        uint32_t bh = rd24(src + pos);
        pos += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        need(type != 3, E_RESERVED);
        if (type == 1) {
            need(len >= pos + 1, E_TRUNCATED);
            need(size <= block_max);
            out.insert(out.end(), size, src[pos]);
            pos += 1;
        } else {
            need(len >= pos + size, E_TRUNCATED);
            need(size <= block_max);
            if (type == 0) out.insert(out.end(), src + pos, src + pos + size);
            else compressed_block(f, src + pos, size, out, start, block_max);
            pos += size;
        }
        if (last) break;
    }
    if (known) need(out.size() - start == content, E_SIZE);
    if (checksum) {
        need(len >= pos + 4, E_TRUNCATED);
        uint32_t want = rd32(src + pos);
        pos += 4;
        uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start));
        need(got == want, E_CHECKSUM);
    }
    return pos;
}

// The slicing-by-8 tables of CRC-32C, built once by a thread-safe
// function-local static.
struct CrcTable {
    uint32_t t[8][256];
    CrcTable() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
            t[0][i] = c;
        }
        for (int s = 1; s < 8; ++s)
            for (int i = 0; i < 256; ++i)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

const CrcTable& crc_table() {
    static const CrcTable table;
    return table;
}

}  // namespace

extern "C" {

// Decode every frame of src; on success *out holds the content (free it
// with zs_free) and the return value is 0, else a negative error code.
int zs_decompress(const uint8_t* src, size_t len, uint8_t** out, size_t* out_len) {
    *out = nullptr;
    *out_len = 0;
    try {
        std::vector<uint8_t> buf;
        size_t pos = 0;
        need(len > 0, E_TRUNCATED);
        while (pos < len) pos += frame(src + pos, len - pos, buf);
        uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
        if (!mem) return E_ALLOC;
        if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
        *out = mem;
        *out_len = buf.size();
        return OK;
    } catch (const Fail& e) {
        return e.code;
    } catch (const std::bad_alloc&) {
        return E_ALLOC;
    } catch (const std::length_error&) {
        return E_SIZE;
    }
}

const char* zs_error(int code) {
    switch (code) {
    case OK: return "ok";
    case E_TRUNCATED: return "truncated input";
    case E_MAGIC: return "not a zstd frame (bad magic number)";
    case E_RESERVED: return "a reserved field is set";
    case E_DICTIONARY: return "the frame needs a dictionary";
    case E_CORRUPT: return "corrupt data";
    case E_CHECKSUM: return "content checksum mismatch";
    case E_SIZE: return "content size mismatch";
    case E_ALLOC: return "out of memory";
    default: return "unknown error";
    }
}

uint32_t zs_crc32c(const uint8_t* p, size_t n) {
    const auto& T = crc_table().t;
    uint32_t c = 0xFFFFFFFFu;
    while (n >= 8) {
        uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
        c = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^
            T[5][(lo >> 16) & 0xFF] ^ T[4][lo >> 24] ^
            T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF] ^
            T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) c = T[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

void zs_free(void* p) { std::free(p); }

}  // extern "C"
