// Native GeoTIFF codec for xdem_tpu.
//
// The reference delegates raster I/O to GDAL through rasterio/geoutils; this standalone
// implementation covers the DEM-relevant GeoTIFF subset:
//   * Read: classic TIFF (little/big endian), striped or tiled layout, compression none (1),
//     LZW (5), DEFLATE (8/32946) and PackBits (32773), sample formats
//     u8/u16/u32/i16/i32/f32/f64, single-band or first band of contiguous multi-band,
//     horizontal differencing (2) and floating-point (3) predictors.
//   * Write: single-band float32, DEFLATE strips, floating-point predictor (default; or
//     none), with ModelPixelScale, ModelTiepoint, GeoKeyDirectory (EPSG), and GDAL_NODATA.
//
// Exposed as a small C ABI consumed from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Ifd_entry {
    uint16_t tag;
    uint16_t type;
    uint64_t count;
    std::vector<uint8_t> data;  // resolved payload bytes
};

struct Tiff {
    std::vector<uint8_t> buf;
    bool big_endian = false;
    bool bigtiff = false;  // BigTIFF (magic 43): 8-byte offsets, 20-byte IFD entries

    uint16_t u16(size_t off) const {
        const uint8_t* p = buf.data() + off;
        return big_endian ? (uint16_t)((p[0] << 8) | p[1]) : (uint16_t)(p[0] | (p[1] << 8));
    }
    uint32_t u32(size_t off) const {
        const uint8_t* p = buf.data() + off;
        return big_endian ? ((uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3])
                          : ((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
    }
    uint64_t u64(size_t off) const {
        return big_endian ? ((uint64_t)u32(off) << 32) | u32(off + 4)
                          : ((uint64_t)u32(off + 4) << 32) | u32(off);
    }
    double f64(size_t off) const {
        uint8_t tmp[8];
        memcpy(tmp, buf.data() + off, 8);
        if (big_endian) {
            for (int i = 0; i < 4; i++) std::swap(tmp[i], tmp[7 - i]);
        }
        double v;
        memcpy(&v, tmp, 8);
        return v;
    }
};

size_t type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;  // BYTE/ASCII/SBYTE/UNDEF
        case 3: case 8: return 2;                  // SHORT/SSHORT
        case 4: case 9: case 11: case 13: return 4;  // LONG/SLONG/FLOAT/IFD
        case 5: case 10: case 12: return 8;        // RATIONAL/SRATIONAL/DOUBLE
        case 16: case 17: case 18: return 8;       // LONG8/SLONG8/IFD8 (BigTIFF)
        default: return 1;
    }
}

struct GtError {
    std::string msg;
};

static thread_local std::string g_last_error;

bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize((size_t)sz);
    size_t got = fread(out.data(), 1, (size_t)sz, f);
    fclose(f);
    return got == (size_t)sz;
}

// Validate the TIFF/BigTIFF header; sets t.big_endian/t.bigtiff and returns the first IFD
// offset, or 0 (never a valid IFD position) with g_last_error set.
uint64_t open_tiff(Tiff& t);

// Resolve IFD entries into a tag -> entry map with payloads loaded (classic and BigTIFF).
bool parse_ifd(const Tiff& t, uint64_t ifd_off, std::vector<Ifd_entry>& entries) {
    const size_t entry_size = t.bigtiff ? 20 : 12;
    uint64_t n;
    size_t base;
    if (t.bigtiff) {
        if (ifd_off + 8 > t.buf.size()) return false;
        n = t.u64((size_t)ifd_off);
        base = (size_t)ifd_off + 8;
    } else {
        if (ifd_off + 2 > t.buf.size()) return false;
        n = t.u16((size_t)ifd_off);
        base = (size_t)ifd_off + 2;
    }
    entries.clear();
    for (uint64_t i = 0; i < n; i++) {
        size_t e = base + entry_size * (size_t)i;
        if (e + entry_size > t.buf.size()) return false;
        Ifd_entry ent;
        ent.tag = t.u16(e);
        ent.type = t.u16(e + 2);
        ent.count = t.bigtiff ? t.u64(e + 4) : t.u32(e + 4);
        // Overflow-safe sizing: counts/offsets are attacker-controlled 64-bit values in
        // BigTIFF; reject anything that could not fit in the file instead of wrapping.
        if (ent.count > t.buf.size() / type_size(ent.type)) return false;
        size_t nbytes = type_size(ent.type) * (size_t)ent.count;
        const size_t inline_cap = t.bigtiff ? 8 : 4;
        const size_t voff_pos = t.bigtiff ? e + 12 : e + 8;
        size_t payload_off = (nbytes <= inline_cap)
                                 ? voff_pos
                                 : (size_t)(t.bigtiff ? t.u64(voff_pos) : t.u32(voff_pos));
        if (payload_off > t.buf.size() || nbytes > t.buf.size() - payload_off) return false;
        ent.data.assign(t.buf.begin() + payload_off, t.buf.begin() + payload_off + nbytes);
        entries.push_back(std::move(ent));
    }
    return true;
}

uint64_t open_tiff(Tiff& t) {
    if (t.buf.size() < 8) {
        g_last_error = "not a TIFF file";
        return 0;
    }
    if (t.buf[0] == 'I' && t.buf[1] == 'I')
        t.big_endian = false;
    else if (t.buf[0] == 'M' && t.buf[1] == 'M')
        t.big_endian = true;
    else {
        g_last_error = "not a TIFF file";
        return 0;
    }
    uint16_t magic = t.u16(2);
    if (magic == 42) {
        t.bigtiff = false;
        return t.u32(4);
    }
    if (magic == 43) {
        if (t.buf.size() < 16 || t.u16(4) != 8 || t.u16(6) != 0) {
            g_last_error = "unsupported BigTIFF header layout";
            return 0;
        }
        t.bigtiff = true;
        return t.u64(8);
    }
    g_last_error = "not a TIFF file";
    return 0;
}

const Ifd_entry* find_tag(const std::vector<Ifd_entry>& entries, uint16_t tag) {
    for (const auto& e : entries)
        if (e.tag == tag) return &e;
    return nullptr;
}

// Read the i-th integer value of an entry (SHORT, LONG, or BigTIFF LONG8), honoring endianness.
uint64_t entry_uint(const Tiff& t, const Ifd_entry& e, size_t i) {
    if (e.type == 3) {  // SHORT
        const uint8_t* p = e.data.data() + 2 * i;
        return t.big_endian ? (uint64_t)((p[0] << 8) | p[1]) : (uint64_t)(p[0] | (p[1] << 8));
    }
    auto rd32 = [&](const uint8_t* p) -> uint32_t {
        return t.big_endian
                   ? ((uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3])
                   : ((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24);
    };
    if (e.type == 16 || e.type == 17 || e.type == 18) {  // LONG8/SLONG8/IFD8
        const uint8_t* p = e.data.data() + 8 * i;
        return t.big_endian ? ((uint64_t)rd32(p) << 32) | rd32(p + 4)
                            : ((uint64_t)rd32(p + 4) << 32) | rd32(p);
    }
    return rd32(e.data.data() + 4 * i);  // LONG
}

double entry_double(const Tiff& t, const Ifd_entry& e, size_t i) {
    uint8_t tmp[8];
    memcpy(tmp, e.data.data() + 8 * i, 8);
    if (t.big_endian)
        for (int k = 0; k < 4; k++) std::swap(tmp[k], tmp[7 - k]);
    double v;
    memcpy(&v, tmp, 8);
    return v;
}

bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_len;
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return ret == Z_STREAM_END || (ret == Z_OK && zs.avail_out == 0) || ret == Z_BUF_ERROR;
}

bool packbits_decode(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
    size_t si = 0, di = 0;
    while (si < src_len && di < dst_len) {
        int8_t n = (int8_t)src[si++];
        if (n >= 0) {
            size_t cnt = (size_t)n + 1;
            if (si + cnt > src_len || di + cnt > dst_len) return false;
            memcpy(dst + di, src + si, cnt);
            si += cnt;
            di += cnt;
        } else if (n != -128) {
            size_t cnt = (size_t)(-n) + 1;
            if (si >= src_len || di + cnt > dst_len) return false;
            memset(dst + di, src[si++], cnt);
            di += cnt;
        }
    }
    return di == dst_len;
}

// TIFF LZW (compression 5): MSB-first variable-width codes starting at 9 bits,
// ClearCode=256, EOI=257, dictionary entries from 258, with the TIFF "early change"
// (the code width grows one code earlier than plain LZW). Decoder per TIFF 6.0 §13.
bool lzw_decode(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
    constexpr uint32_t kClear = 256, kEoi = 257;
    // Dictionary as (prefix, suffix) pairs; entry i<256 is the literal byte i.
    std::vector<int32_t> prefix(4096, -1);
    std::vector<uint8_t> suffix(4096);
    for (uint32_t i = 0; i < 256; i++) suffix[i] = (uint8_t)i;
    uint32_t next_code = 258, code_bits = 9;
    uint64_t bitbuf = 0;
    uint32_t bitcnt = 0;
    size_t si = 0, di = 0;
    int32_t old_code = -1;
    std::vector<uint8_t> stack;
    stack.reserve(4096);

    auto reset = [&]() {
        next_code = 258;
        code_bits = 9;
        old_code = -1;
    };

    while (true) {
        while (bitcnt < code_bits) {
            if (si >= src_len) return di == dst_len;  // stream may omit a trailing EOI
            bitbuf = (bitbuf << 8) | src[si++];
            bitcnt += 8;
        }
        uint32_t code = (uint32_t)((bitbuf >> (bitcnt - code_bits)) & ((1u << code_bits) - 1));
        bitcnt -= code_bits;

        if (code == kEoi) return di == dst_len;
        if (code == kClear) {
            reset();
            continue;
        }
        if (old_code < 0) {
            if (code > 255) return false;  // first code after clear must be a literal
            if (di >= dst_len) return false;
            dst[di++] = (uint8_t)code;
            old_code = (int32_t)code;
        } else {
            uint32_t in_code = code;
            stack.clear();
            if (code >= next_code) {
                if (code != next_code) return false;  // only the KwKwK case is legal
                // Emit old string + its first byte: resolve after walking old_code.
                code = (uint32_t)old_code;
                stack.push_back(0);  // placeholder for the repeated first byte
            }
            while (code > 255) {
                if (code >= 4096) return false;
                stack.push_back(suffix[code]);
                code = (uint32_t)prefix[code];
            }
            uint8_t first = (uint8_t)code;
            if (in_code >= (uint32_t)next_code) stack[0] = first;  // fill the KwKwK placeholder
            if (di + stack.size() + 1 > dst_len) return false;
            dst[di++] = first;
            for (size_t k = stack.size(); k-- > 0;) dst[di++] = stack[k];
            if (next_code < 4096) {
                prefix[next_code] = old_code;
                suffix[next_code] = first;
                next_code++;
            }
            old_code = (int32_t)in_code;
        }
        // TIFF early change (libtiff convention, validated against libtiff/Pillow streams):
        // widen the read width once the decoder's next free entry reaches 511/1023/2047.
        if (next_code >= (1u << code_bits) - 1 && code_bits < 12) code_bits++;
        if (di == dst_len) return true;
    }
}

// Convert raw sample bytes to float32 (handles endianness + sample format).
void samples_to_float(const uint8_t* src, size_t n, uint16_t bits, uint16_t fmt, bool be, float* dst) {
    auto swap16 = [](uint16_t v) { return (uint16_t)((v << 8) | (v >> 8)); };
    auto swap32 = [](uint32_t v) {
        return (v << 24) | ((v << 8) & 0x00ff0000u) | ((v >> 8) & 0x0000ff00u) | (v >> 24);
    };
    for (size_t i = 0; i < n; i++) {
        if (bits == 8) {
            dst[i] = (fmt == 2) ? (float)(int8_t)src[i] : (float)src[i];
        } else if (bits == 16) {
            uint16_t v;
            memcpy(&v, src + 2 * i, 2);
            if (be) v = swap16(v);
            dst[i] = (fmt == 2) ? (float)(int16_t)v : (float)v;
        } else if (bits == 32) {
            uint32_t v;
            memcpy(&v, src + 4 * i, 4);
            if (be) v = swap32(v);
            if (fmt == 3) {
                float f;
                memcpy(&f, &v, 4);
                dst[i] = f;
            } else if (fmt == 2) {
                dst[i] = (float)(int32_t)v;
            } else {
                dst[i] = (float)v;
            }
        } else if (bits == 64 && fmt == 3) {
            uint8_t tmp[8];
            memcpy(tmp, src + 8 * i, 8);
            if (be)
                for (int k = 0; k < 4; k++) std::swap(tmp[k], tmp[7 - k]);
            double d;
            memcpy(&d, tmp, 8);
            dst[i] = (float)d;
        } else {
            dst[i] = 0.0f;
        }
    }
}

// Horizontal differencing predictor (predictor == 2), applied per row in-place on floats'
// integer source — we apply it on the decoded integer buffer before conversion; for
// simplicity we support it for 8/16/32-bit integer samples only.
void undo_predictor(uint8_t* data, size_t rows, size_t cols, uint16_t bits, bool be) {
    if (bits == 8) {
        for (size_t r = 0; r < rows; r++) {
            uint8_t* p = data + r * cols;
            for (size_t c = 1; c < cols; c++) p[c] = (uint8_t)(p[c] + p[c - 1]);
        }
    } else if (bits == 16) {
        for (size_t r = 0; r < rows; r++) {
            uint8_t* p = data + r * cols * 2;
            uint16_t prev;
            memcpy(&prev, p, 2);
            for (size_t c = 1; c < cols; c++) {
                uint16_t v;
                memcpy(&v, p + 2 * c, 2);
                if (be) v = (uint16_t)((v << 8) | (v >> 8));
                uint16_t pv = be ? (uint16_t)((prev << 8) | (prev >> 8)) : prev;
                uint16_t nv = (uint16_t)(v + pv);
                uint16_t store = be ? (uint16_t)((nv << 8) | (nv >> 8)) : nv;
                memcpy(p + 2 * c, &store, 2);
                prev = store;
            }
        }
    } else if (bits == 32) {
        for (size_t r = 0; r < rows; r++) {
            uint8_t* p = data + r * cols * 4;
            for (size_t c = 1; c < cols; c++) {
                uint32_t a, b;
                memcpy(&a, p + 4 * (c - 1), 4);
                memcpy(&b, p + 4 * c, 4);
                uint32_t nv = a + b;  // little-endian assumption for predictor on ints
                memcpy(p + 4 * c, &nv, 4);
            }
        }
    }
}

// Floating-point predictor (predictor == 3, TIFF technical note 3 / libtiff fpAcc):
// each row is stored as byte planes (MSB plane first) after byte-wise horizontal
// differencing with stride = samples-per-pixel. Undo: cumulative byte sum across the
// row, then gather planes back into native little-endian sample order.
void undo_fp_predictor(uint8_t* data, size_t rows, size_t cols, size_t bytes_per_sample,
                       size_t stride, std::vector<uint8_t>& scratch) {
    const size_t row_bytes = cols * bytes_per_sample;
    scratch.resize(row_bytes);
    for (size_t r = 0; r < rows; r++) {
        uint8_t* p = data + r * row_bytes;
        for (size_t i = stride; i < row_bytes; i++) p[i] = (uint8_t)(p[i] + p[i - stride]);
        memcpy(scratch.data(), p, row_bytes);
        for (size_t i = 0; i < cols; i++)
            for (size_t b = 0; b < bytes_per_sample; b++)
                p[i * bytes_per_sample + b] = scratch[(bytes_per_sample - 1 - b) * cols + i];
    }
}

}  // namespace

extern "C" {

struct GtInfo {
    uint32_t width;
    uint32_t height;
    uint32_t bands;
    double transform[6];  // a, b, c, d, e, f: x = a*col + b*row + c ; y = d*col + e*row + f
    int32_t epsg;         // 0 when absent
    double nodata;        // NaN when absent
    int32_t has_nodata;
    int32_t raster_type;  // GTRasterType geokey 1025: 1=PixelIsArea, 2=PixelIsPoint, 0 absent
};

const char* gt_last_error() { return g_last_error.c_str(); }

// GDAL metadata XML (tag 42112), empty string when absent; static buffer like gt_last_error.
static std::string g_metadata;
const char* gt_metadata(const char* path);

// Parse header + georeferencing only; returns 0 on success.
int gt_info(const char* path, GtInfo* info) {
    Tiff t;
    if (!read_file(path, t.buf) || t.buf.size() < 8) {
        g_last_error = "cannot read file";
        return 1;
    }
    uint64_t ifd0 = open_tiff(t);
    if (!ifd0) return 1;
    std::vector<Ifd_entry> e;
    if (!parse_ifd(t, ifd0, e)) {
        g_last_error = "corrupt IFD";
        return 1;
    }

    const Ifd_entry* w = find_tag(e, 256);
    const Ifd_entry* h = find_tag(e, 257);
    if (!w || !h) {
        g_last_error = "missing dimensions";
        return 1;
    }
    info->width = entry_uint(t, *w, 0);
    info->height = entry_uint(t, *h, 0);
    const Ifd_entry* spp = find_tag(e, 277);
    info->bands = spp ? entry_uint(t, *spp, 0) : 1;

    // Georeferencing: ModelPixelScale + ModelTiepoint, or full ModelTransformation
    for (int i = 0; i < 6; i++) info->transform[i] = 0;
    info->transform[0] = 1;
    info->transform[4] = -1;
    const Ifd_entry* mt = find_tag(e, 34264);
    const Ifd_entry* ps = find_tag(e, 33550);
    const Ifd_entry* tp = find_tag(e, 33922);
    if (mt && mt->count >= 16) {
        info->transform[0] = entry_double(t, *mt, 0);
        info->transform[1] = entry_double(t, *mt, 1);
        info->transform[2] = entry_double(t, *mt, 3);
        info->transform[3] = entry_double(t, *mt, 4);
        info->transform[4] = entry_double(t, *mt, 5);
        info->transform[5] = entry_double(t, *mt, 7);
    } else if (ps && tp && ps->count >= 3 && tp->count >= 6) {
        double sx = entry_double(t, *ps, 0);
        double sy = entry_double(t, *ps, 1);
        double px = entry_double(t, *tp, 0), py = entry_double(t, *tp, 1);
        double gx = entry_double(t, *tp, 3), gy = entry_double(t, *tp, 4);
        info->transform[0] = sx;
        info->transform[1] = 0;
        info->transform[2] = gx - px * sx;
        info->transform[3] = 0;
        info->transform[4] = -sy;
        info->transform[5] = gy + py * sy;
    }

    // EPSG from GeoKeyDirectory: ProjectedCSTypeGeoKey (3072) or GeographicTypeGeoKey (2048).
    // When ANY 3072 key exists the file is projected: a user-defined (32767) PCS must yield
    // epsg=0 even if a 2048 key names the geographic DATUM — the datum code is not the CRS
    // (it used to leak through as the raster CRS, silently mis-georeferencing custom files).
    info->epsg = 0;
    info->raster_type = 0;
    const Ifd_entry* gk = find_tag(e, 34735);
    if (gk && gk->count >= 4) {
        uint32_t nkeys = entry_uint(t, *gk, 3);
        int32_t geog_code = 0, proj_code = -1;  // -1: no 3072 key present
        for (uint32_t k = 1; k <= nkeys && 4 * (k + 1) <= gk->count; k++) {
            uint32_t key = entry_uint(t, *gk, 4 * k);
            uint32_t loc = entry_uint(t, *gk, 4 * k + 1);
            uint32_t val = entry_uint(t, *gk, 4 * k + 3);
            if (key == 1025 && loc == 0) info->raster_type = (int32_t)val;
            if (key == 2048 && loc == 0) geog_code = (val != 32767) ? (int32_t)val : 0;
            if (key == 3072 && loc == 0) proj_code = (val != 32767) ? (int32_t)val : 0;
        }
        info->epsg = (proj_code >= 0) ? proj_code : geog_code;
    }

    // GDAL nodata (ASCII tag 42113)
    info->has_nodata = 0;
    info->nodata = 0;
    const Ifd_entry* nd = find_tag(e, 42113);
    if (nd && !nd->data.empty()) {
        std::string s(reinterpret_cast<const char*>(nd->data.data()), nd->data.size());
        info->nodata = atof(s.c_str());
        info->has_nodata = 1;
    }
    return 0;
}

// Read band 1 as float32 into out (size height*width); returns 0 on success.
int gt_read(const char* path, float* out) {
    Tiff t;
    if (!read_file(path, t.buf)) {
        g_last_error = "cannot read file";
        return 1;
    }
    uint64_t ifd0 = open_tiff(t);
    if (!ifd0) return 1;
    std::vector<Ifd_entry> e;
    if (!parse_ifd(t, ifd0, e)) {
        g_last_error = "corrupt IFD";
        return 1;
    }
    uint32_t width = entry_uint(t, *find_tag(e, 256), 0);
    uint32_t height = entry_uint(t, *find_tag(e, 257), 0);
    const Ifd_entry* bps_e = find_tag(e, 258);
    uint16_t bits = bps_e ? (uint16_t)entry_uint(t, *bps_e, 0) : 1;
    const Ifd_entry* comp_e = find_tag(e, 259);
    uint16_t comp = comp_e ? (uint16_t)entry_uint(t, *comp_e, 0) : 1;
    const Ifd_entry* spp_e = find_tag(e, 277);
    uint16_t spp = spp_e ? (uint16_t)entry_uint(t, *spp_e, 0) : 1;
    const Ifd_entry* fmt_e = find_tag(e, 339);
    uint16_t fmt = fmt_e ? (uint16_t)entry_uint(t, *fmt_e, 0) : 1;
    const Ifd_entry* pred_e = find_tag(e, 317);
    uint16_t predictor = pred_e ? (uint16_t)entry_uint(t, *pred_e, 0) : 1;
    const Ifd_entry* planar_e = find_tag(e, 284);
    uint16_t planar = planar_e ? (uint16_t)entry_uint(t, *planar_e, 0) : 1;

    if (comp != 1 && comp != 5 && comp != 8 && comp != 32946 && comp != 32773) {
        g_last_error = "unsupported compression " + std::to_string(comp) +
                       " (supported: none, LZW, DEFLATE, PackBits)";
        return 2;
    }
    size_t bytes_per_sample = bits / 8;
    size_t samples_per_px = (planar == 1) ? spp : 1;
    std::vector<uint8_t> fp_scratch;

    auto decode_block = [&](const uint8_t* src, size_t src_len, std::vector<uint8_t>& dst,
                            size_t expect) -> bool {
        dst.resize(expect);
        if (comp == 1) {
            if (src_len < expect) expect = src_len;
            memcpy(dst.data(), src, expect);
            return true;
        }
        if (comp == 32773) return packbits_decode(src, src_len, dst.data(), expect);
        if (comp == 5) return lzw_decode(src, src_len, dst.data(), expect);
        return inflate_block(src, src_len, dst.data(), expect);
    };

    const Ifd_entry* tile_w_e = find_tag(e, 322);
    if (tile_w_e) {
        // Tiled layout
        uint32_t tw = entry_uint(t, *tile_w_e, 0);
        uint32_t th = entry_uint(t, *find_tag(e, 323), 0);
        const Ifd_entry* offs = find_tag(e, 324);
        const Ifd_entry* cnts = find_tag(e, 325);
        uint32_t tiles_x = (width + tw - 1) / tw;
        uint32_t tiles_y = (height + th - 1) / th;
        std::vector<uint8_t> block;
        std::vector<float> fbuf((size_t)tw * th * samples_per_px);
        for (uint32_t ty = 0; ty < tiles_y; ty++) {
            for (uint32_t tx = 0; tx < tiles_x; tx++) {
                uint32_t ti = ty * tiles_x + tx;
                size_t off = entry_uint(t, *offs, ti);
                size_t len = entry_uint(t, *cnts, ti);
                if (off > t.buf.size() || len > t.buf.size() - off) {
                    g_last_error = "tile data out of bounds";
                    return 3;
                }
                size_t expect = (size_t)tw * th * samples_per_px * bytes_per_sample;
                if (!decode_block(t.buf.data() + off, len, block, expect)) {
                    g_last_error = "tile decode failed";
                    return 3;
                }
                if (predictor == 2 && fmt != 3)
                    undo_predictor(block.data(), th, (size_t)tw * samples_per_px, bits, t.big_endian);
                else if (predictor == 3)
                    undo_fp_predictor(block.data(), th, (size_t)tw * samples_per_px,
                                      bytes_per_sample, samples_per_px, fp_scratch);
                // predictor 3 reassembles bytes into NATIVE order regardless of file endianness
                samples_to_float(block.data(), (size_t)tw * th * samples_per_px, bits, fmt,
                                 predictor == 3 ? false : t.big_endian, fbuf.data());
                for (uint32_t r = 0; r < th; r++) {
                    uint32_t gr = ty * th + r;
                    if (gr >= height) break;
                    for (uint32_t c = 0; c < tw; c++) {
                        uint32_t gc = tx * tw + c;
                        if (gc >= width) break;
                        out[(size_t)gr * width + gc] = fbuf[((size_t)r * tw + c) * samples_per_px];
                    }
                }
            }
        }
        return 0;
    }

    // Striped layout
    const Ifd_entry* rps_e = find_tag(e, 278);
    uint32_t rps = rps_e ? entry_uint(t, *rps_e, 0) : height;
    const Ifd_entry* offs = find_tag(e, 273);
    const Ifd_entry* cnts = find_tag(e, 279);
    if (!offs || !cnts) {
        g_last_error = "missing strip offsets";
        return 1;
    }
    uint32_t n_strips = (height + rps - 1) / rps;
    std::vector<uint8_t> block;
    for (uint32_t s = 0; s < n_strips; s++) {
        uint32_t rows = (s == n_strips - 1) ? height - s * rps : rps;
        size_t off = entry_uint(t, *offs, s);
        size_t len = entry_uint(t, *cnts, s);
        if (off > t.buf.size() || len > t.buf.size() - off) {
            g_last_error = "strip data out of bounds";
            return 3;
        }
        size_t expect = (size_t)rows * width * samples_per_px * bytes_per_sample;
        if (!decode_block(t.buf.data() + off, len, block, expect)) {
            g_last_error = "strip decode failed";
            return 3;
        }
        if (predictor == 2 && fmt != 3)
            undo_predictor(block.data(), rows, (size_t)width * samples_per_px, bits, t.big_endian);
        else if (predictor == 3)
            undo_fp_predictor(block.data(), rows, (size_t)width * samples_per_px,
                              bytes_per_sample, samples_per_px, fp_scratch);
        std::vector<float> fbuf((size_t)rows * width * samples_per_px);
        samples_to_float(block.data(), fbuf.size(), bits, fmt,
                         predictor == 3 ? false : t.big_endian, fbuf.data());
        for (uint32_t r = 0; r < rows; r++)
            for (uint32_t c = 0; c < width; c++)
                out[((size_t)(s * rps + r)) * width + c] = fbuf[((size_t)r * width + c) * samples_per_px];
    }
    return 0;
}

// Write a single-band float32 GeoTIFF with DEFLATE strips; returns 0 on success.
// predictor 3 (TIFF floating-point predictor) typically shrinks DEM rasters 2-3x vs
// plain DEFLATE by making the byte planes of neighboring samples nearly equal.
// geokeys_extra: optional "s<key>=<int>;d<key>=<v[,v...]>;" entries (ascending key ids)
// describing a user-defined CRS as parameter GeoKeys (ProjCoordTransGeoKey 3075 + double
// params in GeoDoubleParams). When non-empty it must INCLUDE the CS key (2048 or 3072) —
// the writer then emits no CS key of its own.
int gt_write(const char* path, const float* data, uint32_t height, uint32_t width,
             const double* transform, int32_t epsg, double nodata, int32_t has_nodata,
             const char* metadata, int32_t predictor, const char* citation,
             int32_t pixel_is_point, const char* geokeys_extra) {
    if (predictor != 1 && predictor != 3) {
        g_last_error = "writer supports predictor 1 (none) or 3 (floating-point)";
        return 1;
    }
    // Compress each strip (64 rows) with zlib
    const uint32_t rps = 64;
    uint32_t n_strips = (height + rps - 1) / rps;
    std::vector<std::vector<uint8_t>> strips(n_strips);
    std::vector<uint8_t> pre;  // predictor-transformed strip buffer
    for (uint32_t s = 0; s < n_strips; s++) {
        uint32_t rows = (s == n_strips - 1) ? height - s * rps : rps;
        size_t strip_bytes = (size_t)rows * width * 4;
        const Bytef* src = reinterpret_cast<const Bytef*>(data + (size_t)s * rps * width);
        if (predictor == 3) {
            // Forward transform (inverse of undo_fp_predictor): per row, gather into byte
            // planes most-significant-first, then byte-wise horizontal differencing.
            pre.resize(strip_bytes);
            for (uint32_t r = 0; r < rows; r++) {
                const uint8_t* in = src + (size_t)r * width * 4;
                uint8_t* outp = pre.data() + (size_t)r * width * 4;
                for (size_t i = 0; i < width; i++)
                    for (size_t j = 0; j < 4; j++)
                        outp[j * width + i] = in[i * 4 + (3 - j)];
                for (size_t k = (size_t)width * 4; k-- > 1;)
                    outp[k] = (uint8_t)(outp[k] - outp[k - 1]);
            }
            src = pre.data();
        }
        uLongf bound = compressBound((uLong)strip_bytes);
        strips[s].resize(bound);
        uLongf out_len = bound;
        if (compress2(strips[s].data(), &out_len, src, (uLong)strip_bytes, 6) != Z_OK) {
            g_last_error = "deflate failed";
            return 1;
        }
        strips[s].resize(out_len);
    }

    // Assemble: header, IFD, payloads
    struct TagW {
        uint16_t tag, type;
        uint32_t count, value;
    };
    std::string nodata_str;
    if (has_nodata) {
        char tmp[64];
        snprintf(tmp, sizeof(tmp), "%g", nodata);
        nodata_str = tmp;
        nodata_str.push_back('\0');
    }

    // GeoKeys: ModelType (1024), RasterType (1025: 1=PixelIsArea), CS key; when no EPSG
    // code exists the CRS is carried as citation WKT (user-defined 32767 + GTCitation in
    // GeoAsciiParams), the GDAL-readable convention for non-EPSG CRSs.
    std::string cit = (citation && citation[0]) ? std::string(citation) : std::string();
    bool geographic = epsg
        ? (epsg == 4326 || epsg == 4269 || epsg == 4258 || epsg == 4267)
        : (cit.rfind("GEOGCS", 0) == 0 || cit.rfind("GEOGCRS", 0) == 0);
    // Parse the extra parameter GeoKeys ("s<key>=<int>;" shorts, "d<key>=<v,..>;" doubles
    // appended to GeoDoubleParams). Python supplies them sorted ascending, CS key included.
    struct ExtraKey { uint16_t key, loc, count, value; };
    std::vector<ExtraKey> extras;
    std::vector<double> double_params;
    if (geokeys_extra && geokeys_extra[0]) {
        const char* s = geokeys_extra;
        while (*s) {
            char kind = *s++;
            char* end = nullptr;
            long key = strtol(s, &end, 10);
            if (!end || *end != '=' || (kind != 's' && kind != 'd')) {
                g_last_error = "malformed geokeys_extra";
                return 1;
            }
            s = end + 1;
            if (kind == 's') {
                long v = strtol(s, &end, 10);
                extras.push_back({(uint16_t)key, 0, 1, (uint16_t)v});
                s = end;
            } else {
                uint16_t off = (uint16_t)double_params.size(), cnt = 0;
                for (;;) {
                    double_params.push_back(strtod(s, &end));
                    cnt++;
                    s = end;
                    if (*s == ',') s++;
                    else break;
                }
                extras.push_back({(uint16_t)key, 34736, cnt, off});
            }
            if (*s == ';') s++;
        }
    }
    std::string ascii_params;
    // Assemble all entries, then sort by key id (GeoTIFF requires ascending ids). Extras
    // override the writer's own defaults for any key they carry (e.g. 1024 model type).
    std::vector<ExtraKey> entries;
    auto extras_contain = [&](uint16_t key) {
        for (const ExtraKey& ek : extras)
            if (ek.key == key) return true;
        return false;
    };
    if (!extras_contain(1024))
        entries.push_back({1024, 0, 1, (uint16_t)(geographic ? 2 : 1)});
    if (!extras_contain(1025))
        entries.push_back({1025, 0, 1, (uint16_t)(pixel_is_point ? 2 : 1)});
    if (!cit.empty()) {
        if (cit.size() > 65000) cit.resize(65000);  // geokey count is a SHORT
        ascii_params = cit + "|";
        entries.push_back({1026, 34737, (uint16_t)ascii_params.size(), 0});
        ascii_params.push_back('\0');
    }
    if (!extras.empty()) {
        entries.insert(entries.end(), extras.begin(), extras.end());
    } else {
        entries.push_back({(uint16_t)(geographic ? 2048 : 3072), 0, 1,
                           (uint16_t)(epsg ? epsg : 32767)});
    }
    std::sort(entries.begin(), entries.end(),
              [](const ExtraKey& a, const ExtraKey& b) { return a.key < b.key; });
    std::vector<uint16_t> geokeys = {1, 1, 0, (uint16_t)entries.size()};
    for (const ExtraKey& ek : entries) {
        uint16_t entry[4] = {ek.key, ek.loc, ek.count, ek.value};
        geokeys.insert(geokeys.end(), entry, entry + 4);
    }

    std::vector<double> pixscale = {transform[0], -transform[4], 0.0};
    std::vector<double> tiepoint = {0, 0, 0, transform[2], transform[5], 0};

    // Layout: 8-byte header | IFD | external payloads | strip data
    uint16_t n_tags = 15 + (has_nodata ? 1 : 0) + (epsg ? 2 : 0);
    // pixscale+tiepoint are always written (2 of the 15? recount below)

    std::vector<TagW> tags;
    std::vector<std::pair<size_t, std::vector<uint8_t>>> payloads;  // (tag index, bytes)

    auto add_payload = [&](std::vector<uint8_t> bytes) -> size_t {
        // Associates the payload with the most recently pushed tag.
        payloads.push_back({tags.size() - 1, std::move(bytes)});
        return payloads.size() - 1;
    };
    auto doubles_bytes = [&](const std::vector<double>& v) {
        std::vector<uint8_t> b(v.size() * 8);
        memcpy(b.data(), v.data(), b.size());
        return b;
    };
    auto shorts_bytes = [&](const std::vector<uint16_t>& v) {
        std::vector<uint8_t> b(v.size() * 2);
        memcpy(b.data(), v.data(), b.size());
        return b;
    };
    auto longs_bytes = [&](const std::vector<uint32_t>& v) {
        std::vector<uint8_t> b(v.size() * 4);
        memcpy(b.data(), v.data(), b.size());
        return b;
    };

    std::vector<uint32_t> strip_offsets(n_strips, 0), strip_counts(n_strips);
    for (uint32_t s = 0; s < n_strips; s++) strip_counts[s] = (uint32_t)strips[s].size();

    tags.push_back({256, 4, 1, width});
    tags.push_back({257, 4, 1, height});
    tags.push_back({258, 3, 1, 32});
    tags.push_back({259, 3, 1, 8});      // DEFLATE
    tags.push_back({262, 3, 1, 1});      // BlackIsZero
    size_t strip_off_tag = tags.size();
    tags.push_back({273, 4, n_strips, 0});
    add_payload(longs_bytes(strip_offsets));  // placeholder, patched later
    tags.push_back({277, 3, 1, 1});
    tags.push_back({278, 4, 1, rps});
    size_t strip_cnt_tag = tags.size();
    tags.push_back({279, 4, n_strips, 0});
    add_payload(longs_bytes(strip_counts));
    tags.push_back({284, 3, 1, 1});
    if (predictor == 3) tags.push_back({317, 3, 1, 3});
    tags.push_back({339, 3, 1, 3});  // IEEE float
    size_t ps_tag = tags.size();
    tags.push_back({33550, 12, 3, 0});
    add_payload(doubles_bytes(pixscale));
    size_t tp_tag = tags.size();
    tags.push_back({33922, 12, 6, 0});
    add_payload(doubles_bytes(tiepoint));
    size_t gk_tag = SIZE_MAX;
    if (epsg || !cit.empty() || !extras.empty()) {
        gk_tag = tags.size();
        tags.push_back({34735, 3, (uint32_t)geokeys.size(), 0});
        add_payload(shorts_bytes(geokeys));
        if (!double_params.empty()) {
            tags.push_back({34736, 12, (uint32_t)double_params.size(), 0});  // GeoDoubleParams
            add_payload(doubles_bytes(double_params));
        }
        if (!ascii_params.empty()) {
            tags.push_back({34737, 2, (uint32_t)ascii_params.size(), 0});
            add_payload(std::vector<uint8_t>(ascii_params.begin(), ascii_params.end()));
        }
    }
    size_t nd_tag = SIZE_MAX;
    if (has_nodata) {
        nd_tag = tags.size();
        tags.push_back({42113, 2, (uint32_t)nodata_str.size(), 0});
        add_payload(std::vector<uint8_t>(nodata_str.begin(), nodata_str.end()));
    }
    if (metadata && metadata[0]) {
        std::string md(metadata);
        md.push_back('\0');
        tags.push_back({42112, 2, (uint32_t)md.size(), 0});  // GDAL_METADATA
        add_payload(std::vector<uint8_t>(md.begin(), md.end()));
    }
    (void)ps_tag; (void)tp_tag; (void)gk_tag; (void)nd_tag; (void)n_tags;

    // Sort tags ascending (TIFF requirement); remember payload tag-index remapping
    std::vector<size_t> order(tags.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    for (size_t i = 0; i < order.size(); i++)
        for (size_t j = i + 1; j < order.size(); j++)
            if (tags[order[j]].tag < tags[order[i]].tag) std::swap(order[i], order[j]);

    size_t ifd_off = 8;
    size_t ifd_size = 2 + tags.size() * 12 + 4;
    size_t payload_off = ifd_off + ifd_size;

    // Assign payload offsets
    std::vector<size_t> payload_offsets(payloads.size());
    size_t cur = payload_off;
    for (size_t i = 0; i < payloads.size(); i++) {
        if (cur % 2) cur++;
        payload_offsets[i] = cur;
        cur += payloads[i].second.size();
    }
    // Strip data offsets
    if (cur % 2) cur++;
    for (uint32_t s = 0; s < n_strips; s++) {
        strip_offsets[s] = (uint32_t)cur;
        cur += strips[s].size();
    }
    // Patch strip offsets payload
    for (size_t i = 0; i < payloads.size(); i++) {
        if (payloads[i].first == strip_off_tag)
            memcpy(payloads[i].second.data(), strip_offsets.data(), n_strips * 4);
        if (payloads[i].first == strip_cnt_tag)
            memcpy(payloads[i].second.data(), strip_counts.data(), n_strips * 4);
    }
    // Resolve tag values: payloads > 4 bytes get offsets; small values stay inline
    for (size_t i = 0; i < payloads.size(); i++) {
        size_t ti = payloads[i].first;
        size_t nbytes = payloads[i].second.size();
        if (nbytes <= 4) {
            uint32_t v = 0;
            memcpy(&v, payloads[i].second.data(), nbytes);
            tags[ti].value = v;
            payload_offsets[i] = SIZE_MAX;  // inline
        } else {
            tags[ti].value = (uint32_t)payload_offsets[i];
        }
    }

    FILE* f = fopen(path, "wb");
    if (!f) {
        g_last_error = "cannot open output file";
        return 1;
    }
    // Header (little-endian host assumed — x86/ARM LE)
    uint8_t header[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
    uint32_t ifd_off32 = (uint32_t)ifd_off;
    memcpy(header + 4, &ifd_off32, 4);
    fwrite(header, 1, 8, f);
    // IFD
    uint16_t cnt16 = (uint16_t)tags.size();
    fwrite(&cnt16, 2, 1, f);
    for (size_t oi = 0; oi < order.size(); oi++) {
        const TagW& tg = tags[order[oi]];
        fwrite(&tg.tag, 2, 1, f);
        fwrite(&tg.type, 2, 1, f);
        fwrite(&tg.count, 4, 1, f);
        fwrite(&tg.value, 4, 1, f);
    }
    uint32_t zero = 0;
    fwrite(&zero, 4, 1, f);
    // Payloads (with alignment padding)
    cur = payload_off;
    for (size_t i = 0; i < payloads.size(); i++) {
        if (payload_offsets[i] == SIZE_MAX) continue;
        while (cur < payload_offsets[i]) {
            fputc(0, f);
            cur++;
        }
        fwrite(payloads[i].second.data(), 1, payloads[i].second.size(), f);
        cur += payloads[i].second.size();
    }
    // Strips
    for (uint32_t s = 0; s < n_strips; s++) {
        while (cur < strip_offsets[s]) {
            fputc(0, f);
            cur++;
        }
        fwrite(strips[s].data(), 1, strips[s].size(), f);
        cur += strips[s].size();
    }
    fclose(f);
    return 0;
}

const char* gt_metadata(const char* path) {
    g_metadata.clear();
    Tiff t;
    if (!read_file(path, t.buf)) return g_metadata.c_str();
    uint64_t ifd0 = open_tiff(t);
    if (!ifd0) return g_metadata.c_str();
    std::vector<Ifd_entry> e;
    if (!parse_ifd(t, ifd0, e)) return g_metadata.c_str();
    const Ifd_entry* md = find_tag(e, 42112);
    if (md && !md->data.empty()) {
        g_metadata.assign(reinterpret_cast<const char*>(md->data.data()), md->data.size());
        // Trim the trailing NUL(s)
        while (!g_metadata.empty() && g_metadata.back() == '\0') g_metadata.pop_back();
    }
    return g_metadata.c_str();
}

// Full GeoKey directory as text: "s<key>=<int>;" for SHORT keys (loc 0) and
// "d<key>=<v[,v...]>;" for DOUBLE keys (loc 34736, values from GeoDoubleParams). ASCII keys
// are omitted (gt_citation serves those). Empty string when no GeoKeyDirectory exists.
static std::string g_geokeys;
const char* gt_geokeys(const char* path) {
    g_geokeys.clear();
    Tiff t;
    if (!read_file(path, t.buf)) return g_geokeys.c_str();
    uint64_t ifd0 = open_tiff(t);
    if (!ifd0) return g_geokeys.c_str();
    std::vector<Ifd_entry> e;
    if (!parse_ifd(t, ifd0, e)) return g_geokeys.c_str();
    const Ifd_entry* gk = find_tag(e, 34735);
    if (!gk || gk->count < 4) return g_geokeys.c_str();
    const Ifd_entry* dp = find_tag(e, 34736);
    uint32_t n_doubles = dp ? dp->count : 0;
    uint32_t nkeys = entry_uint(t, *gk, 3);
    char buf[512];
    for (uint32_t k = 1; k <= nkeys && 4 * (k + 1) <= gk->count; k++) {
        uint32_t key = entry_uint(t, *gk, 4 * k);
        uint32_t loc = entry_uint(t, *gk, 4 * k + 1);
        uint32_t cnt = entry_uint(t, *gk, 4 * k + 2);
        uint32_t val = entry_uint(t, *gk, 4 * k + 3);
        if (loc == 0) {
            snprintf(buf, sizeof(buf), "s%u=%u;", key, val);
            g_geokeys += buf;
        } else if (loc == 34736 && dp && val + cnt <= n_doubles) {
            snprintf(buf, sizeof(buf), "d%u=", key);
            g_geokeys += buf;
            for (uint32_t i = 0; i < cnt; i++) {
                snprintf(buf, sizeof(buf), "%.17g%s", entry_double(t, *dp, val + i),
                         i + 1 < cnt ? "," : ";");
                g_geokeys += buf;
            }
        }
    }
    return g_geokeys.c_str();
}

// CRS citation text (WKT) from the GeoTIFF citation keys (GTCitation 1026, PCSCitation
// 3073, GeogCitation 2049) stored in GeoAsciiParams (34737). Empty string when absent.
static std::string g_citation;
const char* gt_citation(const char* path) {
    g_citation.clear();
    Tiff t;
    if (!read_file(path, t.buf)) return g_citation.c_str();
    uint64_t ifd0 = open_tiff(t);
    if (!ifd0) return g_citation.c_str();
    std::vector<Ifd_entry> e;
    if (!parse_ifd(t, ifd0, e)) return g_citation.c_str();
    const Ifd_entry* gk = find_tag(e, 34735);
    const Ifd_entry* ap = find_tag(e, 34737);
    if (!gk || !ap || gk->count < 4 || ap->data.empty()) return g_citation.c_str();
    const char* ascii = reinterpret_cast<const char*>(ap->data.data());
    size_t ascii_len = ap->data.size();
    uint32_t nkeys = entry_uint(t, *gk, 3);
    // Prefer the generic GTCitation, else PCS/Geog citations
    const uint32_t wanted[3] = {1026, 3073, 2049};
    for (int w = 0; w < 3; w++) {
        for (uint32_t k = 1; k <= nkeys && 4 * (k + 1) <= gk->count; k++) {
            uint32_t key = entry_uint(t, *gk, 4 * k);
            uint32_t loc = entry_uint(t, *gk, 4 * k + 1);
            uint32_t cnt = entry_uint(t, *gk, 4 * k + 2);
            uint32_t off = entry_uint(t, *gk, 4 * k + 3);
            if (key == wanted[w] && loc == 34737 && off < ascii_len) {
                size_t n = cnt;
                if (off + n > ascii_len) n = ascii_len - off;
                g_citation.assign(ascii + off, n);
                // GeoTIFF ASCII values are '|'-terminated; strip it and trailing NULs
                while (!g_citation.empty() &&
                       (g_citation.back() == '|' || g_citation.back() == '\0'))
                    g_citation.pop_back();
                return g_citation.c_str();
            }
        }
    }
    return g_citation.c_str();
}

}  // extern "C"
