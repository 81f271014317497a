// framesink — native presentation backend for voxelengine_tpu.
//
// Host-side analog of the reference's SDLRenderer static library
// (SDLRenderer/SDLRenderer.{h,cpp}): where that wraps an SDL window with a
// streaming ARGB8888 texture and a callback-driven render loop, this wraps
// an asynchronous writer thread with a double-buffered BGRA frame queue so
// the Python render loop never blocks on presentation I/O.  Frames are
// streamed to:
//   * a PPM/raw-BGRA file sequence (headless captures), and/or
//   * a live preview FIFO/file (latest frame only, atomically replaced).
//
// C ABI (used from Python via ctypes):
//   fs_init(width, height, mode, path)  -> handle (>=0) or -1
//   fs_submit(handle, bgra_ptr)         -> 0 ok / -1 bad handle
//   fs_frames_written(handle)           -> count of frames flushed
//   fs_close(handle)                    -> frames flushed (after drain)
//
// mode bitmask: 1 = write numbered PPM sequence under path/frame_%06d.ppm
//               2 = keep path/latest.ppm updated (atomic rename)
//               4 = write numbered PNG sequence under path/frame_%06d.png
//               8 = keep path/latest.png updated (atomic rename)
// PNGs are encoded with a self-contained writer (stored deflate blocks +
// CRC-32/Adler-32; no zlib dependency) — universally readable, ~raw size.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Sink {
    int width = 0, height = 0, mode = 0;
    std::string dir;
    std::vector<uint8_t> pending;   // BGRA frame queued for writing
    std::vector<uint8_t> writing;   // frame being flushed
    bool has_pending = false;
    bool closing = false;
    std::atomic<long> frames_written{0};
    long frames_submitted = 0;
    std::mutex mu;
    std::condition_variable cv;
    std::thread worker;
    bool used = false;
};

constexpr int kMaxSinks = 16;
Sink g_sinks[kMaxSinks];
std::mutex g_table_mu;

void write_ppm(const std::string& path, const uint8_t* bgra, int w, int h) {
    std::string tmp = path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return;
    std::fprintf(f, "P6\n%d %d\n255\n", w, h);
    std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
    for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; i++) {
        rgb[i * 3 + 0] = bgra[i * 4 + 2];
        rgb[i * 3 + 1] = bgra[i * 4 + 1];
        rgb[i * 3 + 2] = bgra[i * 4 + 0];
    }
    std::fwrite(rgb.data(), 1, rgb.size(), f);
    std::fclose(f);
    std::rename(tmp.c_str(), path.c_str());
}

// ---- minimal PNG writer: zlib stream with stored (uncompressed) deflate
// blocks, so no external compression library is needed ----

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
    static uint32_t table[256];
    static bool init = false;
    if (!init) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
            table[i] = c;
        }
        init = true;
    }
    for (size_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return crc;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8); v.push_back(x);
}

void png_chunk(FILE* f, const char type[4], const uint8_t* data, size_t n) {
    uint8_t len[4] = {uint8_t(n >> 24), uint8_t(n >> 16), uint8_t(n >> 8), uint8_t(n)};
    std::fwrite(len, 1, 4, f);
    std::fwrite(type, 1, 4, f);
    if (n) std::fwrite(data, 1, n, f);
    uint32_t crc = crc32_update(0xFFFFFFFFu, reinterpret_cast<const uint8_t*>(type), 4);
    crc = crc32_update(crc, data, n) ^ 0xFFFFFFFFu;
    uint8_t c[4] = {uint8_t(crc >> 24), uint8_t(crc >> 16), uint8_t(crc >> 8), uint8_t(crc)};
    std::fwrite(c, 1, 4, f);
}

void write_png(const std::string& path, const uint8_t* bgra, int w, int h) {
    std::string tmp = path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return;
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    std::fwrite(sig, 1, 8, f);
    std::vector<uint8_t> ihdr;
    put_be32(ihdr, static_cast<uint32_t>(w));
    put_be32(ihdr, static_cast<uint32_t>(h));
    ihdr.push_back(8);  // bit depth
    ihdr.push_back(2);  // color type: truecolor RGB
    ihdr.push_back(0); ihdr.push_back(0); ihdr.push_back(0);
    png_chunk(f, "IHDR", ihdr.data(), ihdr.size());

    // raw scanlines: filter byte 0 + RGB per pixel
    size_t stride = static_cast<size_t>(w) * 3 + 1;
    std::vector<uint8_t> raw(stride * h);
    for (int y = 0; y < h; y++) {
        uint8_t* row = raw.data() + stride * y;
        row[0] = 0;
        const uint8_t* src = bgra + static_cast<size_t>(y) * w * 4;
        for (int x = 0; x < w; x++) {
            row[1 + x * 3 + 0] = src[x * 4 + 2];
            row[1 + x * 3 + 1] = src[x * 4 + 1];
            row[1 + x * 3 + 2] = src[x * 4 + 0];
        }
    }
    // zlib stream: header + stored deflate blocks + adler32
    std::vector<uint8_t> idat;
    idat.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
    idat.push_back(0x78); idat.push_back(0x01);
    size_t off = 0;
    while (off < raw.size()) {
        size_t blk = raw.size() - off;
        if (blk > 65535) blk = 65535;
        bool last = (off + blk == raw.size());
        idat.push_back(last ? 1 : 0);
        idat.push_back(blk & 0xFF); idat.push_back(blk >> 8);
        idat.push_back(~blk & 0xFF); idat.push_back((~blk >> 8) & 0xFF);
        idat.insert(idat.end(), raw.begin() + off, raw.begin() + off + blk);
        off += blk;
    }
    uint32_t a = 1, b = 0;
    for (size_t i = 0; i < raw.size(); i++) {  // adler32 (mod every step: simple)
        a = (a + raw[i]) % 65521u;
        b = (b + a) % 65521u;
    }
    put_be32(idat, (b << 16) | a);
    png_chunk(f, "IDAT", idat.data(), idat.size());
    png_chunk(f, "IEND", nullptr, 0);
    std::fclose(f);
    std::rename(tmp.c_str(), path.c_str());
}

void worker_loop(Sink* s) {
    for (;;) {
        {
            std::unique_lock<std::mutex> lk(s->mu);
            s->cv.wait(lk, [s] { return s->has_pending || s->closing; });
            if (!s->has_pending && s->closing) return;
            s->writing.swap(s->pending);
            s->has_pending = false;
        }
        long n = s->frames_written.load();
        if (s->mode & 1) {
            char name[64];
            std::snprintf(name, sizeof(name), "/frame_%06ld.ppm", n);
            write_ppm(s->dir + name, s->writing.data(), s->width, s->height);
        }
        if (s->mode & 2) {
            write_ppm(s->dir + "/latest.ppm", s->writing.data(), s->width, s->height);
        }
        if (s->mode & 4) {
            char name[64];
            std::snprintf(name, sizeof(name), "/frame_%06ld.png", n);
            write_png(s->dir + name, s->writing.data(), s->width, s->height);
        }
        if (s->mode & 8) {
            write_png(s->dir + "/latest.png", s->writing.data(), s->width, s->height);
        }
        s->frames_written.fetch_add(1);
    }
}

}  // namespace

extern "C" {

int fs_init(int width, int height, int mode, const char* dir) {
    std::lock_guard<std::mutex> lk(g_table_mu);
    for (int i = 0; i < kMaxSinks; i++) {
        Sink& s = g_sinks[i];
        if (s.used) continue;
        s.used = true;
        s.width = width;
        s.height = height;
        s.mode = mode;
        s.dir = dir ? dir : ".";
        s.closing = false;
        s.has_pending = false;
        s.frames_written.store(0);
        s.frames_submitted = 0;
        size_t bytes = static_cast<size_t>(width) * height * 4;
        s.pending.assign(bytes, 0);
        s.writing.assign(bytes, 0);
        s.worker = std::thread(worker_loop, &s);
        return i;
    }
    return -1;
}

int fs_submit(int handle, const uint8_t* bgra) {
    if (handle < 0 || handle >= kMaxSinks || !g_sinks[handle].used) return -1;
    Sink& s = g_sinks[handle];
    {
        std::lock_guard<std::mutex> lk(s.mu);
        std::memcpy(s.pending.data(), bgra, s.pending.size());
        s.has_pending = true;  // newest frame wins; older pending is dropped
        s.frames_submitted++;
    }
    s.cv.notify_one();
    return 0;
}

long fs_frames_written(int handle) {
    if (handle < 0 || handle >= kMaxSinks || !g_sinks[handle].used) return -1;
    return g_sinks[handle].frames_written.load();
}

long fs_close(int handle) {
    if (handle < 0 || handle >= kMaxSinks || !g_sinks[handle].used) return -1;
    Sink& s = g_sinks[handle];
    {
        std::lock_guard<std::mutex> lk(s.mu);
        s.closing = true;
    }
    s.cv.notify_one();
    if (s.worker.joinable()) s.worker.join();
    long n = s.frames_written.load();
    std::lock_guard<std::mutex> lk(g_table_mu);
    s.used = false;
    return n;
}

}  // extern "C"
