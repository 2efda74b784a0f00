// Native audio IO for the host data loader (a copy of the JAX package's
// lidbox_tpu/native/audioio.cpp; host code, not a device kernel).
//
// The reference toolkit decoded audio through tf.audio / miniaudio inside
// the tf.data graph (reference: lidbox/features/audio.py:17-34). In this
// framework the host loader is Python, so the decode hot path is native:
// ctypes calls release the GIL, letting a Python thread pool decode many
// files in true parallelism while the device consumes batches.
//
// C ABI (see lidbox_tpu_torch/native/__init__.py):
//   la_read_wav            decode a PCM/float WAV to mono float32
//   la_read_wav_into       decode into a caller buffer (no allocation)
//   la_wav_header_is_valid RIFF + chunk-size validation
//   la_read_mp3            decode an mp3 to mono float32 (system libmpg123)
//   la_mp3_supported       1 when libmpg123 is loadable
//   la_resample_linear     linear resampler
//   la_rms_frames          framewise RMS (energy VAD front half)
//   la_free                free buffers allocated by this library
//
// Build: g++ -O3 -march=native -shared -fPIC audioio.cpp -o
//        ../_build/libaudioio.so (done at first use by native/__init__.py)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

struct Reader {
    FILE* f = nullptr;
    explicit Reader(const char* path) { f = std::fopen(path, "rb"); }
    ~Reader() { if (f) std::fclose(f); }
    bool ok() const { return f != nullptr; }
    bool read(void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }
    bool skip(long n) { return std::fseek(f, n, SEEK_CUR) == 0; }
    long tell() const { return std::ftell(f); }
};

uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

struct WavFmt {
    uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
    uint16_t channels = 0;
    uint32_t sample_rate = 0;
    uint16_t bits = 0;
};

// Parse RIFF chunks until the data chunk; fills fmt and positions the
// reader at the start of sample data. Returns data byte size or -1.
long parse_header(Reader& r, WavFmt* fmt) {
    uint8_t hdr[12];
    if (!r.read(hdr, 12)) return -1;
    if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
        return -1;
    bool have_fmt = false;
    for (;;) {
        uint8_t ch[8];
        if (!r.read(ch, 8)) return -1;
        uint32_t size = rd_u32(ch + 4);
        if (std::memcmp(ch, "fmt ", 4) == 0) {
            uint8_t buf[16];
            if (size < 16 || !r.read(buf, 16)) return -1;
            fmt->format = rd_u16(buf);
            fmt->channels = rd_u16(buf + 2);
            fmt->sample_rate = rd_u32(buf + 4);
            fmt->bits = rd_u16(buf + 14);
            // Reject malformed fmt chunks up front: bits outside {8,16,32}
            // or zero channels would otherwise divide by zero (SIGFPE) in
            // the frame-count math before decode_to_mono's checks run.
            if (fmt->channels == 0 || fmt->sample_rate == 0 ||
                (fmt->bits != 8 && fmt->bits != 16 && fmt->bits != 32))
                return -1;
            if (size > 16 && !r.skip((long)size - 16)) return -1;
            have_fmt = true;
        } else if (std::memcmp(ch, "data", 4) == 0) {
            if (!have_fmt) return -1;
            return (long)size;
        } else {
            // chunks are word-aligned
            if (!r.skip((long)size + (size & 1))) return -1;
        }
    }
}

// Decode interleaved samples to mono float32 (channel average, matching
// tf.audio.decode_wav + reduce_mean, reference audio.py:17-23).
long decode_to_mono(const uint8_t* raw, long bytes, const WavFmt& fmt,
                    float* out) {
    const int ch = fmt.channels > 0 ? fmt.channels : 1;
    const int bps = fmt.bits / 8;
    if (bps == 0) return -1;
    const long frames = bytes / (bps * ch);
    const float inv_ch = 1.0f / (float)ch;
    if (fmt.format == 1 && fmt.bits == 16) {
        const int16_t* s = (const int16_t*)raw;
        if (ch == 1) {  // hot path: mono, trivially vectorizable
            constexpr float k = 1.0f / 32768.0f;
            for (long i = 0; i < frames; ++i) out[i] = (float)s[i] * k;
        } else {
            for (long i = 0; i < frames; ++i) {
                float acc = 0.0f;
                for (int c = 0; c < ch; ++c) acc += (float)s[i * ch + c];
                out[i] = acc * inv_ch * (1.0f / 32768.0f);
            }
        }
    } else if (fmt.format == 1 && fmt.bits == 32) {
        const int32_t* s = (const int32_t*)raw;
        for (long i = 0; i < frames; ++i) {
            double acc = 0.0;
            for (int c = 0; c < ch; ++c) acc += (double)s[i * ch + c];
            out[i] = (float)(acc * inv_ch / 2147483648.0);
        }
    } else if (fmt.format == 1 && fmt.bits == 8) {
        for (long i = 0; i < frames; ++i) {
            float acc = 0.0f;
            for (int c = 0; c < ch; ++c)
                acc += ((float)raw[i * ch + c] - 128.0f);
            out[i] = acc * inv_ch * (1.0f / 128.0f);
        }
    } else if (fmt.format == 3 && fmt.bits == 32) {
        const float* s = (const float*)raw;
        for (long i = 0; i < frames; ++i) {
            float acc = 0.0f;
            for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
            out[i] = acc * inv_ch;
        }
    } else {
        return -1;
    }
    return frames;
}

}  // namespace

extern "C" {

void la_free(void* p) { std::free(p); }

// Decode a WAV file to mono float32. Returns 0 on success; fills
// *out_samples (caller frees with la_free), *out_n, *out_rate.
int la_read_wav(const char* path, float** out_samples, long* out_n,
                int* out_rate) {
    Reader r(path);
    if (!r.ok()) return -1;
    WavFmt fmt;
    long data_bytes = parse_header(r, &fmt);
    if (data_bytes <= 0) return -2;
    uint8_t* raw = (uint8_t*)std::malloc((size_t)data_bytes);
    if (!raw) return -3;
    if (!r.read(raw, (size_t)data_bytes)) {
        std::free(raw);
        return -4;
    }
    const int ch = fmt.channels > 0 ? fmt.channels : 1;
    const long frames = data_bytes / ((fmt.bits / 8) * ch);
    float* out = (float*)std::malloc(sizeof(float) * (size_t)frames);
    if (!out) {
        std::free(raw);
        return -3;
    }
    long n = decode_to_mono(raw, data_bytes, fmt, out);
    std::free(raw);
    if (n < 0) {
        std::free(out);
        return -5;
    }
    *out_samples = out;
    *out_n = n;
    *out_rate = (int)fmt.sample_rate;
    return 0;
}

// Decode into a caller-provided buffer of capacity `cap` samples.
// Returns the number of samples written (truncated to cap) or < 0 on error;
// fills *out_rate and *out_total (full length before truncation).
long la_read_wav_into(const char* path, float* out, long cap, int* out_rate,
                      long* out_total) {
    float* tmp = nullptr;
    long n = 0;
    int rate = 0;
    int err = la_read_wav(path, &tmp, &n, &rate);
    if (err != 0) return err;
    long m = n < cap ? n : cap;
    std::memcpy(out, tmp, sizeof(float) * (size_t)m);
    std::free(tmp);
    *out_rate = rate;
    *out_total = n;
    return m;
}

// RIFF magic + body-size check (reference: lidbox/features/audio.py:377-396).
int la_wav_header_is_valid(const char* path) {
    Reader r(path);
    if (!r.ok()) return 0;
    WavFmt fmt;
    long data_bytes = parse_header(r, &fmt);
    if (data_bytes <= 0) return 0;
    long data_start = r.tell();
    if (std::fseek(r.f, 0, SEEK_END) != 0) return 0;
    long file_size = r.tell();
    return data_start + data_bytes <= file_size;
}

// Linear-interpolation resampler; returns output length, caller frees *out.
long la_resample_linear(const float* in, long n, int in_rate, int out_rate,
                        float** out) {
    if (n <= 1 || in_rate <= 0 || out_rate <= 0) return -1;
    long m = (long)((double)n * out_rate / in_rate);
    float* o = (float*)std::malloc(sizeof(float) * (size_t)m);
    if (!o) return -3;
    const double step = (double)in_rate / (double)out_rate;
    for (long i = 0; i < m; ++i) {
        double pos = i * step;
        long j = (long)pos;
        if (j >= n - 1) j = n - 2;
        double frac = pos - j;
        o[i] = (float)((1.0 - frac) * in[j] + frac * in[j + 1]);
    }
    *out = o;
    return m;
}

// Framewise RMS over non-overlapping frames of `step` samples.
// Writes n/step values into out (caller-allocated).
long la_rms_frames(const float* in, long n, long step, float* out) {
    if (step <= 0) return -1;
    long frames = n / step;
    for (long f = 0; f < frames; ++f) {
        double acc = 0.0;
        const float* p = in + f * step;
        for (long i = 0; i < step; ++i) acc += (double)p[i] * p[i];
        out[f] = (float)std::sqrt(acc / (double)step);
    }
    return frames;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MP3 decode via the system libmpg123, resolved with dlopen at first use.
// The mpg123 C ABI has been stable for its whole 1.x lifetime, so the
// minimal prototypes are declared here instead of requiring the dev header
// at build time. Replaces the reference's miniaudio mp3 path
// (lidbox/features/audio.py:26-34) with a native, GIL-free decoder.
// ---------------------------------------------------------------------------

#include <dlfcn.h>

namespace {

struct Mpg123Api {
    using handle = void;
    int (*init)(void) = nullptr;
    handle* (*make)(const char*, int*) = nullptr;
    int (*open)(handle*, const char*) = nullptr;
    int (*getformat)(handle*, long*, int*, int*) = nullptr;
    int (*format_none)(handle*) = nullptr;
    int (*format)(handle*, long, int, int) = nullptr;
    void (*rates)(const long**, size_t*) = nullptr;
    int (*read)(handle*, unsigned char*, size_t, size_t*) = nullptr;
    int (*close)(handle*) = nullptr;
    void (*destroy)(handle*) = nullptr;
    int (*scan)(handle*) = nullptr;
    int64_t (*length64)(handle*) = nullptr;
    bool ok = false;
};

const int kMpg123Ok = 0;
const int kMpg123Done = -12;
const int kMpg123NewFormat = -11;
const int kEncFloat32 = 0x200;

const Mpg123Api& mpg123_api() {
    static Mpg123Api api = [] {
        Mpg123Api a;
        void* lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!lib) lib = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
        if (!lib) return a;
        a.init = (int (*)(void))dlsym(lib, "mpg123_init");
        a.make = (Mpg123Api::handle * (*)(const char*, int*))
            dlsym(lib, "mpg123_new");
        a.open = (int (*)(void*, const char*))dlsym(lib, "mpg123_open");
        a.getformat = (int (*)(void*, long*, int*, int*))
            dlsym(lib, "mpg123_getformat");
        a.format_none = (int (*)(void*))dlsym(lib, "mpg123_format_none");
        a.format = (int (*)(void*, long, int, int))dlsym(lib, "mpg123_format");
        a.rates = (void (*)(const long**, size_t*))dlsym(lib, "mpg123_rates");
        a.read = (int (*)(void*, unsigned char*, size_t, size_t*))
            dlsym(lib, "mpg123_read");
        a.close = (int (*)(void*))dlsym(lib, "mpg123_close");
        a.destroy = (void (*)(void*))dlsym(lib, "mpg123_delete");
        a.scan = (int (*)(void*))dlsym(lib, "mpg123_scan");
        // prefer the explicit 64-bit length; fall back to the off_t export
        // (same ABI on this platform: off_t is 64-bit)
        a.length64 = (int64_t (*)(void*))dlsym(lib, "mpg123_length_64");
        if (!a.length64)
            a.length64 = (int64_t (*)(void*))dlsym(lib, "mpg123_length");
        a.ok = a.init && a.make && a.open && a.getformat && a.format_none &&
               a.format && a.rates && a.read && a.close && a.destroy &&
               a.scan && a.length64 && a.init() == kMpg123Ok;
        return a;
    }();
    return api;
}

}  // namespace

extern "C" {

// 1 when libmpg123 is loadable (mp3 decode supported).
int la_mp3_supported(void) { return mpg123_api().ok ? 1 : 0; }

// Sample count and rate of an mp3 without decoding (mpg123 frame scan) —
// the duration back-end for metadata preparation. Returns 0 on success.
int la_mp3_info(const char* path, long* n_samples, int* rate) {
    const Mpg123Api& api = mpg123_api();
    if (!api.ok) return -1;
    int err = 0;
    void* h = api.make(nullptr, &err);
    if (!h) return -2;
    struct Guard {
        const Mpg123Api& api; void* h; bool opened = false;
        ~Guard() { if (opened) api.close(h); api.destroy(h); }
    } guard{api, h};
    if (api.open(h, path) != kMpg123Ok) return -2;
    guard.opened = true;
    long in_rate = 0;
    int channels = 0, enc = 0;
    if (api.getformat(h, &in_rate, &channels, &enc) != kMpg123Ok) return -2;
    if (api.scan(h) != kMpg123Ok) return -4;
    int64_t len = api.length64(h);
    if (len < 0 || in_rate <= 0) return -4;
    *n_samples = (long)len;
    *rate = (int)in_rate;
    return 0;
}

// Decode an mp3 file to mono float32 (channel mean, like the reference's
// read_mp3). Returns 0 on success; caller frees *out with la_free.
// Errors: -1 unsupported (no libmpg123), -2 open/format failure,
// -3 allocation failure, -4 decode error.
int la_read_mp3(const char* path, float** out, long* n, int* rate) {
    const Mpg123Api& api = mpg123_api();
    if (!api.ok) return -1;
    int err = 0;
    void* h = api.make(nullptr, &err);
    if (!h) return -2;
    struct Guard {
        const Mpg123Api& api; void* h; bool opened = false;
        ~Guard() { if (opened) api.close(h); api.destroy(h); }
    } guard{api, h};
    // Accept ONLY float32 output (mono or stereo, any rate) — configured
    // before open so the decoder negotiates float from the first frame.
    if (api.format_none(h) != kMpg123Ok) return -2;
    const long* rate_list = nullptr;
    size_t num_rates = 0;
    api.rates(&rate_list, &num_rates);
    if (!rate_list || num_rates == 0) return -2;
    const int kMonoOrStereo = 0x1 | 0x2;  // MPG123_MONO | MPG123_STEREO
    for (size_t i = 0; i < num_rates; ++i)
        if (api.format(h, rate_list[i], kMonoOrStereo, kEncFloat32)
            != kMpg123Ok)
            return -2;
    if (api.open(h, path) != kMpg123Ok) return -2;
    guard.opened = true;
    long in_rate = 0;
    int channels = 0, enc = 0;
    if (api.getformat(h, &in_rate, &channels, &enc) != kMpg123Ok) return -2;
    if (in_rate <= 0 || channels <= 0 || enc != kEncFloat32) return -2;

    size_t cap = 1 << 20, used = 0;  // floats (all channels interleaved)
    float* buf = (float*)std::malloc(cap * sizeof(float));
    if (!buf) return -3;
    unsigned char chunk[65536];
    for (;;) {
        size_t done = 0;
        int rc = api.read(h, chunk, sizeof(chunk), &done);
        size_t got = done / sizeof(float);
        if (used + got > cap) {
            while (used + got > cap) cap *= 2;
            float* nb = (float*)std::realloc(buf, cap * sizeof(float));
            if (!nb) { std::free(buf); return -3; }
            buf = nb;
        }
        std::memcpy(buf + used, chunk, got * sizeof(float));
        used += got;
        if (rc == kMpg123Done) break;
        if (rc == kMpg123NewFormat) {
            long r2 = 0; int c2 = 0, e2 = 0;
            if (api.getformat(h, &r2, &c2, &e2) != kMpg123Ok ||
                r2 != in_rate || c2 != channels) {
                std::free(buf);
                return -4;  // mid-stream format change unsupported
            }
            continue;
        }
        if (rc != kMpg123Ok) { std::free(buf); return -4; }
    }

    long frames = (long)(used / (size_t)channels);
    float* mono = (float*)std::malloc(sizeof(float) * (size_t)(frames > 0 ? frames : 1));
    if (!mono) { std::free(buf); return -3; }
    const float inv = 1.0f / (float)channels;
    for (long i = 0; i < frames; ++i) {
        float acc = 0.0f;
        const float* p = buf + (size_t)i * channels;
        for (int c = 0; c < channels; ++c) acc += p[c];
        mono[i] = acc * inv;
    }
    std::free(buf);
    *out = mono;
    *n = frames;
    *rate = (int)in_rate;
    return 0;
}

}  // extern "C"
