// oscen_host — native host-runtime for oscen_tpu.
//
// The reference implements its entire control runtime natively (Rust);
// here the host-side control plane — the code that runs per block on the
// CPU while the TPU renders — is C++: MIDI parsing, LRU voice allocation
// (reference voice_allocator.rs semantics), event packing/sorting, and the
// offline windowed-sinc asset resampler (reference asset/resample.rs).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: g++ -O3 -march=native -shared -fPIC -o _oscen_host.so oscen_host.cpp
//
// Python fallbacks exist for every entry point; tests assert parity.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ------------------------------------------------------------------- //
// MIDI parsing (reference midi.rs:147-171)
// kind: 0 = ignored, 1 = note-on, 2 = note-off
// ------------------------------------------------------------------- //
void oscen_parse_midi(const uint8_t* bytes, int32_t len, int32_t* kind,
                      int32_t* note, float* velocity) {
    *kind = 0;
    *note = 0;
    *velocity = 0.0f;
    if (len < 3) return;
    const uint8_t status = bytes[0] & 0xF0;
    if (status == 0x80) {
        *kind = 2;
        *note = bytes[1];
    } else if (status == 0x90) {
        if (bytes[2] == 0) {
            *kind = 2;  // note-on velocity 0 == note-off
            *note = bytes[1];
        } else {
            *kind = 1;
            *note = bytes[1];
            float v = (float)bytes[2] / 127.0f;
            *velocity = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        }
    }
}

// ------------------------------------------------------------------- //
// LRU voice allocator (reference voice_allocator.rs:44-136)
// ------------------------------------------------------------------- //
struct VoiceState {
    bool active = false;
    bool released = false;
    int32_t note = -1;
    uint64_t age = 0;
};

struct Allocator {
    std::vector<VoiceState> voices;
    uint64_t current_age = 0;
};

void* oscen_alloc_create(int32_t num_voices) {
    auto* a = new Allocator();
    a->voices.resize(num_voices);
    return a;
}

void oscen_alloc_destroy(void* p) { delete static_cast<Allocator*>(p); }

void oscen_alloc_reset(void* p) {
    auto* a = static_cast<Allocator*>(p);
    for (auto& v : a->voices) v = VoiceState{};
    a->current_age = 0;
}

int32_t oscen_alloc_note_on(void* p, int32_t note) {
    auto* a = static_cast<Allocator*>(p);
    const int32_t n = (int32_t)a->voices.size();
    // free voice first
    for (int32_t i = 0; i < n; ++i) {
        if (!a->voices[i].active) {
            a->voices[i] = {true, false, note, a->current_age++};
            return i;
        }
    }
    // steal: released-then-oldest (LRU)
    int32_t best = 0;
    auto key = [&](int32_t i) {
        const auto& v = a->voices[i];
        return std::make_pair(v.released ? 0 : 1, v.age);
    };
    for (int32_t i = 1; i < n; ++i)
        if (key(i) < key(best)) best = i;
    a->voices[best] = {true, false, note, a->current_age++};
    return best;
}

int32_t oscen_alloc_note_off(void* p, int32_t note) {
    auto* a = static_cast<Allocator*>(p);
    const int32_t n = (int32_t)a->voices.size();
    for (int32_t i = 0; i < n; ++i) {
        auto& v = a->voices[i];
        if (v.active && !v.released && v.note == note) {
            v.released = true;  // keep active through the release phase
            v.note = -1;
            return i;
        }
    }
    return -1;
}

// ------------------------------------------------------------------- //
// Event packing: stable-sort (offset) + truncate to capacity
// (the staging the generated process_block does, codegen/mod.rs:782-799)
// ------------------------------------------------------------------- //
void oscen_pack_events(const int32_t* offsets, const float* values,
                       int32_t n, int32_t capacity, int32_t* out_off,
                       float* out_val, uint8_t* out_valid) {
    std::vector<int32_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return offsets[a] < offsets[b];
    });
    const int32_t m = std::min(n, capacity);
    for (int32_t i = 0; i < capacity; ++i) {
        if (i < m) {
            out_off[i] = offsets[order[i]];
            out_val[i] = values[order[i]];
            out_valid[i] = 1;
        } else {
            out_off[i] = 0;
            out_val[i] = 0.0f;
            out_valid[i] = 0;
        }
    }
}

// ------------------------------------------------------------------- //
// Offline windowed-sinc resampler (reference asset/resample.rs:47-103):
// 32 zero-crossings, Blackman window, per-output weight normalization.
// ------------------------------------------------------------------- //
static inline float sinc_f(float x) {
    if (x == 0.0f) return 1.0f;
    const float px = (float)M_PI * x;
    return std::sin(px) / px;
}

static inline float blackman_f(float t) {
    if (std::fabs(t) > 1.0f) return 0.0f;
    const float phase = (float)M_PI * (t + 1.0f);
    const float c = std::cos(phase);
    return 0.42f - 0.5f * c + 0.08f * (2.0f * c * c - 1.0f);
}

int64_t oscen_resample_out_len(int64_t n_in, int32_t src, int32_t dst) {
    return (int64_t)std::llround((double)n_in * (double)dst / (double)src);
}

void oscen_resample_channel(const float* in, int64_t n_in, int32_t src,
                            int32_t dst, float* out, int64_t n_out) {
    if (n_in == 0 || n_out == 0) return;
    if (src == dst) {
        std::memcpy(out, in, sizeof(float) * std::min(n_in, n_out));
        return;
    }
    const double ratio = (double)dst / (double)src;
    const float cutoff = (float)std::min(ratio, 1.0);
    const float radius = 32.0f / cutoff;
    const double inv_ratio = 1.0 / ratio;
    const float inv_radius = 1.0f / radius;

    for (int64_t n = 0; n < n_out; ++n) {
        const double pos = (double)n * inv_ratio;
        int64_t first = (int64_t)std::ceil(pos - radius);
        int64_t last = (int64_t)std::floor(pos + radius);
        if (first < 0) first = 0;
        if (last > n_in - 1) last = n_in - 1;
        float acc = 0.0f, wsum = 0.0f;
        for (int64_t i = first; i <= last; ++i) {
            const float dist = (float)(pos - (double)i);
            const float w = sinc_f(cutoff * dist)
                * blackman_f(dist * inv_radius);
            acc += w * in[i];
            wsum += w;
        }
        out[n] = (wsum != 0.0f) ? acc / wsum : 0.0f;
    }
}

}  // extern "C"

// ------------------------------------------------------------------- //
// WAV decoding (the native data-loader; reference decodes with hound).
// Supports PCM 8/16/24/32-bit and IEEE float32, incl. WAVE_FORMAT_
// EXTENSIBLE, arbitrary chunk order, and odd-sized chunks (word
// padding).  Output is interleaved float32 normalized to [-1, 1].
// ------------------------------------------------------------------- //
#include <cstdio>

namespace {

struct WavInfo {
    int32_t channels = 0;
    int32_t rate = 0;
    int64_t frames = 0;
    int32_t fmt = 0;        // 1 = PCM, 3 = float
    int32_t bits = 0;
    int64_t data_off = 0;
    int64_t data_len = 0;
};

bool wav_scan(FILE* f, WavInfo* w) {
    uint8_t hdr[12];
    if (std::fread(hdr, 1, 12, f) != 12) return false;
    if (std::memcmp(hdr, "RIFF", 4) || std::memcmp(hdr + 8, "WAVE", 4))
        return false;
    uint8_t ch[8];
    bool have_fmt = false, have_data = false;
    while (std::fread(ch, 1, 8, f) == 8) {
        uint32_t len = uint32_t(ch[4]) | (uint32_t(ch[5]) << 8)
            | (uint32_t(ch[6]) << 16) | (uint32_t(ch[7]) << 24);
        long pos = std::ftell(f);
        if (!std::memcmp(ch, "fmt ", 4) && len >= 16) {
            uint8_t b[40];
            size_t n = len < sizeof(b) ? len : sizeof(b);
            if (std::fread(b, 1, n, f) != n) return false;
            uint16_t tag = uint16_t(b[0]) | (uint16_t(b[1]) << 8);
            w->channels = uint16_t(b[2]) | (uint16_t(b[3]) << 8);
            w->rate = int32_t(uint32_t(b[4]) | (uint32_t(b[5]) << 8)
                              | (uint32_t(b[6]) << 16)
                              | (uint32_t(b[7]) << 24));
            w->bits = uint16_t(b[14]) | (uint16_t(b[15]) << 8);
            if (tag == 0xFFFE && len >= 40) {       // EXTENSIBLE
                tag = uint16_t(b[24]) | (uint16_t(b[25]) << 8);
            }
            w->fmt = tag;
            have_fmt = true;
        } else if (!std::memcmp(ch, "data", 4)) {
            w->data_off = pos;
            w->data_len = len;
            have_data = true;
        }
        if (std::fseek(f, pos + long(len + (len & 1)), SEEK_SET)) break;
    }
    if (!have_fmt || !have_data || w->channels <= 0 || w->bits <= 0)
        return false;
    const int64_t bytes_per_frame = int64_t(w->channels) * (w->bits / 8);
    if (bytes_per_frame <= 0) return false;
    w->frames = w->data_len / bytes_per_frame;
    return (w->fmt == 1 && (w->bits == 8 || w->bits == 16 || w->bits == 24
                            || w->bits == 32))
        || (w->fmt == 3 && w->bits == 32);
}

}  // namespace

extern "C" int32_t oscen_wav_info(const char* path, int32_t* channels, int32_t* rate,
                       int64_t* frames, int32_t* fmt, int32_t* bits) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    WavInfo w;
    const bool ok = wav_scan(f, &w);
    std::fclose(f);
    if (!ok) return -2;
    *channels = w.channels;
    *rate = w.rate;
    *frames = w.frames;
    *fmt = w.fmt;
    *bits = w.bits;
    return 0;
}

extern "C" int32_t oscen_wav_read(const char* path, float* out, int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    WavInfo w;
    if (!wav_scan(f, &w)) { std::fclose(f); return -2; }
    const int64_t total = w.frames * w.channels;
    if (total > capacity) { std::fclose(f); return -3; }
    if (std::fseek(f, long(w.data_off), SEEK_SET)) {
        std::fclose(f);
        return -4;
    }
    std::vector<uint8_t> raw(size_t(w.data_len));
    if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        std::fclose(f);
        return -4;
    }
    std::fclose(f);
    const uint8_t* p = raw.data();
    if (w.fmt == 3) {                      // float32
        std::memcpy(out, p, size_t(total) * 4);
    } else if (w.bits == 16) {
        for (int64_t i = 0; i < total; ++i) {
            int16_t v;
            std::memcpy(&v, p + i * 2, 2);
            out[i] = float(v) / 32768.0f;
        }
    } else if (w.bits == 24) {
        for (int64_t i = 0; i < total; ++i) {
            int32_t v = int32_t(p[i * 3]) | (int32_t(p[i * 3 + 1]) << 8)
                | (int32_t(p[i * 3 + 2]) << 16);
            if (v >= (1 << 23)) v -= (1 << 24);
            out[i] = float(v) / float(1 << 23);
        }
    } else if (w.bits == 32) {             // PCM32
        for (int64_t i = 0; i < total; ++i) {
            int32_t v;
            std::memcpy(&v, p + i * 4, 4);
            out[i] = float(double(v) / 2147483648.0);
        }
    } else {                               // PCM8 (unsigned)
        for (int64_t i = 0; i < total; ++i)
            out[i] = (float(p[i]) - 128.0f) / 128.0f;
    }
    return 0;
}

