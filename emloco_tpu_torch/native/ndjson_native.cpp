// Native ndjson scene reader for trajnet++-style exports (JTA/JRDB).
//
// The reference parses these files in Python (utils/trajnetplusplustools/
// reader.py:10-143) — fine for toy files, slow for full JTA (millions of
// track rows). This is a minimal, allocation-light scanner over the two row
// shapes the format uses:
//   {"track": {"f": <frame>, "p": <ped>, "x": <x>, "y": <y>, ...}}
//   {"scene": {"id":…, "p": <primary>, "s": <start>, "e": <end>, ...}}
// Exposed over a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// find `"key"` then parse the number after the following ':'
static bool find_num(const char* line, const char* key, double* out) {
    const char* p = strstr(line, key);
    if (!p) return false;
    p += strlen(key);
    while (*p && (*p == ':' || *p == ' ' || *p == '"')) ++p;
    char* end = nullptr;
    *out = strtod(p, &end);
    return end != p;
}

struct Track { int32_t f, p; float x, y; };
struct Scene { int32_t id, p, s, e; };

struct Parsed {
    std::vector<Track> tracks;
    std::vector<Scene> scenes;
};

}  // namespace

extern "C" {

// Parse file; returns opaque handle (0 on failure).
void* ndjson_parse(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* out = new Parsed();
    char* line = nullptr;
    size_t cap = 0;
    ssize_t len;
    while ((len = getline(&line, &cap, f)) > 0) {
        if (strstr(line, "\"track\"")) {
            double fr, p, x, y;
            if (find_num(line, "\"f\"", &fr) && find_num(line, "\"p\"", &p) &&
                find_num(line, "\"x\"", &x) && find_num(line, "\"y\"", &y)) {
                out->tracks.push_back({(int32_t)fr, (int32_t)p,
                                       (float)x, (float)y});
            }
        } else if (strstr(line, "\"scene\"")) {
            double id = 0, p, s, e;
            find_num(line, "\"id\"", &id);
            if (find_num(line, "\"p\"", &p) && find_num(line, "\"s\"", &s) &&
                find_num(line, "\"e\"", &e)) {
                out->scenes.push_back({(int32_t)id, (int32_t)p,
                                       (int32_t)s, (int32_t)e});
            }
        }
    }
    free(line);
    fclose(f);
    return out;
}

int64_t ndjson_num_tracks(void* h) {
    return static_cast<Parsed*>(h)->tracks.size();
}
int64_t ndjson_num_scenes(void* h) {
    return static_cast<Parsed*>(h)->scenes.size();
}

// Copy out flat arrays. tracks: (n,2) int32 [f,p] + (n,2) float [x,y];
// scenes: (m,4) int32 [id,p,s,e].
void ndjson_copy_tracks(void* h, int32_t* fp, float* xy) {
    auto* d = static_cast<Parsed*>(h);
    for (size_t i = 0; i < d->tracks.size(); ++i) {
        fp[2 * i] = d->tracks[i].f;
        fp[2 * i + 1] = d->tracks[i].p;
        xy[2 * i] = d->tracks[i].x;
        xy[2 * i + 1] = d->tracks[i].y;
    }
}
void ndjson_copy_scenes(void* h, int32_t* out) {
    auto* d = static_cast<Parsed*>(h);
    for (size_t i = 0; i < d->scenes.size(); ++i) {
        out[4 * i] = d->scenes[i].id;
        out[4 * i + 1] = d->scenes[i].p;
        out[4 * i + 2] = d->scenes[i].s;
        out[4 * i + 3] = d->scenes[i].e;
    }
}
void ndjson_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
