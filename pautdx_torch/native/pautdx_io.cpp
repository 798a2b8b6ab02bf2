// pautdx native IO: fast PAUT raw-data parsing.
//
// The reference's dataset-build hot loop parses thousands of small
// whitespace-separated A-scan .txt files with np.loadtxt and large JSON
// volumes with json.load (SURVEY.md §3.1) — both slow, pure-Python paths.
// This library provides:
//   - parse_floats_file: one .txt A-scan -> float32 buffer
//   - parse_json_volume_floats: extract every numeric array from the
//     {beam: {scan: [floats...]}} JSON volume schema in one pass
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <algorithm>
#include <atomic>
#include <thread>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Parse whitespace-separated floats from an in-memory buffer.
// Strict (np.loadtxt-like): a non-whitespace byte that does not start a
// float is a parse error — returns false so callers can fall back/raise
// rather than silently load divergent data.
bool parse_floats_buf(const char* p, const char* end,
                      std::vector<float>* out) {
    while (p < end) {
        while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (p >= end) break;
        char* next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) return false;
        out->push_back(v);
        p = next;
    }
    return true;
}

// mmap a file and parse its floats (returns false on IO failure).
bool parse_floats_mmap(const std::string& path, std::vector<float>* out) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (::fstat(fd, &st) != 0 || st.st_size == 0) {
        ::close(fd);
        return st.st_size == 0;  // empty file parses to zero floats
    }
    void* m = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    const char* p = static_cast<const char*>(m);
    // strtof may read past the mapping on files not ending in whitespace;
    // copy the tail into a NUL-terminated scratch to stay safe. The split
    // must land on whitespace so no number straddles it.
    size_t n = static_cast<size_t>(st.st_size);
    size_t safe = n > 64 ? n - 64 : 0;
    while (safe > 0 &&
           !std::isspace(static_cast<unsigned char>(p[safe - 1]))) --safe;
    bool ok = parse_floats_buf(p, p + safe, out);
    std::string tail(p + safe, n - safe);
    ok = ok && parse_floats_buf(tail.c_str(), tail.c_str() + tail.size(), out);
    ::munmap(m, n);
    return ok;
}

std::vector<std::string> list_dir_sorted(const std::string& path,
                                         bool dirs_only) {
    std::vector<std::string> out;
    DIR* d = ::opendir(path.c_str());
    if (!d) return out;
    while (dirent* e = ::readdir(d)) {
        std::string name = e->d_name;
        if (name == "." || name == "..") continue;
        struct stat st;
        if (::stat((path + "/" + name).c_str(), &st) != 0) continue;
        bool is_dir = S_ISDIR(st.st_mode);
        if (dirs_only == is_dir) out.push_back(name);
    }
    ::closedir(d);
    std::sort(out.begin(), out.end());
    return out;
}

}  // namespace

extern "C" {

// Parse a whitespace/newline-separated float file.
// Returns number of floats written (<= capacity), -1 on open failure,
// or -2 on a malformed token (np.loadtxt-strictness).
int64_t parse_floats_file(const char* path, float* out, int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf.resize(got);

    int64_t n = 0;
    const char* p = buf.c_str();
    const char* end = p + buf.size();
    while (p < end && n < capacity) {
        while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (p >= end) break;
        char* next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) return -2;  // malformed token: fail loudly
        out[n++] = v;
        p = next;
    }
    return n;
}

// One-pass scanner for the JSON volume schema {beam: {scan: [numbers]}}.
// Collects, in document order:
//   values  — all numbers inside arrays (flattened)
//   lengths — per-array element counts
//   keys    — '\n'-joined key strings in order: beam key, then its scan
//             keys (each scan key owns the next array)
// Returns 0 on success, -1 on open failure, -2 on capacity overflow.
int64_t parse_json_volume_floats(const char* path,
                                 float* values, int64_t value_capacity,
                                 int64_t* lengths, int64_t length_capacity,
                                 char* keys, int64_t key_capacity,
                                 int64_t* n_values, int64_t* n_arrays,
                                 int64_t* n_key_bytes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf.resize(got);

    const char* p = buf.c_str();
    const char* end = p + buf.size();
    int64_t vi = 0, ai = 0, ki = 0;
    int depth = 0;          // object nesting depth
    bool in_array = false;
    int64_t arr_start = 0;

    while (p < end) {
        char c = *p;
        if (c == '"') {
            // scan the string
            const char* s = ++p;
            std::string key;
            while (p < end && *p != '"') {
                if (*p == '\\' && p + 1 < end) { key.push_back(p[1]); p += 2; }
                else { key.push_back(*p); ++p; }
            }
            ++p;  // closing quote
            // lookahead: a key iff followed by ':'
            const char* q = p;
            while (q < end && std::isspace(static_cast<unsigned char>(*q))) ++q;
            if (q < end && *q == ':' && !in_array) {
                int64_t need = static_cast<int64_t>(key.size()) + 1;
                if (ki + need > key_capacity) return -2;
                std::memcpy(keys + ki, key.c_str(), key.size());
                ki += key.size();
                keys[ki++] = '\n';
            }
            continue;
        }
        if (c == '{') { ++depth; ++p; continue; }
        if (c == '}') { --depth; ++p; continue; }
        if (c == '[') {
            in_array = true;
            arr_start = vi;
            ++p;
            continue;
        }
        if (c == ']') {
            in_array = false;
            if (ai >= length_capacity) return -2;
            lengths[ai++] = vi - arr_start;
            ++p;
            continue;
        }
        if (in_array && (c == '-' || c == '+' ||
                         std::isdigit(static_cast<unsigned char>(c)))) {
            char* next = nullptr;
            float v = std::strtof(p, &next);
            if (next != p) {
                if (vi >= value_capacity) return -2;
                values[vi++] = v;
                p = next;
                continue;
            }
        }
        ++p;
    }
    *n_values = vi;
    *n_arrays = ai;
    *n_key_bytes = ki;
    return 0;
}

// Parallel A-scan tree loader: walks root/<beam_dir>/<scan>.txt (two
// levels, directories and files lexicographically sorted), mmaps + parses
// every txt file with a thread pool, and writes:
//   values  — all floats, files concatenated in walk order
//   lengths — per-file float counts
//   paths   — '\n'-joined "<beam_dir>/<file>" relative paths in walk order
// Replaces the reference dataset-build hot loop (np.loadtxt per scan file,
// DS_preprocessing.py:83 — SURVEY.md §3.1) with one native call.
// Returns 0 ok, -1 root unreadable, -2 capacity overflow, -3 file error.
int64_t parse_ascan_tree(const char* root,
                         float* values, int64_t value_capacity,
                         int64_t* lengths, int64_t length_capacity,
                         char* paths, int64_t path_capacity,
                         int64_t* n_files, int64_t* n_values,
                         int64_t* n_path_bytes, int32_t n_threads) {
    std::string base(root);
    std::vector<std::string> beam_dirs = list_dir_sorted(base, true);
    if (beam_dirs.empty()) return -1;

    std::vector<std::string> rel;
    for (const auto& bd : beam_dirs) {
        for (const auto& fn : list_dir_sorted(base + "/" + bd, false)) {
            if (fn.size() > 4 && fn.compare(fn.size() - 4, 4, ".txt") == 0)
                rel.push_back(bd + "/" + fn);
        }
    }
    int64_t nf = static_cast<int64_t>(rel.size());
    if (nf > length_capacity) return -2;

    std::vector<std::vector<float>> parsed(rel.size());
    std::atomic<int64_t> cursor{0};
    std::atomic<bool> failed{false};
    int workers = n_threads > 0 ? n_threads
        : static_cast<int>(std::thread::hardware_concurrency());
    if (workers < 1) workers = 1;
    if (workers > static_cast<int>(rel.size()))
        workers = static_cast<int>(rel.size());
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int t = 0; t < workers; ++t) {
        pool.emplace_back([&] {
            for (;;) {
                int64_t i = cursor.fetch_add(1);
                if (i >= nf || failed.load()) return;
                if (!parse_floats_mmap(base + "/" + rel[i], &parsed[i]))
                    failed.store(true);
            }
        });
    }
    for (auto& th : pool) th.join();
    if (failed.load()) return -3;

    int64_t vi = 0, pi = 0;
    for (int64_t i = 0; i < nf; ++i) {
        int64_t len = static_cast<int64_t>(parsed[i].size());
        if (vi + len > value_capacity) return -2;
        if (pi + static_cast<int64_t>(rel[i].size()) + 1 > path_capacity)
            return -2;
        std::memcpy(values + vi, parsed[i].data(), len * sizeof(float));
        vi += len;
        lengths[i] = len;
        std::memcpy(paths + pi, rel[i].c_str(), rel[i].size());
        pi += rel[i].size();
        paths[pi++] = '\n';
    }
    *n_files = nf;
    *n_values = vi;
    *n_path_bytes = pi;
    return 0;
}

}  // extern "C"
