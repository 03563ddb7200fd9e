// Segmented append-only log store — the native core of the durable topic
// runtime ("tpulog"), playing the role Kafka's log layer plays for the
// reference's data plane (langstream-kafka-runtime/.../KafkaTopicConnectionsRuntime.java:53).
//
// One LogStore = one topic partition on disk:
//   <dir>/<base-offset, 20 digits>.log   frames: [u32 len][u32 crc32][payload]
//   <dir>/<base-offset, 20 digits>.idx   u64 little-endian file position per record
//
// The .idx file gives O(1) offset -> file-position lookup; recovery scans the
// last segment's tail and truncates torn writes (crc mismatch / short frame).
//
// The port's own copy of langstream_tpu/native/logstore.cpp, byte for byte
// the same on-disk format. Exposed as a C ABI for ctypes
// (langstream_tpu_torch/native/__init__.py builds it with g++ on first use). All calls are
// serialized per-handle with a mutex; the Python side holds one handle per
// partition.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint32_t kFrameHeader = 8;  // u32 len + u32 crc

struct Segment {
    int64_t base = 0;       // offset of the first record
    int64_t count = 0;      // records in this segment
    std::string log_path;
    std::string idx_path;
};

std::string offset_name(int64_t base, const char* ext) {
    char buf[40];
    std::snprintf(buf, sizeof(buf), "%020lld%s",
                  static_cast<long long>(base), ext);
    return std::string(buf);
}

int64_t file_size(const std::string& path) {
    struct stat st;
    if (stat(path.c_str(), &st) != 0) return -1;
    return st.st_size;
}

struct LogStore {
    std::string dir;
    uint64_t segment_bytes;
    std::vector<Segment> segments;
    // active segment write handles
    FILE* log_fp = nullptr;
    FILE* idx_fp = nullptr;
    int64_t active_log_size = 0;
    std::mutex mu;

    ~LogStore() {
        if (log_fp) fclose(log_fp);
        if (idx_fp) fclose(idx_fp);
    }
};

bool read_index_entry(FILE* fp, int64_t i, uint64_t* pos) {
    if (fseeko(fp, i * 8, SEEK_SET) != 0) return false;
    uint8_t buf[8];
    if (fread(buf, 1, 8, fp) != 8) return false;
    uint64_t v = 0;
    for (int b = 7; b >= 0; --b) v = (v << 8) | buf[b];
    *pos = v;
    return true;
}

void write_u32(uint8_t* out, uint32_t v) {
    out[0] = v & 0xff; out[1] = (v >> 8) & 0xff;
    out[2] = (v >> 16) & 0xff; out[3] = (v >> 24) & 0xff;
}

uint32_t read_u32(const uint8_t* in) {
    return (uint32_t)in[0] | ((uint32_t)in[1] << 8) |
           ((uint32_t)in[2] << 16) | ((uint32_t)in[3] << 24);
}

// Validate the tail of a segment against its index; truncate torn writes.
// Returns the number of valid records.
int64_t recover_segment(const Segment& seg) {
    int64_t isize = file_size(seg.idx_path);
    int64_t lsize = file_size(seg.log_path);
    if (isize < 0 || lsize < 0) return 0;
    int64_t n = isize / 8;
    FILE* ifp = fopen(seg.idx_path.c_str(), "rb");
    FILE* lfp = fopen(seg.log_path.c_str(), "rb");
    if (!ifp || !lfp) {
        if (ifp) fclose(ifp);
        if (lfp) fclose(lfp);
        return 0;
    }
    int64_t valid = 0;
    // Walk back from the end: most recovery cases only lose the last frame.
    for (int64_t i = n - 1; i >= 0; --i) {
        uint64_t pos;
        if (!read_index_entry(ifp, i, &pos)) continue;
        if ((int64_t)pos + kFrameHeader > lsize) continue;
        uint8_t hdr[kFrameHeader];
        if (fseeko(lfp, pos, SEEK_SET) != 0) continue;
        if (fread(hdr, 1, kFrameHeader, lfp) != kFrameHeader) continue;
        uint32_t len = read_u32(hdr);
        uint32_t crc = read_u32(hdr + 4);
        if ((int64_t)pos + kFrameHeader + len > lsize) continue;
        std::vector<uint8_t> payload(len);
        if (len && fread(payload.data(), 1, len, lfp) != len) continue;
        if ((uint32_t)crc32(0, payload.data(), len) != crc) continue;
        valid = i + 1;
        break;
    }
    fclose(ifp);
    fclose(lfp);
    return valid;
}

bool open_active(LogStore* s) {
    if (s->segments.empty()) {
        Segment seg;
        seg.base = 0;
        seg.log_path = s->dir + "/" + offset_name(0, ".log");
        seg.idx_path = s->dir + "/" + offset_name(0, ".idx");
        s->segments.push_back(seg);
    }
    Segment& seg = s->segments.back();
    s->log_fp = fopen(seg.log_path.c_str(), "ab");
    s->idx_fp = fopen(seg.idx_path.c_str(), "ab");
    if (!s->log_fp || !s->idx_fp) return false;
    // Truncate files to the recovered record count (drop torn tail bytes).
    int64_t valid = seg.count;
    FILE* ifp = fopen(seg.idx_path.c_str(), "rb");
    int64_t log_end = 0;
    if (valid > 0 && ifp) {
        uint64_t pos = 0;
        if (read_index_entry(ifp, valid - 1, &pos)) {
            FILE* lfp = fopen(seg.log_path.c_str(), "rb");
            if (lfp) {
                uint8_t hdr[kFrameHeader];
                if (fseeko(lfp, pos, SEEK_SET) == 0 &&
                    fread(hdr, 1, kFrameHeader, lfp) == kFrameHeader) {
                    log_end = pos + kFrameHeader + read_u32(hdr);
                }
                fclose(lfp);
            }
        }
    }
    if (ifp) fclose(ifp);
    if (truncate(seg.idx_path.c_str(), valid * 8) != 0 ||
        truncate(seg.log_path.c_str(), log_end) != 0) {
        return false;
    }
    // reopen after truncate so append positions are correct
    fclose(s->log_fp); fclose(s->idx_fp);
    s->log_fp = fopen(seg.log_path.c_str(), "ab");
    s->idx_fp = fopen(seg.idx_path.c_str(), "ab");
    s->active_log_size = log_end;
    return s->log_fp && s->idx_fp;
}

}  // namespace

extern "C" {

LogStore* ls_open(const char* dir, uint64_t segment_bytes) {
    LogStore* s = new LogStore();
    s->dir = dir;
    s->segment_bytes = segment_bytes ? segment_bytes : (64ull << 20);
    mkdir(dir, 0777);  // EEXIST is fine
    DIR* d = opendir(dir);
    if (!d) { delete s; return nullptr; }
    std::vector<int64_t> bases;
    while (dirent* e = readdir(d)) {
        std::string name = e->d_name;
        if (name.size() == 24 && name.substr(20) == ".log") {
            bases.push_back(strtoll(name.substr(0, 20).c_str(), nullptr, 10));
        }
    }
    closedir(d);
    std::sort(bases.begin(), bases.end());
    for (int64_t base : bases) {
        Segment seg;
        seg.base = base;
        seg.log_path = s->dir + "/" + offset_name(base, ".log");
        seg.idx_path = s->dir + "/" + offset_name(base, ".idx");
        seg.count = recover_segment(seg);
        s->segments.push_back(seg);
    }
    if (!open_active(s)) { delete s; return nullptr; }
    return s;
}

int64_t ls_append(LogStore* s, const uint8_t* payload, uint32_t len) {
    std::lock_guard<std::mutex> lock(s->mu);
    Segment* seg = &s->segments.back();
    if (s->active_log_size > 0 &&
        (uint64_t)s->active_log_size + kFrameHeader + len > s->segment_bytes) {
        // roll a new segment
        fclose(s->log_fp); fclose(s->idx_fp);
        Segment next;
        next.base = seg->base + seg->count;
        next.log_path = s->dir + "/" + offset_name(next.base, ".log");
        next.idx_path = s->dir + "/" + offset_name(next.base, ".idx");
        s->segments.push_back(next);
        seg = &s->segments.back();
        s->log_fp = fopen(seg->log_path.c_str(), "ab");
        s->idx_fp = fopen(seg->idx_path.c_str(), "ab");
        s->active_log_size = 0;
        if (!s->log_fp || !s->idx_fp) return -1;
    }
    uint64_t pos = (uint64_t)s->active_log_size;
    uint8_t hdr[kFrameHeader];
    write_u32(hdr, len);
    write_u32(hdr + 4, (uint32_t)crc32(0, payload, len));
    if (fwrite(hdr, 1, kFrameHeader, s->log_fp) != kFrameHeader) return -1;
    if (len && fwrite(payload, 1, len, s->log_fp) != len) return -1;
    uint8_t ibuf[8];
    for (int b = 0; b < 8; ++b) ibuf[b] = (pos >> (8 * b)) & 0xff;
    if (fwrite(ibuf, 1, 8, s->idx_fp) != 8) return -1;
    fflush(s->log_fp);
    fflush(s->idx_fp);
    s->active_log_size += kFrameHeader + len;
    seg->count += 1;
    return seg->base + seg->count - 1;
}

int64_t ls_end_offset(LogStore* s) {
    std::lock_guard<std::mutex> lock(s->mu);
    const Segment& seg = s->segments.back();
    return seg.base + seg.count;
}

int64_t ls_base_offset(LogStore* s) {
    std::lock_guard<std::mutex> lock(s->mu);
    return s->segments.front().base;
}

// Read up to max_records frames starting at `offset` into `buf` as
// [u32 len][payload]... Returns the number of records read, writes the
// total bytes used to *bytes_out. Returns -2 if the first record alone
// does not fit in buflen (caller should grow the buffer).
int64_t ls_read_batch(LogStore* s, int64_t offset, int64_t max_records,
                      uint8_t* buf, uint64_t buflen, uint64_t* bytes_out) {
    std::lock_guard<std::mutex> lock(s->mu);
    *bytes_out = 0;
    if (s->segments.empty()) return 0;
    // fsync-less readers: flush writer buffers so reads see appended data
    if (s->log_fp) fflush(s->log_fp);
    if (s->idx_fp) fflush(s->idx_fp);
    int64_t n_read = 0;
    uint64_t used = 0;
    while (n_read < max_records) {
        // locate segment containing `offset`
        const Segment* seg = nullptr;
        for (auto it = s->segments.rbegin(); it != s->segments.rend(); ++it) {
            if (it->base <= offset) { seg = &*it; break; }
        }
        if (!seg || offset >= seg->base + seg->count) break;
        FILE* ifp = fopen(seg->idx_path.c_str(), "rb");
        FILE* lfp = fopen(seg->log_path.c_str(), "rb");
        if (!ifp || !lfp) {
            if (ifp) fclose(ifp);
            if (lfp) fclose(lfp);
            break;
        }
        bool progressed = false;
        while (n_read < max_records && offset < seg->base + seg->count) {
            uint64_t pos;
            if (!read_index_entry(ifp, offset - seg->base, &pos)) break;
            uint8_t hdr[kFrameHeader];
            if (fseeko(lfp, pos, SEEK_SET) != 0) break;
            if (fread(hdr, 1, kFrameHeader, lfp) != kFrameHeader) break;
            uint32_t len = read_u32(hdr);
            if (used + 4 + len > buflen) {
                fclose(ifp); fclose(lfp);
                if (n_read == 0) return -2;
                *bytes_out = used;
                return n_read;
            }
            write_u32(buf + used, len);
            if (len && fread(buf + used + 4, 1, len, lfp) != len) break;
            used += 4 + len;
            offset += 1;
            n_read += 1;
            progressed = true;
        }
        fclose(ifp);
        fclose(lfp);
        if (!progressed) break;
    }
    *bytes_out = used;
    return n_read;
}

int ls_sync(LogStore* s) {
    std::lock_guard<std::mutex> lock(s->mu);
    if (fflush(s->log_fp) != 0) return -1;
    if (fflush(s->idx_fp) != 0) return -1;
    if (fsync(fileno(s->log_fp)) != 0) return -1;
    if (fsync(fileno(s->idx_fp)) != 0) return -1;
    return 0;
}

void ls_close(LogStore* s) {
    delete s;
}

}  // extern "C"
