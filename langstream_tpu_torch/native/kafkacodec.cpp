// Native hot-path codec for the Kafka runtime: CRC32C (Castagnoli) and
// record-batch field scanning. The wire protocol lives in Python
// (langstream_tpu_torch/topics/kafka/protocol.py); this file only takes the
// byte-wise inner loops that dominate at high record rates (slice-by-8).
//
// The port's own copy of langstream_tpu/native/kafkacodec.cpp, built by
// langstream_tpu_torch/native/__init__.py with g++ on first use and loaded
// via ctypes; the port has no fallback (a failed build raises).
//
// Reference parity: the reference rides the JVM Kafka client's own
// native-speed CRC (java.util.zip.CRC32C); this is the equivalent for
// the from-scratch client.

#include <cstddef>
#include <cstdint>

namespace {

// slice-by-8 CRC32C tables, generated at load time
uint32_t tables[8][256];
bool initialized = false;

void init_tables() {
    if (initialized) return;
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t crc = i;
        for (int j = 0; j < 8; ++j) {
            crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
        }
        tables[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t crc = tables[0][i];
        for (int t = 1; t < 8; ++t) {
            crc = tables[0][crc & 0xFF] ^ (crc >> 8);
            tables[t][i] = crc;
        }
    }
    initialized = true;
}

}  // namespace

extern "C" {

uint32_t ls_crc32c(const uint8_t* data, size_t length, uint32_t seed) {
    init_tables();
    uint32_t crc = seed ^ 0xFFFFFFFFu;
    // align-insensitive slice-by-8 main loop
    while (length >= 8) {
        uint32_t lo = crc ^ (static_cast<uint32_t>(data[0]) |
                             (static_cast<uint32_t>(data[1]) << 8) |
                             (static_cast<uint32_t>(data[2]) << 16) |
                             (static_cast<uint32_t>(data[3]) << 24));
        uint32_t hi = static_cast<uint32_t>(data[4]) |
                      (static_cast<uint32_t>(data[5]) << 8) |
                      (static_cast<uint32_t>(data[6]) << 16) |
                      (static_cast<uint32_t>(data[7]) << 24);
        crc = tables[7][lo & 0xFF] ^ tables[6][(lo >> 8) & 0xFF] ^
              tables[5][(lo >> 16) & 0xFF] ^ tables[4][lo >> 24] ^
              tables[3][hi & 0xFF] ^ tables[2][(hi >> 8) & 0xFF] ^
              tables[1][(hi >> 16) & 0xFF] ^ tables[0][hi >> 24];
        data += 8;
        length -= 8;
    }
    while (length--) {
        crc = tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    }
    return crc ^ 0xFFFFFFFFu;
}

// Zigzag varint encode into out (caller provides >=10 bytes); returns
// the number of bytes written.
int ls_varint_encode(int64_t value, uint8_t* out) {
    uint64_t zigzag =
        (static_cast<uint64_t>(value) << 1) ^
        static_cast<uint64_t>(value >> 63);
    int n = 0;
    while (zigzag >= 0x80) {
        out[n++] = static_cast<uint8_t>(zigzag) | 0x80;
        zigzag >>= 7;
    }
    out[n++] = static_cast<uint8_t>(zigzag);
    return n;
}

// Zigzag varint decode; writes the value to *value and returns bytes
// consumed, or -1 on truncation/overlong input.
int ls_varint_decode(const uint8_t* data, size_t length, int64_t* value) {
    uint64_t zigzag = 0;
    int shift = 0;
    for (size_t i = 0; i < length && i < 10; ++i) {
        zigzag |= static_cast<uint64_t>(data[i] & 0x7F) << shift;
        if (!(data[i] & 0x80)) {
            *value = static_cast<int64_t>(zigzag >> 1) ^
                     -static_cast<int64_t>(zigzag & 1);
            return static_cast<int>(i) + 1;
        }
        shift += 7;
    }
    return -1;
}

}  // extern "C"
