// The port's order-preserving key encoder (host code, no CUDA): bulk
// primary-key encoding for the pk-index builds of storage/columnstore.py.
// The byte format is storage/keys.py's exactly: 8-byte big-endian
// sign-offset ints; 0x00-escaped, 0x00 0x01-terminated bytes; IEEE754
// bit-flip floats. tests/test_torch_native_keyenc.py holds the two to
// each other byte for byte.
//
// Build: native/__init__.py compiles this with g++ at first use into
// _build/ (content-addressed, ctypes ABI); a failed build raises
// NativeBuildError, there is no fallback.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// scalar encodings
// ---------------------------------------------------------------------------

static inline void put_u64_be(uint8_t *dst, uint64_t u) {
  for (int i = 7; i >= 0; --i) {
    dst[i] = (uint8_t)(u & 0xff);
    u >>= 8;
  }
}

// int64 -> 8 bytes big-endian with sign offset (keys.py encode_int)
void keyenc_int64(int64_t v, uint8_t *out) {
  put_u64_be(out, (uint64_t)v + (1ULL << 63));
}

// float64 -> 8 bytes with the order-preserving bit flip
void keyenc_float64(double v, uint8_t *out) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  if (u & (1ULL << 63))
    u = ~u;
  else
    u |= (1ULL << 63);
  put_u64_be(out, u);
}

// escaped+terminated bytes; returns encoded length (<= 2*len + 2)
int64_t keyenc_bytes(const uint8_t *src, int64_t len, uint8_t *out) {
  int64_t o = 0;
  for (int64_t i = 0; i < len; ++i) {
    if (src[i] == 0x00) {
      out[o++] = 0x00;
      out[o++] = 0xff;
    } else {
      out[o++] = src[i];
    }
  }
  out[o++] = 0x00;
  out[o++] = 0x01;
  return o;
}

// ---------------------------------------------------------------------------
// batch key encoders (prefix + one pk column per key)
// ---------------------------------------------------------------------------

// n keys of (prefix + int64): fixed stride. out must hold
// n * (prefix_len + 8); out_offsets gets n+1 entries.
void keyenc_batch_int(const uint8_t *prefix, int64_t prefix_len,
                      const int64_t *vals, int64_t n, uint8_t *out,
                      int64_t *out_offsets) {
  const int64_t stride = prefix_len + 8;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t *dst = out + i * stride;
    std::memcpy(dst, prefix, (size_t)prefix_len);
    keyenc_int64(vals[i], dst + prefix_len);
    out_offsets[i] = i * stride;
  }
  out_offsets[n] = n * stride;
}

// n keys of (prefix + escaped bytes). Inputs are a concatenated utf-8
// buffer with n+1 offsets. out must hold n*prefix_len + 2*data_len +
// 2*n bytes (worst case). Returns total bytes written.
int64_t keyenc_batch_bytes(const uint8_t *prefix, int64_t prefix_len,
                           const uint8_t *data,
                           const int64_t *data_offsets, int64_t n,
                           uint8_t *out, int64_t *out_offsets) {
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    out_offsets[i] = o;
    std::memcpy(out + o, prefix, (size_t)prefix_len);
    o += prefix_len;
    o += keyenc_bytes(data + data_offsets[i],
                      data_offsets[i + 1] - data_offsets[i], out + o);
  }
  out_offsets[n] = o;
  return o;
}

}  // extern "C"
