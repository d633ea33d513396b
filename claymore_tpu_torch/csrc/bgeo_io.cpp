// Houdini BGEO (version 5) particle writer, host C++.
//
// The port's copy of the BGEO serialiser of
// claymore_tpu/native/src/runtime.cpp (the reference's IO singleton,
// Library/MnSystem/IO/IO.h, driving partio's BGEO writer), so that frame
// dumps leave the interpreter without importing the JAX package.  Its
// sample elimination is csrc/sample_elim.cpp.  Built by g++ with the other
// csrc/*.cpp into one library (ops/_build.py:host_library), loaded with
// ctypes by io/bgeo.py.
//
// The bytes are those of io/bgeo.py:write_bgeo_numpy and of the JAX
// package's writers: big-endian header, the point-attribute dictionary
// (every attribute of Houdini type FLOAT, zero defaults), one record per
// point (x y z, w = 1, the attributes), trailer 0x00 0xff.  Records are
// serialised in chunks straight into a buffer and written as they fill, so
// a 100M-particle frame needs no second copy of itself in memory.
//
// runtime.cpp's job queue (cm_async_write_bgeo, cm_flush) is not copied:
// an asynchronous write runs cm_write_bgeo on the Python IO thread
// (io/async_io.py; ctypes releases the interpreter lock for the call),
// whose flush raises a failed write's error, which runtime.cpp drops.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline unsigned char* put_be32(unsigned char* p, uint32_t v) {
  p[0] = (unsigned char)(v >> 24);
  p[1] = (unsigned char)(v >> 16);
  p[2] = (unsigned char)(v >> 8);
  p[3] = (unsigned char)v;
  return p + 4;
}

inline unsigned char* put_bef32(unsigned char* p, float f) {
  uint32_t v;
  std::memcpy(&v, &f, 4);
  return put_be32(p, v);
}

void append_be32(std::vector<unsigned char>& out, uint32_t v) {
  size_t at = out.size();
  out.resize(at + 4);
  put_be32(out.data() + at, v);
}

void append_be16(std::vector<unsigned char>& out, uint16_t v) {
  out.push_back((unsigned char)(v >> 8));
  out.push_back((unsigned char)v);
}

// Returns 0 on success, 1 if the file cannot be opened, 2 if a write or
// the close fails.
int write_bgeo(const char* path, int64_t n, const float* pos, int n_attrs,
               const char* const* names, const int* widths,
               const float* const* attrs) {
  std::vector<unsigned char> head;
  append_be32(head, 0x4267656f);   // 'Bgeo'
  head.push_back('V');
  append_be32(head, 5);            // version
  append_be32(head, uint32_t(n));  // nPoints
  append_be32(head, 0);            // nPrims
  append_be32(head, 0);            // nPointGroups
  append_be32(head, 0);            // nPrimGroups
  append_be32(head, uint32_t(n_attrs));  // nPointAttrib (position excluded)
  append_be32(head, 0);            // nVertexAttrib
  append_be32(head, 0);            // nPrimAttrib
  append_be32(head, 0);            // nAttrib (detail)
  int64_t rec_words = 4;
  for (int a = 0; a < n_attrs; ++a) {
    uint16_t len = uint16_t(std::strlen(names[a]));
    append_be16(head, len);
    head.insert(head.end(), names[a], names[a] + len);
    append_be16(head, uint16_t(widths[a]));
    append_be32(head, 0);          // Houdini type FLOAT
    for (int k = 0; k < widths[a]; ++k) append_be32(head, 0);  // defaults
    rec_words += widths[a];
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  bool ok = std::fwrite(head.data(), 1, head.size(), f) == head.size();
  const int64_t chunk = 1 << 16;
  std::vector<unsigned char> buf(size_t(chunk * rec_words * 4));
  for (int64_t i0 = 0; ok && i0 < n; i0 += chunk) {
    int64_t i1 = i0 + chunk < n ? i0 + chunk : n;
    unsigned char* p = buf.data();
    for (int64_t i = i0; i < i1; ++i) {
      p = put_bef32(p, pos[i * 3 + 0]);
      p = put_bef32(p, pos[i * 3 + 1]);
      p = put_bef32(p, pos[i * 3 + 2]);
      p = put_bef32(p, 1.0f);      // homogeneous w
      for (int a = 0; a < n_attrs; ++a)
        for (int k = 0; k < widths[a]; ++k) p = put_bef32(p, attrs[a][i * widths[a] + k]);
    }
    size_t bytes = size_t(p - buf.data());
    ok = std::fwrite(buf.data(), 1, bytes, f) == bytes;
  }
  const unsigned char trailer[2] = {0x00, 0xff};
  ok = ok && std::fwrite(trailer, 1, 2, f) == 2;
  ok = (std::fclose(f) == 0) && ok;   // a full disk may show only here
  return ok ? 0 : 2;
}

}  // namespace

extern "C" {

// Writes n points (positions [n, 3] and attributes [n,
// widths[a]], float32, row-major).  Returns 0 on success, 1 if the file
// cannot be opened, 2 if writing it fails.
int cm_write_bgeo(const char* path, int64_t n, const float* positions, int n_attrs,
                  const char* const* names, const int* widths,
                  const float* const* attrs) {
  return write_bgeo(path, n, positions, n_attrs, names, widths, attrs);
}

}  // extern "C"
