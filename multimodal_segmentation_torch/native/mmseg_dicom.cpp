// Minimal DICOM reader for the CHAOS MR data path.
//
// The reference ingests DICOM via pydicom (loaders/dcm_contour_utils.py:9-34:
// pixel_array + PixelSpacing + SpacingBetweenSlices). This native reader
// covers the subset those files use — DICOM Part 10 files, explicit or
// implicit VR little endian, uncompressed 8/16-bit grayscale PixelData —
// so the framework's CHAOS pipeline has no hard dependency on pydicom.
//
// Exposed as a C ABI consumed through ctypes
// (multimodal_segmentation_tpu/data/dicom_native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  bool ok(size_t k) const { return off + k <= n; }
  uint16_t u16() {
    uint16_t v = static_cast<uint16_t>(p[off] | (p[off + 1] << 8));
    off += 2;
    return v;
  }
  uint32_t u32() {
    uint32_t v = static_cast<uint32_t>(p[off]) |
                 (static_cast<uint32_t>(p[off + 1]) << 8) |
                 (static_cast<uint32_t>(p[off + 2]) << 16) |
                 (static_cast<uint32_t>(p[off + 3]) << 24);
    off += 4;
    return v;
  }
};

bool vr_has_long_length(const char vr[2]) {
  // VRs with 2-byte reserved + 4-byte length in explicit VR encoding.
  static const char* longs[] = {"OB", "OW", "OF", "SQ", "UT", "UN"};
  for (auto* s : longs)
    if (vr[0] == s[0] && vr[1] == s[1]) return true;
  return false;
}

bool looks_explicit(const uint8_t* q) {
  // Heuristic: bytes 4..5 of the first element are an ASCII VR.
  char a = static_cast<char>(q[4]), b = static_cast<char>(q[5]);
  return a >= 'A' && a <= 'Z' && b >= 'A' && b <= 'Z';
}

}  // namespace

extern "C" {

// Parse a DICOM file.
//   pixels_out: caller buffer of max_pixels uint16 (may be null to query)
//   meta_out:   [rows, cols, bits_allocated, pixel_representation,
//                bits_stored, high_bit]
//   spacing_out:[row_spacing_mm, col_spacing_mm, spacing_between_slices_mm]
//   rescale_out:[RescaleSlope, RescaleIntercept] (modality LUT; defaults
//               1.0 / 0.0 when the tags are absent, as for CHAOS MR)
// Returns 0 on success, negative error codes otherwise.
int mmseg_dicom_read(const char* path, uint16_t* pixels_out, int max_pixels,
                     int32_t* meta_out, double* spacing_out,
                     double* rescale_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  Reader r{buf.data(), buf.size()};

  // Part 10 preamble
  if (r.n > 132 && std::memcmp(buf.data() + 128, "DICM", 4) == 0) {
    r.off = 132;
  }

  // VR-ness of the BODY: decided by TransferSyntaxUID (0002,0010) when a
  // file-meta group is present ("1.2.840.10008.1.2" = implicit VR LE),
  // else by the byte heuristic at the first body element. Headerless
  // files start with the body, so seed from the heuristic.
  bool explicit_vr = r.ok(8) && looks_explicit(buf.data() + r.off);
  bool body_vr_decided = false;
  std::string transfer_syntax;

  int rows = 0, cols = 0, bits = 16, pixrep = 0;
  int bits_stored = 0, high_bit = -1;
  double sp_row = 1.0, sp_col = 1.0, sp_slice = 1.0;
  double rs_slope = 1.0, rs_intercept = 0.0;
  const uint8_t* pixel_data = nullptr;
  uint32_t pixel_len = 0;

  while (r.ok(8)) {
    size_t elem_start = r.off;
    uint16_t group = r.u16();
    uint16_t elem = r.u16();
    if (group != 0x0002 && !body_vr_decided) {
      // First body element: fix the body encoding.
      if (!transfer_syntax.empty()) {
        explicit_vr = transfer_syntax != "1.2.840.10008.1.2";
      } else {
        explicit_vr = looks_explicit(buf.data() + elem_start);
      }
      body_vr_decided = true;
    }
    uint32_t len;
    char vr[2] = {0, 0};
    bool elem_explicit = explicit_vr;
    // File-meta group (0002) is always explicit VR little endian.
    if (group == 0x0002) elem_explicit = true;

    if (elem_explicit) {
      vr[0] = static_cast<char>(buf[r.off]);
      vr[1] = static_cast<char>(buf[r.off + 1]);
      r.off += 2;
      if (vr_has_long_length(vr)) {
        r.off += 2;  // reserved
        if (!r.ok(4)) break;
        len = r.u32();
      } else {
        len = r.u16();
      }
    } else {
      if (!r.ok(4)) break;
      len = r.u32();
    }

    if (group == 0x7FE0 && elem == 0x0010) {
      if (len == 0xFFFFFFFF) return -3;  // encapsulated/compressed: unsupported
      if (!r.ok(len)) return -4;
      pixel_data = buf.data() + r.off;
      pixel_len = len;
      r.off += len;
      continue;
    }

    if (len == 0xFFFFFFFF) {
      // Undefined-length SQ: skip items until SequenceDelimitationItem.
      while (r.ok(8)) {
        uint16_t g2 = r.u16(), e2 = r.u16();
        uint32_t l2 = r.u32();
        if (g2 == 0xFFFE && e2 == 0xE0DD) break;
        if (l2 != 0xFFFFFFFF) r.off += l2;
      }
      continue;
    }
    if (!r.ok(len)) break;

    const char* val = reinterpret_cast<const char*>(buf.data() + r.off);
    if (group == 0x0002 && elem == 0x0010) {
      transfer_syntax.assign(val, len);
      // strip trailing NUL/space padding
      while (!transfer_syntax.empty() &&
             (transfer_syntax.back() == '\0' || transfer_syntax.back() == ' '))
        transfer_syntax.pop_back();
    } else if (group == 0x0028 && elem == 0x0010 && len >= 2) {
      rows = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x0011 && len >= 2) {
      cols = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x0100 && len >= 2) {
      bits = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x0103 && len >= 2) {
      pixrep = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x0101 && len >= 2) {
      bits_stored = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x0102 && len >= 2) {
      high_bit = buf[r.off] | (buf[r.off + 1] << 8);
    } else if (group == 0x0028 && elem == 0x1052) {
      rs_intercept = std::atof(std::string(val, len).c_str());
    } else if (group == 0x0028 && elem == 0x1053) {
      rs_slope = std::atof(std::string(val, len).c_str());
    } else if (group == 0x0028 && elem == 0x0030) {
      // PixelSpacing: "row\col" decimal strings
      std::string s(val, len);
      size_t sep = s.find('\\');
      if (sep != std::string::npos) {
        sp_row = std::atof(s.substr(0, sep).c_str());
        sp_col = std::atof(s.substr(sep + 1).c_str());
      }
    } else if (group == 0x0018 && elem == 0x0088) {
      sp_slice = std::atof(std::string(val, len).c_str());
    }
    r.off += len;
  }

  if (!rows || !cols || !pixel_data) return -5;

  if (bits_stored <= 0 || bits_stored > bits) bits_stored = bits;
  if (high_bit < 0) high_bit = bits_stored - 1;

  if (meta_out) {
    meta_out[0] = rows;
    meta_out[1] = cols;
    meta_out[2] = bits;
    meta_out[3] = pixrep;
    meta_out[4] = bits_stored;
    meta_out[5] = high_bit;
  }
  if (spacing_out) {
    spacing_out[0] = sp_row;
    spacing_out[1] = sp_col;
    spacing_out[2] = sp_slice;
  }
  if (rescale_out) {
    rescale_out[0] = rs_slope;
    rescale_out[1] = rs_intercept;
  }

  if (pixels_out) {
    int npix = rows * cols;
    if (npix > max_pixels) return -6;
    if (bits == 16) {
      if (pixel_len < static_cast<uint32_t>(npix) * 2) return -7;
      std::memcpy(pixels_out, pixel_data, static_cast<size_t>(npix) * 2);
    } else if (bits == 8) {
      if (pixel_len < static_cast<uint32_t>(npix)) return -7;
      for (int i = 0; i < npix; ++i) pixels_out[i] = pixel_data[i];
    } else {
      return -8;
    }
  }
  return 0;
}

}  // extern "C"
