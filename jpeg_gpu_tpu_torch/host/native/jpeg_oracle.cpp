// Independent libjpeg-turbo oracle: coefficient / raw-YUV / RGB stage cuts.
//
// Role model: the reference's libjpeg vtbl backend
// (its src/jpeg_wrap.c:137-201), which serves QUANT via
// jpeg_read_coefficients and YUV via jpeg_read_raw_data with pinned
// settings (do_fancy_upsampling=FALSE, JDCT_ISLOW).  This shim links the
// system libjpeg-turbo and exposes the same three cuts over ctypes so the
// differential tests compare against libjpeg itself rather than only our
// own encoder's ground truth.
//
// All functions return 0 on success; on failure they return nonzero and
// leave a human-readable message in the caller-supplied err buffer.

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char* msg_out;  // caller buffer, >= 200 bytes
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  if (err->msg_out) {
    char buf[JMSG_LENGTH_MAX];
    (*cinfo->err->format_message)(cinfo, buf);
    std::snprintf(err->msg_out, 200, "%s", buf);
  }
  longjmp(err->jump, 1);
}

void silent_emit(j_common_ptr, int) {}

// Common setup: mem source + header read.  Returns false if setjmp target
// installed by the caller has already fired.
void setup(jpeg_decompress_struct* cinfo, ErrorMgr* jerr, char* err_msg,
           const uint8_t* data, size_t len) {
  cinfo->err = jpeg_std_error(&jerr->pub);
  jerr->pub.error_exit = error_exit;
  jerr->pub.emit_message = silent_emit;  // no stderr warnings
  jerr->msg_out = err_msg;
  jpeg_create_decompress(cinfo);
  jpeg_mem_src(cinfo, const_cast<unsigned char*>(data), (unsigned long)len);
  jpeg_read_header(cinfo, TRUE);
}

}  // namespace

extern "C" {

// Header probe: dims + per-component sampling factors.
int joracle_header(const uint8_t* data, int64_t len, int32_t* out,
                   char* err_msg) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  setup(&cinfo, &jerr, err_msg, data, (size_t)len);
  out[0] = (int32_t)cinfo.image_width;
  out[1] = (int32_t)cinfo.image_height;
  out[2] = cinfo.num_components;
  for (int c = 0; c < cinfo.num_components && c < 4; ++c) {
    out[3 + 2 * c] = cinfo.comp_info[c].h_samp_factor;
    out[4 + 2 * c] = cinfo.comp_info[c].v_samp_factor;
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// QUANT cut (cf. jpeg_wrap.c:137-160): quantized DCT coefficients in
// natural (raster) block order.  out_coef[c] is an int16 buffer of shape
// (vb[c], hb[c], 8, 8) where vb/hb are the MCU-aligned block dims the
// caller computed (= nvmb*vsamp, nhmb*hsamp); rows libjpeg did not
// allocate are left untouched.  out_qt[c] is 64 x uint16 (natural order).
int joracle_coefficients(const uint8_t* data, int64_t len, int ncomps,
                         const int32_t* vb, const int32_t* hb,
                         int16_t** out_coef, uint16_t** out_qt,
                         char* err_msg) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  setup(&cinfo, &jerr, err_msg, data, (size_t)len);
  if (cinfo.num_components != ncomps) {
    std::snprintf(err_msg, 200, "component count mismatch: %d != %d",
                  cinfo.num_components, ncomps);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jvirt_barray_ptr* bars = jpeg_read_coefficients(&cinfo);
  for (int c = 0; c < ncomps; ++c) {
    jpeg_component_info* comp = &cinfo.comp_info[c];
    // The virtual array is allocated MCU-aligned; copy every row the
    // caller asked for that libjpeg holds.
    JDIMENSION rows = (JDIMENSION)vb[c];
    JDIMENSION cols = (JDIMENSION)hb[c];
    for (JDIMENSION r = 0; r < rows; ++r) {
      JBLOCKARRAY rowp = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, bars[c], r, 1, FALSE);
      std::memcpy(out_coef[c] + (size_t)r * cols * 64, rowp[0],
                  (size_t)cols * 64 * sizeof(int16_t));
    }
    if (out_qt && comp->quant_table) {
      for (int k = 0; k < 64; ++k)
        out_qt[c][k] = comp->quant_table->quantval[k];
    }
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// YUV cut (cf. jpeg_wrap.c:161-201): jpeg_read_raw_data with pinned
// settings.  out_plane[c] is a uint8 buffer of (nvmb*vs*8, nhmb*hs*8);
// the caller trims to the true component dims.
int joracle_raw_yuv(const uint8_t* data, int64_t len, int ncomps,
                    const int32_t* plane_h, const int32_t* plane_w,
                    uint8_t** out_plane, char* err_msg) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  setup(&cinfo, &jerr, err_msg, data, (size_t)len);
  cinfo.raw_data_out = TRUE;
  cinfo.do_fancy_upsampling = FALSE;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  if (cinfo.num_components != ncomps) {
    std::snprintf(err_msg, 200, "component count mismatch");
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  int vmax = cinfo.max_v_samp_factor;
  // Row-group pointers, refreshed per iMCU row.
  JSAMPROW rowptrs[4][4 * DCTSIZE];
  JSAMPARRAY planes[4];
  for (int c = 0; c < ncomps; ++c) planes[c] = rowptrs[c];
  JDIMENSION scan = 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    for (int c = 0; c < ncomps; ++c) {
      jpeg_component_info* comp = &cinfo.comp_info[c];
      int vs = comp->v_samp_factor;
      int group_rows = vs * DCTSIZE;
      // Pixel rows of this component already produced.
      JDIMENSION base = scan / vmax * vs * DCTSIZE;
      for (int r = 0; r < group_rows; ++r) {
        JDIMENSION row = base + (JDIMENSION)r;
        // Clamp: last iMCU row may exceed the padded buffer only if the
        // caller under-allocated; plane_h is MCU-aligned so it never does.
        if ((int32_t)row >= plane_h[c]) row = plane_h[c] - 1;
        rowptrs[c][r] = out_plane[c] + (size_t)row * plane_w[c];
      }
    }
    JDIMENSION got = jpeg_read_raw_data(&cinfo, planes,
                                        (JDIMENSION)(vmax * DCTSIZE));
    if (got == 0) break;
    scan += got / DCTSIZE;  // in units of 8-row groups of the luma grid
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// RGB cut: the standard full decode with pinned islow DCT; fancy flag
// selectable so both our exact paths have a libjpeg twin.
int joracle_rgb(const uint8_t* data, int64_t len, int fancy,
                uint8_t* out, int64_t out_stride, char* err_msg) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  setup(&cinfo, &jerr, err_msg, data, (size_t)len);
  cinfo.do_fancy_upsampling = fancy ? TRUE : FALSE;
  cinfo.dct_method = JDCT_ISLOW;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * out_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
