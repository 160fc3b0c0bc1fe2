// gaitlab_torch native frame loader: multi-threaded PNG/JPEG batch decode.
//
// The port's own copy of gaitlab's native loader. The reference feeds the
// model from DataLoader worker processes that call cv2.imread per frame;
// worker processes exist there because Python decode holds the GIL. Here
// the decode loop is C++ with the GIL released, fanned out over a thread
// pool, writing RGB pixels straight into a caller-provided buffer (a numpy
// array, or a pinned torch tensor's memory, ready for an asynchronous copy
// to the card).
//
// Exposed via the CPython C API (no pybind11):
//   _gaitloader.decode_batch(paths: list[str], out_buffer, height, width,
//                            n_threads) -> int (frames decoded)
//   _gaitloader.image_size(path) -> (height, width)
//
// Build: gaitlab_torch/pipeline/loader.py compiles this with g++ -lpng
// -ljpeg at first use.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int height = 0;
  int width = 0;
  std::vector<unsigned char> rgb;  // H*W*3
  std::string error;
  bool ok = false;
};

bool has_suffix(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++) {
    char a = s[s.size() - n + i];
    char b = suf[i];
    if (tolower(a) != tolower(b)) return false;
  }
  return true;
}

// ---------------------------------------------------------------- PNG ----
void decode_png(const std::string& path, Image* img) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) { img->error = "cannot open " + path; return; }
  unsigned char header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp); img->error = "not a png: " + path; return;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp); img->error = "libpng init failed"; return;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp); img->error = "libpng decode failed: " + path; return;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type,
               nullptr, nullptr, nullptr);
  // normalize anything to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  img->height = (int)h;
  img->width = (int)w;
  img->rgb.resize((size_t)h * w * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = img->rgb.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  img->ok = true;
}

// --------------------------------------------------------------- JPEG ----
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void decode_jpeg(const std::string& path, Image* img) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) { img->error = "cannot open " + path; return; }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp); img->error = "libjpeg decode failed: " + path; return;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img->height = (int)cinfo.output_height;
  img->width = (int)cinfo.output_width;
  img->rgb.resize((size_t)img->height * img->width * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row =
        img->rgb.data() + (size_t)cinfo.output_scanline * img->width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  img->ok = true;
}

void decode_any(const std::string& path, Image* img) {
  if (has_suffix(path, ".png")) decode_png(path, img);
  else if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    decode_jpeg(path, img);
  else img->error = "unsupported image type: " + path;
}

// ------------------------------------------------------------- module ----

PyObject* py_decode_batch(PyObject*, PyObject* args) {
  PyObject* path_list;
  Py_buffer out;
  int height, width, n_threads;
  if (!PyArg_ParseTuple(args, "Ow*iii", &path_list, &out, &height, &width,
                        &n_threads))
    return nullptr;

  Py_ssize_t n = PyList_Size(path_list);
  std::vector<std::string> paths;
  paths.reserve(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PyList_GetItem(path_list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) { PyBuffer_Release(&out); return nullptr; }
    paths.emplace_back(s);
  }
  size_t frame_bytes = (size_t)height * width * 3;
  if ((size_t)out.len < frame_bytes * (size_t)n) {
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    return nullptr;
  }
  unsigned char* dst = static_cast<unsigned char*>(out.buf);

  std::string first_error;
  std::atomic<long> next(0);
  std::atomic<bool> failed(false);

  Py_BEGIN_ALLOW_THREADS
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > (int)n) workers = (int)n;
  std::vector<std::thread> pool;
  std::mutex err_mu;
  for (int t = 0; t < workers; t++) {
    pool.emplace_back([&]() {
      while (true) {
        long i = next.fetch_add(1);
        if (i >= (long)n || failed.load()) break;
        Image img;
        decode_any(paths[i], &img);
        if (!img.ok || img.height != height || img.width != width) {
          std::lock_guard<std::mutex> lk(err_mu);
          if (first_error.empty()) {
            first_error = img.ok
                ? ("size mismatch at " + paths[i])
                : img.error;
          }
          failed.store(true);
          break;
        }
        memcpy(dst + frame_bytes * (size_t)i, img.rgb.data(), frame_bytes);
      }
    });
  }
  for (auto& th : pool) th.join();
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&out);
  if (failed.load()) {
    PyErr_SetString(PyExc_RuntimeError, first_error.c_str());
    return nullptr;
  }
  return PyLong_FromSsize_t(n);
}

PyObject* py_image_size(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  Image img;
  std::string p(path);
  Py_BEGIN_ALLOW_THREADS
  decode_any(p, &img);
  Py_END_ALLOW_THREADS
  if (!img.ok) {
    PyErr_SetString(PyExc_RuntimeError, img.error.c_str());
    return nullptr;
  }
  return Py_BuildValue("(ii)", img.height, img.width);
}

PyMethodDef methods[] = {
    {"decode_batch", py_decode_batch, METH_VARARGS,
     "decode_batch(paths, out_buffer, height, width, n_threads) -> n"},
    {"image_size", py_image_size, METH_VARARGS,
     "image_size(path) -> (height, width)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_gaitloader",
    "multi-threaded PNG/JPEG batch decoder", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__gaitloader(void) {
  return PyModule_Create(&moduledef);
}
