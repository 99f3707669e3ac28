// Native host-pipeline core of feddat_tpu_torch: a copy of
// feddat_tpu/native/feddat_native.cpp, kept byte for byte the same below
// this comment so both packages' pipelines give the same bits.
//
// GIL-free multithreaded image preprocessing (bilinear resize + normalization
// straight into the batch buffer, and the fused normalize-and-pad of cached
// uint8 images onto a canvas) and a WordPiece tokenizer, exposed through a C
// ABI consumed via ctypes.
//
// Build (feddat_tpu_torch/native/__init__.py does this at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread feddat_native.cpp -o <lib>.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Batched image preprocessing
// ---------------------------------------------------------------------------
// in:  n images, each [h, w, 3] uint8 (contiguous, same size)
// out: n images, each [oh, ow, 3] float32, value = (x/255 - mean[c]) / std[c]
// Bilinear sampling with half-pixel centers (align_corners=False), matching
// PIL/torchvision semantics closely enough for training parity.
void resize_normalize_batch(const uint8_t* in, int64_t n, int64_t h, int64_t w,
                            float* out, int64_t oh, int64_t ow,
                            const float* mean, const float* stddev,
                            int64_t num_threads) {
  const double sy = static_cast<double>(h) / oh;
  const double sx = static_cast<double>(w) / ow;
  const int64_t in_img = h * w * 3;
  const int64_t out_img = oh * ow * 3;

  auto work = [&](int64_t img_begin, int64_t img_end) {
    for (int64_t i = img_begin; i < img_end; ++i) {
      const uint8_t* src = in + i * in_img;
      float* dst = out + i * out_img;
      for (int64_t y = 0; y < oh; ++y) {
        double fy = (y + 0.5) * sy - 0.5;
        fy = std::max(0.0, std::min(fy, static_cast<double>(h - 1)));
        int64_t y0 = static_cast<int64_t>(fy);
        int64_t y1 = std::min(y0 + 1, h - 1);
        double wy = fy - y0;
        for (int64_t x = 0; x < ow; ++x) {
          double fx = (x + 0.5) * sx - 0.5;
          fx = std::max(0.0, std::min(fx, static_cast<double>(w - 1)));
          int64_t x0 = static_cast<int64_t>(fx);
          int64_t x1 = std::min(x0 + 1, w - 1);
          double wx = fx - x0;
          for (int c = 0; c < 3; ++c) {
            double v00 = src[(y0 * w + x0) * 3 + c];
            double v01 = src[(y0 * w + x1) * 3 + c];
            double v10 = src[(y1 * w + x0) * 3 + c];
            double v11 = src[(y1 * w + x1) * 3 + c];
            double top = v00 + (v01 - v00) * wx;
            double bot = v10 + (v11 - v10) * wx;
            double v = (top + (bot - top) * wy) / 255.0;
            dst[(y * ow + x) * 3 + c] =
                static_cast<float>((v - mean[c]) / stddev[c]);
          }
        }
      }
    }
  };

  int64_t nt = std::max<int64_t>(1, std::min(num_threads, n));
  if (nt == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(work, b, e);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Fused canvas finalize: variable-size u8 images -> normalized float32 batch
// ---------------------------------------------------------------------------
// The per-epoch hot path once decoded/resized images are cached: one pass
// u8 -> (x/255 - mean)/std straight into the zero-padded [n, H, W, 3] canvas
// plus the [n, H, W] pixel mask.  The 256-entry LUT is built with the exact
// float32 op sequence numpy uses ((float)p / 255.0f, - mean, / std), so the
// output is bitwise equal to the Python path.
//
// imgs: n pointers to contiguous [h_i, w_i, 3] u8 arrays; hw: [n, 2] int64.
// Images larger than the canvas are top-left cropped (the ViLT canvas rule,
// images.py::process_vilt_image).  mask_out may be null (ALBEF: exact-size
// resize, no mask).
void finalize_canvas_batch(const uint8_t** imgs, const int64_t* hw, int64_t n,
                           float* out, int32_t* mask_out, int64_t H, int64_t W,
                           const float* mean, const float* stddev,
                           int64_t num_threads) {
  float lut[3][256];
  for (int c = 0; c < 3; ++c)
    for (int p = 0; p < 256; ++p)
      lut[c][p] = (static_cast<float>(p) / 255.0f - mean[c]) / stddev[c];

  const int64_t out_img = H * W * 3;
  auto work = [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* src = imgs[i];
      const int64_t h = hw[i * 2], w = hw[i * 2 + 1];
      const int64_t hh = std::min(h, H), ww = std::min(w, W);
      float* dst = out + i * out_img;
      int32_t* msk = mask_out ? mask_out + i * H * W : nullptr;
      for (int64_t y = 0; y < hh; ++y) {
        const uint8_t* srow = src + y * w * 3;
        float* drow = dst + y * W * 3;
        for (int64_t x = 0; x < ww; ++x) {
          drow[x * 3 + 0] = lut[0][srow[x * 3 + 0]];
          drow[x * 3 + 1] = lut[1][srow[x * 3 + 1]];
          drow[x * 3 + 2] = lut[2][srow[x * 3 + 2]];
        }
        if (ww < W) std::fill(drow + ww * 3, drow + W * 3, 0.0f);
        if (msk) {
          int32_t* mrow = msk + y * W;
          std::fill(mrow, mrow + ww, 1);
          if (ww < W) std::fill(mrow + ww, mrow + W, 0);
        }
      }
      if (hh < H) {
        std::fill(dst + hh * W * 3, dst + out_img, 0.0f);
        if (msk) std::fill(msk + hh * W, msk + H * W, 0);
      }
    }
  };
  int64_t nt = std::max<int64_t>(1, std::min(num_threads, n));
  if (nt == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(work, b, e);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// WordPiece tokenizer
// ---------------------------------------------------------------------------
struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk = 1, cls = 2, sep = 3, pad = 0;
  int max_chars_per_word = 100;
};

// vocab_blob: '\n'-joined tokens, id = line index (the vocab.txt convention).
void* wp_create(const char* vocab_blob, int32_t unk_id, int32_t cls_id,
                int32_t sep_id, int32_t pad_id) {
  auto* wp = new WordPiece();
  wp->unk = unk_id;
  wp->cls = cls_id;
  wp->sep = sep_id;
  wp->pad = pad_id;
  std::string blob(vocab_blob);
  size_t start = 0;
  int32_t idx = 0;
  while (start <= blob.size()) {
    size_t end = blob.find('\n', start);
    if (end == std::string::npos) end = blob.size();
    wp->vocab.emplace(blob.substr(start, end - start), idx++);
    if (end == blob.size()) break;
    start = end + 1;
  }
  return wp;
}

void wp_destroy(void* handle) { delete static_cast<WordPiece*>(handle); }

static inline bool is_punct(unsigned char ch) {
  return (ch >= 33 && ch <= 47) || (ch >= 58 && ch <= 64) ||
         (ch >= 91 && ch <= 96) || (ch >= 123 && ch <= 126);
}

static void wordpiece_word(const WordPiece& wp, const std::string& word,
                           std::vector<int32_t>& out) {
  if (static_cast<int>(word.size()) > wp.max_chars_per_word) {
    out.push_back(wp.unk);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string piece = word.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      auto it = wp.vocab.find(piece);
      if (it != wp.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.push_back(wp.unk);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

// ASCII basic-tokenize + WordPiece with HF BertTokenizer parity (the Python
// wrapper routes any text containing non-ASCII bytes through the pure-Python
// tokenizer, so this path only ever sees ASCII):
//   * ASCII control chars (Cc: <0x20 except \t\n\r, and 0x7f) are REMOVED
//     (HF clean_text), \t\n\r count as whitespace;
//   * whole whitespace-delimited tokens matching a never-split special
//     ([PAD]/[UNK]/[CLS]/[SEP]/[MASK]) are kept verbatim;
//   * otherwise lowercase, split punctuation, greedy WordPiece.
// Output: [CLS] + pieces[:max_len-2] + [SEP], padded.  Returns #non-pad.
int32_t wp_encode(void* handle, const char* text, int32_t* out_ids,
                  int32_t max_len) {
  const auto& wp = *static_cast<WordPiece*>(handle);
  static const char* kSpecials[] = {"[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                    "[MASK]"};
  std::vector<int32_t> ids;  // body tokens (no CLS/SEP)
  const int32_t budget = max_len > 2 ? max_len - 2 : 0;  // clamp: max_len<2 must not go negative
  std::string raw;  // whitespace-delimited token, original case
  auto flush_token = [&]() {
    if (raw.empty()) return;
    for (const char* s : kSpecials) {
      if (raw == s) {
        auto it = wp.vocab.find(raw);
        ids.push_back(it != wp.vocab.end() ? it->second : wp.unk);
        raw.clear();
        return;
      }
    }
    // lowercase + split punctuation, WordPiece each run
    std::string word;
    auto flush_word = [&]() {
      if (!word.empty()) {
        wordpiece_word(wp, word, ids);
        word.clear();
      }
    };
    for (unsigned char ch : raw) {
      if (is_punct(ch)) {
        flush_word();
        word.push_back(static_cast<char>(ch));
        flush_word();
      } else {
        word.push_back(static_cast<char>(std::tolower(ch)));
      }
    }
    flush_word();
    raw.clear();
  };
  for (const char* p = text; *p; ++p) {
    unsigned char ch = *p;
    if (ch == '\t' || ch == '\n' || ch == '\r' || ch == ' ') {
      flush_token();
      if (static_cast<int32_t>(ids.size()) >= budget) break;
    } else if (ch < 0x20 || ch == 0x7f) {
      continue;  // control char: removed, does NOT split the word
    } else {
      raw.push_back(static_cast<char>(ch));
    }
  }
  flush_token();
  if (static_cast<int32_t>(ids.size()) > budget) ids.resize(budget);
  std::vector<int32_t> framed;
  framed.reserve(ids.size() + 2);
  framed.push_back(wp.cls);
  framed.insert(framed.end(), ids.begin(), ids.end());
  framed.push_back(wp.sep);
  int32_t n = static_cast<int32_t>(framed.size());
  for (int32_t i = 0; i < max_len; ++i)
    out_ids[i] = i < n ? framed[i] : wp.pad;
  return n;
}

// Batched encode: texts as '\x00'-separated blob with n entries.
void wp_encode_batch(void* handle, const char* texts_blob, int64_t n,
                     int32_t* out_ids, int32_t* out_mask, int32_t max_len,
                     int64_t num_threads) {
  std::vector<const char*> starts(n);
  const char* p = texts_blob;
  for (int64_t i = 0; i < n; ++i) {
    starts[i] = p;
    p += std::strlen(p) + 1;
  }
  auto work = [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      int32_t len = wp_encode(handle, starts[i], out_ids + i * max_len, max_len);
      for (int32_t j = 0; j < max_len; ++j)
        out_mask[i * max_len + j] = j < len ? 1 : 0;
    }
  };
  int64_t nt = std::max<int64_t>(1, std::min(num_threads, n));
  if (nt == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(work, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
