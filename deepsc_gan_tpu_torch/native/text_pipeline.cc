// Native text-normalization pipeline for the Europarl preprocessing path.
//
// Implements, in one C pass per line, the exact semantics of the Python
// reference pipeline (DeepSC-GAN/dataset/preprocess_text.py:24-39, mirrored
// by deepsc_gan_tpu_torch/data/preprocess.py:normalize_string):
//   1. NFD unicode fold -> ASCII (drop combining marks; table-driven for
//      U+0080..U+024F, which covers the Europarl corpus; any other
//      non-ASCII codepoint passes through and is swept by step 4)
//   2. strip <...> tag spans
//   3. insert a space before each of [!.?]
//   4. replace every run of chars outside [a-zA-Z.!?] with ONE space
//   5. collapse whitespace runs to a single space
//   6. lowercase
//
// The Python regex pipeline runs these as 5 full passes per line; this does
// one fused pass over UTF-8 bytes. Exposed via a minimal C ABI consumed by
// ctypes (deepsc_gan_tpu_torch/native/__init__.py) — no pybind11 dependency.
//
// Build: g++ -O2 -shared -fPIC text_pipeline.cc bleu.cc -o libtextpipe.so
// (done by the Python wrapper on first use, into
// deepsc_gan_tpu_torch/_build/).

#include <cstdint>
#include <cstring>

#include "fold_table.inc"

namespace {

// codepoint -> ASCII fold (0 = not in table)
char fold_lookup(uint32_t cp) {
  // table is sorted by codepoint; binary search
  int lo = 0, hi = (int)(sizeof(kFoldTable) / sizeof(kFoldTable[0])) - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (kFoldTable[mid].cp == cp) return kFoldTable[mid].base[0];
    if (kFoldTable[mid].cp < cp) lo = mid + 1; else hi = mid - 1;
  }
  return 0;
}

// decode one UTF-8 codepoint; advances *i; returns 0xFFFD on malformed
uint32_t utf8_next(const unsigned char* s, int n, int* i) {
  unsigned char c = s[*i];
  if (c < 0x80) { (*i)++; return c; }
  int len = (c >= 0xF0) ? 4 : (c >= 0xE0) ? 3 : (c >= 0xC0) ? 2 : 1;
  if (len == 1 || *i + len > n) { (*i)++; return 0xFFFD; }
  uint32_t cp = c & (0x7F >> len);
  for (int k = 1; k < len; ++k) cp = (cp << 6) | (s[*i + k] & 0x3F);
  *i += len;
  return cp;
}

inline bool is_keep_alpha(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
inline bool is_punct_keep(char c) { return c == '!' || c == '.' || c == '?'; }

}  // namespace

extern "C" {

// Normalize `in` (UTF-8, length n) into `out` (capacity cap).
// Returns the output length, or -1 if cap is too small.
// Matches the Python pipeline byte-for-byte on the covered range.
int dsc_normalize(const unsigned char* in, int n, char* out, int cap) {
  // Stage A: fold to ASCII + strip tags, into a scratch view processed
  // streamingly. We fuse stages: for each input codepoint produce 0..2
  // output chars of the FINAL string directly.
  int o = 0;
  bool pending_space = false;  // a collapsed separator waiting to be emitted
  bool emitted_any = false;

  auto emit = [&](char c) -> bool {
    if (o >= cap) return false;
    out[o++] = c;
    return true;
  };
  auto emit_sep = [&]() { pending_space = true; };
  auto flush_sep = [&]() -> bool {
    // Python's step-4/5 regexes emit a space for separator runs anywhere,
    // including leading/trailing positions; reproduce exactly.
    if (pending_space) {
      if (!emit(' ')) return false;
      pending_space = false;
    }
    return true;
  };

  for (int i = 0; i < n;) {
    // tag stripping (step 2): `<[^>]*>` — shortest match to the next '>';
    // an unmatched '<' is NOT a tag and falls through as a separator char
    if (in[i] == '<') {
      const void* close = memchr(in + i + 1, '>', n - i - 1);
      if (close != nullptr) {
        i = (int)((const unsigned char*)close - in) + 1;
        continue;
      }
    }
    uint32_t cp = utf8_next(in, n, &i);
    char c;
    if (cp < 0x80) {
      c = (char)cp;
    } else {
      char f = fold_lookup(cp);
      if (f == 0) {
        // unfoldable non-ASCII -> separator (step 4 would eat it)
        emit_sep();
        continue;
      }
      c = f;
    }
    if (is_keep_alpha(c)) {
      if (!flush_sep()) return -1;
      // lowercase (step 6)
      if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
      if (!emit(c)) return -1;
      emitted_any = true;
    } else if (is_punct_keep(c)) {
      // step 3 inserts a space before !.? — that space then joins any
      // separator run; net effect: exactly one space before the mark
      pending_space = true;
      if (!flush_sep()) return -1;
      if (!emit(c)) return -1;
      emitted_any = true;
    } else {
      // anything else is a separator run (step 4)
      emit_sep();
    }
  }
  // trailing separator: Python's regexes leave a trailing space when the
  // line ends in a separator run — reproduce
  (void)emitted_any;
  if (pending_space && !emit(' ')) return -1;
  return o;
}

// Batch API: normalize `count` lines given as a contiguous UTF-8 buffer
// with offsets (offsets[count] = total length). Output goes to `out`
// with out_offsets filled the same way. Returns total output length or -1.
int dsc_normalize_batch(const unsigned char* buf, const int* offsets,
                        int count, char* out, int out_cap,
                        int* out_offsets) {
  int o = 0;
  for (int s = 0; s < count; ++s) {
    out_offsets[s] = o;
    int len = offsets[s + 1] - offsets[s];
    int w = dsc_normalize(buf + offsets[s], len, out + o, out_cap - o);
    if (w < 0) return -1;
    o += w;
  }
  out_offsets[count] = o;
  return o;
}

// Pad token-id lists to (count, maxlen) int32, post-padding with pad_id —
// the dataloader's pad_sequences in native code for large corpora.
// tokens: concatenated ids; offsets: per-list offsets (offsets[count]=total).
void dsc_pad_sequences(const int* tokens, const int* offsets, int count,
                       int maxlen, int pad_id, int* out) {
  for (int s = 0; s < count; ++s) {
    int len = offsets[s + 1] - offsets[s];
    if (len > maxlen) len = maxlen;
    const int* src = tokens + offsets[s];
    int* dst = out + (long)s * maxlen;
    int k = 0;
    for (; k < len; ++k) dst[k] = src[k];
    for (; k < maxlen; ++k) dst[k] = pad_id;
  }
}

}  // extern "C"
