// Native BLEU scorer — exact NLTK `sentence_bleu` semantics
// (the reference scores every result table with per-sentence NLTK BLEU,
// DeepSC-GAN/utlis/tools.py:30-43; at sweep scale that Python loop is the
// host-side hot path: 19 SNR x 700+ sentences per eval).
//
// Semantics reproduced bit-for-bit against nltk.translate.bleu_score
// (single reference, SmoothingFunction().method0 default):
//   p_n  = sum_ngram min(count_hyp, count_ref) / max(1, #hyp n-grams)
//   if numerator(p_1) == 0 -> score 0
//   numerator(p_n) == 0    -> p_n := DBL_MIN          (method0)
//   BP   = 1 if hyp_len > ref_len else exp(1 - ref_len/hyp_len)
//          (0 if hyp_len == 0)
//   bleu = BP * exp(sum_n w_n * log p_n)
//
// Sentences arrive as int32 token-id sequences (the Python wrapper maps
// words to ids — identity for this framework's decode output). N-grams are
// hashed into a small open-addressing table; n <= 4.
//
// Build: folded into libtextpipe.so (see native/__init__.py).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxN = 4;

// open-addressing hash map from n-gram (n<=4 int32 ids) to (ref,hyp) counts
struct NgramTable {
  static constexpr int kCap = 4096;  // > 2*31 n-grams per sentence, ample
  uint64_t keys[kCap];
  int32_t ref_cnt[kCap];
  int32_t hyp_cnt[kCap];
  uint64_t used[kCap / 64 + 1];

  void clear() { std::memset(used, 0, sizeof(used)); }

  static uint64_t hash(const int32_t* w, int n) {
    uint64_t h = 1469598103934665603ull ^ (uint64_t)n;
    for (int i = 0; i < n; ++i) {
      h ^= (uint64_t)(uint32_t)w[i] + 0x9E3779B97F4A7C15ull;
      h *= 1099511628211ull;
    }
    return h | 1;  // never 0
  }

  int slot(uint64_t key) {
    int i = (int)(key % kCap);
    while (true) {
      bool occ = used[i >> 6] >> (i & 63) & 1;
      if (!occ) {
        used[i >> 6] |= 1ull << (i & 63);
        keys[i] = key;
        ref_cnt[i] = hyp_cnt[i] = 0;
        return i;
      }
      if (keys[i] == key) return i;
      i = (i + 1) % kCap;
    }
  }
};

double sentence_bleu(const int32_t* ref, int ref_len, const int32_t* hyp,
                     int hyp_len, const double* weights, NgramTable* tab) {
  if (hyp_len == 0) return 0.0;

  double logsum = 0.0;
  for (int n = 1; n <= kMaxN; ++n) {
    int hyp_total = hyp_len - n + 1;
    // count, then clip hyp counts by ref counts
    tab->clear();
    for (int i = 0; i + n <= ref_len; ++i)
      tab->ref_cnt[tab->slot(NgramTable::hash(ref + i, n))]++;
    long long clipped = 0;
    if (hyp_total > 0) {
      // second pass with per-slot hyp counts so min() clips per n-gram
      for (int i = 0; i + n <= hyp_len; ++i)
        tab->hyp_cnt[tab->slot(NgramTable::hash(hyp + i, n))]++;
      for (int i = 0; i + n <= hyp_len; ++i) {
        int s = tab->slot(NgramTable::hash(hyp + i, n));
        if (tab->hyp_cnt[s] > 0) {  // count each distinct slot once
          clipped += tab->ref_cnt[s] < tab->hyp_cnt[s] ? tab->ref_cnt[s]
                                                       : tab->hyp_cnt[s];
          tab->hyp_cnt[s] = 0;
        }
      }
    }
    if (n == 1 && clipped == 0) return 0.0;  // nltk short-circuit
    double p = clipped > 0
                   ? (double)clipped / (double)(hyp_total > 0 ? hyp_total : 1)
                   : DBL_MIN;  // SmoothingFunction.method0
    if (weights[n - 1] != 0.0) logsum += weights[n - 1] * std::log(p);
  }

  double bp = hyp_len > ref_len
                  ? 1.0
                  : std::exp(1.0 - (double)ref_len / (double)hyp_len);
  return bp * std::exp(logsum);
}

}  // namespace

extern "C" {

// Flattened batch: pair i is refs[roff[i]:roff[i+1]] vs hyps[hoff[i]:hoff[i+1]].
// weights: 4 doubles. out: n scores.
int dsc_bleu_batch(const int32_t* refs, const int32_t* roff,
                   const int32_t* hyps, const int32_t* hoff, int n_pairs,
                   const double* weights, double* out) {
  NgramTable* tab = new NgramTable();
  for (int i = 0; i < n_pairs; ++i) {
    out[i] = sentence_bleu(refs + roff[i], roff[i + 1] - roff[i],
                           hyps + hoff[i], hoff[i + 1] - hoff[i], weights,
                           tab);
  }
  delete tab;
  return n_pairs;
}

}  // extern "C"
