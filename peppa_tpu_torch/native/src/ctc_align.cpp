// ctc_align.cpp: the CTC Viterbi forced-alignment DP of the port's aligner.
//
// Mirrors peppa_tpu/native/src/ctc_align.cpp, with the same C ABI and the
// same arithmetic: peppa_tpu_torch/preprocess/forced_align.py calls it
// through ctypes (`ctc_forced_align`), and its Python version
// (`_ctc_align_python`) runs the same IEEE f64 compare/add sequence, so
// both give the same labels and score bit for bit.  The DP is O(T * S)
// with S = 2N + 1 interleaved-blank states, a host loop per utterance.
//
// Contract:
//   states s = 0..2N: even = blank, odd = token (s-1)/2;
//   transitions: stay, s-1, and s-2 when s is odd and the token differs from
//   the previous token; ties resolved toward the SMALLEST state step
//   (strict '>' comparisons, as the Python version);
//   end state: argmax over {S-1, S-2} with '>=' favoring S-1;
//   labels[t] = token index emitted at frame t, -1 for blank.
//
// Returns 0 on success, 1 on an unalignable problem (T < N or N == 0),
// 2 on an out-of-range token id.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" int ppk_ctc_align(const double* log_probs, int64_t T, int64_t V,
                             const int32_t* tokens, int64_t N, int32_t blank,
                             int32_t* labels, double* score) {
  if (T <= 0 || N <= 0 || T < N) return 1;
  if (blank < 0 || blank >= V) return 2;
  for (int64_t i = 0; i < N; ++i)
    if (tokens[i] < 0 || tokens[i] >= V) return 2;

  const int64_t S = 2 * N + 1;
  const double NEG = -1e30;
  std::vector<double> prev((size_t)S, NEG), cur((size_t)S);
  // back[0] row is never read (the backtrace assigns labels[t] before
  // following back[t]) — kept for layout symmetry with the Python version
  std::vector<int32_t> back((size_t)T * (size_t)S, 0);

  prev[0] = log_probs[blank];
  prev[1] = log_probs[tokens[0]];
  for (int64_t t = 1; t < T; ++t) {
    const double* row = log_probs + t * V;
    int32_t* bt = back.data() + (size_t)t * S;
    for (int64_t s = 0; s < S; ++s) {
      double best = prev[s];
      int32_t arg = (int32_t)s;
      if (s >= 1 && prev[s - 1] > best) { best = prev[s - 1]; arg = (int32_t)(s - 1); }
      if (s >= 2 && (s & 1) && tokens[(s - 1) / 2] != tokens[(s - 3) / 2] &&
          prev[s - 2] > best) { best = prev[s - 2]; arg = (int32_t)(s - 2); }
      cur[s] = best + row[(s & 1) ? tokens[(s - 1) / 2] : blank];
      bt[s] = arg;
    }
    prev.swap(cur);
  }

  int64_t end = (prev[S - 1] >= prev[S - 2]) ? S - 1 : S - 2;
  *score = prev[end];
  int64_t s = end;
  for (int64_t t = T - 1; t >= 0; --t) {
    labels[t] = (s & 1) ? (int32_t)((s - 1) / 2) : -1;
    if (t > 0) s = back[(size_t)t * S + s];
  }
  return 0;
}
