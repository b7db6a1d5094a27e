// Native edit-distance core for CER/WER scoring (a copy of the JAX
// package's native/edit_distance.cpp, kept beside the port's CUDA sources).
// Sequences arrive as int32 code points (the host converts unicode); bound
// with ctypes by mtl_tpu_torch/utils/edit_distance.py.
//
// Built at first use by mtl_tpu_torch/utils/host_native.py:
// g++ -O3 -shared -fPIC edit_distance.cpp -o libedit_distance-<hash>.so

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Classic two-row Levenshtein distance between a[0..na) and b[0..nb).
int32_t edit_distance(const int32_t* a, int32_t na, const int32_t* b,
                      int32_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int32_t> prev(nb + 1), cur(nb + 1);
  for (int32_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int32_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int32_t j = 1; j <= nb; ++j) {
      const int32_t sub = prev[j - 1] + (ai != b[j - 1]);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Batched variant: flattened ragged arrays with offsets, writes per-pair
// distances into out[0..n).
void edit_distance_batch(const int32_t* a_flat, const int32_t* a_off,
                         const int32_t* b_flat, const int32_t* b_off,
                         int32_t n, int32_t* out) {
  for (int32_t i = 0; i < n; ++i) {
    out[i] = edit_distance(a_flat + a_off[i], a_off[i + 1] - a_off[i],
                           b_flat + b_off[i], b_off[i + 1] - b_off[i]);
  }
}

}  // extern "C"
