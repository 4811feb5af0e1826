#include "sampler.h"

#include <algorithm>
#include <cmath>
#include <numeric>

namespace dllama {

float Sampler::NextUniform() {
  // xorshift64* — same spirit as the reference's xorshift rng
  // (distributed-llama/src/utils.cpp:53-64), 64-bit variant.
  state_ ^= state_ >> 12;
  state_ ^= state_ << 25;
  state_ ^= state_ >> 27;
  const uint64_t r = state_ * 0x2545F4914F6CDD1DULL;
  return static_cast<float>(r >> 40) / static_cast<float>(1ULL << 24);
}

int Sampler::Sample(const std::vector<float>& logits) {
  const size_t n = logits.size();
  if (temperature_ <= 0.0f) {
    return static_cast<int>(
        std::max_element(logits.begin(), logits.end()) - logits.begin());
  }

  // softmax(logits / temperature), numerically stable
  std::vector<float> probs(n);
  const float max_logit = *std::max_element(logits.begin(), logits.end());
  double sum = 0.0;
  for (size_t i = 0; i < n; ++i) {
    probs[i] = std::exp((logits[i] - max_logit) / temperature_);
    sum += probs[i];
  }
  for (float& p : probs) p = static_cast<float>(p / sum);

  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  const bool use_topp = topp_ > 0.0f && topp_ < 1.0f;
  if (use_topp) {
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return probs[a] > probs[b]; });
  }

  const float u = NextUniform();
  if (!use_topp) {
    float cdf = 0.0f;
    for (size_t i = 0; i < n; ++i) {
      cdf += probs[i];
      if (u < cdf) return static_cast<int>(i);
    }
    return static_cast<int>(n - 1);
  }

  // Nucleus: keep tokens while the mass *before* them is < topp (the
  // crossing token is included), then renormalize and draw.
  float mass = 0.0f;
  size_t keep = 0;
  for (; keep < n; ++keep) {
    if (mass >= topp_) break;
    mass += probs[order[keep]];
  }
  float cdf = 0.0f;
  const float target = u * mass;
  for (size_t i = 0; i < keep; ++i) {
    cdf += probs[order[i]];
    if (target < cdf) return order[i];
  }
  return order[keep - 1];
}

}  // namespace dllama
