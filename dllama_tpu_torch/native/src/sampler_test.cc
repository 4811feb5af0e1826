// Standalone exit-code test for the native sampler (reference test style:
// main() + asserts, cf. distributed-llama/src/funcs-test.cpp).

#include <cassert>
#include <cmath>
#include <cstdio>
#include <vector>

#include "sampler.h"

int main() {
  // temperature 0 -> argmax, deterministic.
  {
    dllama::Sampler s(0.0f, 0.9f, 7);
    std::vector<float> logits = {0.1f, 2.5f, -1.0f, 2.4f};
    for (int i = 0; i < 10; ++i) assert(s.Sample(logits) == 1);
  }
  // Very peaked distribution: low temperature must pick the peak ~always.
  {
    dllama::Sampler s(0.1f, 0.0f, 42);  // topp=0 disables nucleus filtering
    std::vector<float> logits = {0.f, 10.f, 0.f};
    for (int i = 0; i < 50; ++i) assert(s.Sample(logits) == 1);
  }
  // topp small enough to exclude all but the top token.
  {
    dllama::Sampler s(1.0f, 0.05f, 3);
    std::vector<float> logits = {3.0f, 1.0f, 0.5f, 0.1f};
    for (int i = 0; i < 50; ++i) assert(s.Sample(logits) == 0);
  }
  // High temperature + full nucleus: all tokens reachable, frequencies sane.
  {
    dllama::Sampler s(1.0f, 0.999f, 9);
    std::vector<float> logits = {1.0f, 1.0f, 1.0f, 1.0f};
    std::vector<int> counts(4, 0);
    const int kDraws = 4000;
    for (int i = 0; i < kDraws; ++i) ++counts[s.Sample(logits)];
    for (int c : counts) {
      assert(c > kDraws / 8);  // uniform-ish: each well above 12.5%
      assert(c < kDraws / 2);
    }
  }
  // Seeded reproducibility: same seed -> same stream.
  {
    dllama::Sampler a(0.8f, 0.9f, 123), b(0.8f, 0.9f, 123);
    std::vector<float> logits = {0.3f, 0.7f, 0.9f, 0.2f, 0.5f};
    for (int i = 0; i < 20; ++i) assert(a.Sample(logits) == b.Sample(logits));
  }

  std::printf("sampler_test: OK\n");
  return 0;
}
