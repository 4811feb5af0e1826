// Host-side token sampler: greedy argmax / temperature / top-p nucleus.
//
// Same semantics as the Python sampler (dllama_tpu_torch/runtime/sampler.py) and
// the reference Sampler (distributed-llama/src/tokenizer.cpp:231-356):
// temperature 0 -> argmax; otherwise softmax(logits/temperature) and either
// a plain multinomial draw or nucleus sampling keeping the smallest
// descending-probability prefix whose cumulative mass exceeds top-p
// (inclusive of the crossing token). xorshift-seeded for reproducible runs.
#pragma once

#include <cstdint>
#include <vector>

namespace dllama {

class Sampler {
 public:
  Sampler(float temperature, float topp, uint64_t seed)
      : temperature_(temperature), topp_(topp), state_(seed ? seed : 1) {}

  // logits: f32[vocab]. Returns the sampled token id.
  int Sample(const std::vector<float>& logits);

 private:
  float NextUniform();  // [0, 1)

  float temperature_;
  float topp_;
  uint64_t state_;
};

}  // namespace dllama
