// Export-directory manifest: the contract between the exporter
// (dllama_tpu_torch/export_native.py) and the runner (main.cc).
//
// A text manifest, one record per line, space-separated: the header
// "dllama_native_torch 1", the model's vocab and context, the device the
// programs were compiled for, the three AOTInductor packages and the flat
// argument list every program takes first — the weights (byte offsets into
// weights.bin), the two KV caches (zeroed by the runner, then updated in
// place by each program) and the host-fed token and position. The record
// grammar is the JAX package's native manifest's.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace dllama {

enum class ArgKind { kWeight, kCache, kToken, kPos };

struct ArgSpec {
  std::string name;
  ArgKind kind;
  std::string dtype;          // "f32" | "bf16" | "f16" | "f8e4m3fn" | "i32"
  std::vector<int64_t> dims;  // [] for scalars
  int64_t offset = -1;        // byte offset into weights.bin (kWeight only)
  int64_t nbytes = 0;
};

struct OutSpec {
  std::string name;
  std::string kind;  // "logits"
  std::string dtype;
  std::vector<int64_t> dims;
};

struct Manifest {
  int version = 0;
  std::string model_name;
  int64_t vocab_size = 0;
  int64_t seq_len = 0;
  std::string device;        // "cuda" | "cpu": where the packages run
  std::string weights_file;  // relative to the manifest dir
  // The decode step: (inputs...) -> logits f32[vocab].
  std::string package_file;
  // loop_steps decode steps sampled on the device: (inputs..., temperature
  // f32[], topp f32[], seed i32[]) -> tokens i32[loop_steps].
  std::string loop_package_file;
  int64_t loop_steps = 0;
  // The bucketed prompt step: the inputs with the token slot widened to
  // i32[prefill_bucket], then n i32[] (the real count) -> the logits of row
  // n - 1.
  std::string prefill_package_file;
  int64_t prefill_bucket = 0;
  std::vector<ArgSpec> inputs;
  std::vector<OutSpec> outputs;
  std::string dir;  // directory the manifest was loaded from

  std::string path(const std::string& rel) const { return dir + "/" + rel; }
};

// Parses <dir>/manifest.txt. Throws std::runtime_error on malformed input.
Manifest LoadManifest(const std::string& dir);

}  // namespace dllama
