// Exit-code unit test for the manifest parser (the exporter<->runner
// contract), in the reference's standalone-binary test style
// (distributed-llama/src/quants-test.cpp pattern): writes a synthetic
// manifest to a temp dir, parses it and asserts every field, including the
// warn-don't-abort handling of keys the parser does not know.
#include <cassert>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <stdexcept>
#include <string>

#include "manifest.h"

namespace {

std::string TempDir() {
  const char* tmp = std::getenv("TMPDIR");
  std::string tmpl = std::string(tmp != nullptr && *tmp ? tmp : "/tmp") +
                     "/dllama_manifest_test_XXXXXX";
  const char* dir = mkdtemp(tmpl.data());
  assert(dir != nullptr);
  return dir;
}

void Write(const std::string& dir, const std::string& text) {
  std::ofstream f(dir + "/manifest.txt");
  f << text;
}

bool Throws(const std::string& dir) {
  try {
    dllama::LoadManifest(dir);
  } catch (const std::exception&) {
    return true;
  }
  return false;
}

}  // namespace

int main() {
  const std::string dir = TempDir();
  Write(dir,
        "dllama_native_torch 1\n"
        "# caches are updated in place\n"
        "model tiny\n"
        "vocab_size 96\n"
        "seq_len 32\n"
        "device cpu\n"
        "weights_file weights.bin\n"
        "export_file model_export.pt2\n"  // unknown to this parser: warn
        "package_file model.pt2\n"
        "loop_package_file model_loop.pt2\n"
        "loop_steps 32\n"
        "prefill_package_file model_prefill.pt2\n"
        "prefill_bucket 32\n"
        "input w.0 weight f32 0 64 2 4 4\n"
        "input cache.k cache f32 -1 128 3 2 4 4\n"
        "input cache.v cache f32 -1 128 3 2 4 4\n"
        "input token token i32 -1 4 1 1\n"
        "input pos pos i32 -1 4 0\n"
        "output logits logits f32 1 96\n");
  dllama::Manifest m = dllama::LoadManifest(dir);

  assert(m.version == 1);
  assert(m.model_name == "tiny");
  assert(m.vocab_size == 96 && m.seq_len == 32);
  assert(m.device == "cpu");
  assert(m.weights_file == "weights.bin");
  assert(m.package_file == "model.pt2");
  assert(m.loop_package_file == "model_loop.pt2" && m.loop_steps == 32);
  assert(m.prefill_package_file == "model_prefill.pt2" && m.prefill_bucket == 32);

  assert(m.inputs.size() == 5);
  assert(m.inputs[0].kind == dllama::ArgKind::kWeight && m.inputs[0].offset == 0 &&
         m.inputs[0].nbytes == 64 && m.inputs[0].dims.size() == 2 &&
         m.inputs[0].dims[1] == 4);
  assert(m.inputs[1].kind == dllama::ArgKind::kCache && m.inputs[1].dims.size() == 3);
  assert(m.inputs[3].kind == dllama::ArgKind::kToken);
  assert(m.inputs[4].kind == dllama::ArgKind::kPos && m.inputs[4].dims.empty());
  assert(m.outputs.size() == 1);
  assert(m.outputs[0].kind == "logits" && m.outputs[0].dims.size() == 1 &&
         m.outputs[0].dims[0] == 96);
  assert(m.path("x.bin") == dir + "/x.bin");

  // rejected: no inputs/outputs; the JAX package's header; an unknown device
  const std::string dir2 = TempDir();
  Write(dir2, "dllama_native_torch 1\ndevice cpu\n");
  assert(Throws(dir2));
  Write(dir2, "dllama_native 1\ndevice cpu\ninput pos pos i32 -1 4 0\n"
              "output logits logits f32 1 96\n");
  assert(Throws(dir2));
  Write(dir2, "dllama_native_torch 1\ndevice tpu\ninput pos pos i32 -1 4 0\n"
              "output logits logits f32 1 96\n");
  assert(Throws(dir2));

  std::printf("manifest_test: OK\n");
  return 0;
}
