// dllama-native-torch — the C++ runner of a model exported by
// `python -m dllama_tpu_torch.export_native`.
//
// The counterpart of the JAX package's PJRT runner (native/src/main.cc) on
// libtorch: it loads the three AOTInductor packages the exporter compiled
// (the decode step, the fused decode loop and the bucketed prefill) with
// torch::inductor::AOTIModelPackageLoader, reads weights.bin once into
// tensors on the manifest's device, passes them to every program, and runs
// the reference's generate loop (distributed-llama/src/apps/dllama/dllama.cpp:14-92)
// with the same prompt walk, chunk loop and tail as the JAX runner, and its
// stdout and stderr lines. No Python runs.
//
// Usage:
//   dllama-native-torch generate --export-dir DIR [--tokenizer T.t]
//     [--prompt "..."] [--steps N] [--temperature F] [--topp F] [--seed N]

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "manifest.h"
#include "sampler.h"
#include "tokenizer.h"

namespace dllama {
namespace {

double NowMs() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Args {
  std::string mode;
  std::string export_dir;
  std::string tokenizer;
  std::string prompt = "Hello";
  int steps = 32;
  float temperature = 0.8f;
  float topp = 0.9f;
  uint64_t seed = 12345;

  static Args Parse(int argc, char** argv) {
    if (argc < 2) throw std::runtime_error("usage: dllama-native-torch <generate|inference>");
    Args a;
    a.mode = argv[1];
    for (int i = 2; i < argc; i += 2) {
      const std::string k = argv[i];
      if (i + 1 >= argc) throw std::runtime_error("flag " + k + " is missing its value");
      const std::string v = argv[i + 1];
      if (k == "--export-dir") a.export_dir = v;
      else if (k == "--tokenizer") a.tokenizer = v;
      else if (k == "--prompt") a.prompt = v;
      else if (k == "--steps") a.steps = std::stoi(v);
      else if (k == "--temperature") a.temperature = std::stof(v);
      else if (k == "--topp") a.topp = std::stof(v);
      else if (k == "--seed") a.seed = std::stoull(v);
      else throw std::runtime_error("unknown flag " + k);
    }
    if (a.export_dir.empty()) throw std::runtime_error("--export-dir required");
    return a;
  }
};

at::ScalarType DType(const std::string& name) {
  if (name == "f32") return at::kFloat;
  if (name == "bf16") return at::kBFloat16;
  if (name == "f16") return at::kHalf;
  if (name == "f8e4m3fn") return at::kFloat8_e4m3fn;
  if (name == "i32") return at::kInt;
  throw std::runtime_error("manifest: unknown dtype " + name);
}

using Loader = torch::inductor::AOTIModelPackageLoader;

std::unique_ptr<Loader> LoadPackage(const Manifest& m, const std::string& file,
                                    c10::DeviceIndex index) {
  if (file.empty())
    throw std::runtime_error("manifest names no compiled package (exported with --no-aot?)");
  return std::make_unique<Loader>(m.path(file), "model", false, 1, index);
}

int Generate(const Args& args) {
  Manifest m = LoadManifest(args.export_dir);
  const bool cuda = m.device == "cuda";
  if (cuda && !at::hasCUDA())
    throw std::runtime_error("the export is for cuda and no CUDA device is available");
  const at::Device dev = cuda ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);
  std::fprintf(stderr, "💡 device: %s\n", m.device.c_str());

  const double t_load0 = NowMs();
  const c10::DeviceIndex index = cuda ? 0 : -1;
  std::unique_ptr<Loader> step = LoadPackage(m, m.package_file, index);
  std::unique_ptr<Loader> loop = LoadPackage(m, m.loop_package_file, index);
  std::unique_ptr<Loader> prefill = LoadPackage(m, m.prefill_package_file, index);
  std::fprintf(stderr, "⏩ fused %lld-step decode loop, %lld-token batched prefill\n",
               static_cast<long long>(m.loop_steps), static_cast<long long>(m.prefill_bucket));
  std::fprintf(stderr, "🕒 programs ready in %.0f ms\n", NowMs() - t_load0);

  // weights read once, straight into host tensors, and uploaded; args_t
  // mirrors m.inputs
  const double t_weights0 = NowMs();
  std::vector<at::Tensor> args_t(m.inputs.size());
  int token_idx = -1, pos_idx = -1;
  int64_t weight_bytes = 0;
  {
    const std::string path = m.path(m.weights_file);
    std::ifstream blob(path, std::ios::binary | std::ios::ate);
    if (!blob) throw std::runtime_error("cannot open " + path);
    const int64_t blob_size = static_cast<int64_t>(blob.tellg());
    for (size_t i = 0; i < m.inputs.size(); ++i) {
      const ArgSpec& in = m.inputs[i];
      const at::TensorOptions opts = at::TensorOptions().dtype(DType(in.dtype));
      switch (in.kind) {
        case ArgKind::kWeight: {
          if (in.offset < 0 || in.offset + in.nbytes > blob_size)
            throw std::runtime_error("weight " + in.name + " out of range");
          at::Tensor host = at::empty(in.dims, opts);
          if (host.nbytes() != static_cast<size_t>(in.nbytes))
            throw std::runtime_error("weight " + in.name + " has the wrong size");
          blob.seekg(in.offset);
          if (!blob.read(static_cast<char*>(host.data_ptr()), in.nbytes))
            throw std::runtime_error("short read of weight " + in.name);
          args_t[i] = cuda ? host.to(dev) : host;
          weight_bytes += in.nbytes;
          break;
        }
        case ArgKind::kCache:
          args_t[i] = at::zeros(in.dims, opts.device(dev));
          break;
        case ArgKind::kToken:
          token_idx = static_cast<int>(i);
          break;
        case ArgKind::kPos:
          pos_idx = static_cast<int>(i);
          break;
      }
    }
  }
  if (token_idx < 0 || pos_idx < 0) throw std::runtime_error("manifest missing token/pos inputs");
  if (m.outputs.empty() || m.outputs[0].kind != "logits")
    throw std::runtime_error("manifest output 0 must be logits");
  std::fprintf(stderr, "⏩ loaded %lld MB of weights in %.0f ms\n",
               static_cast<long long>(weight_bytes >> 20), NowMs() - t_weights0);

  Tokenizer tok(args.tokenizer.empty() ? m.path("tokenizer.t") : args.tokenizer);
  Sampler sampler(args.temperature, args.topp, args.seed);
  std::vector<int> prompt_tokens = tok.Encode(args.prompt, /*add_bos=*/true);
  const int n_prompt = static_cast<int>(prompt_tokens.size());
  const int S = static_cast<int>(m.seq_len);
  if (n_prompt > S)
    throw std::runtime_error("prompt of " + std::to_string(n_prompt) +
                             " tokens exceeds seq_len " + std::to_string(S));

  auto i32 = [&](const std::vector<int32_t>& v, bool scalar) {
    at::Tensor host = at::from_blob(const_cast<int32_t*>(v.data()),
                                    {static_cast<int64_t>(v.size())}, at::kInt);
    if (scalar) host = host.reshape({});
    return host.to(dev, /*non_blocking=*/false, /*copy=*/true);
  };
  auto f32 = [&](float v) {
    return at::full({}, v, at::TensorOptions().dtype(at::kFloat).device(dev));
  };
  // the program's inputs: the manifest's list with this call's token span
  // and position, then the extra trailing scalars; the caches are updated
  // in place
  auto run = [&](Loader& program, const std::vector<int32_t>& toks, int pos_val,
                 std::vector<at::Tensor> extra) {
    std::vector<at::Tensor> inputs(args_t);
    inputs[token_idx] = i32(toks, false);
    inputs[pos_idx] = i32({pos_val}, true);
    for (at::Tensor& e : extra) inputs.push_back(std::move(e));
    return program.run(inputs);
  };
  std::vector<float> logits(static_cast<size_t>(m.vocab_size));
  auto pull_logits = [&](const at::Tensor& t) {
    at::Tensor host = t.to(at::kCPU, at::kFloat).contiguous();
    if (host.numel() != m.vocab_size) throw std::runtime_error("logits of the wrong size");
    std::memcpy(logits.data(), host.data_ptr<float>(), logits.size() * sizeof(float));
  };

  int token = prompt_tokens.empty() ? tok.bos_id() : prompt_tokens[0];
  double infer_ms_total = 0, gen_ms_total = 0;
  std::vector<int> produced;
  int pos = 0;
  auto emit = [&](int next) {
    const std::string piece = tok.DecodePiece(token, next);
    std::fwrite(piece.data(), 1, piece.size(), stdout);
    token = next;
    produced.push_back(next);
  };

  // the first sample comes from position n_prompt-1, the last usable one
  // from seq_len-1: at most seq_len - n_prompt + 1 tokens
  int remaining = std::min(args.steps, S - n_prompt + 1);
  bool eos = false;

  // Prompt phase: all n_prompt positions in ceil(n_prompt/bucket) prefill
  // dispatches, the first generated token sampled from the last one's
  // logits. Buckets near the context end restart at seq_len - bucket:
  // re-fed positions rewrite identical K/V, so every prompt costs
  // ceil(T/bucket). Without room for a bucket (or with a one-token prompt)
  // the prompt walks one step dispatch per position.
  const double t_prompt0 = NowMs();
  int n_prompt_dispatches = 0;
  const int PB = static_cast<int>(m.prefill_bucket);
  const bool use_prefill = n_prompt > 1 && remaining > 0 && PB <= S;
  if (use_prefill) {
    while (pos < n_prompt) {
      const int start = std::min(pos, S - PB);
      const int take = std::min(n_prompt - start, PB);
      std::vector<int32_t> tok_host(static_cast<size_t>(PB), 0);
      for (int i = 0; i < take; ++i) tok_host[i] = prompt_tokens[start + i];
      std::vector<at::Tensor> outs = run(*prefill, tok_host, start, {i32({take}, true)});
      pos = start + take;
      ++n_prompt_dispatches;
      if (pos == n_prompt) pull_logits(outs[0]);
    }
  } else {
    for (; pos + 1 < n_prompt; ++pos) {
      run(*step, {token}, pos, {});
      token = prompt_tokens[pos + 1];
      ++n_prompt_dispatches;
    }
  }
  if (n_prompt > 1)
    std::fprintf(stderr, "📄 prompt: %d tokens in %d dispatches, %.0f ms\n", n_prompt,
                 n_prompt_dispatches, NowMs() - t_prompt0);

  if (use_prefill) {
    // first token straight from the prefill logits; its time carries the
    // whole prompt phase, like the reference's first generated token
    token = prompt_tokens[n_prompt - 1];
    emit(sampler.Sample(logits));
    std::fflush(stdout);
    --remaining;
    const double dt = NowMs() - t_prompt0;
    gen_ms_total += dt;
    infer_ms_total += dt;
    std::fprintf(stderr, "🔶 first token from prefill logits (G %4.0f ms)\n", dt);
    if (token == tok.eos_id()) eos = true;
  }

  // Decode phase: fused chunks while a whole chunk is wanted and fits in the
  // context, single steps for the tail. A chunk always runs loop_steps
  // positions; unconsumed slots are rewritten before any later query
  // attends them.
  const int N = static_cast<int>(m.loop_steps);
  int n_chunks = 0;
  if (remaining <= 0 && !use_prefill && pos < S) {
    // --steps 0: still feed the final prompt position, never sample
    run(*step, {token}, pos, {});
    ++pos;
  }
  while (remaining > 0 && !eos && pos < S) {
    const double t0 = NowMs();
    if (remaining >= N && pos + N <= S) {
      const int32_t seed = static_cast<int32_t>(
          (args.seed + 1000003ull * static_cast<uint64_t>(n_chunks)) & 0x7fffffff);
      std::vector<at::Tensor> outs =
          run(*loop, {token}, pos, {f32(args.temperature), f32(args.topp), i32({seed}, true)});
      at::Tensor chunk = outs[0].to(at::kCPU).contiguous();
      const double t_infer = NowMs() - t0;
      ++n_chunks;
      int consumed = 0;
      for (int i = 0; i < N && consumed < remaining; ++i) {
        emit(chunk.data_ptr<int32_t>()[i]);
        ++consumed;
        if (token == tok.eos_id()) {
          eos = true;
          break;
        }
      }
      std::fflush(stdout);
      remaining -= consumed;
      pos += consumed;
      infer_ms_total += t_infer;
      gen_ms_total += NowMs() - t0;
      std::fprintf(stderr, "🔶 chunk %d: %d tok, G %.3f ms I %.3f ms (%.3f ms/token)\n",
                   n_chunks, consumed, NowMs() - t0, t_infer,
                   consumed > 0 ? (NowMs() - t0) / consumed : 0.0);
    } else {
      pull_logits(run(*step, {token}, pos, {})[0]);
      const double t_infer = NowMs() - t0;
      emit(sampler.Sample(logits));
      std::fflush(stdout);
      --remaining;
      infer_ms_total += t_infer;
      gen_ms_total += NowMs() - t0;
      std::fprintf(stderr, "🔶 G %.3f ms I %.3f ms T %.3f ms | pos %d\n", NowMs() - t0,
                   t_infer, NowMs() - t0 - t_infer, pos);
      ++pos;
      if (token == tok.eos_id()) eos = true;
    }
  }

  std::printf("\nToken ids:          ");
  for (int id : produced) std::printf(" %d", id);
  std::printf("\n");
  if (!produced.empty()) {
    const double gen_ms = std::max(gen_ms_total, 1e-3);
    const int generated = static_cast<int>(produced.size());
    std::printf("Generated tokens:    %d\n", generated);
    std::printf("Avg tokens / second: %.2f\n", 1000.0 * generated / gen_ms);
    std::printf("Avg generation time: %.3f ms\n", gen_ms / generated);
    std::printf("Avg inference time:  %.3f ms\n", infer_ms_total / generated);
  }
  return 0;
}

}  // namespace
}  // namespace dllama

int main(int argc, char** argv) {
  try {
    dllama::Args args = dllama::Args::Parse(argc, argv);
    if (args.mode == "generate" || args.mode == "inference") return dllama::Generate(args);
    std::fprintf(stderr, "unknown mode: %s\n", args.mode.c_str());
    return 2;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "💥 %s\n", e.what());
    return 1;
  }
}
