#include "manifest.h"

#include <cstdio>
#include <fstream>
#include <sstream>
#include <stdexcept>

namespace dllama {
namespace {

ArgKind ParseKind(const std::string& s) {
  if (s == "weight") return ArgKind::kWeight;
  if (s == "cache") return ArgKind::kCache;
  if (s == "token") return ArgKind::kToken;
  if (s == "pos") return ArgKind::kPos;
  throw std::runtime_error("manifest: unknown input kind " + s);
}

int64_t PositiveInt(std::istringstream& ss, const std::string& line) {
  int64_t v = 0;
  if (!(ss >> v) || v <= 0) throw std::runtime_error("manifest: bad line: " + line);
  return v;
}

}  // namespace

Manifest LoadManifest(const std::string& dir) {
  Manifest m;
  m.dir = dir;
  std::ifstream f(dir + "/manifest.txt");
  if (!f) throw std::runtime_error("cannot open " + dir + "/manifest.txt");

  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string key;
    ss >> key;
    if (key == "dllama_native_torch") {
      if (!(ss >> m.version))
        throw std::runtime_error("manifest: bad version line: " + line);
    } else if (key == "model") {
      ss >> m.model_name;
    } else if (key == "vocab_size") {
      m.vocab_size = PositiveInt(ss, line);
    } else if (key == "seq_len") {
      m.seq_len = PositiveInt(ss, line);
    } else if (key == "device") {
      ss >> m.device;
    } else if (key == "weights_file") {
      ss >> m.weights_file;
    } else if (key == "package_file") {
      ss >> m.package_file;
    } else if (key == "loop_package_file") {
      ss >> m.loop_package_file;
    } else if (key == "loop_steps") {
      m.loop_steps = PositiveInt(ss, line);
    } else if (key == "prefill_package_file") {
      ss >> m.prefill_package_file;
    } else if (key == "prefill_bucket") {
      m.prefill_bucket = PositiveInt(ss, line);
    } else if (key == "step_export_file" || key == "loop_export_file" ||
               key == "prefill_export_file") {
      // the exported programs, for Python (torch.export.load); not run here
    } else if (key == "input") {
      // input <name> <kind> <dtype> <offset> <nbytes> <ndims> <dims...>
      ArgSpec a;
      std::string kind;
      size_t ndims = 0;
      ss >> a.name >> kind >> a.dtype >> a.offset >> a.nbytes >> ndims;
      if (!ss) throw std::runtime_error("manifest: bad input line: " + line);
      a.kind = ParseKind(kind);
      a.dims.resize(ndims);
      for (size_t i = 0; i < ndims; ++i) ss >> a.dims[i];
      if (!ss) throw std::runtime_error("manifest: bad input line: " + line);
      m.inputs.push_back(std::move(a));
    } else if (key == "output") {
      // output <name> <kind> <dtype> <ndims> <dims...>
      OutSpec o;
      size_t ndims = 0;
      ss >> o.name >> o.kind >> o.dtype >> ndims;
      o.dims.resize(ndims);
      for (size_t i = 0; i < ndims; ++i) ss >> o.dims[i];
      if (!ss) throw std::runtime_error("manifest: bad output line: " + line);
      m.outputs.push_back(std::move(o));
    } else {
      // a newer exporter may add optional records (the exported programs'
      // file names are such): warn, do not abort
      std::fprintf(stderr, "manifest: ignoring unknown key %s\n", key.c_str());
    }
  }
  if (m.version != 1) throw std::runtime_error("manifest: unsupported version");
  if (m.inputs.empty() || m.outputs.empty())
    throw std::runtime_error("manifest: no inputs/outputs");
  if (m.device != "cuda" && m.device != "cpu")
    throw std::runtime_error("manifest: device must be cuda or cpu, got '" + m.device + "'");
  return m;
}

}  // namespace dllama
