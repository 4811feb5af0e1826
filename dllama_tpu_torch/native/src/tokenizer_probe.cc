// Tiny probe used by tests/test_torch_export_native.py to cross-check the C++ tokenizer
// against the Python one: prints space-separated token ids for argv[2]
// encoded with the vocab at argv[1] (BOS added, matching encode defaults).
#include <cstdio>
#include <string>
#include <vector>

#include "tokenizer.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: tokenizer-probe <vocab.t> [text]\n");
    return 2;
  }
  try {
    dllama::Tokenizer tok(argv[1]);
    const std::string text = argc > 2 ? argv[2] : "";
    std::vector<int> ids = tok.Encode(text, /*add_bos=*/true);
    for (size_t i = 0; i < ids.size(); ++i)
      std::printf("%s%d", i ? " " : "", ids[i]);
    std::printf("\n");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "%s\n", e.what());
    return 1;
  }
}
