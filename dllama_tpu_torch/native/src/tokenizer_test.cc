// Standalone exit-code test for the native tokenizer, in the reference's
// test style (main() + asserts, distributed-llama/src/funcs-test.cpp pattern).
// Builds a tiny .t vocab on disk, checks encode/decode round-trips match the
// Python tokenizer's semantics (tests/test_tokenizer.py covers the same
// cases on the Python side; tests/test_torch_export_native.py cross-checks them).

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

#include "tokenizer.h"

namespace {

// Writes a vocab where ids 0-2 are specials, 3-258 are byte tokens, then
// pieces with scores enabling "he", "hell", "hello" merges.
std::string WriteTestVocab() {
  const char* tmp = std::getenv("TMPDIR");
  const std::string path =
      std::string(tmp != nullptr && *tmp ? tmp : "/tmp") + "/dllama_native_test.t";
  struct Piece {
    std::string text;
    float score;
  };
  std::vector<Piece> pieces;
  pieces.push_back({"<unk>", 0.f});
  pieces.push_back({"<s>", 0.f});
  pieces.push_back({"</s>", 0.f});
  for (int b = 0; b < 256; ++b) {
    char buf[8];
    std::snprintf(buf, sizeof(buf), "<0x%02X>", b);
    pieces.push_back({buf, 0.f});
  }
  pieces.push_back({" ", -1.f});       // 259: dummy-prefix space
  pieces.push_back({"h", -2.f});       // 260
  pieces.push_back({"e", -2.f});       // 261
  pieces.push_back({"l", -2.f});       // 262
  pieces.push_back({"o", -2.f});       // 263
  pieces.push_back({"he", -1.5f});     // 264
  pieces.push_back({"hel", -1.4f});    // 265
  pieces.push_back({"hell", -1.2f});   // 266
  pieces.push_back({"hello", -1.0f});  // 267
  pieces.push_back({" hello", -0.5f}); // 268

  std::ofstream f(path, std::ios::binary);
  const uint32_t magic = 0x567123, n = static_cast<uint32_t>(pieces.size());
  uint32_t max_len = 0;
  for (const Piece& p : pieces)
    max_len = std::max<uint32_t>(max_len, p.text.size());
  const int32_t bos = 1, eos = 2, pad = -1;
  f.write(reinterpret_cast<const char*>(&magic), 4);
  f.write(reinterpret_cast<const char*>(&n), 4);
  f.write(reinterpret_cast<const char*>(&max_len), 4);
  f.write(reinterpret_cast<const char*>(&bos), 4);
  f.write(reinterpret_cast<const char*>(&eos), 4);
  f.write(reinterpret_cast<const char*>(&pad), 4);
  for (const Piece& p : pieces) {
    const int32_t len = static_cast<int32_t>(p.text.size());
    f.write(reinterpret_cast<const char*>(&p.score), 4);
    f.write(reinterpret_cast<const char*>(&len), 4);
    f.write(p.text.data(), len);
  }
  return path;
}

}  // namespace

int main() {
  const std::string path = WriteTestVocab();
  dllama::Tokenizer tok(path);

  assert(tok.vocab_size() == 269);
  assert(tok.bos_id() == 1);
  assert(tok.eos_id() == 2);

  // "hello" -> BOS, " hello" (dummy space merges with the word)
  {
    std::vector<int> ids = tok.Encode("hello", /*add_bos=*/true);
    assert(ids.size() == 2);
    assert(ids[0] == 1);
    assert(ids[1] == 268);
  }
  // Unknown codepoint falls back to byte tokens (id = byte + 3).
  {
    std::vector<int> ids = tok.Encode("z", /*add_bos=*/false);
    // dummy space + byte('z')
    assert(ids.size() == 2);
    assert(ids[0] == 259);
    assert(ids[1] == static_cast<int>('z') + 3);
  }
  // Decode strips the BOS-adjacent leading space and maps byte tokens.
  {
    std::vector<int> ids = {1, 267};
    assert(tok.Decode(ids) == "hello");
    std::vector<int> ids2 = {1, 267, static_cast<int>('!') + 3};
    assert(tok.Decode(ids2) == "hello!");
  }
  // add_eos appends EOS; Decode hides it.
  {
    std::vector<int> ids = tok.Encode("hello", true, true);
    assert(ids.back() == 2);
    assert(tok.Decode(ids) == "hello");
  }
  // Multi-byte UTF-8 codepoint survives a byte-fallback round-trip.
  {
    const std::string text = "h\xC3\xA9";  // "hé"
    std::vector<int> ids = tok.Encode(text, false);
    std::string out = tok.Decode(ids);
    assert(out.find("h") != std::string::npos);
    assert(out.find("\xC3\xA9") != std::string::npos);
  }

  std::printf("tokenizer_test: OK\n");
  return 0;
}
