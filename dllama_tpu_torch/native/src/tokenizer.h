// Native BPE tokenizer over the `.t` vocab file format.
//
// Same binary format and encode/decode semantics as the Python side
// (dllama_tpu_torch/formats/tokenizer_file.py, dllama_tpu_torch/tokenizer/bpe.py), which
// in turn match the reference's loader and greedy-merge encoder
// (distributed-llama/src/tokenizer.cpp:38-229). Pieces are raw byte strings;
// encode does UTF-8 codepoint splitting with byte-fallback (byte b -> id b+3)
// and then repeatedly merges the adjacent pair with the highest vocab score.
#pragma once

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace dllama {

class Tokenizer {
 public:
  explicit Tokenizer(const std::string& path);  // throws on bad file

  int vocab_size() const { return static_cast<int>(vocab_.size()); }
  int bos_id() const { return bos_id_; }
  int eos_id() const { return eos_id_; }

  std::vector<int> Encode(const std::string& text, bool add_bos = true,
                          bool add_eos = false) const;
  // Decode one token given its predecessor (BOS-space strip + <0xXX> bytes).
  std::string DecodePiece(int prev_token, int token) const;
  std::string Decode(const std::vector<int>& tokens) const;

 private:
  int LookupPiece(const std::string& piece) const;

  std::vector<std::string> vocab_;
  std::vector<float> scores_;
  std::unordered_map<std::string, int> index_;
  int bos_id_ = -1;
  int eos_id_ = -1;
  int pad_id_ = -1;
};

}  // namespace dllama
