#include "tokenizer.h"

#include <cstdio>
#include <cstring>
#include <fstream>
#include <stdexcept>

namespace dllama {
namespace {
constexpr uint32_t kMagic = 0x567123;

template <typename T>
T ReadScalar(std::ifstream& f) {
  T v;
  f.read(reinterpret_cast<char*>(&v), sizeof(v));
  if (!f) throw std::runtime_error("tokenizer file truncated");
  return v;
}
}  // namespace

Tokenizer::Tokenizer(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open tokenizer " + path);
  if (ReadScalar<uint32_t>(f) != kMagic)
    throw std::runtime_error("bad tokenizer magic in " + path);
  const uint32_t vocab_size = ReadScalar<uint32_t>(f);
  ReadScalar<uint32_t>(f);  // max_token_length (derivable)
  bos_id_ = ReadScalar<int32_t>(f);
  eos_id_ = ReadScalar<int32_t>(f);
  pad_id_ = ReadScalar<int32_t>(f);

  vocab_.reserve(vocab_size);
  scores_.reserve(vocab_size);
  index_.reserve(vocab_size);
  for (uint32_t i = 0; i < vocab_size; ++i) {
    const float score = ReadScalar<float>(f);
    const int32_t len = ReadScalar<int32_t>(f);
    std::string piece(static_cast<size_t>(len), '\0');
    f.read(&piece[0], len);
    if (!f) throw std::runtime_error("tokenizer file truncated");
    scores_.push_back(score);
    index_.emplace(piece, static_cast<int>(i));
    vocab_.push_back(std::move(piece));
  }
}

int Tokenizer::LookupPiece(const std::string& piece) const {
  auto it = index_.find(piece);
  return it == index_.end() ? -1 : it->second;
}

std::vector<int> Tokenizer::Encode(const std::string& text, bool add_bos,
                                   bool add_eos) const {
  std::vector<int> tokens;
  if (add_bos && bos_id_ >= 0) tokens.push_back(bos_id_);
  if (!text.empty()) {
    const int dummy = LookupPiece(" ");
    if (dummy != -1) tokens.push_back(dummy);
  }

  // UTF-8 codepoint split (continuation bytes 10xxxxxx, max 4 bytes/cp).
  size_t i = 0;
  while (i < text.size()) {
    size_t j = i + 1;
    while (j < text.size() && j - i < 4 &&
           (static_cast<unsigned char>(text[j]) & 0xC0) == 0x80)
      ++j;
    const std::string chunk = text.substr(i, j - i);
    const int tid = LookupPiece(chunk);
    if (tid != -1) {
      tokens.push_back(tid);
    } else {
      for (char c : chunk)  // byte fallback: ids 0..2 are <unk>/<s>/</s>
        tokens.push_back(static_cast<int>(static_cast<unsigned char>(c)) + 3);
    }
    i = j;
  }

  // Greedy highest-score adjacent pair merging. Byte-fallback ids can exceed
  // the vocab when a .t file omits the 256 byte tokens — skip those pairs
  // (they have no piece text to merge) instead of indexing out of bounds.
  const int n_vocab = vocab_size();
  while (true) {
    float best_score = -1e10f;
    int best_idx = -1, best_id = -1;
    for (size_t idx = 0; idx + 1 < tokens.size(); ++idx) {
      if (tokens[idx] >= n_vocab || tokens[idx + 1] >= n_vocab) continue;
      const std::string merged = vocab_[tokens[idx]] + vocab_[tokens[idx + 1]];
      const int mid = LookupPiece(merged);
      if (mid != -1 && scores_[mid] > best_score) {
        best_score = scores_[mid];
        best_idx = static_cast<int>(idx);
        best_id = mid;
      }
    }
    if (best_idx == -1) break;
    tokens[best_idx] = best_id;
    tokens.erase(tokens.begin() + best_idx + 1);
  }

  if (add_eos && eos_id_ >= 0) tokens.push_back(eos_id_);
  return tokens;
}

std::string Tokenizer::DecodePiece(int prev_token, int token) const {
  std::string piece = vocab_.at(static_cast<size_t>(token));
  if (prev_token == bos_id_ && !piece.empty() && piece[0] == ' ')
    piece = piece.substr(1);
  if (piece.size() == 6 && piece.compare(0, 3, "<0x") == 0 &&
      piece[5] == '>') {
    unsigned byte = 0;
    if (std::sscanf(piece.c_str(), "<0x%02X>", &byte) == 1)
      return std::string(1, static_cast<char>(byte));
  }
  return piece;
}

std::string Tokenizer::Decode(const std::vector<int>& tokens) const {
  std::string out;
  int prev = -1;
  for (int t : tokens) {
    if (t == bos_id_ || t == eos_id_) {
      prev = t;
      continue;
    }
    out += DecodePiece(prev, t);
    prev = t;
  }
  return out;
}

}  // namespace dllama
