"""BPE tokenizer (sentencepiece-style) over the `.t` vocab format.

Encode mirrors the reference algorithm exactly
(`distributed-llama/src/tokenizer.cpp:109-229`): optional BOS, a dummy-prefix
space token for non-empty text, UTF-8 codepoint lookup with byte-fallback
(byte b -> token b + 3), then greedy merging of the highest-score adjacent
pair until no merge exists.

Decode mirrors `distributed-llama/src/tokenizer.cpp:89-100`: a leading space is
stripped from the piece right after BOS, and ``<0xXX>`` byte tokens decode to
their raw byte. (The reference compares ``sscanf``'s result against ``bosId``
instead of 1 — a quirk documented in SURVEY.md §7 that we do not replicate.)
"""

from __future__ import annotations

from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, read_tokenizer


class Tokenizer:
    def __init__(self, data: TokenizerData):
        self.data = data
        self.vocab = data.vocab
        self.scores = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        self._index = {piece: i for i, piece in enumerate(data.vocab)}

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        return cls(read_tokenizer(path))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def piece_id(self, piece: bytes) -> int:
        return self._index.get(piece, -1)

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> list:
        raw = text.encode("utf-8")
        tokens: list = []
        if add_bos and self.bos_id >= 0:
            tokens.append(self.bos_id)
        if raw:
            dummy = self._index.get(b" ", -1)
            if dummy != -1:
                tokens.append(dummy)

        # split into UTF-8 codepoints (max 4 bytes, same cap as the reference)
        i = 0
        while i < len(raw):
            j = i + 1
            while j < len(raw) and j - i < 4 and (raw[j] & 0xC0) == 0x80:
                j += 1
            chunk = raw[i:j]
            tid = self._index.get(chunk, -1)
            if tid != -1:
                tokens.append(tid)
            else:
                # byte fallback: first 3 ids are <unk>/<s>/</s>
                tokens.extend(b + 3 for b in chunk)
            i = j

        # greedy highest-score pair merging
        while True:
            best_score = -1e10
            best_idx = -1
            best_id = -1
            for idx in range(len(tokens) - 1):
                merged = self.vocab[tokens[idx]] + self.vocab[tokens[idx + 1]]
                mid = self._index.get(merged, -1)
                if mid != -1 and self.scores[mid] > best_score:
                    best_score = self.scores[mid]
                    best_idx = idx
                    best_id = mid
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]

        if add_eos and self.eos_id >= 0:
            tokens.append(self.eos_id)
        return tokens

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        # raw-byte tokens look like b"<0x0A>"
        if len(piece) == 6 and piece.startswith(b"<0x") and piece.endswith(b">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass  # not a raw-byte token after all: fall through to
                # the literal piece
        return piece

    def decode(self, tokens: list) -> str:
        """Decode a full sequence. BOS/EOS render as nothing (the reference CLI
        only ever passes BOS as ``prev``, never prints it —
        `distributed-llama/src/apps/dllama/dllama.cpp:43-79`)."""
        out = bytearray()
        prev = -1
        for t in tokens:
            if t in (self.bos_id, self.eos_id):
                prev = t
                continue
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")
