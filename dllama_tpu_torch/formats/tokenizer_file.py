"""`.t` tokenizer-file codec.

Binary layout (`distributed-llama/src/tokenizer.hpp:16-23`, loader at
`distributed-llama/src/tokenizer.cpp:38-80`):

```
uint32 magic = 0x567123
uint32 vocab_size          # reference header stores it but trusts the CLI value
uint32 max_token_length
int32  bos_id
int32  eos_id
int32  pad_id
repeat vocab_size:
    float32 score
    int32   length
    bytes   piece[length]   # raw bytes, NOT nul-terminated
```
"""

from __future__ import annotations

import dataclasses
import struct

MAGIC = 0x567123
_HEADER = struct.Struct("<IIIiii")


@dataclasses.dataclass
class TokenizerData:
    vocab: list  # list[bytes]
    scores: list  # list[float]
    bos_id: int
    eos_id: int
    pad_id: int = -1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def max_token_length(self) -> int:
        return max((len(p) for p in self.vocab), default=0)


def read_tokenizer(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        data = f.read()
    magic, vocab_size, _max_len, bos_id, eos_id, pad_id = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"invalid tokenizer file magic 0x{magic:X}")
    off = _HEADER.size
    vocab: list = []
    scores: list = []
    for _ in range(vocab_size):
        score, length = struct.unpack_from("<fi", data, off)
        off += 8
        vocab.append(data[off : off + length])
        off += length
        scores.append(score)
    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos_id, eos_id=eos_id, pad_id=pad_id)


def write_tokenizer(path: str, tok: TokenizerData) -> None:
    with open(path, "wb") as f:
        f.write(
            _HEADER.pack(
                MAGIC, tok.vocab_size, tok.max_token_length, tok.bos_id, tok.eos_id, tok.pad_id
            )
        )
        for piece, score in zip(tok.vocab, tok.scores):
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)
