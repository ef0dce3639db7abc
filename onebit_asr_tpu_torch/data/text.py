"""Model-side ids -> text (own copy of onebit_asr_tpu/data/text.py's
decoding half). Model ids [0, offset) are specials; subword id = model id -
offset. Needs the `tokenizers` package and an HF `tokenizer.json`."""

from __future__ import annotations

import os
from typing import Iterable, Optional

from onebit_asr_tpu_torch.utils.config import SpecialTokens


class AsrTokenizer:
    def __init__(self, hf_tokenizer, specials: Optional[SpecialTokens] = None):
        self._tok = hf_tokenizer
        self.specials = specials or SpecialTokens()

    @classmethod
    def load(cls, path: str, specials: Optional[SpecialTokens] = None) -> "AsrTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), specials)

    @classmethod
    def find_and_load(
        cls, data_dir: str, specials: Optional[SpecialTokens] = None
    ) -> "AsrTokenizer":
        """`tokenizer.json` in `data_dir` (a SentencePiece `tokenizer.model`
        is not read by this package yet)."""
        p = os.path.join(data_dir, "tokenizer.json")
        if not os.path.exists(p):
            raise FileNotFoundError(f"no tokenizer.json in {data_dir}")
        return cls.load(p, specials)

    def ids_to_text(self, ids: Iterable[int]) -> str:
        """Drop specials, subtract the offset, decode."""
        off = self.specials.offset
        return self._tok.decode([int(i) - off for i in ids if int(i) >= off])
