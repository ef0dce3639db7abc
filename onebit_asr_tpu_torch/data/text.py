"""Model-side ids <-> text (own copy of onebit_asr_tpu/data/text.py, its BPE
trainer included). Model ids [0, offset) are specials; subword id = model
id - offset. Training and an HF `tokenizer.json` need the `tokenizers`
package; a SentencePiece `tokenizer.model` is read by data/spm.py."""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

from onebit_asr_tpu_torch.utils.config import SpecialTokens


class AsrTokenizer:
    def __init__(self, hf_tokenizer, specials: Optional[SpecialTokens] = None):
        self._tok = hf_tokenizer
        self.specials = specials or SpecialTokens()

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 5000,
              specials: Optional[SpecialTokens] = None) -> "AsrTokenizer":
        """A BPE of `vocab_size` subwords (Metaspace pre-tokenizer and
        decoder, `<unk>` its one special) on the upper-cased texts."""
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<unk>"])
        tok.train_from_iterator((t.upper() for t in texts), trainer)
        return cls(tok, specials)

    def save(self, path: str) -> None:
        self._tok.save(path)

    @classmethod
    def load(cls, path: str, specials: Optional[SpecialTokens] = None) -> "AsrTokenizer":
        """An HF `tokenizer.json` or a SentencePiece `tokenizer.model`."""
        if path.endswith(".model"):
            from onebit_asr_tpu_torch.data.spm import SpmBackend, SpmBpeModel

            return cls(SpmBackend(SpmBpeModel.load(path)), specials)
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), specials)

    @classmethod
    def find_and_load(
        cls, data_dir: str, specials: Optional[SpecialTokens] = None
    ) -> "AsrTokenizer":
        """`tokenizer.json` in `data_dir`, else `tokenizer.model` (the two id
        spaces differ: a checkpoint goes with the artifact it was trained
        against)."""
        for name in ("tokenizer.json", "tokenizer.model"):
            p = os.path.join(data_dir, name)
            if os.path.exists(p):
                return cls.load(p, specials)
        raise FileNotFoundError(f"no tokenizer.json / tokenizer.model in {data_dir}")

    @property
    def subword_vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def vocab_size(self) -> int:
        """Model vocabulary: subwords + the reserved specials."""
        return self.subword_vocab_size + self.specials.offset

    def encode(self, text: str) -> List[int]:
        """Text -> model-side ids (offset-shifted)."""
        return [i + self.specials.offset for i in self._tok.encode(text.upper()).ids]

    def ids_to_text(self, ids: Iterable[int]) -> str:
        """Drop specials, subtract the offset, decode."""
        off = self.specials.offset
        return self._tok.decode([int(i) - off for i in ids if int(i) >= off])
