"""SentencePiece `tokenizer.model` without the sentencepiece package.

Own copy of onebit_asr_tpu/data/spm.py (pure Python): a minimal protobuf
codec for the `ModelProto` of a `tokenizer.model` (field 1 = repeated
SentencePiece{piece, score, type}); the SentencePiece BPE encode (NFKC,
whitespace collapsed, dummy prefix, spaces escaped to U+2581, then the
adjacent pair whose concatenation is the best-scoring known piece merged
first, leftmost on ties); decode (pieces joined, U+2581 -> space, the dummy
prefix stripped, control pieces skipped, unk rendered as SPM's surface);
and an exporter from an HF-`tokenizers` BPE to a `.model` file.

`AsrTokenizer.load("<...>/tokenizer.model")` (data/text.py) reads one: its
model-side ids are spm_id + 4. The exporter gives pieces spm_id = hf_id + 3
(SPM reserves ids 0-3, the HF backend id 0 for `<unk>`): piece sequences,
and so text, agree across the two artifacts; raw ids do not, so a
checkpoint goes with the artifact it was trained against.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

SPACE = "▁"  # the SentencePiece whitespace marker
UNK_SURFACE = " ⁇ "  # SPM's default unk_surface " ⁇ "

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


# --------------------------------------------------------------------------
# protobuf wire primitives
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:  # varint
        _, i = _read_varint(buf, i)
        return i
    if wire == 1:  # 64-bit
        return i + 8
    if wire == 2:  # length-delimited
        n, i = _read_varint(buf, i)
        return i + n
    if wire == 5:  # 32-bit
        return i + 4
    raise ValueError(f"unsupported wire type {wire}")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, payload_or_value) over a message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            v, i = _read_varint(buf, i)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, buf[i : i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i : i + ln]
            i += ln
        elif wire == 5:
            yield field, wire, buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _write_varint(len(payload)) + payload


def _f32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _vi(field: int, value: int) -> bytes:
    return _tag(field, 0) + _write_varint(value)


# --------------------------------------------------------------------------
# ModelProto read / write
# --------------------------------------------------------------------------


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """tokenizer.model bytes -> [(piece, score, type), ...] in id order.

    Only field 1 (pieces) is consumed; trainer/normalizer specs are skipped
    (inference needs only the piece inventory)."""
    pieces: List[Tuple[str, float, int]] = []
    for field, wire, payload in _iter_fields(data):
        if field != 1 or wire != 2:
            continue
        piece, score, ptype = "", 0.0, NORMAL
        for f2, w2, v2 in _iter_fields(payload):
            if f2 == 1 and w2 == 2:
                piece = v2.decode("utf-8")
            elif f2 == 2 and w2 == 5:
                score = struct.unpack("<f", v2)[0]
            elif f2 == 3 and w2 == 0:
                ptype = v2
        pieces.append((piece, score, ptype))
    if not pieces:
        raise ValueError("no pieces found — not a SentencePiece model file?")
    return pieces


def write_model_proto(
    pieces: Sequence[Tuple[str, float, int]],
    vocab_size: int | None = None,
) -> bytes:
    """[(piece, score, type)] -> tokenizer.model bytes.

    Includes a TrainerSpec (model_type=BPE, vocab_size, the reference's
    special ids/pieces — tokenizer.py:67-81) and a NormalizerSpec
    (add_dummy_prefix / remove_extra_whitespaces / escape_whitespaces, no
    precompiled charsmap) so real `sentencepiece` accepts the file."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = _ld(1, piece.encode("utf-8")) + _f32(2, score)
        if ptype != NORMAL:
            body += _vi(3, ptype)
        out += _ld(1, body)
    # TrainerSpec (field 2): model_type=3 (BPE=2), vocab_size=4,
    # unk/bos/eos/pad ids = 40-43, unk/bos/eos/pad pieces = 45-48.
    ts = (
        _vi(3, 2)
        + _vi(4, vocab_size if vocab_size is not None else len(pieces))
        + _vi(40, 1)
        + _vi(41, 2)
        + _vi(42, 3)
        + _vi(43, 0)
        + _ld(45, b"<unk>")
        + _ld(46, b"<sos>")
        + _ld(47, b"<eos>")
        + _ld(48, b"<blank>")
    )
    out += _ld(2, ts)
    # NormalizerSpec (field 3): name=1, add_dummy_prefix=3,
    # remove_extra_whitespaces=4, escape_whitespaces=5.
    ns = _ld(1, b"nmt_nfkc") + _vi(3, 1) + _vi(4, 1) + _vi(5, 1)
    out += _ld(3, ns)
    return bytes(out)


# --------------------------------------------------------------------------
# the SPM BPE model
# --------------------------------------------------------------------------


class SpmBpeModel:
    """Inference-only SentencePiece BPE: encode/decode over a parsed
    ModelProto, mirroring sentencepiece's `bpe_model.cc`."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.pieces = list(pieces)
        self.piece_to_id: Dict[str, int] = {}
        self.unk_id = 0
        self._mergeable: Dict[str, Tuple[float, int]] = {}  # piece -> (score, id)
        for i, (piece, score, ptype) in enumerate(self.pieces):
            self.piece_to_id.setdefault(piece, i)
            if ptype == UNKNOWN:
                self.unk_id = i
            if ptype in (NORMAL, USER_DEFINED):
                self._mergeable.setdefault(piece, (score, i))

    @classmethod
    def load(cls, path: str) -> "SpmBpeModel":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    def __len__(self) -> int:
        return len(self.pieces)

    # -- normalize ------------------------------------------------------

    @staticmethod
    def normalize(text: str) -> str:
        """nmt_nfkc approximation: NFKC + whitespace collapse (SPM's extra
        nmt rules touch control chars / exotic spaces that cannot appear in
        LibriSpeech transcripts), then dummy prefix + escape to U+2581."""
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # remove_extra_whitespaces
        if not text:
            return ""
        return (" " + text).replace(" ", SPACE)  # add_dummy_prefix + escape

    # -- encode ---------------------------------------------------------

    def encode_pieces(self, text: str) -> List[str]:
        norm = self.normalize(text)
        if not norm:
            return []
        symbols: List[str] = list(norm)
        # Greedy best-scoring adjacent merge, leftmost on ties — a linear
        # rescan per merge is O(n^2) worst case but n is a transcript.
        while True:
            best_score, best_pos, best_piece = None, -1, None
            for j in range(len(symbols) - 1):
                cand = symbols[j] + symbols[j + 1]
                hit = self._mergeable.get(cand)
                if hit is None:
                    continue
                if best_score is None or hit[0] > best_score:
                    best_score, best_pos, best_piece = hit[0], j, cand
            if best_piece is None:
                break
            symbols[best_pos : best_pos + 2] = [best_piece]
        return symbols

    def encode(self, text: str) -> List[int]:
        return [
            self.piece_to_id.get(s, self.unk_id) for s in self.encode_pieces(text)
        ]

    # -- decode ---------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            piece, _, ptype = self.pieces[i]
            if ptype == CONTROL:
                continue
            if ptype == UNKNOWN:
                parts.append(UNK_SURFACE)
            else:
                parts.append(piece)
        text = "".join(parts).replace(SPACE, " ")
        return text[1:] if text.startswith(" ") else text


class SpmBackend:
    """Adapter giving `SpmBpeModel` the backend surface `AsrTokenizer`
    drives (`encode(text).ids`, `decode`, `get_vocab_size`) so a reference
    `tokenizer.model` drops into the data/eval pipeline unchanged: the
    subword ids ARE spm ids, so the +4 model-side shift reproduces the
    reference scheme exactly (dataloader_stub.py:199-207)."""

    class _Enc:
        __slots__ = ("ids",)

        def __init__(self, ids: List[int]):
            self.ids = ids

    def __init__(self, model: SpmBpeModel):
        self.model = model

    def encode(self, text: str) -> "SpmBackend._Enc":
        return self._Enc(self.model.encode(text))

    def decode(self, ids: Iterable[int]) -> str:
        return self.model.decode(ids)

    def get_vocab_size(self) -> int:
        return len(self.model)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(write_model_proto([p for p in self.model.pieces]))


# --------------------------------------------------------------------------
# exporter: HF-`tokenizers` BPE -> tokenizer.model
# --------------------------------------------------------------------------


def export_hf_to_spm(hf_tokenizer, path: str) -> None:
    """Write an SPM `tokenizer.model` equivalent to a trained HF BPE.

    Piece scores encode the merge priority (score = -(rank+1); characters
    below all merges), so the SPM BPE algorithm reproduces the HF merge
    order; `tests/test_spm.py` asserts piece-sequence equivalence on
    shared text. SPM layout: ids 0-3 are the reference's specials
    (`<blank>`, `<unk>`, `<sos>`, `<eos>`), pieces follow in HF-id order
    (spm_id = hf_id + 3; HF id 0 is `<unk>`)."""
    import json

    spec = json.loads(hf_tokenizer.to_str())
    vocab: Dict[str, int] = spec["model"]["vocab"]
    merges = spec["model"]["merges"]
    rank: Dict[str, int] = {}
    for r, m in enumerate(merges):
        a, b = m.split(" ", 1) if isinstance(m, str) else m
        rank.setdefault(a + b, r)
    n_merges = len(merges)
    by_id = sorted(vocab.items(), key=lambda kv: kv[1])

    pieces: List[Tuple[str, float, int]] = [
        ("<blank>", 0.0, CONTROL),
        ("<unk>", 0.0, UNKNOWN),
        ("<sos>", 0.0, CONTROL),
        ("<eos>", 0.0, CONTROL),
    ]
    n_chars = 0
    for piece, hf_id in by_id:
        if hf_id == 0:  # the HF backend's <unk> slot — already emitted
            continue
        r = rank.get(piece)
        if r is not None:
            score = -float(r + 1)
        else:  # alphabet character: below every merge, ordered by id
            score = -float(n_merges + n_chars + 1)
            n_chars += 1
        pieces.append((piece, score, NORMAL))
    with open(path, "wb") as f:
        f.write(write_model_proto(pieces))
