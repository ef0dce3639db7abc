"""onebit_asr_tpu_torch/data/spm.py and the `.model` branch of its tokenizer
against the JAX package, on CPU.

The SentencePiece artifacts are built in the test, as tests/test_spm.py
builds them: a hand-made model written with `write_model_proto`, and a BPE
trained by the JAX package's HF-`tokenizers` trainer then exported to
`tokenizer.model`. Encode and decode must equal the JAX package's exactly.
"""

import numpy as np
import pytest

from onebit_asr_tpu.data import spm as jspm
from onebit_asr_tpu.data.text import AsrTokenizer as JaxTokenizer
from onebit_asr_tpu_torch.data import spm
from onebit_asr_tpu_torch.data.text import AsrTokenizer

PIECES = [
    ("<blank>", 0.0, spm.CONTROL), ("<unk>", 0.0, spm.UNKNOWN),
    ("<sos>", 0.0, spm.CONTROL), ("<eos>", 0.0, spm.CONTROL),
    ("▁", -10.0, spm.NORMAL), ("A", -11.0, spm.NORMAL), ("B", -12.0, spm.NORMAL),
    ("AB", -1.0, spm.NORMAL), ("▁A", -2.0, spm.NORMAL), ("AA", -3.0, spm.NORMAL),
]
TEXTS = ["THE QUICK BROWN FOX", "HELLO  SPEECH", "TERNARY QUANTIZATION", "DOG", "FOXß",
         "  leading and trailing  ", "AAA AB BA"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A toy .model and one exported from a trained BPE, both on disk."""
    root = tmp_path_factory.mktemp("spm")
    (root / "toy.model").write_bytes(jspm.write_model_proto(PIECES))
    corpus = ["the quick brown fox jumps over the lazy dog",
              "speech recognition with ternary weights",
              "hello world hello speech", "quantization aware training of conformer models"] * 4
    tok = JaxTokenizer.train(corpus, vocab_size=80)
    trained = root / "trained"
    trained.mkdir()
    jspm.export_hf_to_spm(tok._tok, str(trained / "tokenizer.model"))
    return root / "toy.model", trained


def test_proto_codec_matches_jax():
    data = spm.write_model_proto(PIECES)
    assert data == jspm.write_model_proto(PIECES)
    assert spm.parse_model_proto(data) == jspm.parse_model_proto(data)


@pytest.mark.parametrize("which", ["toy", "trained"])
def test_spm_encode_decode_match_jax(artifacts, which):
    toy, trained = artifacts
    path = str(toy if which == "toy" else trained / "tokenizer.model")
    got, want = spm.SpmBpeModel.load(path), jspm.SpmBpeModel.load(path)
    assert len(got) == len(want) and got.unk_id == want.unk_id
    for text in TEXTS:
        assert got.encode_pieces(text) == want.encode_pieces(text), text
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids) == want.decode(ids), text
    rng = np.random.default_rng(0)
    for ids in rng.integers(0, len(want) + 3, size=(20, 12)).tolist():
        assert got.decode(ids) == want.decode(ids)


def test_find_and_load_picks_up_tokenizer_model(artifacts):
    _, trained = artifacts
    tok = AsrTokenizer.find_and_load(str(trained))
    jtok = JaxTokenizer.find_and_load(str(trained))
    assert tok.vocab_size == jtok.vocab_size
    for text in TEXTS[:4]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and min(ids) >= 4
        assert tok.ids_to_text(ids + [0, 3]) == jtok.ids_to_text(ids + [0, 3])
    with pytest.raises(FileNotFoundError):
        AsrTokenizer.find_and_load(str(trained.parent / "nowhere"))
