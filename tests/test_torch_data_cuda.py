"""The real-data pipeline on the card against the same code on the CPU.

Needs an NVIDIA card and skips without one. The file imports no JAX, so on a
machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_data_cuda.py

SpecAugment only writes zeros, so on the same starts the card's result
equals the CPU's bit for bit, in f32 and f16. The data dir is chip_smoke's
seeded writer at a small size (train 12, dev 4, test 4 utterances of 1-3 s,
and the float16 feature-cache copy).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from onebit_asr_tpu_torch.data import prefetch
from onebit_asr_tpu_torch.data.librispeech import LibriSpeechDataModule
from onebit_asr_tpu_torch.data.text import AsrTokenizer
from onebit_asr_tpu_torch.ops.specaugment import draw_starts, spec_augment_from_config
from onebit_asr_tpu_torch.train.step import batch_to_device
from onebit_asr_tpu_torch.utils.config import DataConfig, FrontendConfig

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def dirs(cuda, tmp_path):
    """(data dir, feature-cache copy) written by chip_smoke's writer."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.write_data_dir(str(tmp_path), 0, (("train", 12), ("dev", 4), ("test", 4)),
                             (1.0, 3.0), "cuda")


def _module(d, device):
    return LibriSpeechDataModule(d, AsrTokenizer.find_and_load(d),
                                 DataConfig(data_dir=d, batch_size=4, num_buckets=3),
                                 device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_spec_augment_on_the_card_equals_the_cpu(cuda, dtype):
    cfg = FrontendConfig(time_mask_ratio=0.7)
    rng = np.random.default_rng(0)
    lens = np.array([300, 1, 0, 57, 90, 170, 299, 180])
    feats = torch.from_numpy(rng.standard_normal((len(lens), 300, 80))).to(dtype)
    starts = torch.from_numpy(draw_starts(rng, lens, 80, cfg))
    want = spec_augment_from_config(feats, torch.from_numpy(lens), starts, cfg)
    got = spec_augment_from_config(feats.to(cuda), torch.from_numpy(lens).to(cuda),
                                   starts.to(cuda), cfg)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_featurized_batches_on_the_card_under_prefetch(cuda, dirs):
    dm = _module(dirs[0], cuda)
    want = [batch_to_device(b, cuda) for b in dm.featurized_batches("train", 1, augment=True)]
    stats = {}
    got = list(prefetch(dm.featurized_batches("train", 1, augment=True),
                        transfer=lambda b: batch_to_device(b, cuda), depth=2, stats=stats))
    assert stats["items"] == len(want) == 3
    for g, w in zip(got, want):
        assert g["feats"].device.type == "cuda" and g["feats"].dtype == torch.float32
        for k in w:
            assert torch.equal(g[k], w[k]), k
    # the card's features equal the CPU's at the frontend's tolerance (f32
    # FFTs of two libraries)
    cpu = next(_module(dirs[0], "cpu").featurized_batches("dev"))
    card = next(dm.featurized_batches("dev"))
    torch.testing.assert_close(card["feats"].cpu(), cpu["feats"], rtol=1e-4, atol=2e-4)
    dm.close()


def test_cached_batches_reach_the_card_as_float16(cuda, dirs):
    dm = _module(dirs[1], cuda)
    host = _module(dirs[1], "cpu")
    for b, h in zip(dm.featurized_batches("train", 0, augment=True),
                    host.featurized_batches("train", 0, augment=True)):
        assert b["feats"].device.type == "cuda" and b["feats"].dtype == torch.float16
        assert torch.equal(b["feats"].cpu(), h["feats"])
        up = batch_to_device(b, cuda)["feats"]
        assert up.dtype == torch.float32 and torch.equal(up, b["feats"].float())
    dm.close()
    host.close()
