"""The device beam and its hashes on the card against the same code on the CPU.

Needs an NVIDIA card and skips without one. The file imports no JAX, so on a
machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_decode_cuda.py

The log-probs are random f32 (no two candidate scores tie), so the beam's
ids and lengths on the card must equal the CPU's exactly, with and without
an LM; the uint32-wrap hashes and the LM's tables and scores are integer
arithmetic and table lookups, equal bit for bit (the scores' f32 sums of
the same two terms too).
"""

import numpy as np
import pytest
import torch

from onebit_asr_tpu_torch.decode.beam_device import beam_search_device
from onebit_asr_tpu_torch.decode.lm import NGramLM
from onebit_asr_tpu_torch.decode.lm_device import DeviceLM, mul32

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lm(V, seed=0):
    rng = np.random.default_rng(seed)
    return NGramLM(3).fit([[int(t) for t in rng.integers(4, V, size=rng.integers(2, 30))]
                           for _ in range(400)])


def test_hashes_agree_on_the_two_devices(cuda):
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.integers(0, 2 ** 32, size=1 << 20, dtype=np.int64))
    h[:4] = torch.tensor([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    for m in (1000003, 2654435761):
        want = (h.numpy().astype(np.uint32) * np.uint32(m)).astype(np.int64)
        assert torch.equal(mul32(h, m), torch.from_numpy(want))
        assert torch.equal(mul32(h.to(cuda), m).cpu(), torch.from_numpy(want))
    lm = _lm(5004)
    host, dev = DeviceLM.pack(lm), DeviceLM.pack(lm, cuda)
    prefixes = torch.from_numpy(rng.integers(4, 5004, size=(8, 10, 64)))
    plen = torch.from_numpy(rng.integers(0, 64, size=(8, 10)))
    cand = torch.from_numpy(rng.integers(0, 5004, size=(8, 20)))
    want = host.scores(prefixes, plen, cand)
    got = dev.scores(prefixes.to(cuda), plen.to(cuda), cand.to(cuda)).cpu()
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_lm", [False, True])
def test_device_beam_on_cuda_equals_cpu(cuda, use_lm):
    rng = np.random.default_rng(1)
    B, T, V = 8, 120, 5004
    x = rng.standard_normal((B, T, V)).astype(np.float32) * 3
    lp = torch.log_softmax(torch.from_numpy(x), -1)
    lens = torch.from_numpy(rng.integers(1, T + 1, size=B))
    lm = _lm(V) if use_lm else None
    kw = dict(beam_size=10, max_len=T, lm_weight=0.5 if use_lm else 0.0, length_bonus=0.2)
    ids, n = beam_search_device(lp, lens, lm=DeviceLM.pack(lm) if use_lm else None, **kw)
    ids_c, n_c = beam_search_device(lp.to(cuda), lens.to(cuda),
                                    lm=DeviceLM.pack(lm, cuda) if use_lm else None, **kw)
    assert torch.equal(n_c.cpu(), n) and torch.equal(ids_c.cpu(), ids)
    assert int(n.min()) > 0
