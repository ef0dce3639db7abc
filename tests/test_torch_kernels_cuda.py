"""CUDA kernels of onebit_asr_tpu_torch against their plain versions, on the card.

Every test here needs an NVIDIA card with nvcc (sm_90a) and skips without
one. The file imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py

Tolerances: the bf16 kernel and its plain version multiply the same bf16
values exactly and sum in f32 in different orders, so they differ by f32
rounding of sums of at most K terms (atol 1e-4, rtol 1e-5 at |x| ~ N(0,1),
K <= 1024). The W2A8 kernel sums integers exactly and applies the scales in
the plain version's order: equal bit for bit.
"""

import numpy as np
import pytest
import torch

from onebit_asr_tpu_torch.ops import ternary_matmul as tm

pytestmark = pytest.mark.gpu

# (M, K, N): the Conformer-M serving shapes at B=8, 16 s (T'=512), then
# ragged edges in M, N and K (K % 8 != 0 takes the element-wise tile copy)
SHAPES = [
    (4096, 256, 1024), (4096, 1024, 256), (4096, 256, 256), (1023, 256, 256),
    (37, 64, 96), (100, 256, 100), (5, 12, 8), (1, 1024, 256),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(M, K, N, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-1, 2, size=(K, N)).astype(np.float32))
    alpha = torch.tensor(rng.uniform(0.5, 2.0), dtype=torch.float32)
    packed = tm.pack_planar(q)
    return x.to(device).to(torch.bfloat16), packed.to(device), alpha.to(device)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_kernel_matches_plain(cuda, shape):
    x, packed, alpha = _case(*shape, seed=sum(shape), device=cuda)
    before = tm.ternary_matmul.launches
    out = tm.ternary_matmul(x, packed, alpha)
    torch.cuda.synchronize()
    assert tm.ternary_matmul.launches == before + 1
    ref = tm.ternary_matmul_reference(x, packed, alpha)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_w2a8_kernel_bit_exact(cuda, shape):
    x, packed, alpha = _case(*shape, seed=sum(shape) + 1, device=cuda)
    before = tm.ternary_matmul_w2a8.launches
    out = tm.ternary_matmul_w2a8(x, packed, alpha)
    torch.cuda.synchronize()
    assert tm.ternary_matmul_w2a8.launches == before + 1
    ref = tm.ternary_matmul_w2a8_reference(x, packed, alpha)
    assert torch.equal(out, ref)


def test_kernels_take_unaligned_views(cuda):
    """A view that starts off a 16-byte boundary takes the element-wise copy."""
    x, packed, alpha = _case(65, 64, 64, seed=3, device=cuda)
    xv = torch.cat([x.new_zeros(65, 1), x], dim=1)[:, 1:]  # offset by 2 bytes
    torch.testing.assert_close(
        tm.ternary_matmul(xv, packed, alpha),
        tm.ternary_matmul_reference(x, packed, alpha), rtol=1e-5, atol=1e-4,
    )
    assert torch.equal(
        tm.ternary_matmul_w2a8(xv, packed, alpha),
        tm.ternary_matmul_w2a8_reference(x, packed, alpha),
    )


def test_cuda_wrapper_raises_on_split_devices(cuda):
    x, packed, alpha = _case(8, 16, 8, seed=4, device=cuda)
    for fn in (tm.ternary_matmul, tm.ternary_matmul_w2a8):
        with pytest.raises(RuntimeError):
            fn(x, packed.cpu(), alpha)


def test_packed_forward_on_kernels_matches_plain(cuda):
    """A small packed model: CTC log-probs through the kernels vs the same
    model on the plain versions, on the card (bf16 activations: the two
    differ by f32 summation order inside bf16 layers)."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, packed_model_from_jax
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=40, enc_d_model=64, enc_layers=2,
        enc_heads=2, enc_d_ff=128, enc_conv_kernel=7,
    )
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((3, 301, 80)).astype(np.float32)).to(cuda)
    lens = torch.tensor([301, 250, 120], device=cuda)
    for int8_act, plain in ((False, tm.ternary_matmul_reference),
                            (True, tm.ternary_matmul_w2a8_reference)):
        model = packed_model_from_jax(cfg, params, 2, int8_act, cuda)
        with torch.inference_mode():
            _, mask, logits = model(feats, lens)
            for m in model.modules():
                if isinstance(m, QuantDense):
                    m.matmul = plain
            _, _, ref = model(feats, lens)
        lp = torch.log_softmax(logits.float(), -1)[mask]
        lp_ref = torch.log_softmax(ref.float(), -1)[mask]
        assert torch.isfinite(lp).all()
        assert (lp - lp_ref).abs().max().item() < 0.1
