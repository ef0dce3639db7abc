"""onebit_asr_tpu_torch's packed-ternary ops against the JAX package, on CPU.

On CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode (`*_any_m(interpret=None)`) or its
plain references, as the JAX package's own tests do. Inputs come from numpy
with a seed. The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onebit_asr_tpu.model import packed as jpacked
from onebit_asr_tpu.ops import ternary_matmul as jtm
from onebit_asr_tpu_torch.convert import to_torch
from onebit_asr_tpu_torch.model.packed import export_packed_params
from onebit_asr_tpu_torch.ops import ternary_matmul as tm
from onebit_asr_tpu_torch.ops.quant import project_weight
from torch_cpu_threads import one_thread  # noqa: F401


def _case(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-1, 2, size=(K, N)).astype(np.float32)
    alpha = np.float32(rng.uniform(0.5, 2.0))
    return x, q, alpha


@pytest.mark.parametrize("K,N", [(24, 128), (256, 64), (4, 3)])
def test_pack_planar_round_trip_and_bytes_match_jax(K, N):
    q = np.random.default_rng(K).integers(-1, 2, size=(K, N)).astype(np.float32)
    packed = tm.pack_planar(torch.from_numpy(q))
    assert packed.shape == (K // 4, N) and packed.dtype == torch.int8
    np.testing.assert_array_equal(tm.unpack_planar(packed).numpy(), q)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jtm.pack_planar(jnp.asarray(q))))


def test_pack_planar_stacked_layers():
    q = np.random.default_rng(0).integers(-1, 2, size=(3, 16, 8)).astype(np.float32)
    packed = tm.pack_planar(torch.from_numpy(q))
    assert packed.shape == (3, 4, 8)
    for i in range(3):
        np.testing.assert_array_equal(
            packed[i].numpy(), np.asarray(jtm.pack_planar(jnp.asarray(q[i])))
        )


def test_pack_planar_rejects_k_not_multiple_of_4():
    with pytest.raises(ValueError):
        tm.pack_planar(torch.zeros(6, 4))


# M ragged (not a multiple of the JAX block) through N <= 512 (JAX block_n rule)
SHAPES = [(16, 32, 128), (37, 64, 96), (1, 128, 256), (129, 256, 512), (8, 4, 8)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_ternary_matmul_plain_matches_jax_kernel(seed, shape):
    """f32 outputs of bf16-operand products: the two sum in different orders
    (rtol 1e-5, atol 1e-5 at |x| ~ N(0,1))."""
    x, q, alpha = _case(seed, *shape)
    packed = tm.pack_planar(torch.from_numpy(q))
    out = tm.ternary_matmul(torch.from_numpy(x), packed, torch.tensor(alpha))
    ref = jtm.ternary_matmul_any_m(
        jnp.asarray(x), jnp.asarray(packed.numpy()), jnp.asarray(alpha), interpret=None
    )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref_plain = jtm.ternary_matmul_reference(
        jnp.asarray(x), jnp.asarray(packed.numpy()), jnp.asarray(alpha)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_plain), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_activations_int8_matches_jax(seed):
    x, _, _ = _case(seed, 33, 64, 4)
    x[3] = 0.0  # zero row: scale floor, all-zero codes
    q, scale = tm.quantize_activations_int8(torch.from_numpy(x))
    jq, jscale = jtm.quantize_activations_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def _edge_rows(K: int) -> np.ndarray:
    """Rows decided at the edges of the int8 rounding: all zeros; x / scale
    exactly on k + 0.5 at scale 1 and 2; both ends at +-127; tiny values."""
    ties = np.arange(K, dtype=np.float32) % 127 - 63.5  # -63.5 .. 62.5
    rows = np.zeros((5, K), np.float32)
    rows[1], rows[1, 0] = ties, 127.0  # absmax 127 -> scale 1
    rows[2], rows[2, 0] = 2.0 * ties, -254.0  # scale 2
    rows[3] = np.random.default_rng(K).uniform(-1, 1, K)
    rows[3, :2] = (3.0, -3.0)
    rows[4] = rows[3] * 1e-20
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_int8_edge_rows_match_jax(dtype):
    """What the W2A8 kernel must reproduce: ties round half to even, a zero
    row stays zero at the 1e-30 scale floor, the absmax element maps to
    +-127; f32 and bf16 input, bit for bit with JAX."""
    rows = _edge_rows(64)
    xt = torch.from_numpy(rows).to(getattr(torch, dtype))
    q, scale = tm.quantize_activations_int8(xt)
    jq, jscale = jtm.quantize_activations_int8(jnp.asarray(rows, dtype=getattr(jnp, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert q[1, 1:4].tolist() == [-62, -62, -60] and q[2, 1:4].tolist() == [-62, -62, -60]
    assert not q[0].any() and scale[0].item() == np.float32(np.float32(1e-30) / np.float32(127))
    assert q[3].max().item() == 127 and q[3].min().item() == -127
    assert q[4].max().item() == 127 and q[4].min().item() == -127
    packed = tm.pack_planar(torch.from_numpy(
        np.random.default_rng(1).integers(-1, 2, size=(64, 8)).astype(np.float32)))
    np.testing.assert_array_equal(
        tm.ternary_matmul_w2a8(xt, packed, torch.tensor(0.731)).numpy(),
        np.asarray(jtm.ternary_matmul_w2a8_reference(
            jnp.asarray(rows, dtype=getattr(jnp, dtype)), jnp.asarray(packed.numpy()),
            jnp.asarray(np.float32(0.731)))),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_w2a8_plain_bit_exact_vs_jax(seed, shape):
    """Bit for bit equal to the JAX golden ternary_matmul_w2a8_reference.
    The JAX Pallas kernel itself (interpret mode) may differ from that golden
    by an ulp in the final f32 scale multiplies, which XLA fuses in another
    order; the JAX package's own test allows rtol/atol 1e-5 for it, and so
    does this one."""
    x, q, alpha = _case(seed + 10, *shape)
    packed = tm.pack_planar(torch.from_numpy(q))
    out = tm.ternary_matmul_w2a8(torch.from_numpy(x), packed, torch.tensor(alpha))
    jx, jp, ja = jnp.asarray(x), jnp.asarray(packed.numpy()), jnp.asarray(alpha)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jtm.ternary_matmul_w2a8_reference(jx, jp, ja))
    )
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jtm.ternary_matmul_w2a8_any_m(jx, jp, ja, interpret=None)),
        rtol=1e-5, atol=1e-5,
    )


def test_cpu_wrappers_run_plain_versions_without_counting():
    x, q, alpha = _case(3, 9, 16, 8)
    xt, packed, a = torch.from_numpy(x), tm.pack_planar(torch.from_numpy(q)), torch.tensor(alpha)
    before = (tm.ternary_matmul.launches, tm.ternary_matmul_w2a8.launches)
    assert torch.equal(tm.ternary_matmul(xt, packed, a), tm.ternary_matmul_reference(xt, packed, a))
    assert torch.equal(
        tm.ternary_matmul_w2a8(xt, packed, a), tm.ternary_matmul_w2a8_reference(xt, packed, a)
    )
    assert (tm.ternary_matmul.launches, tm.ternary_matmul_w2a8.launches) == before


@pytest.mark.parametrize("fn", [tm.ternary_matmul, tm.ternary_matmul_w2a8])
def test_wrappers_reject_bad_operands(fn):
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        fn(x, torch.zeros(3, 8, dtype=torch.int8), torch.tensor(1.0))  # K mismatch
    with pytest.raises(TypeError):
        fn(x, torch.zeros(4, 8), torch.tensor(1.0))  # not int8
    with pytest.raises(ValueError):
        fn(x, torch.zeros(4, 8, dtype=torch.int8), torch.ones(8))  # vector alpha
    with pytest.raises(RuntimeError):
        fn(x.to("meta"), torch.zeros(4, 8, dtype=torch.int8, device="meta"),
           torch.tensor(1.0, device="meta"))  # neither CPU nor CUDA


@pytest.mark.parametrize("binary", [False, True])
def test_project_weight_matches_jax(binary):
    rng = np.random.default_rng(7)
    kernel = rng.standard_normal((3, 16, 8)).astype(np.float32)
    kernel[0, 0, 0] = 0.0
    alpha = np.array([0.5, -1.0, 1e-30], np.float32)  # stacked [L]; |alpha|; tiny
    got = project_weight(torch.from_numpy(kernel), torch.from_numpy(alpha), binary)
    want = jpacked._project(jnp.asarray(kernel), jnp.asarray(alpha), binary)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", [2, 1])
def test_export_packed_params_matches_jax(precision):
    rng = np.random.default_rng(precision)
    kern = rng.standard_normal((2, 16, 8)).astype(np.float32)
    tree = {
        "blocks": {"w": {"kernel": kern, "alpha": np.abs(kern).mean((1, 2)),
                         "bias": rng.standard_normal((2, 8)).astype(np.float32)}},
        "head": {"kernel": kern[0], "bias": np.zeros(8, np.float32)},  # Dense: no alpha
    }
    got = export_packed_params(to_torch(tree), precision)
    want = jpacked.export_packed_params(tree, precision)
    w = got["blocks"]["w"]
    assert set(w) == {"packed_kernel", "alpha", "bias"}
    np.testing.assert_array_equal(w["packed_kernel"].numpy(),
                                  np.asarray(want["blocks"]["w"]["packed_kernel"]))
    assert "kernel" in got["head"] and "packed_kernel" not in got["head"]
    with pytest.raises(ValueError):
        export_packed_params({}, precision=3)


def test_export_refuses_per_channel_alpha():
    tree = {"w": {"kernel": torch.zeros(8, 4), "alpha": torch.ones(4)}}
    with pytest.raises(NotImplementedError):
        export_packed_params(tree)
