"""CUDA kernels of onebit_asr_tpu_torch against their plain versions, on the card.

Every test here needs an NVIDIA card with nvcc (sm_90a) and skips without
one. The file imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py

Tolerances: the bf16 kernel and its plain version multiply the same bf16
values exactly and sum in f32 in different orders, so they differ by f32
rounding of sums of at most K terms (atol 1e-4, rtol 1e-5 at |x| ~ N(0,1),
K <= 4100). The W2A8 kernel quantizes x per row as the plain version does
(IEEE division, round half to even), sums integers exactly and applies the
scales in the plain version's order: equal bit for bit. The fused subsampler kernel
rounds conv1 as its plain version does and sums conv2's 9C bf16 products in
f32 in another order, so its bf16 output may differ by one bf16 ulp (rtol
2^-7, atol 1e-3). The fused attention kernel sums its products in f32 in
another order and takes the softmax sum online, so a bf16 probability or
output may differ by one bf16 ulp (|d| <= 1e-2 + 2^-7 |ref|). Its backward
kernel sums in f32 in other orders too, so a gradient element may round the
other way and a ds element with it: each gradient within one bf16 ulp of
the element plus one of the tensor's largest (|d| <= 2^-7 (|ref| +
max|ref|)); its cross-block sums run in a fixed order, so two launches give
the same bits. The fused subsampler's backward kernel is held in two halves:
its masked cotangent gm (g where y_pre > 0) must equal the plain version's
except where |y_pre| <= 2^-14 (|pat| |w2| + |b2|), an f32 rounding of 0
that another summation order may put on either side; its five gradients must
match the plain backward applied to the kernel's own gm, dx/dw1/db1 within
one bf16 ulp of the element plus one of the largest (a dpat element may
round the other way), dw2/db2 within 1e-4 (|ref| + max|ref|) (f32 sums of
the same products in another order); two launches give the same bits. The CTC
lattice kernels run the plain versions' f32 recursion in the same order with
the same expf/logf: equal bit for bit (NEG_INF entries included), and, as a
second check, NEG_INF entries (<= -5e29) matching as a pattern and the
finite ones within 1e-5 relative (+1e-5).
"""

import numpy as np
import pytest
import torch

from onebit_asr_tpu_torch.ops import ctc_lattice as cl
from onebit_asr_tpu_torch.ops import subsampler as ss
from onebit_asr_tpu_torch.ops import ternary_matmul as tm

pytestmark = pytest.mark.gpu

# (M, K, N): the Conformer-M serving shapes at B=8, 16 s (T'=512), then
# ragged edges in M, N and K (K/4 % 8 != 0 takes the element-wise copy of x,
# N % 16 != 0 that of the weights), K/4 off the 16- and 32-row stages
# (1028, 1020), and K/4 > 256, walked in passes (4100, 2048)
SHAPES = [
    (4096, 256, 1024), (4096, 1024, 256), (4096, 256, 256), (1023, 256, 256),
    (37, 64, 96), (100, 256, 100), (5, 12, 8), (1, 1024, 256),
    (300, 1028, 200), (4096, 1020, 256), (64, 4100, 130), (1023, 2048, 512),
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


def _edge_rows(K: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Rows whose int8 quantization is decided at its edges: all zeros;
    x / scale exactly on k + 0.5 (scale 1 and 2: round half to even); one
    row reaching +127 and -127; a row of tiny values; random rows."""
    rng = np.random.default_rng(K)
    rows = np.zeros((8, K), np.float32)
    ties = np.arange(K, dtype=np.float32) % 127 - 63.5  # -63.5 .. 62.5
    rows[1] = ties
    rows[1, 0] = 127.0  # absmax 127 -> scale 1: x / scale = x
    rows[2] = 2.0 * ties
    rows[2, 0] = -254.0  # scale 2: x / scale = k + 0.5 again
    rows[3] = rng.uniform(-1, 1, K)
    rows[3, :2] = (3.0, -3.0)  # both ends saturate at +-127
    rows[4] = rng.standard_normal(K) * 1e-20
    rows[5:] = rng.standard_normal((3, K)) * np.array([[0.01], [1.0], [300.0]], np.float32)
    return torch.from_numpy(rows).to(device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [256, 1028])
def test_w2a8_kernel_edge_rows_bit_exact(cuda, dtype, K):
    x = _edge_rows(K, dtype, cuda)
    q, scale = tm.quantize_activations_int8(x)
    assert torch.equal(q[1, 1:4].cpu(), torch.tensor([-62, -62, -60], dtype=torch.int8))  # ties
    assert int(q[3].max()) == 127 and int(q[3].min()) == -127 and not q[0].any()
    rng = np.random.default_rng(K + 1)
    packed = tm.pack_planar(torch.from_numpy(
        rng.integers(-1, 2, size=(K, 96)).astype(np.float32))).to(cuda)
    alpha = torch.tensor(0.731, device=cuda)
    out = tm.ternary_matmul_w2a8(x, packed, alpha)
    assert torch.equal(out, tm.ternary_matmul_w2a8_reference(x, packed, alpha))


def test_plain_quantization_is_one_function_on_cpu_and_card(cuda):
    """The W2A8 kernel's plain version gives the card the CPU's (and JAX's)
    bits: its scale is an IEEE quotient on both devices."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4096, 256)).astype(np.float32))
    q, scale = tm.quantize_activations_int8(x)
    qc, scalec = tm.quantize_activations_int8(x.to(cuda))
    assert torch.equal(scale, scalec.cpu()) and torch.equal(q, qc.cpu())


def _launch(int8, x, packed, alpha, mt, nsplit):
    """One launch with the given tiles (the wrappers let the plan choose)."""
    from onebit_asr_tpu_torch.ops import _build

    M, K = x.shape
    N = packed.shape[1]
    out = torch.full((M, N), float("nan"), device=x.device)
    args = (packed.data_ptr(), alpha.data_ptr(), out.data_ptr(), M, K, N, mt, nsplit,
            tm._flags(x, packed), x.device.index, torch.cuda.current_stream().cuda_stream)
    lib = _build.library()
    if int8:
        err = lib.ternary_matmul_w2a8(x.data_ptr(), int(x.dtype == torch.float32), *args)
    else:
        err = lib.ternary_matmul_bf16(x.data_ptr(), *args)
    _build.check(err, "ternary launch")
    return out


@pytest.mark.parametrize("shape", [(100, 256, 300), (70, 1100, 260), (33, 36, 640)])
def test_every_tiling_gives_the_same_result(cuda, shape):
    """Every rows-per-CTA (16, 32, 64) and every split of N (one chunk per
    CTA, or several walked with the slab of the next prefetched) against the
    plain version; two launches of one tiling give the same bits."""
    x, packed, alpha = _case(*shape, seed=sum(shape) + 2, device=cuda)
    ref = tm.ternary_matmul_reference(x, packed, alpha)
    ref8 = tm.ternary_matmul_w2a8_reference(x, packed, alpha)
    tiles_n = -(-shape[2] // 128)
    for mt in (1, 2, 4):
        for nsplit in sorted({1, 2, tiles_n}):
            out = _launch(False, x, packed, alpha, mt, nsplit)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
            assert torch.equal(out, _launch(False, x, packed, alpha, mt, nsplit))
            out8 = _launch(True, x, packed, alpha, mt, nsplit)
            assert torch.equal(out8, ref8), (mt, nsplit)
            assert torch.equal(out8, _launch(True, x, packed, alpha, mt, nsplit))


def test_w2a8_call_is_one_kernel(cuda):
    """The per-row quantization runs inside the launch: one CUDA call of
    ternary_matmul_w2a8 on bf16 x is one device kernel and nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, packed, alpha = _case(4096, 256, 256, seed=5, device=cuda)
    tm.ternary_matmul_w2a8(x, packed, alpha)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tm.ternary_matmul_w2a8(x, packed, alpha)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "ternary_w2a8_kernel" in names[0], names


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
    # contiguous views at an odd offset: x and the weight both misaligned
    xs = x.new_zeros(65 * 64 + 1)[1:].view(65, 64).copy_(x)
    ps = packed.new_zeros(16 * 64 + 3)[3:].view(16, 64).copy_(packed)
    assert xs.data_ptr() % 16 and ps.data_ptr() % 16 and tm._flags(xs, ps) == 0
    torch.testing.assert_close(
        tm.ternary_matmul(xs, ps, alpha),
        tm.ternary_matmul_reference(x, packed, alpha), rtol=1e-5, atol=1e-4,
    )
    assert torch.equal(
        tm.ternary_matmul_w2a8(xs, ps, alpha),
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


def _subsample_operands(B, T, F, C, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.standard_normal((B, T, F)),
        rng.standard_normal((3, 3, C)) * 0.3,
        rng.standard_normal((C,)) * 0.1,
        rng.standard_normal((9 * C, C)) / np.sqrt(9 * C),
        rng.standard_normal((C,)) * 0.1,
    )
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


# (B, T, F, C): Conformer-S/M/L widths at the 16 s serving shape (T2=398,
# not a multiple of the kernel's row block), B=1, a short T2=9, a narrow F;
# T2=257 (a multiple of neither the 5- or 6-row blocks nor the dw2 pass's
# 16-row blocks) at Conformer-S/M/L widths; C=272 (a last 16-channel conv1
# slice and a second, 16-wide output chunk) and C=48
SUBSAMPLE_SHAPES = [
    (8, 1598, 80, 256), (2, 1598, 80, 144), (2, 1598, 80, 512),
    (1, 1598, 80, 256), (3, 43, 80, 256), (2, 101, 17, 64), (1, 7, 7, 16),
    (3, 1031, 80, 144), (3, 1031, 80, 256), (2, 1031, 80, 512), (2, 301, 80, 272),
    (2, 301, 80, 48),
]


@pytest.mark.parametrize("shape", SUBSAMPLE_SHAPES)
def test_fused_subsample_kernel_matches_plain(cuda, shape):
    B, T, F, C = shape
    ops = _subsample_operands(*shape, seed=sum(shape), device=cuda)
    ops[3] = ops[3].to(torch.bfloat16)
    before = ss.fused_subsample.launches
    out = ss.fused_subsample(*ops)
    torch.cuda.synchronize()
    assert ss.fused_subsample.launches == before + 1
    ref = ss.fused_subsample_reference(*ops)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert out.shape == (B, ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F)), C)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)


def test_fused_subsample_kernel_gives_the_same_bits_twice(cuda):
    ops = _subsample_operands(3, 1031, 80, 256, seed=11, device=cuda)
    ops[3] = ops[3].to(torch.bfloat16)
    out = ss.fused_subsample(*ops)
    assert torch.equal(out, ss.fused_subsample(*ops))


def _launch_subsample(ops, r2, g=None):
    """The forward (or, with g, the mask pass) at r2 output rows per CTA."""
    from onebit_asr_tpu_torch.ops import _build

    x, w1, b1, w2, b2 = ops
    B, T, F = x.shape
    C = w1.shape[-1]
    T2, F2 = ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F))
    out = torch.full((B, T2, F2, C), float("nan"), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    if g is None:
        err = lib.fused_subsample_fwd(*(t.data_ptr() for t in (x, w1, b1, w2, b2, out)), B, T, F,
                                      C, r2, x.device.index, stream)
    else:
        err = lib.fused_subsample_bwd_mask(*(t.data_ptr() for t in (x, w1, b1, w2, b2, g, out)),
                                           B, T, F, C, r2, x.device.index, stream)
    _build.check(err, "subsampler launch")
    return out


@pytest.mark.parametrize("shape", [(2, 301, 80, 144), (3, 1031, 80, 256), (2, 101, 17, 64)])
def test_every_subsample_tiling_gives_the_same_bits(cuda, shape):
    """Every rows-per-CTA the forward takes sums conv2 in the same k order,
    so the forward and the mask pass give the same bits at each, within one
    bf16 ulp of the plain version; two launches give the same bits."""
    ops = _subsample_operands(*shape, seed=sum(shape) + 3, device=cuda)
    ops[3] = ops[3].to(torch.bfloat16)
    g = _subsample_cotangent(*shape, seed=sum(shape) + 4, device=cuda)
    plan = ss.launch_plan(*shape)
    ref = ss.fused_subsample_reference(*ops)
    want = _launch_subsample(ops, plan["fwd_r2"])
    want_gm = _launch_subsample(ops, plan["fwd_r2"], g)
    torch.testing.assert_close(want.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)
    assert torch.equal(want, ss.fused_subsample(*ops))
    assert torch.equal(want_gm.reshape(-1, shape[3]), ss.masked_cotangent(*ops, g))
    for r2 in range(1, plan["fwd_r2_max"] + 1):
        assert torch.equal(_launch_subsample(ops, r2), want), r2
        assert torch.equal(_launch_subsample(ops, r2, g), want_gm), r2


def test_fused_subsample_kernel_takes_unaligned_views(cuda):
    """Operands that start off a 16-byte boundary are copied, not misread."""
    ops = _subsample_operands(2, 101, 80, 32, seed=5, device=cuda)
    ops[3] = ops[3].to(torch.bfloat16)
    views = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].reshape(t.shape) for t in ops]
    assert all(v.data_ptr() % 16 for v in views)
    torch.testing.assert_close(ss.fused_subsample(*views).float(),
                               ss.fused_subsample_reference(*ops).float(),
                               rtol=2.0 ** -7, atol=1e-3)


def test_fused_subsample_kernel_refuses_what_it_does_not_take(cuda):
    ops = _subsample_operands(1, 43, 80, 24, seed=0, device=cuda)
    before = ss.fused_subsample.launches
    with pytest.raises(ValueError):
        ss.fused_subsample(*ops)  # C % 16 != 0
    ops = _subsample_operands(1, 43, 80, 32, seed=0, device=cuda)
    with pytest.raises(NotImplementedError):
        ss.fused_subsample(*ops, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError):
        ss.fused_subsample(ops[0], ops[1].cpu(), *ops[2:])
    assert ss.fused_subsample.launches == before


def test_fused_subsampler_forward_on_kernels_matches_plain(cuda):
    """A small packed model with fused_subsampler=True: one subsampler
    launch per forward, and CTC log-probs close to the same model on the
    plain versions."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, packed_model_from_jax
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=40, enc_d_model=64, enc_layers=2,
        enc_heads=2, enc_d_ff=128, enc_conv_kernel=7, fused_subsampler=True,
    )
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((3, 301, 80)).astype(np.float32)).to(cuda)
    lens = torch.tensor([301, 250, 120], device=cuda)
    model = packed_model_from_jax(cfg, init_params(cfg, seed=0), 2, False, cuda)
    before = ss.fused_subsample.launches
    with torch.inference_mode():
        _, mask, logits = model(feats, lens)
        assert ss.fused_subsample.launches == before + 1
        model.encoder.subsample.subsample_fn = ss.fused_subsample_reference
        for m in model.modules():
            if isinstance(m, QuantDense):
                m.matmul = tm.ternary_matmul_reference
        _, _, ref = model(feats, lens)
    lp = torch.log_softmax(logits.float(), -1)[mask]
    lp_ref = torch.log_softmax(ref.float(), -1)[mask]
    assert torch.isfinite(lp).all()
    assert (lp - lp_ref).abs().max().item() < 0.1


SUBSAMPLE_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
MASK_SLACK = 2.0 ** -14  # of |pat| |w2| + |b2|: y_pre this close to 0 may fall either way


def _subsample_cotangent(B, T, F, C, seed, device):
    """A bf16 cotangent [B, T2, F2, C] with a fifth of its elements 0."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, ss.out_len(ss.out_len(T)), ss.out_len(ss.out_len(F)), C))
    g[rng.random(g.shape) < 0.2] = 0.0
    return torch.from_numpy(g.astype(np.float32)).to(device).to(torch.bfloat16)


def _assert_subsample_bwd_close(ops, g, grads):
    """Row 6's gradients against its plain version, in two halves (the
    module docstring): returns the number of mask elements that differ."""
    gm = ss.masked_cotangent(*ops, g)
    gm_ref, y_pre = ss.masked_cotangent_reference(*ops, g)
    _, pat, _ = ss._pre_activations(*ops, torch.bfloat16)
    scale = pat.float() @ ops[3].to(torch.bfloat16).float().abs() + ops[4].abs()
    differ = gm.float() != gm_ref
    assert bool((y_pre.abs()[differ] <= MASK_SLACK * scale[differ]).all())
    want = ss.bwd_of_masked_reference(*ops, gm)
    for name, a, r, tol in zip(SUBSAMPLE_GRADS, grads, want, (2.0 ** -7,) * 3 + (1e-4,) * 2):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        d = (a - r).abs()
        assert bool((d <= tol * (r.abs() + r.abs().max())).all()), (name, d.max().item())
    return int(differ.sum())


# (B, T, F, C): the train step's shape of Conformer-M (B=16 per branch,
# T=1024), a ragged T2=25 (not a multiple of the row blocks), Conformer-S's
# C=144 (a 16-wide last slice), Conformer-L's C=512, a narrow F, one pixel;
# T2=257 (a multiple of none of the 5-, 6- or 16-row blocks) at
# Conformer-S/M/L widths; C=272 (a 16-wide last slice and output chunk)
SUBSAMPLE_BWD_SHAPES = [
    (16, 1024, 80, 256), (3, 103, 80, 256), (2, 600, 80, 144), (2, 301, 80, 512),
    (2, 101, 17, 64), (1, 7, 7, 16),
    (3, 1031, 80, 144), (3, 1031, 80, 256), (2, 1031, 80, 512), (2, 301, 80, 272),
]


@pytest.mark.parametrize("shape", SUBSAMPLE_BWD_SHAPES)
def test_fused_subsample_bwd_kernel_matches_plain(cuda, shape):
    ops = _subsample_operands(*shape, seed=sum(shape), device=cuda)
    g = _subsample_cotangent(*shape, seed=sum(shape) + 1, device=cuda)
    before = ss.fused_subsample_bwd.launches
    out = ss.fused_subsample_bwd(*ops, g)
    again = ss.fused_subsample_bwd(*ops, g)
    torch.cuda.synchronize()
    assert ss.fused_subsample_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    _assert_subsample_bwd_close(ops, g, out)


def test_fused_subsample_bwd_kernel_takes_unaligned_views(cuda):
    ops = _subsample_operands(2, 101, 80, 32, seed=6, device=cuda)
    g = _subsample_cotangent(2, 101, 80, 32, seed=7, device=cuda)
    views = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].reshape(t.shape) for t in ops + [g]]
    assert all(v.data_ptr() % 16 for v in views)
    got = ss.fused_subsample_bwd(*views)
    for a, b in zip(got, ss.fused_subsample_bwd(*ops, g)):
        assert torch.equal(a, b)


def test_fused_subsample_bwd_kernel_refuses_what_it_does_not_take(cuda):
    ops = _subsample_operands(1, 43, 80, 24, seed=0, device=cuda)
    before = ss.fused_subsample_bwd.launches
    with pytest.raises(ValueError):  # C % 16 != 0
        ss.fused_subsample_bwd(*ops, _subsample_cotangent(1, 43, 80, 24, seed=0, device=cuda))
    ops = _subsample_operands(1, 43, 80, 32, seed=0, device=cuda)
    g = _subsample_cotangent(1, 43, 80, 32, seed=0, device=cuda)
    with pytest.raises(NotImplementedError):  # f32 compute
        ss.fused_subsample_bwd(*ops, g, compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError):  # an f32 cotangent
        ss.fused_subsample_bwd(*ops, g.float())
    with pytest.raises(RuntimeError):  # split devices
        ss.fused_subsample_bwd(*ops, g.cpu())
    assert ss.fused_subsample_bwd.launches == before


def test_fused_subsampler_train_step_on_kernels_matches_plain(cuda, monkeypatch):
    """One small-model 3-branch loss and its gradients under fused_subsampler
    (bf16, dropout 0.1 from seeded generators) on the kernels (one forward
    and one backward launch per branch) against the same step with the
    plain Function: aux rtol 1e-2, gradients within 0.1 of their norm (bf16
    layers carry an element rounded the other way)."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule
    from onebit_asr_tpu_torch.train.state import create_train_state
    from onebit_asr_tpu_torch.train.step import batch_to_device, make_batch_loss, value_and_grad
    from onebit_asr_tpu_torch.utils.config import LossConfig, ModelConfig, SpecialTokens

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=32, enc_d_model=64, enc_layers=2, enc_heads=2,
        enc_d_ff=128, enc_conv_kernel=7, dec_layers=1, dec_d_ff=64, dropout=0.1,
        fused_subsampler=True)
    model = qat_model_from_jax(cfg, init_params(cfg, 0), device="cuda")
    state = create_train_state(model, 0)
    batch_loss = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)
    batch = batch_to_device(next(iter(DummyDataModule(batch_size=4).train_batches(0))), cuda)
    sp = torch.tensor([True, False])

    def run():
        gens = [torch.Generator(device="cuda").manual_seed(i) for i in range(3)]
        return value_and_grad(batch_loss, state.params, batch, sp, gens)

    counts = (ss.fused_subsample.launches, ss.fused_subsample_bwd.launches)
    (_, aux), grads = run()
    assert (ss.fused_subsample.launches - counts[0],
            ss.fused_subsample_bwd.launches - counts[1]) == (3, 3)
    monkeypatch.setattr(model.encoder.subsample, "subsample_fn", ss.fused_subsample_plain)
    (_, ref_aux), ref_grads = run()
    for k in aux:
        assert torch.allclose(aux[k], ref_aux[k], rtol=1e-2), k
    num = sum(float(((grads[k] - ref_grads[k]).float() ** 2).sum()) for k in grads)
    den = sum(float((ref_grads[k].float() ** 2).sum()) for k in grads)
    assert (num / den) ** 0.5 <= 0.1
    for k in ("conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"):
        g = grads[f"encoder.subsample.{k}"]
        assert g.dtype == torch.float32 and float(g.abs().max()) > 0, k


def _attention_operands(B, H, T, dh, seed, device, lens=None, rate=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, dh)) for _ in range(3))
    p = rng.standard_normal((H, 2 * T - 1, dh))
    u, vb = (0.1 * rng.standard_normal((H, dh)) for _ in range(2))
    if lens is None:
        lens = rng.integers(T // 2, T + 1, size=B)
    key_mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    ops = [torch.from_numpy(a.astype(np.float32)).to(device).to(torch.bfloat16)
           for a in (q, k, v, p, u, vb)]
    drop8 = (rng.integers(0, 256, size=(B, H, T, T), dtype=np.uint8) if rate
             else np.zeros((1, 1, 1, 1), np.uint8))
    return ops + [torch.from_numpy(key_mask).to(device), torch.from_numpy(drop8).to(device)]


def _assert_attention_close(out, ref):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    d = (out.float() - ref.float()).abs()
    bound = 1e-2 + 2.0 ** -7 * ref.float().abs()
    assert bool((d <= bound).all()), d.max().item()


# (B, H, T, dh): B=1 at T=37 (one ragged key tile) and T=512 (the serving
# T' of 16 s), the Conformer-M/L head width 64, Conformer-S 36 (rows not
# 16-byte aligned), 16 and 32; then the serving shape at B=8; tile edges:
# T=257 and 511 (a last tile of 1 and of 63 rows, the draws' rows not
# 16-byte aligned), T=1000 (16 tiles: the p-block ring wraps four times a
# pass) and T=1 (a single key)
ATTENTION_SHAPES = [
    (1, 2, T, dh) for T in (37, 512) for dh in (16, 36, 64)
] + [(1, 2, 100, 32), (8, 4, 512, 64), (2, 2, 257, 64), (1, 2, 511, 64), (1, 1, 1000, 64),
     (2, 2, 1, 16)]


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_fused_attention_kernel_matches_plain(cuda, shape):
    from onebit_asr_tpu_torch.ops import attention as fa

    B, H, T, dh = shape
    ops = _attention_operands(*shape, seed=sum(shape), device=cuda)
    scale = 1.0 / float(np.sqrt(dh))
    before = fa.fused_relpos_attention.launches
    out = fa.fused_relpos_attention(*ops, scale, 0.0)
    torch.cuda.synchronize()
    assert fa.fused_relpos_attention.launches == before + 1
    ref = fa.fused_relpos_attention_reference(*ops, scale, 0.0)
    _assert_attention_close(out, ref)


@pytest.mark.parametrize("T", [37, 130])
def test_fused_attention_kernel_ragged_keys_and_all_pad_row(cuda, T):
    """Key lengths that end inside a key tile, a row with no valid key
    (uniform 1/T over all T keys, not over the tile-rounded length), and a
    full row."""
    from onebit_asr_tpu_torch.ops import attention as fa

    ops = _attention_operands(3, 2, T, 36, seed=T, device=cuda, lens=[T - 5, 0, T])
    out = fa.fused_relpos_attention(*ops, 1 / 6, 0.0)
    ref = fa.fused_relpos_attention_reference(*ops, 1 / 6, 0.0)
    _assert_attention_close(out, ref)
    uniform = ops[2][1].float().mean(-2, keepdim=True).expand(-1, T, -1)
    torch.testing.assert_close(out[1].float(), uniform, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("dh", [16, 36, 64])
def test_fused_attention_kernel_dropout(cuda, dh):
    from onebit_asr_tpu_torch.ops import attention as fa

    ops = _attention_operands(2, 2, 77, dh, seed=dh, device=cuda, rate=0.1)
    out = fa.fused_relpos_attention(*ops, 0.125, 0.1)
    ref = fa.fused_relpos_attention_reference(*ops, 0.125, 0.1)
    _assert_attention_close(out, ref)
    assert not torch.allclose(out, fa.fused_relpos_attention_reference(*ops, 0.125, 0.0))


@pytest.mark.parametrize("shape,rate", [((2, 2, 100, 64), 0.1), ((1, 4, 512, 64), 0.0),
                                        ((2, 2, 77, 36), 0.1), ((3, 1, 1000, 16), 0.0)])
def test_fused_attention_kernel_gives_the_same_bits_twice(cuda, shape, rate):
    """Two launches give the same bits; the training forward, which also
    writes each row's max and sum, gives the serving forward's bits, and its
    statistics match the plain ones (the same products summed in another
    f32 order: m within 1e-4 (1 + |m|), l within 1e-4 relative)."""
    from onebit_asr_tpu_torch.ops import attention as fa

    B, H, T, dh = shape
    ops = _attention_operands(*shape, seed=T + dh, device=cuda, rate=rate)
    scale = 1.0 / float(np.sqrt(dh))
    out = fa.fused_relpos_attention(*ops, scale, rate)
    again = fa.fused_relpos_attention(*ops, scale, rate)
    trained, (m, l) = fa._fwd(*ops, scale, rate, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, trained)
    q, k, _, p, u, vb, key_mask, _ = ops
    m_ref, l_ref = fa.row_stats_reference(q, k, p, u, vb, key_mask, scale)
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == (B, H, T)
    assert bool(((m - m_ref).abs() <= 1e-4 * (1 + m_ref.abs())).all())
    assert bool(((l - l_ref).abs() <= 1e-4 * l_ref).all())


# sm_div_rows of csrc/attention_common.cuh (the softmax's divide: each
# row's reciprocal taken once, the divide itself for a warp that holds a
# tiny numerator) and the IEEE divide, side by side in one kernel: thread i
# divides a[4i .. 4i+3] by the row sums b[2i] (the first two) and b[2i+1]
DIVIDE_CHECK_CU = r"""
#include "attention_common.cuh"
__global__ void divide_check_kernel(const float* a, const float* b, float* q, float* r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float e[1][4];
  const float l[2] = {b[2 * i], b[2 * i + 1]};
  const float y[2] = {sm_rcp(l[0]), sm_rcp(l[1])};
  for (int x = 0; x < 4; ++x) e[0][x] = a[4 * i + x];
  sm_div_rows(e, l, y);
  for (int x = 0; x < 4; ++x) {
    q[4 * i + x] = e[0][x];
    r[4 * i + x] = a[4 * i + x] / l[x >> 1];
  }
}
extern "C" int divide_check(const void* a, const void* b, void* q, void* r, int threads) {
  divide_check_kernel<<<threads / 256, 256>>>(static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(q), static_cast<float*>(r));
  return (int)cudaGetLastError();
}
"""


def test_softmax_divide_gives_the_ieee_quotient(cuda, tmp_path):
    """The kernels' softmax divide (sm_div_rows: a row sum's reciprocal
    taken once, then Markstein's FMA correction; the divide itself for a
    warp holding a numerator below 2^-96) equals a / b bit for bit: 2^24
    numerators in [2^-96, 1) (log-uniform, random significands: the FMA
    path), 2^20 in [2^-126, 2^-90) (the divide's path and the switch), 0
    and 1, over row sums in [1, 2^13) with random significands, with
    all-ones significands and every integer up to 4096."""
    import ctypes
    import subprocess

    from onebit_asr_tpu_torch.ops import _build

    src = tmp_path / "divide_check.cu"
    src.write_text(DIVIDE_CHECK_CU)
    lib_path = tmp_path / "divide_check.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                    "-shared", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.divide_check.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    rng = np.random.default_rng(7)

    def floats(lo_exp, hi_exp, size):
        e = rng.integers(lo_exp, hi_exp, size).astype(np.uint32)
        m = rng.integers(0, 1 << 23, size).astype(np.uint32)
        return ((e + 127) << 23 | m).view(np.float32)

    ones = ((rng.integers(0, 13, 4096).astype(np.uint32) + 127) << 23 | 0x7FFFFF).view(np.float32)
    a = np.concatenate([floats(-96, 0, 1 << 24), floats(-126, -90, 1 << 20),
                        np.zeros(4096, np.float32), np.ones(4096, np.float32)])
    b = np.concatenate([floats(0, 13, len(a) // 2 - 8192), ones,
                        np.arange(1, 4097, dtype=np.float32)])
    threads = len(a) // 4
    assert len(a) == 4 * threads == 2 * len(b) and threads % 256 == 0
    at, bt = (torch.from_numpy(x).to(cuda) for x in (a, b))
    q, r = torch.empty_like(at), torch.empty_like(at)
    assert lib.divide_check(at.data_ptr(), bt.data_ptr(), q.data_ptr(), r.data_ptr(),
                            threads) == 0
    torch.cuda.synchronize()
    assert torch.equal(q.view(torch.int32), r.view(torch.int32))


def test_fused_attention_kernel_refuses_what_it_does_not_take(cuda):
    from onebit_asr_tpu_torch.ops import attention as fa

    ops = _attention_operands(1, 2, 40, 16, seed=0, device=cuda)
    before = fa.fused_relpos_attention.launches
    with pytest.raises(NotImplementedError):  # f32 operands
        fa.fused_relpos_attention(*(t.float() for t in ops[:6]), *ops[6:], 0.25, 0.0)
    wide = _attention_operands(1, 1, 40, 128, seed=0, device=cuda)
    with pytest.raises(ValueError):  # dh > 64
        fa.fused_relpos_attention(*wide, 0.25, 0.0)
    with pytest.raises(RuntimeError):  # split devices
        fa.fused_relpos_attention(*ops[:3], ops[3].cpu(), *ops[4:], 0.25, 0.0)
    assert fa.fused_relpos_attention.launches == before


def test_fused_attention_forward_on_kernels_matches_plain(cuda):
    """A small packed model with fused_attention (and fused_subsampler):
    one attention launch per block, and CTC log-probs close to the same
    model on the plain versions."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, packed_model_from_jax
    from onebit_asr_tpu_torch.model.layers import QuantDense
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.utils.config import ModelConfig

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=40, enc_d_model=64, enc_layers=2, enc_heads=2,
        enc_d_ff=128, enc_conv_kernel=7, fused_attention=True, fused_subsampler=True,
    )
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((3, 301, 80)).astype(np.float32)).to(cuda)
    lens = torch.tensor([301, 250, 120], device=cuda)
    model = packed_model_from_jax(cfg, init_params(cfg, seed=0), 2, False, cuda)
    before = fa.fused_relpos_attention.launches
    with torch.inference_mode():
        _, mask, logits = model(feats, lens)
        assert fa.fused_relpos_attention.launches == before + cfg.enc_layers
        model.encoder.subsample.subsample_fn = ss.fused_subsample_reference
        for m in model.modules():
            if isinstance(m, QuantDense):
                m.matmul = tm.ternary_matmul_reference
        for block in model.encoder.blocks:
            block.mhsa.attention_fn = fa.fused_relpos_attention_reference
        _, _, ref = model(feats, lens)
    lp = torch.log_softmax(logits.float(), -1)[mask]
    lp_ref = torch.log_softmax(ref.float(), -1)[mask]
    assert torch.isfinite(lp).all()
    assert (lp - lp_ref).abs().max().item() < 0.1


def _assert_attention_grads_close(grads, ref):
    for name, a, r in zip(("dq", "dk", "dv", "dp", "du", "dvb"), grads, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        a, r = a.float(), r.float()
        assert bool(torch.isfinite(a).all()), name
        d = (a - r).abs()
        assert bool((d <= 2.0 ** -7 * (r.abs() + r.abs().max())).all()), (name, d.max().item())


# (B, H, T, dh): one tile, the train step's shape of Conformer-M (B=16,
# T'=256), a ragged last tile (T=255), Conformer-S's dh=36 at T=200, the
# serving T'=512; dh=16; tile edges: T=257 and 511 (a last tile of 1 and
# of 63 rows), T=1000 (16 tiles: the p-block ring wraps five times) and T=1
ATTENTION_BWD_SHAPES = [(2, 4, 16, 64), (16, 4, 256, 64), (3, 4, 255, 64), (2, 2, 200, 36),
                        (8, 4, 512, 64), (2, 2, 100, 16), (2, 2, 257, 64), (1, 2, 511, 64),
                        (1, 1, 1000, 64), (2, 1, 1, 16)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", ATTENTION_BWD_SHAPES)
def test_fused_attention_bwd_kernel_matches_plain(cuda, shape, rate):
    """Ragged key lengths and an all-pad last row; two launches give the
    same bits."""
    from onebit_asr_tpu_torch.ops import attention as fa

    B, H, T, dh = shape
    rng = np.random.default_rng(sum(shape))
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0
    ops = _attention_operands(*shape, seed=sum(shape), device=cuda, lens=lens, rate=rate)
    g = torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32)).to(cuda)
    g = g.to(torch.bfloat16)
    scale = 1.0 / float(np.sqrt(dh))
    before = fa.fused_relpos_attention_bwd.launches
    out = fa.fused_relpos_attention_bwd(*ops, g, scale, rate)
    again = fa.fused_relpos_attention_bwd(*ops, g, scale, rate)
    torch.cuda.synchronize()
    assert fa.fused_relpos_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    _assert_attention_grads_close(out, fa.fused_relpos_attention_bwd_reference(*ops, g, scale,
                                                                               rate))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (3, 2, 130, 36), (2, 2, 70, 16)])
def test_fused_attention_bwd_on_saved_statistics_gives_the_same_bits(cuda, shape, rate):
    """The backward on the row statistics the training forward wrote gives
    the bits of the backward that computes them itself, launch after
    launch."""
    from onebit_asr_tpu_torch.ops import attention as fa

    B, H, T, dh = shape
    rng = np.random.default_rng(T + dh)
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0
    ops = _attention_operands(*shape, seed=T + dh, device=cuda, lens=lens, rate=rate)
    g = torch.from_numpy(rng.standard_normal((B, H, T, dh)).astype(np.float32)).to(cuda)
    g = g.to(torch.bfloat16)
    scale = 1.0 / float(np.sqrt(dh))
    _, stats = fa._fwd(*ops, scale, rate, stats=True)
    own = fa.fused_relpos_attention_bwd(*ops, g, scale, rate)
    saved = fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats)
    again = fa.fused_relpos_attention_bwd(*ops, g, scale, rate, stats=stats)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(own, saved))
    assert all(torch.equal(a, b) for a, b in zip(saved, again))


def test_fused_attention_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from onebit_asr_tpu_torch.ops import attention as fa

    ops = _attention_operands(1, 2, 40, 16, seed=0, device=cuda)
    g = torch.zeros_like(ops[0])
    before = fa.fused_relpos_attention_bwd.launches
    with pytest.raises(NotImplementedError):  # f32 operands
        fa.fused_relpos_attention_bwd(*(t.float() for t in ops[:6]), *ops[6:], g.float(),
                                      0.25, 0.0)
    with pytest.raises(NotImplementedError):  # an f32 cotangent
        fa.fused_relpos_attention_bwd(*ops, g.float(), 0.25, 0.0)
    wide = _attention_operands(1, 1, 40, 128, seed=0, device=cuda)
    with pytest.raises(ValueError):  # dh > 64
        fa.fused_relpos_attention_bwd(*wide, torch.zeros_like(wide[0]), 0.25, 0.0)
    with pytest.raises(RuntimeError):  # split devices
        fa.fused_relpos_attention_bwd(*ops, g.cpu(), 0.25, 0.0)
    with pytest.raises(ValueError):  # row statistics of another shape
        fa.fused_relpos_attention_bwd(*ops, g, 0.25, 0.0,
                                      stats=(torch.zeros(1, device=cuda),) * 2)
    assert fa.fused_relpos_attention_bwd.launches == before


def test_fused_attention_train_step_on_kernels_matches_plain(cuda, monkeypatch):
    """One small-model 3-branch loss and its gradients under fused_attention
    (bf16, dropout 0.1 from seeded generators) with the attention on the
    kernels (one forward and one backward launch per block and branch)
    against the same step with the plain Function: aux rtol 1e-2, gradients
    within 0.1 of their norm (bf16 layers carry an element rounded the other
    way)."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule
    from onebit_asr_tpu_torch.model.conformer import RelPosMHSA
    from onebit_asr_tpu_torch.ops import attention as fa
    from onebit_asr_tpu_torch.train.state import create_train_state
    from onebit_asr_tpu_torch.train.step import batch_to_device, make_batch_loss, value_and_grad
    from onebit_asr_tpu_torch.utils.config import LossConfig, ModelConfig, SpecialTokens

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=32, enc_d_model=64, enc_layers=2, enc_heads=2,
        enc_d_ff=128, enc_conv_kernel=7, dec_layers=1, dec_d_ff=64, dropout=0.1,
        fused_attention=True)
    model = qat_model_from_jax(cfg, init_params(cfg, 0), device="cuda")
    state = create_train_state(model, 0)
    batch_loss = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)
    batch = batch_to_device(next(iter(DummyDataModule(batch_size=4).train_batches(0))), cuda)
    sp = torch.tensor([True, False])

    def run():
        gens = [torch.Generator(device="cuda").manual_seed(i) for i in range(3)]
        return value_and_grad(batch_loss, state.params, batch, sp, gens)

    counts = (fa.fused_relpos_attention.launches, fa.fused_relpos_attention_bwd.launches)
    (_, aux), grads = run()
    assert (fa.fused_relpos_attention.launches - counts[0],
            fa.fused_relpos_attention_bwd.launches - counts[1]) == (6, 6)
    for m in model.modules():
        if isinstance(m, RelPosMHSA):
            monkeypatch.setattr(m, "attention_fn", fa.fused_relpos_attention_plain)
    (_, ref_aux), ref_grads = run()
    for k in aux:
        assert torch.allclose(aux[k], ref_aux[k], rtol=1e-2), k
    num = sum(float(((grads[k] - ref_grads[k]).float() ** 2).sum()) for k in grads)
    den = sum(float((ref_grads[k].float() ** 2).sum()) for k in grads)
    assert (num / den) ** 0.5 <= 0.1


def _lattice_operands(B, T, U, seed, device, vocab=None):
    """Emissions of random logits for random labels (from a small vocabulary
    by default, so labels repeat), with ragged lengths: row 0 full length,
    row 1 label length 0, row 2 fewer frames than its labels need."""
    from onebit_asr_tpu_torch.losses import ctc as tctc

    rng = np.random.default_rng(seed)
    V = vocab or 9
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32) * 2).to(device)
    labels = torch.from_numpy(rng.integers(4, V, (B, U))).to(device)
    label_lens = torch.from_numpy(rng.integers(0, U + 1, B)).to(device)
    lens = torch.from_numpy(rng.integers(1, T + 1, B)).to(device)
    lens[0] = T
    if B > 2:
        label_lens[1] = 0
        label_lens[2], lens[2] = U, max(1, min(T, U - 1))
    z, can_skip = tctc._extended_targets(labels, 3)
    emit, _ = tctc._emissions(logits, z)
    S = z.shape[1]
    s_idx = torch.arange(S, device=device)[None]
    ll = label_lens[:, None]
    beta0 = torch.where((s_idx == 2 * ll) | ((s_idx == 2 * ll - 1) & (ll > 0)), 0.0,
                        cl.NEG_INF).float()
    return emit, lens, can_skip, tctc._alpha0_of(emit, label_lens), beta0


def _assert_lattice_close(out, ref):
    neg = ref <= cl.NEG_INF / 2
    assert torch.equal(out <= cl.NEG_INF / 2, neg)
    d = (out - ref).abs()[~neg]
    assert bool((d <= 1e-5 * ref.abs()[~neg] + 1e-5).all()), d.max().item()


def _assert_lattice_exact(out, ref):
    assert torch.equal(out, ref), (out != ref).sum().item()
    _assert_lattice_close(out, ref)


LATTICES = ((cl.ctc_alpha, cl.ctc_alpha_reference, 3), (cl.ctc_beta, cl.ctc_beta_reference, 4))


def _lattice_operands_s(B, T, S, seed, device):
    """`_lattice_operands` at any S (those of 2 (S // 2) + 1 states cut to
    S, so even S too), with row 3 of length 1 and row 4 longer than T."""
    ops = _lattice_operands(B, T, S // 2, seed, device)
    emit, lens, skip, alpha0, beta0 = (x[..., :S].contiguous() if x.dim() > 1 else x
                                       for x in ops)
    lens[3], lens[4] = 1, T + 3
    return emit, lens, skip, alpha0, beta0


# csrc/ctc_lattice.cu's variants: 1 state a lane on up to 32 warps (S <=
# 1024; 97 is the train step's S, 457 LibriSpeech's ceiling), 32 on up to
# 16 (S <= 16384); S on every warp and variant boundary
VARIANT_S = [1, 2, 3, 31, 32, 33, 63, 64, 65, 97, 127, 128, 129, 457, 1023, 1024, 1025,
             4095, 4096, 4097, 8193, 16383, 16384]


@pytest.mark.parametrize("T", [1, 2, 37, 512])
@pytest.mark.parametrize("S", VARIANT_S)
def test_ctc_lattice_kernels_match_plain(cuda, S, T):
    """Both kernels equal their plain versions bit for bit, one launch a
    call, with lengths 1, T and > T, label length 0 and a row too short for
    its labels."""
    ops = _lattice_operands_s(6, T, S, S * 7 + T, cuda)
    for fn, plain, i in LATTICES:
        before = fn.launches
        out = fn(*ops[:3], ops[i])
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_lattice_exact(out, plain(*ops[:3], ops[i]))


@pytest.mark.parametrize("S", [25, 97, 457])
def test_ctc_lattice_kernels_take_every_length_and_mask_dtype(cuda, S):
    """int32 and int64 lengths and bool, uint8 and float masks: the same
    bits as the plain version, one launch a call."""
    emit, lens, skip, alpha0, beta0 = _lattice_operands_s(6, 37, S, S, cuda)
    for fn, plain, i in LATTICES:
        init = (alpha0, beta0)[i - 3]
        ref = plain(emit, lens, skip, init)
        for ll in (lens, lens.to(torch.int32)):
            for sk in (skip, skip.to(torch.uint8), skip.float()):
                before = fn.launches
                _assert_lattice_exact(fn(emit, ll, sk, init), ref)
                assert fn.launches == before + 1, (ll.dtype, sk.dtype)


@pytest.mark.parametrize("S", [25, 97, 457, 8193])
def test_ctc_lattice_kernels_give_the_same_bits_twice(cuda, S):
    ops = _lattice_operands_s(6, 64, S, 3, cuda)
    for fn, _, i in LATTICES:
        assert torch.equal(fn(*ops[:3], ops[i]), fn(*ops[:3], ops[i]))


def test_ctc_lattice_call_is_one_kernel(cuda):
    """On the loss's operands (int64 lengths, a bool mask) a wrapper call is
    one device kernel and nothing else: no conversion launch. The profiler
    can drop an event of a session (here it dropped one of 6 every time
    after the file's earlier tests), so the kernels per call are read as
    the difference between sessions of 6 and 3 calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ops = _lattice_operands_s(6, 64, 97, 2, cuda)
    assert ops[1].dtype == torch.int64 and ops[2].dtype == torch.bool

    def kernels(fn, init, calls):
        fn(*ops[:3], init)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*ops[:3], init)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert names and all(fn.__name__ + "_kernel" in n for n in names), names
        return len(names)

    for fn, _, i in LATTICES:
        for _ in range(5):  # the drops may differ between the two sessions: take both again
            per_call = (kernels(fn, ops[i], 6) - kernels(fn, ops[i], 3)) / 3
            if per_call == 1:
                break
        assert per_call == 1, per_call


def test_ctc_lattice_plan_picks_the_variant(cuda):
    assert cl.launch_plan(97) == {"states_per_lane": 1, "warps": 4, "smem": 8 * 128 * 4 + 64}
    assert cl.launch_plan(457)["warps"] == 15
    assert cl.launch_plan(1025) == {"states_per_lane": 32, "warps": 2, "smem": 3 * 2048 * 4 + 32}
    assert cl.launch_plan(cl.MAX_STATES) == {"states_per_lane": 32, "warps": 16,
                                             "smem": 3 * 16384 * 4 + 16 * 16}
    with pytest.raises(RuntimeError):
        cl.launch_plan(cl.MAX_STATES + 1)


def test_ctc_lattice_kernels_beyond_4096_states(cuda):
    """S = 8193: 32 states a lane on 9 warps, a ring 3 rows deep."""
    emit, lens, skip, alpha0, beta0 = _lattice_operands(2, 20, 4096, 7, cuda)
    _assert_lattice_exact(cl.ctc_alpha(emit, lens, skip, alpha0),
                          cl.ctc_alpha_reference(emit, lens, skip, alpha0))
    _assert_lattice_exact(cl.ctc_beta(emit, lens, skip, beta0),
                          cl.ctc_beta_reference(emit, lens, skip, beta0))


def test_ctc_lattice_kernels_refuse_what_they_do_not_take(cuda):
    emit, lens, skip, alpha0, _ = _lattice_operands(3, 12, 4, 1, cuda)
    for fn in (cl.ctc_alpha, cl.ctc_beta):
        before = fn.launches
        for bad in (emit.double(), emit.to(torch.bfloat16)):
            with pytest.raises(TypeError):
                fn(bad, lens, skip, alpha0)
        with pytest.raises(RuntimeError):  # split devices
            fn(emit, lens.cpu(), skip, alpha0)
        S = cl.MAX_STATES + 1
        with pytest.raises(ValueError):
            fn(emit.new_zeros(1, 2, S), lens[:1], skip.new_zeros(1, S), emit.new_zeros(1, S))
        assert fn.launches == before


def test_train_step_on_ctc_kernels_matches_plain_ctc(cuda, monkeypatch):
    """One small-model 3-branch loss and its gradients with the CTC on the
    kernels (one alpha and one beta launch for the three branches) against
    the same step with the plain lattices, f32, dropout 0."""
    import dataclasses

    from onebit_asr_tpu_torch.convert import init_params, qat_model_from_jax
    from onebit_asr_tpu_torch.data.dummy import DummyDataModule
    from onebit_asr_tpu_torch.losses import ctc as tctc
    from onebit_asr_tpu_torch.train.state import create_train_state
    from onebit_asr_tpu_torch.train.step import batch_to_device, make_batch_loss, value_and_grad
    from onebit_asr_tpu_torch.utils.config import LossConfig, ModelConfig, SpecialTokens

    cfg = dataclasses.replace(
        ModelConfig(), vocab_size=32, enc_d_model=64, enc_layers=2, enc_heads=2,
        enc_d_ff=128, enc_conv_kernel=7, dec_layers=1, dec_d_ff=64, dropout=0.0,
        compute_dtype="float32")
    model = qat_model_from_jax(cfg, init_params(cfg, 0), device="cuda")
    state = create_train_state(model, 0)
    batch_loss = make_batch_loss(model, LossConfig(), SpecialTokens(), 2)
    batch = batch_to_device(next(iter(DummyDataModule(batch_size=4).train_batches(0))), cuda)
    sp = torch.tensor([True, False])
    counts = (cl.ctc_alpha.launches, cl.ctc_beta.launches)
    (loss, aux), grads = value_and_grad(batch_loss, state.params, batch, sp, [None] * 3)
    assert (cl.ctc_alpha.launches, cl.ctc_beta.launches) == (counts[0] + 1, counts[1] + 1)
    monkeypatch.setattr(tctc, "ctc_alpha", cl.ctc_alpha_reference)
    monkeypatch.setattr(tctc, "ctc_beta", cl.ctc_beta_reference)
    (ref_loss, ref_aux), ref_grads = value_and_grad(batch_loss, state.params, batch, sp, [None] * 3)
    for k in aux:
        assert torch.allclose(aux[k], ref_aux[k], rtol=1e-5, atol=1e-6), k
    scale = max(g.abs().max() for g in ref_grads.values())
    for k, g in grads.items():
        assert torch.allclose(g, ref_grads[k], rtol=1e-4, atol=1e-6 * scale), k


# ---------------------------------------------------------------------------
# the custom ops (torch.ops.onebit.*) that the wrappers call and a
# torch.export artifact calls: the launch, counted in the same place, with
# nothing of the dispatcher changing a bit; no fallback

OPS = ["ternary_matmul", "ternary_matmul_w2a8", "fused_relpos_attention", "fused_subsample"]


def _op_case(name, device):
    """(the wrapper, the launch the op's CUDA kernel is, its operands at a
    Conformer-M serving shape, B=8, 16 s)."""
    from onebit_asr_tpu_torch.ops import attention as fa

    if name.startswith("ternary_matmul"):
        x, packed, alpha = _case(4096, 256, 1024, seed=5, device=device)
        if name == "ternary_matmul_w2a8":
            return tm.ternary_matmul_w2a8, tm._launch_w2a8, (x.float(), packed, alpha)
        return tm.ternary_matmul, tm._launch_bf16, (x, packed, alpha)
    if name == "fused_relpos_attention":
        ops = _attention_operands(8, 4, 512, 64, seed=7, device=device)
        return fa.fused_relpos_attention, fa._fwd, (*ops, 0.125, 0.0)
    ops = _subsample_operands(8, 1598, 80, 256, seed=9, device=device)
    ops[3] = ops[3].to(torch.bfloat16)
    return ss.fused_subsample, ss._fwd, (*ops, torch.bfloat16)


@pytest.mark.parametrize("name", OPS)
def test_custom_op_launches_the_kernel_and_equals_the_wrapper(cuda, name):
    wrapper, launch, args = _op_case(name, cuda)
    before = wrapper.launches
    out = getattr(torch.ops.onebit, name)(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    refs = (wrapper(*args), launch(*args))  # through the op; the launch without it
    assert wrapper.launches == before + 3
    for ref in refs:
        assert out.dtype == ref.dtype and out.shape == ref.shape and out.device == ref.device
        assert torch.equal(out, ref)


def test_custom_ops_on_the_card_raise_where_the_kernel_does_not_take(cuda):
    ops = _attention_operands(1, 2, 37, 16, seed=3, device=cuda)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        torch.ops.onebit.fused_relpos_attention(*[t.float() for t in ops[:6]], *ops[6:], 0.25,
                                                0.0)
    sub = _subsample_operands(1, 43, 80, 24, seed=3, device=cuda)
    with pytest.raises(ValueError, match="C % 16"):
        torch.ops.onebit.fused_subsample(*sub, torch.bfloat16)
    x, packed, alpha = _case(5, 12, 8, seed=1, device=cuda)
    with pytest.raises(RuntimeError, match="operand on"):
        torch.ops.onebit.ternary_matmul(x, packed.cpu(), alpha)
