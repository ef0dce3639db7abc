"""onebit_asr_tpu_torch's CTC lattices and loss against the JAX package, on CPU.

On the CPU the wrappers `ctc_alpha`/`ctc_beta` run their plain versions; the
JAX side runs its Pallas kernels `ctc_alpha_pallas`/`ctc_beta_pallas` in
interpret mode (called directly, as tests/test_ctc_pallas.py does) and its
lax.scan form. The cases mix repeated labels (the skip mask), label length
0, infeasible rows (fewer frames than the labels need) and T not a multiple
of 8. Tolerances: rtol = atol = 1e-5, f32 arithmetic of the same formulas
in two libraries (exp/log and summation order may differ by an ulp).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onebit_asr_tpu.losses.ctc as jctc
from onebit_asr_tpu.ops.ctc_pallas import ctc_alpha_pallas, ctc_beta_pallas
from onebit_asr_tpu_torch.losses import ctc as tctc
from onebit_asr_tpu_torch.ops import ctc_lattice as cl
from torch_cpu_threads import one_thread  # noqa: F401

BLANK = 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B=4, T=21, V=9, U=5):
    """Logits, lengths and labels with every edge: row 0 label_len 0, row 1
    infeasible (a repeated pair needs an extra blank frame), the others
    random with repeats from a small vocabulary."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2.0
    labels = rng.integers(4, 7, size=(B, U)).astype(np.int32)
    label_lens = rng.integers(min(1, U), U + 1, size=B).astype(np.int32)
    logit_lens = rng.integers(min(2 * U + 1, T), T + 1, size=B).astype(np.int32)
    label_lens[0] = 0
    if B > 2 and U >= 2:
        labels[1, :2] = 5
        label_lens[1], logit_lens[1] = U, U  # repeats need U + 1 frames at least
    logit_lens[-1] = T
    return logits, logit_lens, labels, label_lens


def _lattice_inputs(seed, **kw):
    logits, logit_lens, labels, label_lens = _case(seed, **kw)
    z, can_skip = jctc._extended_targets(jnp.asarray(labels), BLANK)
    emit, _ = jctc._emissions(jnp.asarray(logits), z)
    alpha0 = jctc._alpha0_of(emit, jnp.asarray(label_lens))
    S = z.shape[1]
    s_idx = np.arange(S)[None]
    ll = label_lens[:, None]
    beta0 = np.where((s_idx == 2 * ll) | ((s_idx == 2 * ll - 1) & (ll > 0)), 0.0,
                     jctc.NEG_INF).astype(np.float32)
    # [:, :S]: for U = 0 the JAX mask broadcasts to 2 columns
    return (np.array(emit), logit_lens, np.array(can_skip)[:, :S], np.array(alpha0), beta0)


def _port(emit, logit_lens, can_skip, init):
    return (torch.from_numpy(emit), torch.from_numpy(logit_lens), torch.from_numpy(can_skip),
            torch.from_numpy(np.asarray(init)))


SEEDS_SHAPES = [(0, dict()), (1, dict(T=16)), (2, dict(B=3, T=33, U=7)), (3, dict(T=1, U=0)),
                (4, dict(B=1, T=9, U=1))]
# the JAX scan form cannot stack its [B, 2] skip column at S = 1 (U = 0)
SCAN_SHAPES = SEEDS_SHAPES[:3] + [(3, dict(T=1, U=2))] + SEEDS_SHAPES[4:]


@pytest.mark.parametrize("seed,shape", SEEDS_SHAPES)
def test_plain_lattices_match_jax_pallas_interpret(seed, shape):
    emit, lens, skip, alpha0, beta0 = _lattice_inputs(seed, **shape)
    e_tbs = jnp.moveaxis(jnp.asarray(emit), 1, 0)
    ja = np.moveaxis(np.asarray(ctc_alpha_pallas(e_tbs, lens, skip, alpha0)), 0, 1)
    jb = np.moveaxis(np.asarray(ctc_beta_pallas(e_tbs, lens, skip, beta0)), 0, 1)
    ta = cl.ctc_alpha(*_port(emit, lens, skip, alpha0)).numpy()
    tb = cl.ctc_beta(*_port(emit, lens, skip, beta0)).numpy()
    np.testing.assert_allclose(ta, ja, **TOL)
    np.testing.assert_allclose(tb, jb, **TOL)


@pytest.mark.parametrize("seed,shape", SCAN_SHAPES)
def test_plain_lattices_match_jax_scan(seed, shape, monkeypatch):
    monkeypatch.setattr(jctc, "_use_pallas", lambda *a: False)
    emit, lens, skip, alpha0, beta0 = _lattice_inputs(seed, **shape)
    _, _, _, label_lens = _case(seed, **shape)
    ja, jnll = jctc._alpha_scan(jnp.asarray(emit), lens, jnp.asarray(label_lens), skip)
    jb = jctc._beta_scan(jnp.asarray(emit), lens, skip, beta0)
    ta = cl.ctc_alpha_reference(*_port(emit, lens, skip, alpha0))
    tb = cl.ctc_beta_reference(*_port(emit, lens, skip, beta0))
    np.testing.assert_allclose(ta.numpy(), np.moveaxis(np.asarray(ja), 0, 1), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.moveaxis(np.asarray(jb), 0, 1), **TOL)
    tnll = tctc._nll_of(ta[:, -1], torch.from_numpy(label_lens).long())
    np.testing.assert_allclose(tnll.numpy(), np.asarray(jnll), **TOL)


def _loss_and_grad_jax(logits, logit_lens, labels, label_lens):
    def f(x):
        return jctc.ctc_loss(x, jnp.asarray(logit_lens), jnp.asarray(labels),
                             jnp.asarray(label_lens), BLANK)
    loss, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _loss_and_grad_port(logits, logit_lens, labels, label_lens, dtype=torch.float32):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    loss = tctc.ctc_loss(x, torch.from_numpy(logit_lens).long(), torch.from_numpy(labels).long(),
                         torch.from_numpy(label_lens).long(), BLANK)
    loss.backward()
    return float(loss.detach()), x.grad.float().numpy()


@pytest.mark.parametrize("path", ["scan", "pallas"])
@pytest.mark.parametrize("seed", [0, 2])
def test_ctc_loss_and_grad_match_jax(seed, path, monkeypatch):
    if path == "pallas":
        monkeypatch.setenv("ONEBIT_CTC_PALLAS_FORCE_INTERPRET", "1")
        assert jctc.pallas_available_on_backend()
    else:
        monkeypatch.setattr(jctc, "_use_pallas", lambda *a: False)
    case = _case(seed, **dict(SEEDS_SHAPES)[seed])
    jl, jg = _loss_and_grad_jax(*case)
    tl, tg = _loss_and_grad_port(*case)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert np.abs(tg[1]).max() == 0.0  # the infeasible row has no gradient


def test_ctc_loss_and_grad_match_torch_ctc():
    """Against torch.nn.functional.ctc_loss(reduction="mean",
    zero_infinity=True), the semantics the JAX package reproduces."""
    logits, logit_lens, labels, label_lens = _case(5, B=5, T=30, U=6)
    label_lens[0] = 1  # F.ctc_loss's mean divides by clamp(len, 1) too
    x = torch.from_numpy(logits).requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1).transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(logit_lens).long(), torch.from_numpy(label_lens).long(),
        blank=BLANK, reduction="mean", zero_infinity=True)
    ref.backward()
    tl, tg = _loss_and_grad_port(logits, logit_lens, labels, label_lens)
    np.testing.assert_allclose(tl, float(ref.detach()), **TOL)
    np.testing.assert_allclose(tg, x.grad.numpy(), rtol=1e-5, atol=2e-5)


def test_ctc_loss_bf16_logits_give_bf16_grads():
    logits, logit_lens, labels, label_lens = _case(6)
    tl, _ = _loss_and_grad_port(logits, logit_lens, labels, label_lens)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    loss = tctc.ctc_loss(x, torch.from_numpy(logit_lens).long(), torch.from_numpy(labels).long(),
                         torch.from_numpy(label_lens).long(), BLANK)
    loss.backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    assert abs(float(loss.detach()) - tl) < 0.05 * abs(tl)  # logits rounded to bf16


def test_lattice_operand_checks():
    emit, lens, skip, alpha0, _ = _lattice_inputs(0)
    e, l, s, a = _port(emit, lens, skip, alpha0)
    for fn in (cl.ctc_alpha, cl.ctc_beta):
        with pytest.raises(ValueError):
            fn(e[0], l, s, a)  # not [B, T, S]
        with pytest.raises(TypeError):
            fn(e.double(), l, s, a)
        with pytest.raises(TypeError):
            fn(e.to(torch.bfloat16), l, s, a)
        with pytest.raises(TypeError):
            fn(e, l.float(), s, a)
        with pytest.raises(ValueError):
            fn(e, l, s[:, :-1], a)
        with pytest.raises(ValueError):
            fn(e, l[:-1], s, a)
        # a tensor on any device but the CPU launches the kernel or raises:
        # it never takes the plain version
        before = fn.launches
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            fn(e.to("meta"), l.to("meta"), s.to("meta"), a.to("meta"))
        assert fn.launches == before


def test_wrappers_do_not_count_cpu_calls():
    emit, lens, skip, alpha0, beta0 = _lattice_inputs(1)
    before = (cl.ctc_alpha.launches, cl.ctc_beta.launches)
    cl.ctc_alpha(*_port(emit, lens, skip, alpha0))
    cl.ctc_beta(*_port(emit, lens, skip, beta0))
    assert (cl.ctc_alpha.launches, cl.ctc_beta.launches) == before
    assert not os.environ.get("ONEBIT_CTC_PALLAS_FORCE_INTERPRET")


def test_plain_lattices_take_every_length_and_mask_dtype():
    """The operand forms the kernels read as they are (int32 and int64
    lengths; bool and uint8 masks) and the float mask the wrapper converts
    give the same lattice bits as the int32 / bool reference form."""
    logits, lens, labels, label_lens = (torch.from_numpy(x) for x in _case(2, B=3, T=12, U=4))
    z, skip = tctc._extended_targets(labels.long(), BLANK)
    emit, _ = tctc._emissions(logits, z)
    alpha0 = tctc._alpha0_of(emit, label_lens)
    beta0 = torch.where(torch.arange(z.shape[1]) == 2 * label_lens[:, None], 0.0, cl.NEG_INF)
    for fn, init in ((cl.ctc_alpha, alpha0), (cl.ctc_beta, beta0)):
        ref = fn(emit, lens, skip, init)
        for ll, sk in ((lens.long(), skip), (lens, skip.to(torch.uint8)), (lens, skip.float())):
            assert torch.equal(fn(emit, ll, sk, init), ref), (ll.dtype, sk.dtype)
