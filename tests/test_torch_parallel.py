"""onebit_asr_tpu_torch's data parallelism and ZeRO-2 (parallel/mesh.py,
parallel/fsdp.py, train/step.py::make_sharded_train_step, the train CLI
under torchrun) against the one-process step and the JAX package, on CPU.

One pool of 4 gloo ranks (tests/torch_parallel_workers.py, which imports no
JAX) runs every multi-rank case; the JAX steps run in this process on a
mesh of 4 of conftest's fake CPU devices. Model and data are JAX
tests/test_fsdp.py::_setup's (d=32, 2 blocks, vocabulary 16, B=8 of 32
frames), f32, dropout 0, parameters from `convert.init_params`; two steps
(the LR is 0 at step 0), the sp mask pinned to [True, False] on both
sides. Tolerances:

- the data-parallel step vs the one-process step on the whole batch, and
  vs JAX's make_sharded_train_step: those tests/test_torch_train.py holds
  a step to (loss and aux rtol 1e-5 atol 1e-6, grad_norm rtol 1e-5, m and
  sqrt(v) rtol 1e-4 atol 2e-6 x the largest gradient, parameters atol 1e-5
  where the gradient exceeds 1e-6 in both steps: below, AdamW's direction
  g / (|g| + 1e-8) is set by f32 noise); every rank holds the same bits;
- the ZeRO-2 step vs the replicated step, and vs JAX's
  make_fsdp_train_step (grad_accum 1 and 2): JAX tests/test_fsdp.py's
  (loss rtol 1e-5, grad_norm rtol 1e-4, parameters rtol 2e-4 atol 2e-6,
  where the gradient exceeds 1e-6), moments as above;
- ("dcn", "data") = (2, 2) vs the flat 4-rank mesh: rtol 1e-5 atol 1e-6
  (JAX tests/test_train_step.py:136-165).

At d=32 no per-layer leaf of the port reaches JAX's `min_elems` (4,096):
JAX stacks the blocks as [L, ...] leaves and the port does not. The FSDP
cases therefore pass min_elems=256 on both sides.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from onebit_asr_tpu.model.asr import ConformerASR as JaxASR
from onebit_asr_tpu.parallel import fsdp as jfsdp
from onebit_asr_tpu.parallel import mesh as jmesh
from onebit_asr_tpu.train import optim as joptim
from onebit_asr_tpu.train import step as jstep
from onebit_asr_tpu.train.state import TrainState as JaxTrainState
from onebit_asr_tpu.utils import config as jc
from onebit_asr_tpu_torch import convert
from onebit_asr_tpu_torch.cli import train as train_cli
from onebit_asr_tpu_torch.convert import qat_model_from_jax
from onebit_asr_tpu_torch.parallel import fsdp as pfsdp
from onebit_asr_tpu_torch.parallel.mesh import local_rows, make_mesh, shard_batch
from onebit_asr_tpu_torch.utils.checkpoint import load_config
from torch_cpu_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MIN_ELEMS = 256
FLAGS = {"unfused": {}, "fused_attention": {"fused_attention": True},
         "fused_subsampler": {"fused_subsampler": True}}


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(WORLD)
    yield p
    p.close()


_RUNS = {}


def run(pool, name, **kwargs):
    """pool.run, once per case in this module."""
    key = repr((name, sorted(kwargs.items())))
    if key not in _RUNS:
        _RUNS[key] = pool.run(name, **kwargs)
    return _RUNS[key]


# -- the JAX side -----------------------------------------------------------------------


def _jax_steps(kind, grad_accum=1, batch_size=8):
    """Two steps of JAX's make_sharded_train_step ("dp") or
    make_fsdp_train_step ("fsdp", min_elems 256) on 4 fake devices, from the
    port's parameters -> {aux, params, mu, nu} in the port's names."""
    cfg = W.config()
    jcfg = dataclasses.replace(jc.ModelConfig(), remat_blocks=False, **W.SMALL)
    params = jax.tree.map(jnp.asarray, convert.init_params(cfg, 0))
    model = JaxASR.from_config(jcfg, deterministic=True)
    opt = joptim.make_optimizer(jc.OptimConfig(warmup_steps=W.WARMUP), W.TOTAL)
    state = JaxTrainState(step=jnp.int32(0), params=params, opt_state=opt.init(params),
                          rng=jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh(devices=jax.devices()[:WORLD])
    auxes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "sample_sp_mask", lambda *a, **k: jnp.asarray(W.SP_MASK))
        if kind == "dp":
            step = jstep.make_sharded_train_step(model, opt, jc.LossConfig(),
                                                 jc.SpecialTokens(), W.L, mesh)
            state = jax.device_put(state, jmesh.replicate(mesh))
        else:
            step = jfsdp.make_fsdp_train_step(model, opt, jc.LossConfig(), jc.SpecialTokens(),
                                              W.L, mesh, state, min_elems=MIN_ELEMS,
                                              grad_accum=grad_accum)
            state = jfsdp.shard_state_fsdp(state, mesh, min_elems=MIN_ELEMS)
        for b in W.batches(batch_size):
            state, aux = step(state, jmesh.shard_batch(b, mesh))
            auxes.append({k: float(v) for k, v in aux.items()})
    sd = lambda tree: {k: v.numpy() for k, v in convert.state_dict_from_jax(  # noqa: E731
        convert.to_torch(jax.tree.map(np.asarray, tree)), cfg).items()}
    adam = state.opt_state[1][0]
    return dict(aux=auxes, params=sd(state.params), mu=sd(adam.mu), nu=sd(adam.nu))


@pytest.fixture(scope="module")
def jax_dp():
    return _jax_steps("dp")


@pytest.fixture(scope="module")
def jax_fsdp():
    return _jax_steps("fsdp")


# -- comparisons --------------------------------------------------------------------------


def assert_steps_match(got, ref, grads, params_rtol=0.0, params_atol=1e-5, norm_rtol=1e-5):
    """`got` vs `ref` after the same two steps; `grads`: the recorded
    gradients of each step (the mask and the scale)."""
    for g, r in zip(got["aux"], ref["aux"]):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        for k in r:
            if k not in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=norm_rtol)
    scale = max(float(np.abs(v).max()) for step in grads for v in step.values())
    assert set(got["params"]) == set(ref["params"])
    masked = 0
    for k, want in ref["params"].items():
        np.testing.assert_allclose(got["mu"][k], ref["mu"][k], rtol=1e-4, atol=2e-6 * scale,
                                   err_msg=k)
        np.testing.assert_allclose(np.sqrt(got["nu"][k]), np.sqrt(ref["nu"][k]), rtol=1e-4,
                                   atol=2e-6 * scale, err_msg=k)
        keep = np.ones(want.shape, bool)
        for step in grads:
            keep &= np.abs(step[k]) > 1e-6
        masked += int((~keep).sum())
        np.testing.assert_allclose(got["params"][k][keep], want[keep], rtol=params_rtol,
                                   atol=params_atol, err_msg=k)
    assert masked < 0.3 * sum(v.size for v in ref["params"].values())


def assert_ranks_agree(results):
    """Every rank ends with the same bits (replicated state)."""
    for r in results[1:]:
        for part in ("params", "mu", "nu"):
            for k, v in results[0][part].items():
                assert np.array_equal(r[part][k], v), (part, k)


# -- the data-parallel step -------------------------------------------------------------


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_sharded_step_matches_one_process_step(pool, flags, grad_accum):
    """make_sharded_train_step on 4 ranks x 2 rows equals make_train_step on
    the whole batch of 8, unfused and under each fused flag (their plain
    versions on the CPU), at grad_accum 1 and 2 (micro-batch i = the
    ranks' i-th rows together, as shard_batch(micro=2) lays them out)."""
    res = run(pool, "data_parallel", flags=FLAGS[flags], grad_accum=grad_accum, reference=True)
    assert res[0]["rows"] == 8 // WORLD
    ref = res[0]["reference"]
    assert_steps_match(res[0], ref, ref["grads"])
    assert_ranks_agree(res)


def test_sharded_fp32_control_matches_one_process_step(pool):
    """The no-QAT control over the mesh (`make_fp32_train_step(mesh=)`, the
    CLI's --fp32_control under torchrun) equals it on the whole batch, at
    grad_accum 2."""
    res = pool.run("data_parallel", grad_accum=2, reference=True, fp32=True)
    ref = res[0]["reference"]
    assert set(ref["aux"][0]) == {"loss", "loss_att_32bit", "loss_ctc_32bit", "grad_norm"}
    assert_steps_match(res[0], ref, ref["grads"])
    assert_ranks_agree(res)


def test_sharded_step_matches_jax(pool, jax_dp):
    """The port's data-parallel step equals JAX's shard_map step on 4
    devices, the same parameters, batches and sp mask."""
    res = run(pool, "data_parallel", flags={}, grad_accum=1, reference=True)
    assert_steps_match(res[0], jax_dp, res[0]["grads"])


def test_multislice_mesh_matches_flat_mesh(pool):
    """("dcn", "data") = (2, 2), the batch over both axes and the gradient
    mean within each slice then across: the flat 4-rank mesh's step."""
    ms = pool.run("data_parallel", multislice=True)
    flat = run(pool, "data_parallel", flags={}, grad_accum=1, reference=True)
    for part in ("params", "mu", "nu"):
        for k, v in flat[0][part].items():
            np.testing.assert_allclose(ms[0][part][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert_ranks_agree(ms)


def test_one_rank_mesh_is_the_one_process_step():
    """Without a process group the mesh is one rank and every collective is
    the identity: both parallel steps give the one-process step's bits."""
    from onebit_asr_tpu_torch.parallel.fsdp import make_fsdp_train_step, shard_state_fsdp
    from onebit_asr_tpu_torch.train.step import (
        batch_to_device,
        make_sharded_train_step,
        make_train_step,
    )
    from onebit_asr_tpu_torch.utils.config import LossConfig, SpecialTokens

    mesh = make_mesh()
    assert mesh.size == 1 and mesh.group is None and mesh.member
    out = []
    for kind in ("one", "dp", "fsdp"):
        model, state = W._model({})
        opt = W._optimizer()
        if kind == "one":
            step = make_train_step(model, opt, LossConfig(), SpecialTokens(), W.L)
        elif kind == "dp":
            step = make_sharded_train_step(model, opt, LossConfig(), SpecialTokens(), W.L, mesh)
        else:
            step = make_fsdp_train_step(model, opt, LossConfig(), SpecialTokens(), W.L, mesh,
                                        state)
            state = shard_state_fsdp(state, mesh)
        for b in W.batches():
            state, aux = step(state, batch_to_device(shard_batch(b, mesh), "cpu"))
        out.append((float(aux["loss"]), float(aux["grad_norm"]), state.params))
    for loss, norm, params in out[1:]:
        assert (loss, norm) == out[0][:2]
        assert all(torch.equal(params[k], out[0][2][k]) for k in params)


# -- ZeRO-2 ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fsdp_run(pool):
    return pool.run("fsdp", reference=True, min_elems=MIN_ELEMS)


def _sharded_names(res):
    return [k for k, shape in res["before"]["params"].items()
            if shape != res["full_shapes"]["params"][k]]


def test_fsdp_step_matches_replicated(fsdp_run):
    """The ZeRO-2 step on 4 ranks equals the one-process (replicated) step
    on the whole batch."""
    ref = fsdp_run[0]["reference"]
    assert_steps_match(fsdp_run[0], ref, ref["grads"], params_rtol=2e-4, params_atol=2e-6,
                       norm_rtol=1e-4)


def test_fsdp_layout_shards_params_and_moments(fsdp_run):
    """Each rank holds 1/4 of every leaf the rule shards, and of its mu and
    nu; leaves under min_elems replicate; the encoder's feed-forward and
    attention kernels shard."""
    full = fsdp_run[0]["full_shapes"]["params"]
    specs = pfsdp.fsdp_state_specs(W._model({})[1], WORLD, min_elems=MIN_ELEMS)
    for res in fsdp_run:
        for part in ("params", "mu", "nu"):
            for k, shape in res["before"][part].items():
                want = [n // WORLD if s == "data" else n
                        for n, s in zip(full[k], specs[part][k] or (None,) * len(full[k]))]
                assert list(shape) == want, (part, k)
    names = _sharded_names(fsdp_run[0])
    for leaf in ("ff1.w1.kernel", "ff1.w2.kernel", "mhsa.q_proj.kernel", "mhsa.out_proj.kernel"):
        assert f"encoder.blocks.0.{leaf}" in names, leaf
    small = [k for k in full if int(np.prod(full[k])) < MIN_ELEMS]
    assert small and not set(small) & set(names)


def test_fsdp_zero2_step_matches_jax(fsdp_run, jax_fsdp):
    """The port's ZeRO-2 step equals JAX's make_fsdp_train_step on 4
    devices; its weights are all-gathered and its gradients
    reduce-scattered (once per sharded leaf a step)."""
    n = len(_sharded_names(fsdp_run[0]))
    for res in fsdp_run:
        assert res["calls"] == {"all_gather_into_tensor": 2 * n, "reduce_scatter_tensor": 2 * n}
    assert_steps_match(fsdp_run[0], jax_fsdp, fsdp_run[0]["grads"], params_rtol=2e-4,
                       params_atol=2e-6, norm_rtol=1e-4)


def test_fsdp_zero2_grad_accum_matches_jax(pool):
    """grad_accum=2 inside the ZeRO-2 step (each rank's 4 rows in two
    micro-batches, the scattered shards accumulated) equals JAX's
    make_fsdp_train_step(grad_accum=2) on the same batches of 16."""
    res = pool.run("fsdp", grad_accum=2, batch_size=16, min_elems=MIN_ELEMS)
    want = _jax_steps("fsdp", grad_accum=2, batch_size=16)
    assert_steps_match(res[0], want, res[0]["grads"], params_rtol=2e-4, params_atol=2e-6,
                       norm_rtol=1e-4)


def test_fsdp_layout_survives_the_step(fsdp_run):
    """After two steps every rank still holds only its shards, and the
    parameters moved."""
    for res in fsdp_run:
        assert res["after"] == res["before"]
    init = convert.state_dict_from_jax(convert.to_torch(convert.init_params(W.config(), 0)),
                                       W.config())
    assert any(not np.array_equal(fsdp_run[0]["params"][k], v.numpy()) for k, v in init.items())


def test_leaf_spec_matches_jax():
    """The layout rule on a list of shapes, world sizes and thresholds."""
    shapes = [(), (7,), (32,), (4096,), (32, 64), (64, 32), (64, 64), (2, 32, 64), (31, 17),
              (12, 256, 1024), (1024, 256), (5004, 256), (3, 3, 1, 256), (1, 1, 4096)]
    for n in (1, 2, 3, 4, 8):
        for min_elems in (1, 256, 4096):
            for s in shapes:
                want = tuple(jfsdp._leaf_spec(np.zeros(s, np.int8), n, "data", min_elems))
                assert pfsdp._leaf_spec(s, n, "data", min_elems) == want, (s, n, min_elems)


# -- data ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    import chip_smoke

    root = str(tmp_path_factory.mktemp("parallel_data"))
    return chip_smoke.write_data_dir(root, 0, (("train", 8), ("dev", 2)), (1.0, 2.0), "cpu",
                                     cached=True)


@pytest.mark.parametrize("cached", [False, True])
def test_ranks_rows_make_the_one_process_batch(pool, data_dirs, cached):
    """Each rank featurizes only its rows (the waveforms, or the feature
    cache's rows) with SpecAugment on; their rows together are the
    one-process featurized batch, at its padded length."""
    res = pool.run("data_rows", data_dir=data_dirs[1] if cached else data_dirs[0],
                   batch_size=8, cached=cached)
    whole = res[0]["whole"]
    for k, v in whole.items():
        got = np.concatenate([r["local"][k] for r in res])
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert (whole["feats"] == 0).any()  # the masks are there


def test_shard_batch_layouts():
    """shard_batch's rows: contiguous (JAX's P(axis)), or with micro > 1
    each micro-batch's 1/n; lists and tensors alike."""
    np.testing.assert_array_equal(local_rows(8, 1, 4), [2, 3])
    np.testing.assert_array_equal(local_rows(16, 1, 4, micro=2), [2, 3, 10, 11])
    with pytest.raises(ValueError, match="not divisible"):
        local_rows(6, 0, 4)


# -- the CLI under torchrun ------------------------------------------------------------

TINY_CLI = ["--enc_layers", "2", "--enc_d_model", "32", "--enc_heads", "2", "--enc_d_ff", "64",
            "--enc_conv_kernel", "7", "--dec_layers", "1", "--dec_d_ff", "64",
            "--dummy_frames", "64", "--warmup_steps", "1", "--eval_batches", "1",
            "--steps_per_epoch", "2", "--device", "cpu", "--dummy_data"]


def _torchrun(argv, nproc=2, program=("-m", "onebit_asr_tpu_torch.train")):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), *program, *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def test_torchrun_trains_saves_resumes_and_serves(tmp_path, data_dirs):
    """2 gloo ranks on a seeded data dir (each rank featurizes its rows): a
    data-parallel epoch, then an --fsdp --resume epoch from its checkpoint;
    rank 0 alone logs and saves the full state, which a one-process
    `transcribe --checkpoint` serves. On the synthetic backend a batch of 3
    trains on 1 of the 2 ranks, the other leaves with 0; --multistep at
    world 2 exits 1."""
    real = [a for a in TINY_CLI if a != "--dummy_data"]
    common = [*real, "--data_dir", data_dirs[0], "--num_buckets", "1", "--max_frames", "250",
              "--save_dir", str(tmp_path), "--run_name", "r", "--batch_size", "4"]
    first = _torchrun([*common, "--epochs", "1"])
    assert first.returncode == 0, first.stderr[-3000:]
    second = _torchrun([*common, "--epochs", "2", "--fsdp", "--resume"])
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.count("resumed at step 2 (epoch 1)") == 1
    assert second.stdout.count("FSDP/ZeRO-2: params + moments sharded over 2 ranks") == 1
    run_dir = tmp_path / "r"
    assert sorted(os.listdir(run_dir / "ckpt")) == ["step_2.pt", "step_4.pt"]
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 4]
    # the full state, in a one-process run's format
    saved = torch.load(run_dir / "ckpt" / "step_4.pt", weights_only=True)
    cfg = load_config(str(run_dir)).model
    want = {k: tuple(v.shape) for k, v in qat_model_from_jax(
        cfg, convert.init_params(cfg, 0), device="cpu").named_parameters()}
    for part in ("params", "mu", "nu"):
        assert {k: tuple(v.shape) for k, v in saved[part].items()} == want, part

    import chip_smoke
    from onebit_asr_tpu_torch.cli import transcribe

    wavs = tmp_path / "wavs"
    rng = np.random.default_rng(0)
    chip_smoke.write_wavs(str(wavs), [0.1 * rng.standard_normal(8000).astype(np.float32)
                                      for _ in range(2)])
    out = tmp_path / "hyp.tsv"
    with contextlib.redirect_stdout(io.StringIO()):
        assert transcribe.main(["--checkpoint", str(run_dir), "--wav_dir", str(wavs),
                                "--out", str(out), "--device", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == 2

    odd = _torchrun([*TINY_CLI, "--save_dir", str(tmp_path), "--run_name", "odd",
                     "--batch_size", "3", "--epochs", "1"])
    assert odd.returncode == 0, odd.stderr[-3000:]
    assert odd.stdout.count("using 1/2 ranks (batch divisibility)") == 2
    refused = _torchrun([*TINY_CLI, "--save_dir", str(tmp_path), "--run_name", "m",
                         "--batch_size", "4", "--epochs", "1", "--multistep", "2"])
    assert refused.returncode != 0
    assert refused.stdout.count("FATAL: --multistep is the single-chip") == 2


def test_torchrun_waits_out_rank_0s_evaluation(tmp_path):
    """Rank 0 evaluates and saves alone while the other rank waits: that
    wait outlasts --dist_timeout (the step's collectives' limit), here 5 s
    against an evaluation made 15 s slower, and the run ends with 0."""
    got = _torchrun([*TINY_CLI, "--save_dir", str(tmp_path), "--run_name", "w",
                     "--batch_size", "4", "--epochs", "1", "--dist_timeout", "5"],
                    program=(os.path.join(REPO, "tests", "torch_parallel_workers.py"), "15"))
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.count("epoch 0: train") == 1
    assert os.listdir(tmp_path / "w" / "ckpt") == ["step_2.pt"]


@pytest.mark.parametrize("flags,code", [
    (["--fsdp", "--fp32_control"], 1),
    (["--fsdp", "--multistep", "2"], 1),
])
def test_cli_refuses_fsdp_beside(flags, code, tmp_path, capsys):
    """JAX's exit codes: --fsdp with --fp32_control or --multistep exits 1."""
    assert train_cli.main([*TINY_CLI, "--save_dir", str(tmp_path), "--batch_size", "4",
                           *flags]) == code
    assert "FATAL" in capsys.readouterr().out
