"""The port's training substrate on the CPU, without JAX: the data pipeline,
checkpoints, the fault-tolerant runner, the trainer and the train entry
point (``repro_torch.{data,checkpoint,runtime,training}``,
``launch/train.py``).

Every case of the reference's checkpoint, runner and data tests
(``tests/test_substrate.py``) and of its training tests
(``tests/test_system.py``) runs here on the port, ``batch_at`` is pinned to
arrays the reference's pipeline gives, a restart from a checkpoint must
reproduce an uninterrupted run bit for bit, and the kernel tier's
gradients (the hand kernels' ``torch.autograd.Function``s, run on their
plain versions here) must equal the torch tier's for every leaf: a
``Function`` that cut the graph or dropped a cotangent fails here, since
its forward runs outside autograd on the CPU as on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.tiny import TINY_TTI_CASCADE
from repro_torch.data import SyntheticLMData, SyntheticTTIData, make_batch_iterator
from repro_torch.launch import train as train_launcher
from repro_torch.models.diffusion import DiffusionPipeline
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn import init_module, materialize, trainable
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunnerConfig
from repro_torch.training import AdamWConfig, TrainConfig, adamw_init, adamw_update, train
from repro_torch.training.trainer import step_generator

GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread under several test workers; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_sd(seed=0):
    return init_module(DiffusionPipeline(TINY_TTI_CASCADE), seed, "cpu")


def _tiny_tti_data(batch=2):
    cfg = TINY_TTI_CASCADE
    return SyntheticTTIData(latent_hw=cfg.latent_size, latent_ch=cfg.unet.in_channels,
                            text_vocab=cfg.text.vocab, text_len=cfg.text.max_len,
                            global_batch=batch)


def _olmo(seed=0):
    return init_module(TransformerLM(reduced(get_config("olmo-1b"))), seed, "cpu")


# ---------------------------------------------------------------------------
# Data pipeline (tests/test_substrate.py and arrays of the reference)
# ---------------------------------------------------------------------------


def test_lm_batch_at_equals_the_references_arrays():
    """``SyntheticLMData(vocab=50, seq_len=40, global_batch=4, seed=3,
    n_hosts=2, host_id=1).batch_at(5)`` as ``repro.data`` gives it: Zipf
    unigrams clipped to the vocab and the 8-gram motif at 16..23."""
    b = SyntheticLMData(vocab=50, seq_len=40, global_batch=4, seed=3, n_hosts=2,
                        host_id=1).batch_at(5)
    gold = np.array([
        [22, 7, 49, 2, 2, 1, 5, 49, 1, 49, 1, 9, 23, 49, 1, 2, 44, 44, 26, 32, 24, 46, 35,
         28, 41, 6, 49, 3, 1, 21, 3, 49, 49, 49, 49, 1, 6, 18, 49, 1],
        [2, 2, 1, 49, 6, 1, 1, 49, 4, 49, 49, 2, 32, 49, 1, 6, 25, 32, 40, 16, 10, 41, 2,
         46, 49, 1, 4, 49, 49, 1, 2, 33, 5, 49, 7, 1, 49, 20, 1, 45]], np.int32)
    assert b["tokens"].dtype == np.int32
    np.testing.assert_array_equal(b["tokens"], gold)
    np.testing.assert_array_equal(b["labels"][:, :-1], gold[:, 1:])
    np.testing.assert_array_equal(b["labels"][:, -1], [1, 1])


def test_tti_batch_at_equals_the_references_arrays():
    b = SyntheticTTIData(latent_hw=2, latent_ch=3, text_vocab=30, text_len=5,
                         global_batch=2, seed=1).batch_at(2)
    np.testing.assert_array_equal(b["text"], [[19, 13, 28, 12, 2], [12, 3, 8, 24, 24]])
    gold = np.array([
        [-0.05591294, 1.4461182, 1.4922192, 0.7041147, -0.82781446, 0.50985813, 1.8299483,
         1.8326104, -0.10554276, 1.4251952, -0.1735117, -0.12979126],
        [-2.3738031, 0.8981745, 0.45610294, -2.3037093, -1.8632977, 0.48364124,
         0.41777533, -0.7447401, 1.6517164, 2.5910769, 1.070201, 0.13380218]], np.float32)
    assert b["latents"].dtype == np.float32
    np.testing.assert_allclose(b["latents"].reshape(2, -1), gold, rtol=1e-7, atol=1e-7)


def test_data_deterministic_and_host_sharded():
    d0 = SyntheticLMData(vocab=100, seq_len=16, global_batch=8, n_hosts=2, host_id=0)
    d0b = SyntheticLMData(vocab=100, seq_len=16, global_batch=8, n_hosts=2, host_id=0)
    d1 = SyntheticLMData(vocab=100, seq_len=16, global_batch=8, n_hosts=2, host_id=1)
    b0 = d0.batch_at(7)
    np.testing.assert_array_equal(b0["tokens"], d0b.batch_at(7)["tokens"])
    assert not np.array_equal(b0["tokens"], d1.batch_at(7)["tokens"])
    assert b0["tokens"].shape == (4, 16)
    assert d0.batch_at(3)["labels"].shape == (4, 16)  # next-token shifted


def test_tti_data_shapes():
    b = SyntheticTTIData(latent_hw=8, latent_ch=4, text_vocab=50, text_len=6,
                         global_batch=4).batch_at(0)
    assert b["latents"].shape == (4, 8, 8, 4)
    assert b["text"].shape == (4, 6)


def test_batch_iterator_prefetches_from_a_step_onto_a_device():
    src = SyntheticLMData(vocab=100, seq_len=8, global_batch=2)
    it = make_batch_iterator(src, start_step=3, device="cpu")
    first, second = next(it), next(it)
    it.close()
    assert isinstance(first["tokens"], torch.Tensor)
    np.testing.assert_array_equal(first["tokens"].numpy(), src.batch_at(3)["tokens"])
    np.testing.assert_array_equal(second["labels"].numpy(), src.batch_at(4)["labels"])
    plain = make_batch_iterator(src)
    assert isinstance(next(plain)["tokens"], np.ndarray)
    plain.close()


# ---------------------------------------------------------------------------
# Checkpoints and the runner (tests/test_substrate.py)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (10, 20, 30):
        ck.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"] + step}})
    assert ck.all_steps() == [20, 30]  # retention keeps 2
    restored = ck.restore(tree)  # latest
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) + 30)


def test_checkpoint_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, {"x": torch.zeros(128)})
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_async_save_keeps_the_values_it_was_given(tmp_path, monkeypatch):
    """The background write holds a copy: leaves updated in place after
    ``save`` returns (an optimizer step on CPU tensors) do not reach the
    checkpoint, whichever leaf type or dtype."""
    import threading

    from repro_torch.checkpoint.checkpointer import Checkpointer as Ck

    go = threading.Event()
    write = Ck._write

    def held_write(self, step, leaves):
        go.wait(10)  # the writer starts only after the live leaves changed
        write(self, step, leaves)

    monkeypatch.setattr(Ck, "_write", held_write)
    ck = Checkpointer(str(tmp_path), async_save=True)
    live = {"w": torch.arange(6, dtype=torch.float32), "m": torch.ones(4).bfloat16(),
            "step": torch.tensor(3, dtype=torch.int32), "host": np.full(3, 2.0)}
    saved = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy()
             for k, v in live.items()}
    ck.save(1, live)
    live["w"].mul_(-1)
    live["m"].add_(1)
    live["step"].add_(1)
    live["host"] += 1
    go.set()
    ck.wait()
    out = ck.restore(saved, step=1)
    for key, want in saved.items():
        assert torch.equal(out[key], torch.as_tensor(want)), key


def test_checkpoint_no_partial_state_on_overwrite(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, {"x": torch.ones(3)})
    ck.save(5, {"x": torch.ones(3) * 2})  # overwrite the same step atomically
    out = ck.restore({"x": torch.zeros(3)}, step=5)
    np.testing.assert_array_equal(out["x"].numpy(), 2 * np.ones(3))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_checkpoint_layout_paths_dtypes_and_devices(tmp_path):
    """Dotted keys are the nested paths they spell, in ``keystr`` form; bf16
    and int32 leaves keep their dtype; ``device`` places the restored
    leaves."""
    import json

    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"params": {"unet.conv_in.kernel": torch.randn(3, 3, 2, 4),
                        "blocks.g0_dense.norm1.scale": torch.randn(2, 8).bfloat16()},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}, "seed": torch.tensor(3)}
    ck.save(7, state)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert {m["path"]: m["dtype"] for m in manifest["leaves"]} == {
        "['opt']['step']": "int32",
        "['params']['blocks']['g0_dense']['norm1']['scale']": "bfloat16",
        "['params']['unet']['conv_in']['kernel']": "float32",
        "['seed']": "int64"}
    assert [m["path"] for m in manifest["leaves"]] == sorted(m["path"] for m in
                                                             manifest["leaves"])
    out = ck.restore(state, device="cpu")
    for key in state["params"]:
        assert out["params"][key].dtype == state["params"][key].dtype
        assert torch.equal(out["params"][key], state["params"][key])
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 7


def test_runner_retries_transient_failures(tmp_path):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2, total_steps=10,
                       max_retries=3)
    fail_at = {5}  # fail once at step 5

    def step_fn(state, step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("transient device failure")
        return {"x": state["x"] + 1}

    out = FaultTolerantRunner(cfg).run({"x": torch.zeros(())}, step_fn)
    # the retry resumed from the last checkpoint (step 4) and completed
    assert float(out["x"]) == 10.0


def test_runner_gives_up_after_max_retries_with_a_checkpoint(tmp_path):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=100, total_steps=5,
                       max_retries=1)
    runner = FaultTolerantRunner(cfg)

    def step_fn(state, step):
        if step == 3:
            raise RuntimeError("persistent failure")
        return {"x": state["x"] + 1}

    with pytest.raises(RuntimeError, match="persistent"):
        runner.run({"x": torch.zeros(())}, step_fn)
    # the last good state is saved at the failing step before the error rises
    assert runner.ckpt.latest_step() == 3
    assert float(runner.ckpt.restore({"x": torch.zeros(())})["x"]) == 3.0


def test_runner_restart_resumes_from_checkpoint(tmp_path):
    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2, total_steps=4)
    out1 = FaultTolerantRunner(cfg).run({"x": torch.zeros(())}, lambda s, i: {"x": s["x"] + 1})
    assert float(out1["x"]) == 4.0
    # a second run continues to a higher total from the saved step
    cfg2 = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2, total_steps=8)
    out2 = FaultTolerantRunner(cfg2).run({"x": torch.zeros(())},
                                         lambda s, i: {"x": s["x"] + 1})
    assert float(out2["x"]) == 8.0  # 4 restored + 4 more


def test_runner_saves_and_stops_on_preemption(tmp_path):
    runner = FaultTolerantRunner(RunnerConfig(checkpoint_dir=str(tmp_path),
                                              checkpoint_every=100, total_steps=10))

    def step_fn(state, step):
        if step == 2:
            runner._preempted = True  # what the SIGTERM handler sets
        return {"x": state["x"] + 1}

    out = runner.run({"x": torch.zeros(())}, step_fn)
    assert float(out["x"]) == 3.0 and runner.ckpt.latest_step() == 3


# ---------------------------------------------------------------------------
# The optimizer's own contract (against the reference: test_torch_train_parity)
# ---------------------------------------------------------------------------


def test_adamw_treats_a_missing_gradient_as_zero():
    """A ``None`` gradient moves the moments and takes weight decay exactly
    as an explicit zero gradient, and counts as 0 in the global norm."""
    rng = np.random.default_rng(0)
    base = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in (("a", (4, 3)), ("b", (5,)))}
    g_a = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    runs = []
    for g_b in (None, torch.zeros(5)):
        params = {k: v.clone() for k, v in base.items()}
        state = adamw_init(params)
        for _ in range(3):
            params, state, metrics = adamw_update(params, {"a": g_a, "b": g_b}, state, cfg)
        runs.append((params, state, metrics))
    (p1, s1, m1), (p2, s2, m2) = runs
    for k in base:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1["v"][k], s2["v"][k])
    assert not torch.equal(p1["b"], base["b"])  # decayed with no gradient
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    assert int(s1["step"]) == 3 and s1["m"]["b"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Gradients: the kernel tier's Functions keep the graph whole
# ---------------------------------------------------------------------------


def _leaf_grads(model, loss_of):
    params = trainable(model)
    grads = torch.autograd.grad(loss_of(), list(params.values()), allow_unused=True)
    return dict(zip(params, grads))


def _assert_grads_match(kernel: dict, plain: dict):
    assert kernel.keys() == plain.keys()
    for key, g in plain.items():
        if g is None or not g.abs().max() > 0:
            continue
        k = kernel[key]
        assert k is not None and k.abs().max() > 0, f"{key}: no gradient on the kernel tier"
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(k.numpy(), g.numpy(), rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * scale, err_msg=key)


def test_kernel_tier_grads_equal_torch_tier_grads_tiny_sd():
    """Every leaf of the tiny pixel cascade under ``denoise_loss`` (the
    kernel tier takes the fused structure: conv producers, emitted stats,
    GroupNorm and flash-attention Functions); the SR UNet gets no gradient
    on either tier."""
    model = _tiny_sd()
    batch = {k: torch.from_numpy(v) for k, v in _tiny_tti_data().batch_at(0).items()}
    t, eps = model.train_noise(tuple(batch["latents"].shape), step_generator(0, 0))
    grads = {impl: _leaf_grads(model, lambda: model.denoise_loss(batch, t, eps, impl=impl))
             for impl in ("kernel", "torch")}
    _assert_grads_match(grads["kernel"], grads["torch"])
    assert all(g is None for k, g in grads["kernel"].items() if k.startswith("sr0."))
    assert all(g is not None for k, g in grads["kernel"].items() if k.startswith("unet."))


def test_kernel_tier_grads_equal_torch_tier_grads_reduced_olmo():
    """Every leaf of reduced olmo-1b, the stacked ``blocks.g0_dense`` leaves
    included (their per-layer views are taken inside the forward)."""
    model = _olmo()
    b = SyntheticLMData(vocab=model.cfg.vocab, seq_len=16, global_batch=2).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = {impl: _leaf_grads(model, lambda: model.loss(batch, impl=impl))
             for impl in ("kernel", "torch")}
    _assert_grads_match(grads["kernel"], grads["torch"])
    stacked = [k for k in grads["kernel"] if k.startswith("blocks.g0_dense.")]
    assert stacked and all(grads["kernel"][k].abs().max() > 0 for k in stacked)


def test_stacked_views_are_not_reused_across_graphs():
    """After an inference forward cached the layer views, a training
    forward still reaches the stacked leaves, and an optimizer step in
    between does not stale them."""
    model = _olmo()
    tokens = torch.from_numpy(SyntheticLMData(vocab=model.cfg.vocab, seq_len=8,
                                              global_batch=1).batch_at(0)["tokens"])
    with torch.inference_mode():
        model(tokens)
    params = trainable(model)
    key = "blocks.g0_dense.attn.wq.kernel"
    for _ in range(2):
        loss = model.loss({"tokens": tokens, "labels": tokens})
        g = torch.autograd.grad(loss, [params[key]])[0]
        assert g.abs().max() > 0
        with torch.no_grad():
            params[key].sub_(0.1 * g)


def test_trainable_refuses_inference_tensors_and_meta():
    values = _olmo().state_dict()
    with torch.inference_mode():  # values loaded under inference mode
        state = {k: v.clone() for k, v in values.items()}
    model = materialize(TransformerLM(reduced(get_config("olmo-1b"))), state, "cpu")
    with pytest.raises(ValueError, match="inference"):
        trainable(model)
    with pytest.raises(ValueError, match="meta"):
        trainable(TransformerLM(reduced(get_config("olmo-1b"))))


# ---------------------------------------------------------------------------
# The trainer (tests/test_system.py) and restart
# ---------------------------------------------------------------------------


def test_tiny_lm_training_reduces_loss(tmp_path):
    lm = _olmo()
    it = make_batch_iterator(SyntheticLMData(vocab=lm.cfg.vocab, seq_len=32, global_batch=4))
    tcfg = TrainConfig(total_steps=40, checkpoint_dir=str(tmp_path), checkpoint_every=50,
                       log_every=1000, opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40))
    state, history = train(lm, lambda batch, gen: lm.loss(batch), it, tcfg,
                           log=lambda *_: None)
    assert history[-1] < history[0] - 0.3, (history[0], history[-1])


def test_training_with_microbatching_matches_shapes(tmp_path):
    lm = _olmo()
    it = make_batch_iterator(SyntheticLMData(vocab=lm.cfg.vocab, seq_len=16, global_batch=8))
    tcfg = TrainConfig(total_steps=3, microbatches=4, checkpoint_dir=str(tmp_path),
                       checkpoint_every=100, log_every=1000)
    state, history = train(lm, lambda batch, gen: lm.loss(batch), it, tcfg,
                           log=lambda *_: None)
    assert len(history) == 3 and all(np.isfinite(history))


def _run(make_model, loss_of, source, tmp, steps, every):
    model = make_model()
    cfg = TrainConfig(total_steps=steps, checkpoint_dir=str(tmp), checkpoint_every=every,
                      log_every=1000, opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4))
    state, history = train(model, lambda b, g: loss_of(model, b, g), source, cfg,
                           log=lambda *_: None)
    return model, state, history


@pytest.mark.parametrize("which", ["tiny-sd", "olmo-1b"])
def test_restart_reproduces_the_uninterrupted_run_bitwise(tmp_path, which):
    """4 steps in one run against 2 steps, a checkpoint, and a restart for 2
    more: equal parameters, moments and step, bit for bit (the data source
    and the noise are read by step)."""
    if which == "tiny-sd":
        make, source = _tiny_sd, _tiny_tti_data()

        def loss_of(model, batch, gen):
            return model.train_loss(batch, gen)
    else:
        make = _olmo
        source = SyntheticLMData(vocab=reduced(get_config("olmo-1b")).vocab, seq_len=16,
                                 global_batch=2)

        def loss_of(model, batch, gen):
            return model.loss(batch)

    whole, s_whole, h_whole = _run(make, loss_of, source, tmp_path / "whole", 4, 100)
    _, _, h_first = _run(make, loss_of, source, tmp_path / "split", 2, 2)
    resumed, s_resumed, h_rest = _run(make, loss_of, source, tmp_path / "split", 4, 2)
    assert h_first + h_rest == h_whole
    assert int(s_resumed["opt"]["step"]) == int(s_whole["opt"]["step"]) == 4
    for key, p in whole.state_dict().items():
        assert torch.equal(resumed.state_dict()[key], p), key
        assert torch.equal(s_resumed["opt"]["m"][key], s_whole["opt"]["m"][key]), key
        assert torch.equal(s_resumed["opt"]["v"][key], s_whole["opt"]["v"][key]), key


def test_diffusion_train_loss_draws_its_noise_from_the_generator():
    model = _tiny_sd()
    batch = _tiny_tti_data().batch_at(0)
    with torch.no_grad():
        a = model.train_loss(batch, step_generator(0, 1))
        b = model.train_loss(batch, step_generator(0, 1))
        c = model.train_loss(batch, step_generator(0, 2))
    assert float(a) == float(b) and float(a) != float(c) and np.isfinite(float(a))


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def test_train_puts_back_the_sigterm_handler(tmp_path):
    """``train`` routes SIGTERM to its runner's preemption flag only while
    it runs."""
    import signal

    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        model = _olmo()
        cfg = TrainConfig(total_steps=1, log_every=100, checkpoint_every=100,
                          checkpoint_dir=str(tmp_path))
        data = SyntheticLMData(vocab=model.cfg.vocab, seq_len=16, global_batch=2)
        train(model, lambda batch, gen: model.loss(batch), data, cfg, log=lambda *a: None)
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_train_launcher_runs_reduced_on_the_cpu(tmp_path):
    logs = []
    model, state, history = train_launcher.main(
        ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "16", "--microbatches", "2", "--ckpt-dir", str(tmp_path)], log=logs.append)
    assert len(history) == 3 and all(np.isfinite(history))
    assert int(state["opt"]["step"]) == 3 and logs[-1].startswith("final loss")
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("flag", [["--mesh", "pod16x16"], ["--mesh", "pod2x16x16"]])
def test_train_launcher_refuses_a_mesh(tmp_path, flag):
    """A production mesh needs its world (256 or 512 ranks); here it has 1."""
    with pytest.raises(SystemExit, match="world of (256|512) ranks"):
        train_launcher.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), *flag])


def test_train_launcher_defaults_to_the_card():
    assert train_launcher.parse_args(["--arch", "olmo-1b"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_launcher.main(["--arch", "olmo-1b", "--reduced", "--steps", "1"])


def test_train_config_defaults_follow_the_reference():
    cfg = TrainConfig()
    assert (cfg.total_steps, cfg.microbatches, cfg.log_every, cfg.checkpoint_every) == (
        300, 1, 20, 100)
    assert dataclasses.asdict(cfg.opt) == dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                                               weight_decay=0.1, clip_norm=1.0,
                                               warmup_steps=100, total_steps=10000)
