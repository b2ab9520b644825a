"""Parity of the port's image-token training with the JAX package on the
CPU: Muse's masked cross-entropy and Parti's next-token cross-entropy
(``ARImageModel.train_loss``), on the reduced configs.

The oracle is ``jax.value_and_grad`` of the reference's ``train_loss`` on
``blocked_jax``; the port runs its ``kernel`` tier (the hand kernels'
autograd ``Function``s, on their plain versions here) and its ``torch``
tier.  Both packages get the same seeded numpy parameters (non-zero biases)
and batch, and Muse's loss gets the reference's own mask, drawn with
``jax.random`` as the reference draws it and handed to ``token_loss``.
The VQ-GAN decoder takes no part in the loss: its leaves have no gradient
in the port (``None``) and zeros in the reference.  Tolerances: the loss
within 1e-4 relative, every gradient within 1e-4 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.suite  # noqa: F401  (registers the suite)
from repro.configs import get_config as j_get_config
from repro.workload import reduced_workload as j_reduced_workload
from repro_torch.configs import get_config
from repro_torch.nn import init_params, trainable
from repro_torch.nn.module import flatten_tree
from repro_torch.workload import reduced_workload

GRAD = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4
ARCHS = ["muse", "parti"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy()
    return tree


@pytest.fixture(scope="module")
def token_runs():
    """Per model: seeded params, a batch, the reference's mask (Muse) and
    its loss and gradients on blocked_jax."""
    out = {}
    for arch in ARCHS:
        jwl = j_reduced_workload(j_get_config(arch))
        cfg = jwl.cfg
        state = init_params(reduced_workload(get_config(arch)).model, 2)
        rng = np.random.default_rng(4)
        for key in [k for k in state if k.endswith("bias") and not k.startswith("vq.")]:
            state[key] = torch.from_numpy((0.1 * rng.standard_normal(state[key].shape))
                                          .astype(np.float32))
        params = jax.tree.map(jnp.asarray, _nested(state))
        S = cfg.image_tokens
        batch = {"image_tokens": rng.integers(0, cfg.image_vocab, (2, S)).astype(np.int32),
                 "text": rng.integers(0, cfg.text.vocab, (2, cfg.text.max_len)).astype(np.int32)}
        key = jax.random.PRNGKey(6)
        mask = None
        if cfg.decode != "ar":  # as repro/models/ar_image.py draws Muse's mask
            frac = jax.random.uniform(key, (2, 1), minval=0.2, maxval=0.9)
            mask = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (2, S)) < frac)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jwl.model.train_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, key, impl="blocked_jax")))(params)
        out[arch] = dict(state=state, batch=batch, mask=mask, loss=float(loss),
                         grads={k: np.asarray(v) for k, v in flatten_tree(grads).items()})
    return out


def _close_scaled(out, gold, msg):
    scale = max(1.0, float(np.abs(gold).max())) if gold.size else 1.0
    np.testing.assert_allclose(out.detach().numpy(), gold, rtol=GRAD["rtol"],
                               atol=GRAD["atol"] * scale, err_msg=msg)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_loss_and_every_leaf_grad_match_jax(token_runs, arch, impl):
    run = token_runs[arch]
    model = reduced_workload(get_config(arch)).load(run["state"], device="cpu")
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    mask = None if run["mask"] is None else torch.tensor(run["mask"])
    if mask is not None:
        assert 0 < float(mask.float().mean()) < 1
    loss = model.token_loss(batch, mask, impl=impl)
    np.testing.assert_allclose(loss.item(), run["loss"], rtol=LOSS_RTOL)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    assert set(grads) == set(run["grads"])
    assert all(grads[k] is None for k in grads if k.startswith("vq."))
    for key, gold in run["grads"].items():
        g = torch.zeros(gold.shape) if grads[key] is None else grads[key]
        _close_scaled(g, gold, f"{arch} {impl} {key}")


def test_parti_draws_nothing_and_muse_draws_its_mask(token_runs):
    """Parti's loss is a function of the batch alone; Muse's ``train_loss``
    is ``token_loss`` with the mask ``train_mask`` draws from the
    generator."""
    for arch in ARCHS:
        run = token_runs[arch]
        model = reduced_workload(get_config(arch)).load(run["state"], device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
        with torch.no_grad():
            loss = model.train_loss(batch, torch.Generator().manual_seed(3), impl="torch")
            mask = model.train_mask(tuple(batch["image_tokens"].shape),
                                    torch.Generator().manual_seed(3))
            assert (mask is None) == (arch == "parti")
            assert loss.item() == model.token_loss(batch, mask, impl="torch").item()
